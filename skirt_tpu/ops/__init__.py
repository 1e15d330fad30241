"""Tally primitives and the platform's kernel execution mode."""

from .binned import binned_add, drop_add  # noqa: F401
