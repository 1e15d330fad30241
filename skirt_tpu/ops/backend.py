"""The platforms the engine runs on: the GPU and the CPU.

The fused event bodies (engine/fused*.py) are pure functions over
per-lane arrays that run under ``jit`` as plain XLA on both platforms: on
the card each was timed against a Pallas Triton kernel of the same body,
and XLA's version was faster for every one (PERF.md).  There is no
interpreter path.

Any other platform raises :class:`BackendError` when a fused engine is
built.  It is deliberately not a ``ValueError``: the engine builders fall
back to the vector path on ``ValueError``, and a device the engine does
not support must fail loudly instead of quietly running the slow path.
"""

from __future__ import annotations

import jax

SUPPORTED_PLATFORMS = ("gpu", "cpu")


class BackendError(RuntimeError):
    """The platform is not one the engine runs on."""


def require_supported_platform(platform: str | None = None) -> None:
    """Raise BackendError unless the platform (default: JAX's default
    backend) is the GPU or the CPU."""
    platform = jax.default_backend() if platform is None else platform
    if platform not in SUPPORTED_PLATFORMS:
        raise BackendError(f"unsupported platform {platform!r} (expected "
                           f"one of {SUPPORTED_PLATFORMS})")
