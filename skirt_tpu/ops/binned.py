"""Tally scatter-adds with a drop sentinel.

ref: the reference's tally primitive is a lock-free atomic add per event
(Fundamentals/LockFree.hpp:25-37).  XLA lowers `.at[idx].add` to a
scatter that runs as atomic adds on the GPU, the same primitive.
"""

from __future__ import annotations

import jax.numpy as jnp


def drop_add(tally, idx, values):
    """`tally.at[idx].add(values)` where idx < 0 means "drop".

    JAX follows numpy indexing semantics: a -1 index WRAPS to the last
    bin even under mode='drop' (which only drops positive out-of-range
    indices).  Every scatter in the engine uses -1 as its dropped-lane
    sentinel, so remap it to `tally.size` (genuinely out of range) first.
    """
    safe = jnp.where(idx >= 0, idx, tally.shape[-1])
    return tally.at[safe].add(values, mode="drop")


def binned_add(tally, idx, values):
    """`tally.at[idx].add(values)` for flat (N,) updates of a flat tally.

    Negative and out-of-range indices are dropped (the lifecycle's
    sentinel for escaped or padded lanes).
    """
    return drop_add(tally, idx.ravel(), values.ravel())
