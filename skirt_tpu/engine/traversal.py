"""Generic grid-traversal driver.

Replaces the reference's per-photon DustGridPath record-and-replay
(ref: SKIRTcore/DustGridPath.hpp:27-168, DustSystem::fillOpticalDepth
DustSystem.cpp:959-980) with *streaming* sweeps: a lockstep loop advances a
whole packet batch one cell per iteration, invoking a per-segment callback
(tau accumulation, absorption tallies, interaction-point search) without
ever materializing variable-length paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


CHECK_EVERY = 8  # steps between all-lanes-done checks (amortizes the
                 # while-condition any-reduction; early exit granularity)

_BIG = 3.4e38  # float32 max-ish sentinel


def sweep(grid, origin, direction, seg_fn, carry0, state0=None,
          max_steps: int | None = None, active=None,
          check_every: int | None = None):
    """Traverse the grid from `origin` along `direction` for a packet batch.

    seg_fn(carry, cell, ds, t_exit) -> (carry, active) is invoked once per
    segment per packet; `cell` is -1 and ds = 0 for lanes already outside.
    `active` lets the callback terminate lanes early (e.g. once an optical
    depth target is reached); the loop ends when no lane is both inside and
    active, or after max_steps.  The `active` argument masks out lanes
    entirely (dead packets must not extend the lockstep loop).

    The outer while-loop condition is only evaluated every `check_every`
    steps; the inner steps run as an unrolled fori (each evaluation of
    the data-dependent condition is a device-to-host round trip of the
    loop).
    """
    if state0 is None:
        state0 = grid.start(origin)
    if max_steps is None:
        max_steps = grid.max_steps
    if check_every is None:
        check_every = CHECK_EVERY
    active0 = jnp.ones(origin.shape[:-1], dtype=bool) if active is None \
        else active

    def one_step(loop):
        i, state, carry, active = loop
        cell = grid.cell_of(state)
        ds, nstate = grid.step(state, origin, direction)
        live = active & (cell >= 0)
        carry, still = seg_fn(carry, jnp.where(live, cell, -1),
                              jnp.where(live, ds, 0.0), nstate.t)
        # lanes keep their state when inactive so results stay frozen
        frozen = jnp.logical_not(live)
        nstate = jax.tree.map(
            lambda new, old: jnp.where(frozen, old, new), nstate, state)
        return i + 1, nstate, carry, active & still

    def cond(loop):
        i, state, carry, active = loop
        return (i < max_steps) & jnp.any(active & (grid.cell_of(state) >= 0))

    def body(loop):
        # fully unrolled inner chunk: straight-line code between condition
        # checks (device loop iterations are the latency bottleneck)
        for _ in range(check_every):
            loop = one_step(loop)
        return loop

    _, state, carry, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state0, carry0, active0))
    return carry, state


def optical_depth(grid, kapparho_of_cell, origin, direction, state0=None,
                  max_s=None, active=None):
    """Total optical depth from origin to the domain boundary.

    kapparho_of_cell(cell) -> extinction coefficient [1/m] per packet
    (must return 0 for cell == -1).  With max_s (per-packet path-length
    limit, e.g. the distance to a perspective camera) accumulation stops
    at that distance (ref: DustGridPath::opticalDepth(kapparho, d)).
    """
    def seg(tau, cell, ds, t_exit):
        if max_s is not None:
            seg_start = t_exit - ds
            ds = jnp.clip(jnp.minimum(t_exit, max_s) - seg_start, 0.0, ds)
            cont = t_exit < max_s
        else:
            cont = jnp.ones_like(tau, dtype=bool)
        return tau + kapparho_of_cell(cell) * ds, cont

    tau0 = jnp.zeros(origin.shape[:-1], dtype=origin.dtype)
    tau, _ = sweep(grid, origin, direction, seg, tau0, state0=state0,
                   active=active)
    return tau


def propagate_to_tau(grid, kapparho_of_cell, origin, direction, tau_target,
                     state0=None, active=None):
    """Path length s at which the cumulative optical depth reaches tau_target.

    ref: DustGridPath::pathlength(tau) inverse lookup — here computed in the
    same streaming sweep.  Lanes whose total tau never reaches the target
    return the boundary distance (caller guards against that by sampling
    tau_target < tau_path).  Returns (s, cell_at_s).
    """
    n = origin.shape[:-1]
    carry0 = dict(
        tau=jnp.zeros(n, dtype=origin.dtype),
        s=jnp.zeros(n, dtype=origin.dtype),
        cell=jnp.full(n, -1, dtype=jnp.int32),
        done=jnp.zeros(n, dtype=bool),
    )

    def seg(carry, cell, ds, t_exit):
        kr = kapparho_of_cell(cell)
        dtau = kr * ds
        tau_new = carry["tau"] + dtau
        reaches = jnp.logical_not(carry["done"]) & (tau_new >= tau_target) & (cell >= 0)
        # fractional position inside this segment
        frac = jnp.where(dtau > 0, (tau_target - carry["tau"]) / jnp.maximum(dtau, 1e-30), 0.0)
        s_here = (t_exit - ds) + jnp.clip(frac, 0.0, 1.0) * ds
        carry = dict(
            tau=tau_new,
            s=jnp.where(reaches, s_here, jnp.where(carry["done"], carry["s"], t_exit)),
            cell=jnp.where(reaches, cell, jnp.where(carry["done"], carry["cell"], cell)),
            done=carry["done"] | reaches,
        )
        return carry, jnp.logical_not(carry["done"])

    carry, _ = sweep(grid, origin, direction, seg, carry0, state0=state0,
                     active=active)
    return carry["s"], carry["cell"]


def record_path(grid, origin, direction, state0=None, max_steps=None,
                active=None, check_every=None):
    """Record the full traversal path into fixed-size (S, N) buffers.

    ref: DustGridPath — the reference records every path segment
    (cell m, ds, s) once and replays it for absorption and for the
    pathlength(tau) inverse lookup (DustGridPath.hpp:117-168).  Here the
    bounded-step buffer turns the per-segment physics into *vectorized*
    (S, N) array math (cumsum over the step axis) instead of S sequential
    loop iterations, and saves the second traversal that the streaming
    design needs for propagation.

    Returns (cells (S, N) int32 with -1 padding, ds (S, N), t_exit (S, N)).
    Memory: 3 * S * N words — callers gate on grid.max_steps.
    """
    if state0 is None:
        state0 = grid.start(origin)
    S = max_steps if max_steps is not None else grid.max_steps
    K = check_every if check_every is not None else CHECK_EVERY
    nshape = origin.shape[:-1]
    active0 = jnp.ones(nshape, dtype=bool) if active is None else active

    # pad by one chunk: the while condition is only checked every K steps,
    # so the write index can run K-1 past S (XLA clamps out-of-range
    # dynamic updates, which would silently clobber the last row)
    S_pad = S + K
    cells_buf = jnp.full((S_pad,) + nshape, -1, jnp.int32)
    ds_buf = jnp.zeros((S_pad,) + nshape, origin.dtype)
    te_buf = jnp.zeros((S_pad,) + nshape, origin.dtype)

    def one_step(loop):
        i, state, cb, db, tb = loop
        cell = grid.cell_of(state)
        ds, nstate = grid.step(state, origin, direction)
        live = active0 & (cell >= 0)
        cb = jax.lax.dynamic_update_index_in_dim(
            cb, jnp.where(live, cell, -1), i, 0)
        db = jax.lax.dynamic_update_index_in_dim(
            db, jnp.where(live, ds, 0.0), i, 0)
        tb = jax.lax.dynamic_update_index_in_dim(tb, nstate.t, i, 0)
        frozen = jnp.logical_not(live)
        nstate = jax.tree.map(
            lambda new, old: jnp.where(frozen, old, new), nstate, state)
        return i + 1, nstate, cb, db, tb

    def cond(loop):
        i, state, *_ = loop
        return (i < S) & jnp.any(active0 & (grid.cell_of(state) >= 0))

    def body(loop):
        for _ in range(K):
            loop = one_step(loop)
        return loop

    # S may not be divisible by K; the buffer writes guard via i < S being
    # checked per chunk start, so pad S up to a K multiple for the buffers
    _, _, cb, db, tb = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state0, cells_buf, ds_buf, te_buf))
    return cb, db, tb


def sweep_tau_recorded(grid, origin, direction, seg_fn, carry0, state0=None,
                       active=None, max_steps=None, check_every=None):
    """Streaming sweep that records per-step (cumtau, ds, t_exit) rows.

    Like `sweep`, but seg_fn returns (carry, active, cumtau_after) and the
    loop stacks (cumtau_after, ds, t_exit) into (S, N) buffers.  The
    recording costs only buffer writes — no extra gathers — and lets the
    caller invert tau -> path position afterwards WITHOUT the second
    traversal that `propagate_to_tau` performs (ref: DustGridPath records
    the path once and replays it; eliminating the replay traversal halves
    the per-event gather count).

    Unwritten cumtau rows stay at +BIG so a row-count inversion
    (sum(cumtau < tau)) never lands in the padding.
    Returns (carry, (cumtau (S,N), ds (S,N), t_exit (S,N))).
    """
    if state0 is None:
        state0 = grid.start(origin)
    if max_steps is None:
        max_steps = grid.max_steps
    K = check_every if check_every is not None else CHECK_EVERY
    nshape = origin.shape[:-1]
    active0 = jnp.ones(nshape, dtype=bool) if active is None else active

    S_pad = max_steps + K  # see record_path: chunked condition checks
    cum_buf = jnp.full((S_pad,) + nshape, _BIG, origin.dtype)
    ds_buf = jnp.zeros((S_pad,) + nshape, origin.dtype)
    te_buf = jnp.zeros((S_pad,) + nshape, origin.dtype)

    def one_step(loop):
        i, state, carry, act, cb, db, tb = loop
        cell = grid.cell_of(state)
        ds, nstate = grid.step(state, origin, direction)
        live = act & (cell >= 0)
        carry, still, cum_after = seg_fn(
            carry, jnp.where(live, cell, -1), jnp.where(live, ds, 0.0),
            nstate.t)
        cb = jax.lax.dynamic_update_index_in_dim(
            cb, jnp.where(live, cum_after, _BIG), i, 0)
        db = jax.lax.dynamic_update_index_in_dim(
            db, jnp.where(live, ds, 0.0), i, 0)
        tb = jax.lax.dynamic_update_index_in_dim(
            tb, jnp.where(live, nstate.t, 0.0), i, 0)
        frozen = jnp.logical_not(live)
        nstate = jax.tree.map(
            lambda new, old: jnp.where(frozen, old, new), nstate, state)
        return i + 1, nstate, carry, act & still, cb, db, tb

    def cond(loop):
        i, state, carry, act, *_ = loop
        return (i < max_steps) & jnp.any(act & (grid.cell_of(state) >= 0))

    def body(loop):
        for _ in range(K):
            loop = one_step(loop)
        return loop

    _, _, carry, _, cb, db, tb = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), state0, carry0, active0, cum_buf, ds_buf, te_buf))
    return carry, (cb, db, tb)
