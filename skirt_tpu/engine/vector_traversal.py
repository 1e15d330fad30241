"""Fully-batched path recording via the all-crossings formulation.

ref: SKIRTcore/CartesianDustGrid.cpp:136-220 walks a ray wall-by-wall in a
sequential DDA loop; SKIRTcore/DustGridPath.hpp records the segments.

Batched re-design: a sequential per-cell walk serializes one tiny gather per
step, because dependent gathers cannot be batched.  For border-structured
grids the full crossing set is known UP FRONT: every grid surface yields a
closed-form ray parameter.  So instead of walking, we (1) compute ALL
wall-crossing parameters in one batched op, (2) sort them per lane, and
(3) derive segment lengths and cell
ids from consecutive crossing pairs with arithmetic + *batched* gathers.
There is no sequential loop at all, and every memory op is vectorized.

A grid opts in by providing
  crossings(pos, direction) -> (t_all (N, S), t_start (N,), t_stop (N,))
    unsorted candidate crossing parameters (use BIG for non-crossings) and
    the entry/exit parameters of the domain (0/0 for rays that miss), and
  locate_batched(points (..., 3)) -> (...,) int32 cell ids (-1 outside)
    with purely batched ops (no per-lane binary-search loops).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_BIG = 3.4e38


def record_paths(grid, pos, direction, *, want_cells=True, want_mid=False):
    """Record the full traversal path of every lane, without stepping.

    Returns (cells, ds, t_exit[, t_mid]), each (N, S): per-segment cell id
    (-1 for zero-length padding segments), segment length, ray parameter at
    the segment exit, and (when want_mid) the segment-midpoint parameter.
    Segments are sorted along the ray; padding segments have ds == 0 and
    contribute nothing downstream.  want_cells=False skips the locate pass
    (cells comes back None) — used by the analytic-density mode, which
    evaluates rho at midpoints instead of gathering per-cell tables.
    """
    t_all, t_start, t_stop = grid.crossings(pos, direction)
    t = jnp.clip(t_all, t_start[:, None], t_stop[:, None])
    ts = jnp.sort(t, axis=-1)
    ds = ts[:, 1:] - ts[:, :-1]
    mid = ts[:, :-1] + 0.5 * ds
    cells = None
    if want_cells:
        pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
        cells = grid.locate_batched(pmid)
        cells = jnp.where(ds > 0, cells, -1)
    if want_mid:
        return cells, ds, ts[:, 1:], mid
    return cells, ds, ts[:, 1:]


def panel_paths(grid, pos, direction, npanels: int):
    """Equal-length panel decomposition of the in-domain ray span.

    The analytic-density mode evaluates a CONTINUOUS rho at segment
    midpoints, so the cell-boundary segmentation of record_paths is just
    one midpoint-quadrature panelization among many; equal panels give the
    same order of accuracy (per-direction resolution is bounded by
    box-extent / npanels, like the wall crossings) without the crossings
    computation, the clip, or the per-lane SORT — the sort alone is ~40%
    of an analytic iteration.

    Returns (ds, t_exit, t_mid), each (N, P); zero-width panels for rays
    that miss the domain.
    """
    t0, t1 = grid.ray_span(pos, direction)
    delta = (t1 - t0) / npanels
    k = jnp.arange(1, npanels + 1, dtype=pos.dtype)[None, :]
    te = t0[:, None] + k * delta[:, None]
    mid = te - 0.5 * delta[:, None]
    ds = jnp.broadcast_to(delta[:, None], te.shape)
    return ds, te, mid


def row_cumsum(x):
    """Inclusive row cumsum as one (N,S)@(S,S) lower-triangular matmul."""
    S = x.shape[-1]
    tri = jnp.asarray(np.tril(np.ones((S, S), np.float32)).T)
    # HIGHEST: a default float32 product may run in TF32 on the GPU
    # (preferred_element_type only sets the accumulator), which would put
    # ~1e-3 relative error on every optical depth
    return jax.lax.dot_general(
        x, tri, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)


def invert_tau_panels(cum, t0, delta, tau):
    """Panel-quadrature specialization of invert_tau.

    With equal panels, the exit/length/midpoint of the hit segment are
    arithmetic in the hit index — only the cum picks remain.  Returns
    (s, mid_h).
    """
    S = cum.shape[1]
    i_hit = jnp.clip(
        jnp.sum((cum < tau[:, None]).astype(jnp.int32), axis=1), 0, S - 1)
    cum_h = masked_row_pick(cum, i_hit)
    cum_prev = jnp.where(i_hit > 0,
                         masked_row_pick(cum, jnp.maximum(i_hit - 1, 0)), 0.0)
    dtau_h = cum_h - cum_prev
    frac = jnp.where(dtau_h > 0,
                     (tau - cum_prev) / jnp.maximum(dtau_h, 1e-30), 0.0)
    fi = i_hit.astype(cum.dtype)
    s = t0 + (fi + jnp.clip(frac, 0.0, 1.0)) * delta
    mid_h = t0 + (fi + 0.5) * delta
    return s, mid_h


def panel_pick_mid(t0, delta, i_pick):
    """Midpoint parameter of panel i_pick (arithmetic, no row pick)."""
    return t0 + (i_pick.astype(t0.dtype) + 0.5) * delta


def masked_row_pick(rows, i_hit):
    """rows (N, S) -> (N,) value at per-lane column i_hit.

    A one-hot masked sum over the S columns instead of a per-lane
    jnp.take_along_axis gather.
    """
    S = rows.shape[1]
    sel = jnp.arange(S, dtype=jnp.int32)[None, :] == i_hit[:, None]
    return jnp.sum(jnp.where(sel, rows, 0), axis=1)


def masked_row_pick_int(rows, i_hit, fill=-1):
    S = rows.shape[1]
    sel = jnp.arange(S, dtype=jnp.int32)[None, :] == i_hit[:, None]
    picked = jnp.sum(jnp.where(sel, rows, 0), axis=1)
    any_sel = jnp.any(sel, axis=1)
    return jnp.where(any_sel, picked, fill)


def invert_tau(cum, ds, t_exit, cells, tau):
    """Path position where cumulative optical depth reaches `tau`.

    ref: DustGridPath::pathlength (DustGridPath.hpp:117-168) — the inverse
    lookup in the recorded path, vectorized over lanes with masked-sum row
    picks.  Returns (s, cell_at, mid_h); cell_at is None when cells is
    None (analytic mode — the caller locates the hit-segment midpoint
    arithmetically instead), mid_h is the hit segment's midpoint parameter.
    """
    S = cum.shape[1]
    i_hit = jnp.clip(
        jnp.sum((cum < tau[:, None]).astype(jnp.int32), axis=1), 0, S - 1)
    cum_h = masked_row_pick(cum, i_hit)
    cum_prev = jnp.where(i_hit > 0,
                         masked_row_pick(cum, jnp.maximum(i_hit - 1, 0)), 0.0)
    dtau_h = cum_h - cum_prev
    frac = jnp.where(dtau_h > 0,
                     (tau - cum_prev) / jnp.maximum(dtau_h, 1e-30), 0.0)
    te_h = masked_row_pick(t_exit, i_hit)
    ds_h = masked_row_pick(ds, i_hit)
    s = (te_h - ds_h) + jnp.clip(frac, 0.0, 1.0) * ds_h
    cell_at = masked_row_pick_int(cells, i_hit) if cells is not None else None
    return s, cell_at, te_h - 0.5 * ds_h
