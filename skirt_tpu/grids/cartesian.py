"""3-D rectilinear Cartesian dust grid with vectorized DDA traversal.

ref: SKIRTcore/CartesianDustGrid.cpp — whichcell via per-axis binary search
(:109-118) and a DDA-style path walk to the next x/y/z wall (:136-220).

Batched re-design: traversal is an index-stepping Amanatides-Woo walk carried
out lockstep over a whole packet batch.  The per-packet traversal state is
(ix, iy, iz, t) with t the ray parameter from the traversal origin; each
step gathers the next border per axis, takes the nearest crossing, and
advances one cell.  No positions are re-derived from floating-point
accumulation, so cells are never skipped or revisited.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class CartesianState(NamedTuple):
    """Traversal state: per-axis cell indices and ray parameter."""
    ix: jnp.ndarray
    iy: jnp.ndarray
    iz: jnp.ndarray
    t: jnp.ndarray

    @property
    def inside(self):
        return (self.ix >= 0) & (self.iy >= 0) & (self.iz >= 0)


_BIG = 3.4e38  # float32 max-ish sentinel (plain float: no backend init at import)


class CartesianGrid:
    """Rectilinear grid from three border arrays (SI meters)."""

    dimension = 3

    def __init__(self, xborders, yborders, zborders):
        self.xb64 = np.asarray(xborders, dtype=np.float64)
        self.yb64 = np.asarray(yborders, dtype=np.float64)
        self.zb64 = np.asarray(zborders, dtype=np.float64)
        for b in (self.xb64, self.yb64, self.zb64):
            if b.ndim != 1 or b.size < 2 or np.any(np.diff(b) <= 0):
                raise ValueError("borders must be strictly increasing 1-D arrays")
        self.nx = self.xb64.size - 1
        self.ny = self.yb64.size - 1
        self.nz = self.zb64.size - 1
        self.ncells = self.nx * self.ny * self.nz
        # host (numpy) tables: traced code inlines them as HLO literals
        self.xb = np.asarray(self.xb64, np.float32)
        self.yb = np.asarray(self.yb64, np.float32)
        self.zb = np.asarray(self.zb64, np.float32)
        self.max_steps = self.nx + self.ny + self.nz + 4

        # uniform-spacing fast path: border lookups become arithmetic
        # (no gathers in the traversal)
        def uniform(b):
            d = np.diff(b)
            return np.allclose(d, d[0], rtol=1e-6)

        self._uniform = (uniform(self.xb64), uniform(self.yb64),
                         uniform(self.zb64))
        self._lo = (float(self.xb64[0]), float(self.yb64[0]),
                    float(self.zb64[0]))
        self._dx = (float(self.xb64[1] - self.xb64[0]),
                    float(self.yb64[1] - self.yb64[0]),
                    float(self.zb64[1] - self.zb64[0]))

    # -- host-side cell metadata ------------------------------------------

    def bounding_box(self):
        return (self.xb64[0], self.yb64[0], self.zb64[0],
                self.xb64[-1], self.yb64[-1], self.zb64[-1])

    def cell_volumes(self) -> np.ndarray:
        dx = np.diff(self.xb64)
        dy = np.diff(self.yb64)
        dz = np.diff(self.zb64)
        return (dx[:, None, None] * dy[None, :, None] * dz[None, None, :]).ravel()

    def cell_centers(self) -> np.ndarray:
        cx = 0.5 * (self.xb64[:-1] + self.xb64[1:])
        cy = 0.5 * (self.yb64[:-1] + self.yb64[1:])
        cz = 0.5 * (self.zb64[:-1] + self.zb64[1:])
        g = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1)
        return g.reshape(-1, 3)

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        """Uniform positions inside the given cells (host side, for setup MC)."""
        ix, iy, iz = self._split_np(cells)
        u = rng_np.uniform(size=(cells.size, 3))
        x = self.xb64[ix] + u[:, 0] * (self.xb64[ix + 1] - self.xb64[ix])
        y = self.yb64[iy] + u[:, 1] * (self.yb64[iy + 1] - self.yb64[iy])
        z = self.zb64[iz] + u[:, 2] * (self.zb64[iz + 1] - self.zb64[iz])
        return np.stack([x, y, z], axis=-1)

    def _split_np(self, cells):
        iz = cells % self.nz
        iy = (cells // self.nz) % self.ny
        ix = cells // (self.ny * self.nz)
        return ix, iy, iz

    def random_position_in_cell_dev(self, key, cells):
        """Device-side uniform positions inside given cells (N,) -> (N, 3).

        ref: DustGrid::randomPositionInCell (used by the dust-emission
        launch, PanMonteCarloSimulation.cpp:303).  Uniform-spacing axes
        use arithmetic borders — no gathers, the common dust-launch case.
        """
        iz = cells % self.nz
        iy = (cells // self.nz) % self.ny
        ix = cells // (self.ny * self.nz)
        u = jax.random.uniform(key, (cells.shape[0], 3), dtype=jnp.float32)

        def axis_pos(axis, idx, ua):
            borders = (self.xb, self.yb, self.zb)[axis]
            if self._uniform[axis]:
                lo = jnp.float32(self._lo[axis]) \
                    + idx.astype(jnp.float32) * jnp.float32(self._dx[axis])
                return lo + ua * jnp.float32(self._dx[axis])
            b = jnp.asarray(borders)
            lo = b[idx]
            return lo + ua * (b[idx + 1] - lo)

        return jnp.stack([axis_pos(0, ix, u[:, 0]),
                          axis_pos(1, iy, u[:, 1]),
                          axis_pos(2, iz, u[:, 2])], axis=-1)

    # -- device-side protocol ---------------------------------------------

    def flatten_index(self, ix, iy, iz):
        return (ix * self.ny + iy) * self.nz + iz

    def cell_of(self, state: CartesianState):
        ok = ((state.ix >= 0) & (state.ix < self.nx)
              & (state.iy >= 0) & (state.iy < self.ny)
              & (state.iz >= 0) & (state.iz < self.nz))
        return jnp.where(ok, self.flatten_index(state.ix, state.iy, state.iz), -1)

    def locate(self, pos):
        """Flat cell index containing pos, -1 outside (vectorized)."""
        s = self.start(pos)
        return self.cell_of(s)

    def start(self, pos) -> CartesianState:
        """Traversal state for rays originating at pos (t = 0)."""
        ix = jnp.searchsorted(self.xb, pos[..., 0], side="right").astype(jnp.int32) - 1
        iy = jnp.searchsorted(self.yb, pos[..., 1], side="right").astype(jnp.int32) - 1
        iz = jnp.searchsorted(self.zb, pos[..., 2], side="right").astype(jnp.int32) - 1
        ix = jnp.where((ix >= 0) & (ix < self.nx), ix, -1)
        iy = jnp.where((iy >= 0) & (iy < self.ny), iy, -1)
        iz = jnp.where((iz >= 0) & (iz < self.nz), iz, -1)
        t = jnp.zeros(pos.shape[:-1], dtype=pos.dtype)
        return CartesianState(ix, iy, iz, t)

    def enter(self, pos, direction):
        """Distance to the domain boundary for outside rays + entry state.

        ref: DustGridPath::moveInside.  Returns (s0, state) with s0 = inf
        (and state outside) for rays that miss the box.
        """
        eps = jnp.float32(1e-5)
        lo = jnp.stack([self.xb[0], self.yb[0], self.zb[0]])
        hi = jnp.stack([self.xb[-1], self.yb[-1], self.zb[-1]])
        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (lo - pos) * inv
        t2 = (hi - pos) * inv
        tnear = jnp.max(jnp.where(moving, jnp.minimum(t1, t2), -_BIG), axis=-1)
        tfar = jnp.min(jnp.where(moving, jnp.maximum(t1, t2), _BIG), axis=-1)
        # parallel rays outside the slab never enter
        par_outside = jnp.any(jnp.logical_not(moving)
                              & ((pos < lo) | (pos > hi)), axis=-1)
        hit = (tnear <= tfar) & (tfar > 0) & jnp.logical_not(par_outside)
        s0 = jnp.where(hit, jnp.maximum(tnear, 0.0), _BIG)
        # nudge slightly inside to get a well-defined cell
        span = jnp.max(hi - lo)
        entry = pos + (s0 + eps * span)[..., None] * direction
        state = self.start(entry)
        state = state._replace(t=jnp.where(hit, s0, _BIG))
        dead = jnp.logical_not(hit)
        state = state._replace(ix=jnp.where(dead, -1, state.ix))
        return s0, state

    def step(self, state: CartesianState, origin, direction):
        """Advance one cell: returns (ds, new_state).

        ds is the path length through the current cell; new_state.t is the
        ray parameter at the exit wall.  For states already outside, ds = 0
        and the state is unchanged.
        """
        ix, iy, iz, t = state
        inside = (ix >= 0) & (iy >= 0) & (iz >= 0)
        cix = jnp.clip(ix, 0, self.nx - 1)
        ciy = jnp.clip(iy, 0, self.ny - 1)
        ciz = jnp.clip(iz, 0, self.nz - 1)

        dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
        ox, oy, oz = origin[..., 0], origin[..., 1], origin[..., 2]

        # parameter value of the next wall crossing on each axis
        tx = self._axis_t(self.xb, cix, ox, dx, 0)
        ty = self._axis_t(self.yb, ciy, oy, dy, 1)
        tz = self._axis_t(self.zb, ciz, oz, dz, 2)

        tmin = jnp.minimum(tx, jnp.minimum(ty, tz))
        ds = jnp.maximum(tmin - t, 0.0)

        stepx = (tx <= ty) & (tx <= tz)
        stepy = jnp.logical_not(stepx) & (ty <= tz)
        stepz = jnp.logical_not(stepx) & jnp.logical_not(stepy)

        sgn = lambda d: jnp.where(d > 0, 1, -1).astype(jnp.int32)
        nix = jnp.where(stepx, cix + sgn(dx), cix)
        niy = jnp.where(stepy, ciy + sgn(dy), ciy)
        niz = jnp.where(stepz, ciz + sgn(dz), ciz)

        # leaving the domain marks the state outside
        nix = jnp.where((nix < 0) | (nix >= self.nx), -1, nix)
        niy = jnp.where((niy < 0) | (niy >= self.ny), -1, niy)
        niz = jnp.where((niz < 0) | (niz >= self.nz), -1, niz)

        new_state = CartesianState(
            jnp.where(inside, nix, ix),
            jnp.where(inside, niy, iy),
            jnp.where(inside, niz, iz),
            jnp.where(inside, tmin, t),
        )
        return jnp.where(inside, ds, 0.0), new_state

    def _axis_t(self, borders, idx, o, d, axis):
        """Ray parameter of the next border crossing along one axis."""
        pos_dir = d > 0
        nxt = jnp.where(pos_dir, idx + 1, idx)
        if self._uniform[axis]:
            # arithmetic border (no gather) for uniformly spaced meshes
            border = jnp.float32(self._lo[axis]) \
                + nxt.astype(jnp.float32) * jnp.float32(self._dx[axis])
        else:
            border = jnp.asarray(borders)[nxt]
        t = (border - o) / jnp.where(jnp.abs(d) > 1e-30, d, jnp.float32(1e-30))
        return jnp.where(jnp.abs(d) > 1e-30, t, _BIG)

    def position_at(self, origin, direction, t):
        return origin + t[..., None] * direction

    # -- batched all-crossings traversal (engine/vector_traversal.py) ------

    def crossings(self, pos, direction):
        """All candidate wall-crossing ray parameters, unsorted.

        Returns (t_all (N, S), t_start (N,), t_stop (N,)) with
        S = nx+ny+nz+3; non-crossings (rays parallel to an axis) are BIG
        and rays that miss the box get t_start = t_stop = 0.
        """
        return self.crossings_with_x(jnp.asarray(self.xb), pos, direction)

    def crossings_with_x(self, xb, pos, direction):
        """crossings() against a caller-supplied (traced) x-border array.

        Used by the slab-decomposed lifecycle (parallel/slab.py): each
        device passes only ITS slab's x-planes, so the entry/exit span
        comes out already clipped to the slab and the candidate count
        drops from nx+ny+nz+3 to nx/D+ny+nz+3.
        """
        borders = (xb, jnp.asarray(self.yb), jnp.asarray(self.zb))
        t_parts = []
        t_near = jnp.full(pos.shape[:-1], -_BIG, pos.dtype)
        t_far = jnp.full(pos.shape[:-1], _BIG, pos.dtype)
        for axis in range(3):
            b = borders[axis]
            oa = pos[..., axis]
            da = direction[..., axis]
            moving = jnp.abs(da) > 1e-30
            inv = 1.0 / jnp.where(moving, da, 1.0)
            t = (b[None, :] - oa[:, None]) * inv[:, None]
            t_parts.append(jnp.where(moving[:, None], t, _BIG))
            tlo = t[:, 0]
            thi = t[:, -1]
            near = jnp.minimum(tlo, thi)
            far = jnp.maximum(tlo, thi)
            in_slab = (oa >= b[0]) & (oa <= b[-1])
            near = jnp.where(moving, near, jnp.where(in_slab, -_BIG, _BIG))
            far = jnp.where(moving, far, jnp.where(in_slab, _BIG, -_BIG))
            t_near = jnp.maximum(t_near, near)
            t_far = jnp.minimum(t_far, far)
        t_start = jnp.maximum(t_near, 0.0)
        hit = (t_start <= t_far) & (t_far > 0)
        t_start = jnp.where(hit, t_start, 0.0)
        t_stop = jnp.where(hit, t_far, 0.0)
        return jnp.concatenate(t_parts, axis=-1), t_start, t_stop

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the bounding box (slab test).

        Pure elementwise arithmetic — used by the analytic-density panel
        quadrature, which needs only the in-domain span, not the
        individual wall crossings.  Rays that miss give t_start == t_stop.
        """
        lo = jnp.asarray([self.xb[0], self.yb[0], self.zb[0]])
        hi = jnp.asarray([self.xb[-1], self.yb[-1], self.zb[-1]])
        moving = jnp.abs(direction) > 1e-30
        inv = 1.0 / jnp.where(moving, direction, 1.0)
        t1 = (lo - pos) * inv
        t2 = (hi - pos) * inv
        in_slab = (pos >= lo) & (pos <= hi)
        near = jnp.where(moving, jnp.minimum(t1, t2),
                         jnp.where(in_slab, -_BIG, _BIG))
        far = jnp.where(moving, jnp.maximum(t1, t2),
                        jnp.where(in_slab, _BIG, -_BIG))
        t_near = jnp.max(near, axis=-1)
        t_far = jnp.min(far, axis=-1)
        t_start = jnp.maximum(t_near, 0.0)
        hit = (t_start <= t_far) & (t_far > 0)
        t_start = jnp.where(hit, t_start, 0.0)
        return t_start, jnp.where(hit, t_far, t_start)

    def _locate_axis(self, axis, x):
        """Batched per-axis cell index (arithmetic when uniform)."""
        borders = (self.xb, self.yb, self.zb)[axis]
        n = (self.nx, self.ny, self.nz)[axis]
        if self._uniform[axis]:
            rel = (x - jnp.float32(self._lo[axis])) \
                * jnp.float32(1.0 / self._dx[axis])
            idx = jnp.floor(rel).astype(jnp.int32)
        else:
            # compare-all beats searchsorted's sequential binary search
            idx = jnp.sum((x[..., None] >= jnp.asarray(borders)[None, :]),
                          axis=-1).astype(jnp.int32) - 1
        return jnp.where((idx >= 0) & (idx < n), idx, -1)

    def locate_batched(self, points):
        """Flat cell ids for arbitrary-shaped point batches (-1 outside)."""
        ix = self._locate_axis(0, points[..., 0])
        iy = self._locate_axis(1, points[..., 1])
        iz = self._locate_axis(2, points[..., 2])
        ok = (ix >= 0) & (iy >= 0) & (iz >= 0)
        return jnp.where(ok, self.flatten_index(jnp.clip(ix, 0),
                                                jnp.clip(iy, 0),
                                                jnp.clip(iz, 0)), -1)


class TwoPhaseGrid(CartesianGrid):
    """Cartesian grid carrying random two-phase density weights.

    ref: SKIRTcore/TwoPhaseDustGrid.cpp — each cell is drawn into the
    high-density phase with probability `filling_factor`; the weights
    contrast/norm (high) and 1/norm (low), with norm = contrast*ff + 1-ff,
    keep the volume-averaged weight at exactly one so normalizations are
    preserved.  `DustSystem` multiplies the sampled densities by
    `cell_weights` (ref: DustSystem.cpp:159-170 applies grid->weight(m)).
    """

    def __init__(self, xborders, yborders, zborders, filling_factor: float,
                 contrast: float, seed: int = 4357):
        super().__init__(xborders, yborders, zborders)
        if not 0.0 < filling_factor < 1.0:
            raise ValueError("the volume filling factor of the high-density "
                             "medium should be between 0 and 1")
        if contrast <= 0.0:
            raise ValueError("the density contrast should be positive")
        self.filling_factor = float(filling_factor)
        self.contrast = float(contrast)
        X = np.random.default_rng(seed).random(self.ncells)
        norm = contrast * filling_factor + 1.0 - filling_factor
        self.cell_weights = np.where(X < filling_factor,
                                     contrast / norm, 1.0 / norm)
