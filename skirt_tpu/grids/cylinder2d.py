"""2-D axisymmetric (R, z) cylindrical dust grid.

ref: SKIRTcore/Cylinder2DDustGrid.cpp — the default grid for axisymmetric
disc models.  Cells are annular rings; traversal intersects rays with
cylinder walls (quadratic) and z-planes.

float32 note: all intersection math runs in coordinates scaled by the
outer radius, because squaring SI positions (~1e20 m) overflows float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class CylinderState(NamedTuple):
    ir: jnp.ndarray   # radial cell index, -1 outside
    iz: jnp.ndarray   # vertical cell index, -1 outside
    t: jnp.ndarray    # ray parameter in *scaled* units


_BIG = 3.4e38  # float32 max-ish sentinel (plain float: no backend init at import)
_EPS = 1e-6


class Cylinder2DGrid:
    """Axisymmetric grid from radial borders [0..Rmax] and z borders."""

    dimension = 2

    def __init__(self, rborders, zborders):
        self.rb64 = np.asarray(rborders, dtype=np.float64)
        self.zb64 = np.asarray(zborders, dtype=np.float64)
        if self.rb64[0] != 0.0:
            self.rb64 = np.concatenate([[0.0], self.rb64]) \
                if self.rb64[0] > 0 else self.rb64
        if np.any(np.diff(self.rb64) <= 0) or np.any(np.diff(self.zb64) <= 0):
            raise ValueError("borders must be strictly increasing")
        self.nr = self.rb64.size - 1
        self.nz = self.zb64.size - 1
        self.ncells = self.nr * self.nz
        # scale so radii are O(1) in device math
        self.scale = float(self.rb64[-1])
        self._rb_np = np.asarray(self.rb64 / self.scale, np.float32)
        self._rb2_np = self._rb_np * self._rb_np
        self._zb_np = np.asarray(self.zb64 / self.scale, np.float32)
        self.max_steps = 2 * self.nr + self.nz + 4

    # -- host-side metadata -----------------------------------------------

    @property
    def rb(self):
        return jnp.asarray(self._rb_np)

    @property
    def rb2(self):
        return jnp.asarray(self._rb2_np)

    @property
    def zb(self):
        return jnp.asarray(self._zb_np)

    def bounding_box(self):
        R = self.rb64[-1]
        return (-R, -R, self.zb64[0], R, R, self.zb64[-1])

    def cell_volumes(self) -> np.ndarray:
        dr2 = self.rb64[1:] ** 2 - self.rb64[:-1] ** 2
        dz = np.diff(self.zb64)
        return (np.pi * dr2[:, None] * dz[None, :]).ravel()

    def cell_centers(self) -> np.ndarray:
        rc = 0.5 * (self.rb64[:-1] + self.rb64[1:])
        zc = 0.5 * (self.zb64[:-1] + self.zb64[1:])
        rr, zz = np.meshgrid(rc, zc, indexing="ij")
        return np.stack([rr.ravel(), np.zeros(rr.size), zz.ravel()], axis=-1)

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        ir = cells // self.nz
        iz = cells % self.nz
        u = rng_np.uniform(size=(cells.size, 3))
        r2 = self.rb64[ir] ** 2 + u[:, 0] * (self.rb64[ir + 1] ** 2
                                             - self.rb64[ir] ** 2)
        R = np.sqrt(r2)
        phi = 2.0 * np.pi * u[:, 1]
        z = self.zb64[iz] + u[:, 2] * (self.zb64[iz + 1] - self.zb64[iz])
        return np.stack([R * np.cos(phi), R * np.sin(phi), z], axis=-1)

    def random_position_in_cell_dev(self, key, cells):
        """Device-side uniform positions inside annular cells (SI meters)."""
        ir = cells // self.nz
        iz = cells % self.nz
        u = jax.random.uniform(key, (cells.shape[0], 3), dtype=jnp.float32)
        r2 = self.rb2[ir] + u[:, 0] * (self.rb2[ir + 1] - self.rb2[ir])
        R = jnp.sqrt(r2) * self.scale
        phi = 2.0 * jnp.pi * u[:, 1]
        z = (self.zb[iz] + u[:, 2] * (self.zb[iz + 1] - self.zb[iz])) * self.scale
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), z], axis=-1)

    # -- analytic-mode panel quadrature support ---------------------------

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the cylinder, SI meters."""
        inv = jnp.float32(1.0 / self.scale)
        p = pos * inv
        # radial quadratic in the xy plane
        dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        a = dx * dx + dy * dy
        b = px * dx + py * dy
        c = px * px + py * py - self.rb2[-1]
        moving_r = a > 1e-30
        disc = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        rt0 = jnp.where(moving_r, (-b - sq) / jnp.maximum(a, 1e-30), -_BIG)
        rt1 = jnp.where(moving_r, (-b + sq) / jnp.maximum(a, 1e-30), _BIG)
        inside_r = c <= 0
        rt0 = jnp.where(moving_r, rt0, jnp.where(inside_r, -_BIG, _BIG))
        rt1 = jnp.where(moving_r, rt1, jnp.where(inside_r, _BIG, -_BIG))
        hit_r = jnp.where(moving_r, disc > 0, inside_r)
        # z slab
        moving_z = jnp.abs(dz) > 1e-30
        izv = 1.0 / jnp.where(moving_z, dz, 1.0)
        zt0 = (self.zb[0] - pz) * izv
        zt1 = (self.zb[-1] - pz) * izv
        zlo = jnp.minimum(zt0, zt1)
        zhi = jnp.maximum(zt0, zt1)
        in_z = (pz >= self.zb[0]) & (pz <= self.zb[-1])
        zlo = jnp.where(moving_z, zlo, jnp.where(in_z, -_BIG, _BIG))
        zhi = jnp.where(moving_z, zhi, jnp.where(in_z, _BIG, -_BIG))
        t_start = jnp.maximum(jnp.maximum(rt0, zlo), 0.0)
        t_stop = jnp.minimum(rt1, zhi)
        hit = hit_r & (t_start <= t_stop) & (t_stop > 0)
        t_start = jnp.where(hit, t_start, 0.0)
        t_stop = jnp.where(hit, t_stop, t_start)
        return t_start * self.scale, t_stop * self.scale

    def locate_batched(self, points):
        """Flat (ir, iz) cell ids for (..., 3) SI points (-1 outside)."""
        inv = jnp.float32(1.0 / self.scale)
        p = points * inv
        r = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        z = p[..., 2]
        ir = jnp.sum((r[..., None] >= self.rb[..., :]).astype(jnp.int32),
                     axis=-1) - 1
        iz = jnp.sum((z[..., None] >= self.zb[..., :]).astype(jnp.int32),
                     axis=-1) - 1
        ok = (ir >= 0) & (ir < self.nr) & (iz >= 0) & (iz < self.nz)
        return jnp.where(ok, ir * self.nz + iz, -1)

    # -- device-side protocol ---------------------------------------------

    def cell_of(self, state: CylinderState):
        ok = (state.ir >= 0) & (state.ir < self.nr) \
            & (state.iz >= 0) & (state.iz < self.nz)
        return jnp.where(ok, state.ir * self.nz + state.iz, -1)

    def _scaled(self, pos):
        return pos * jnp.float32(1.0 / self.scale)

    def start(self, pos) -> CylinderState:
        p = self._scaled(pos)
        r = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        ir = jnp.searchsorted(self.rb, r, side="right").astype(jnp.int32) - 1
        iz = jnp.searchsorted(self.zb, p[..., 2], side="right").astype(jnp.int32) - 1
        ir = jnp.where((ir >= 0) & (ir < self.nr), ir, -1)
        iz = jnp.where((iz >= 0) & (iz < self.nz), iz, -1)
        t = jnp.zeros(pos.shape[:-1], dtype=jnp.float32)
        return CylinderState(ir, iz, t)

    def locate(self, pos):
        return self.cell_of(self.start(pos))

    def enter(self, pos, direction):
        """Advance outside rays to the domain (outer cylinder + z slab)."""
        p = self._scaled(pos)
        dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
        ox, oy, oz = p[..., 0], p[..., 1], p[..., 2]

        # z-slab entry interval
        inv_dz = jnp.where(jnp.abs(dz) > 1e-30, 1.0 / dz, _BIG)
        tz1 = (self.zb[0] - oz) * inv_dz
        tz2 = (self.zb[-1] - oz) * inv_dz
        tz_lo = jnp.minimum(tz1, tz2)
        tz_hi = jnp.maximum(tz1, tz2)
        z_par_out = (jnp.abs(dz) <= 1e-30) & ((oz < self.zb[0]) | (oz > self.zb[-1]))
        tz_lo = jnp.where(jnp.abs(dz) <= 1e-30, -_BIG, tz_lo)
        tz_hi = jnp.where(jnp.abs(dz) <= 1e-30, _BIG, tz_hi)

        # outer-cylinder entry interval
        a = dx * dx + dy * dy
        b = 2.0 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - self.rb2[-1]
        disc = b * b - 4.0 * a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        safe_a = jnp.maximum(a, 1e-30)
        tr_lo = (-b - sq) / (2.0 * safe_a)
        tr_hi = (-b + sq) / (2.0 * safe_a)
        vertical = a <= 1e-30
        inside_r = c <= 0
        tr_lo = jnp.where(vertical, jnp.where(inside_r, -_BIG, _BIG), tr_lo)
        tr_hi = jnp.where(vertical, jnp.where(inside_r, _BIG, -_BIG), tr_hi)
        no_hit_r = jnp.logical_not(vertical) & (disc <= 0)

        tnear = jnp.maximum(tz_lo, tr_lo)
        tfar = jnp.minimum(tz_hi, tr_hi)
        hit = (tnear <= tfar) & (tfar > 0) & jnp.logical_not(z_par_out) \
            & jnp.logical_not(no_hit_r)
        s0 = jnp.where(hit, jnp.maximum(tnear, 0.0), _BIG)
        entry = p + (s0 + _EPS)[..., None] * direction
        r = jnp.sqrt(entry[..., 0] ** 2 + entry[..., 1] ** 2)
        ir = jnp.searchsorted(self.rb, r, side="right").astype(jnp.int32) - 1
        iz = jnp.searchsorted(self.zb, entry[..., 2], side="right").astype(jnp.int32) - 1
        ir = jnp.where(hit & (ir >= 0) & (ir < self.nr), ir, -1)
        iz = jnp.where(hit & (iz >= 0) & (iz < self.nz), iz, -1)
        s0_m = jnp.where(hit, s0, _BIG / 1e6) * self.scale
        state = CylinderState(ir, iz, s0_m)
        return s0_m, state

    def step(self, state: CylinderState, origin, direction):
        """One cell forward.  state.t and ds are in meters; the
        intersection math runs in scaled units."""
        p = self._scaled(origin)
        ir, iz, t_m = state
        t = t_m * jnp.float32(1.0 / self.scale)
        inside = (ir >= 0) & (iz >= 0)
        cir = jnp.clip(ir, 0, self.nr - 1)
        ciz = jnp.clip(iz, 0, self.nz - 1)

        dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
        ox, oy, oz = p[..., 0], p[..., 1], p[..., 2]

        a = dx * dx + dy * dy
        b = 2.0 * (ox * dx + oy * dy)
        c0 = ox * ox + oy * oy
        safe_a = jnp.maximum(a, 1e-30)
        vertical = a <= 1e-30

        # outer cylinder: '+' root (we are inside it)
        c_out = c0 - self.rb2[cir + 1]
        disc_out = jnp.maximum(b * b - 4.0 * a * c_out, 0.0)
        t_out = (-b + jnp.sqrt(disc_out)) / (2.0 * safe_a)
        t_out = jnp.where(vertical, _BIG, jnp.maximum(t_out, t))

        # inner cylinder: '-' root, only when it lies ahead
        has_inner = cir > 0
        c_in = c0 - self.rb2[jnp.maximum(cir, 1)]
        disc_in = b * b - 4.0 * a * c_in
        t_in = (-b - jnp.sqrt(jnp.maximum(disc_in, 0.0))) / (2.0 * safe_a)
        valid_in = has_inner & (disc_in > 0) & (t_in > t) & jnp.logical_not(vertical)
        t_in = jnp.where(valid_in, t_in, _BIG)

        # z planes
        pos_dz = dz > 0
        znext = self.zb[jnp.where(pos_dz, ciz + 1, ciz)]
        t_z = (znext - oz) / jnp.where(jnp.abs(dz) > 1e-30, dz, jnp.float32(1e-30))
        t_z = jnp.where(jnp.abs(dz) > 1e-30, t_z, _BIG)

        tmin = jnp.minimum(t_out, jnp.minimum(t_in, t_z))
        ds = jnp.maximum(tmin - t, 0.0)

        crossed_z = (t_z <= t_out) & (t_z <= t_in)
        crossed_in = jnp.logical_not(crossed_z) & (t_in < t_out)

        nir = jnp.where(crossed_z, cir,
                        jnp.where(crossed_in, cir - 1, cir + 1))
        niz = jnp.where(crossed_z,
                        ciz + jnp.where(pos_dz, 1, -1).astype(jnp.int32), ciz)

        nir = jnp.where((nir < 0) | (nir >= self.nr), -1, nir)
        niz = jnp.where((niz < 0) | (niz >= self.nz), -1, niz)

        new_state = CylinderState(
            jnp.where(inside, nir, ir),
            jnp.where(inside, niz, iz),
            jnp.where(inside, tmin * self.scale, t_m),
        )
        return jnp.where(inside, ds, 0.0) * self.scale, new_state
