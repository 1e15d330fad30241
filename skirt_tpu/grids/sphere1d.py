"""1-D spherical (radial shells) dust grid.

ref: SKIRTcore/Sphere1DDustGrid.cpp — radial shells over a Mesh.  Traversal
intersects rays with concentric spheres.  Intersection math runs in units
of the outer radius (float32 overflow, see cylinder2d.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class SphereState(NamedTuple):
    ir: jnp.ndarray   # radial shell index, -1 outside
    t: jnp.ndarray    # ray parameter [m]


_BIG = 3.4e38  # float32 max-ish sentinel (plain float: no backend init at import)
_EPS = 1e-6


class Sphere1DGrid:
    dimension = 1

    def __init__(self, rborders):
        rb = np.asarray(rborders, dtype=np.float64)
        if rb[0] != 0.0:
            rb = np.concatenate([[0.0], rb])
        if np.any(np.diff(rb) <= 0):
            raise ValueError("radial borders must be strictly increasing")
        self.rb64 = rb
        self.nr = rb.size - 1
        self.ncells = self.nr
        self.scale = float(rb[-1])
        # host (numpy) tables exposed via jnp-wrapping properties
        self._rb_np = np.asarray(rb / self.scale, np.float32)
        self._rb2_np = self._rb_np * self._rb_np
        self.max_steps = 2 * self.nr + 4

    @property
    def rb(self):
        return jnp.asarray(self._rb_np)

    @property
    def rb2(self):
        return jnp.asarray(self._rb2_np)

    def bounding_box(self):
        R = self.rb64[-1]
        return (-R, -R, -R, R, R, R)

    def cell_volumes(self) -> np.ndarray:
        return 4.0 / 3.0 * np.pi * (self.rb64[1:] ** 3 - self.rb64[:-1] ** 3)

    def cell_centers(self) -> np.ndarray:
        rc = 0.5 * (self.rb64[:-1] + self.rb64[1:])
        return np.stack([rc, np.zeros(self.nr), np.zeros(self.nr)], axis=-1)

    def random_positions_in_cells(self, rng_np, cells) -> np.ndarray:
        u = rng_np.uniform(size=(cells.size, 4))
        r3 = self.rb64[cells] ** 3 + u[:, 0] * (self.rb64[cells + 1] ** 3
                                                - self.rb64[cells] ** 3)
        r = np.cbrt(r3)
        ct = 2.0 * u[:, 1] - 1.0
        st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
        phi = 2.0 * np.pi * u[:, 2]
        return np.stack([r * st * np.cos(phi), r * st * np.sin(phi), r * ct],
                        axis=-1)

    def random_position_in_cell_dev(self, key, cells):
        """Device-side uniform positions inside radial shells (SI meters)."""
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (cells.shape[0],), dtype=jnp.float32)
        rb3 = self.rb * self.rb * self.rb
        r3 = rb3[cells] + u * (rb3[cells + 1] - rb3[cells])
        r = jnp.cbrt(r3) * self.scale
        from .. import rng as _rng
        d = _rng.isotropic_direction(k2, (cells.shape[0],))
        return r[:, None] * d

    # -- device-side -------------------------------------------------------

    def cell_of(self, state: SphereState):
        ok = (state.ir >= 0) & (state.ir < self.nr)
        return jnp.where(ok, state.ir, -1)

    def _scaled(self, pos):
        return pos * jnp.float32(1.0 / self.scale)

    def start(self, pos) -> SphereState:
        p = self._scaled(pos)
        r = jnp.sqrt(jnp.sum(p * p, axis=-1))
        ir = jnp.searchsorted(self.rb, r, side="right").astype(jnp.int32) - 1
        ir = jnp.where((ir >= 0) & (ir < self.nr), ir, -1)
        return SphereState(ir, jnp.zeros(pos.shape[:-1], jnp.float32))

    def locate(self, pos):
        return self.cell_of(self.start(pos))

    # -- analytic-mode panel quadrature support ---------------------------

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the outer sphere, SI meters.

        Scaled-unit quadratic (SI radii squared overflow float32)."""
        p = self._scaled(pos)
        b = jnp.sum(p * direction, axis=-1)
        c = jnp.sum(p * p, axis=-1) - self.rb2[-1]
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = jnp.maximum(-b - sq, 0.0)
        t1 = -b + sq
        hit = (disc > 0) & (t1 > 0) & (t0 <= t1)
        t0 = jnp.where(hit, t0, 0.0)
        t1 = jnp.where(hit, t1, 0.0)
        return t0 * self.scale, t1 * self.scale

    def locate_batched(self, points):
        """Radial cell ids for (..., 3) SI points (-1 outside)."""
        p = self._scaled(points)
        r = jnp.sqrt(jnp.sum(p * p, axis=-1))
        ir = jnp.sum((r[..., None] >= self.rb[..., :]).astype(jnp.int32),
                     axis=-1) - 1
        return jnp.where((ir >= 0) & (ir < self.nr), ir, -1)

    def enter(self, pos, direction):
        p = self._scaled(pos)
        b = 2.0 * jnp.sum(p * direction, axis=-1)
        c = jnp.sum(p * p, axis=-1) - self.rb2[-1]
        disc = b * b - 4.0 * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t_lo = (-b - sq) / 2.0
        hit = (disc > 0) & (t_lo > 0)
        s0 = jnp.where(hit, t_lo, _BIG / 1e6)
        entry = p + (s0 + _EPS)[..., None] * direction
        r = jnp.sqrt(jnp.sum(entry * entry, axis=-1))
        ir = jnp.searchsorted(self.rb, r, side="right").astype(jnp.int32) - 1
        ir = jnp.where(hit & (ir >= 0) & (ir < self.nr), ir, -1)
        s0_m = s0 * self.scale
        return s0_m, SphereState(ir, s0_m)

    def step(self, state: SphereState, origin, direction):
        p = self._scaled(origin)
        ir, t_m = state
        t = t_m * jnp.float32(1.0 / self.scale)
        inside = ir >= 0
        cir = jnp.clip(ir, 0, self.nr - 1)

        b = 2.0 * jnp.sum(p * direction, axis=-1)
        c0 = jnp.sum(p * p, axis=-1)

        # outer sphere (always hit from inside): '+' root
        c_out = c0 - self.rb2[cir + 1]
        disc_out = jnp.maximum(b * b - 4.0 * c_out, 0.0)
        t_out = jnp.maximum((-b + jnp.sqrt(disc_out)) / 2.0, t)

        # inner sphere: '-' root when ahead
        has_inner = cir > 0
        c_in = c0 - self.rb2[jnp.maximum(cir, 1)]
        disc_in = b * b - 4.0 * c_in
        t_in = (-b - jnp.sqrt(jnp.maximum(disc_in, 0.0))) / 2.0
        valid_in = has_inner & (disc_in > 0) & (t_in > t)
        t_in = jnp.where(valid_in, t_in, _BIG)

        tmin = jnp.minimum(t_out, t_in)
        ds = jnp.maximum(tmin - t, 0.0)
        crossed_in = t_in < t_out
        nir = jnp.where(crossed_in, cir - 1, cir + 1)
        nir = jnp.where((nir < 0) | (nir >= self.nr), -1, nir)

        new_state = SphereState(
            jnp.where(inside, nir, ir),
            jnp.where(inside, tmin * self.scale, t_m),
        )
        return jnp.where(inside, ds, 0.0) * self.scale, new_state
