"""2-D spherical (r, theta) dust grid.

ref: SKIRTcore/Sphere2DDustGrid.cpp — radial shells x polar cones (the
grid for the Pascucci et al. 2004 2-D benchmark).  Traversal intersects
rays with concentric spheres and half-cones through the origin.

Intersection math runs in outer-radius units (float32 overflow, see
cylinder2d.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

_BIG = 3.4e38


class Sphere2DState(NamedTuple):
    ir: jnp.ndarray
    it: jnp.ndarray
    t: jnp.ndarray    # ray parameter [m]


class Sphere2DGrid:
    dimension = 2

    def __init__(self, rborders, thetaborders=None, ntheta: int = 9):
        rb = np.asarray(rborders, dtype=np.float64)
        if rb[0] != 0.0:
            rb = np.concatenate([[0.0], rb])
        if thetaborders is None:
            tb = np.linspace(0.0, np.pi, ntheta + 1)
        else:
            tb = np.asarray(thetaborders, dtype=np.float64)
            if tb[0] != 0.0 or abs(tb[-1] - np.pi) > 1e-12:
                raise ValueError("theta borders must span [0, pi]")
        if np.any(np.diff(rb) <= 0) or np.any(np.diff(tb) <= 0):
            raise ValueError("borders must be strictly increasing")
        self.rb64 = rb
        self.tb64 = tb
        self.nr = rb.size - 1
        self.nt = tb.size - 1
        self.ncells = self.nr * self.nt
        self.scale = float(rb[-1])
        self._rb_np = np.asarray(rb / self.scale, np.float32)
        self._rb2_np = self._rb_np * self._rb_np
        # cone parameters: cos(theta_k); interior borders only (k=1..nt-1)
        self._costb_np = np.asarray(np.cos(tb), np.float32)
        self.costb64 = np.cos(tb)
        self.max_steps = 2 * self.nr + 2 * self.nt + 8

    # -- host metadata -----------------------------------------------------

    @property
    def rb(self):
        return jnp.asarray(self._rb_np)

    @property
    def rb2(self):
        return jnp.asarray(self._rb2_np)

    @property
    def costb(self):
        return jnp.asarray(self._costb_np)

    def bounding_box(self):
        R = self.rb64[-1]
        return (-R, -R, -R, R, R, R)

    def cell_volumes(self) -> np.ndarray:
        dr3 = self.rb64[1:] ** 3 - self.rb64[:-1] ** 3
        dmu = self.costb64[:-1] - self.costb64[1:]  # cos decreasing in theta
        return (2.0 * np.pi / 3.0 * dr3[:, None] * dmu[None, :]).ravel()

    def cell_centers(self) -> np.ndarray:
        rc = 0.5 * (self.rb64[:-1] + self.rb64[1:])
        tc = 0.5 * (self.tb64[:-1] + self.tb64[1:])
        rr, tt = np.meshgrid(rc, tc, indexing="ij")
        return np.stack([rr.ravel() * np.sin(tt.ravel()),
                         np.zeros(rr.size),
                         rr.ravel() * np.cos(tt.ravel())], axis=-1)

    def random_positions_in_cells(self, rng_np, cells) -> np.ndarray:
        ir = cells // self.nt
        it = cells % self.nt
        u = rng_np.uniform(size=(cells.size, 3))
        r3 = self.rb64[ir] ** 3 + u[:, 0] * (self.rb64[ir + 1] ** 3
                                             - self.rb64[ir] ** 3)
        r = np.cbrt(r3)
        mu = self.costb64[it] + u[:, 1] * (self.costb64[it + 1]
                                           - self.costb64[it])
        st = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))
        phi = 2.0 * np.pi * u[:, 2]
        return np.stack([r * st * np.cos(phi), r * st * np.sin(phi), r * mu],
                        axis=-1)

    def random_position_in_cell_dev(self, key, cells):
        ir = cells // self.nt
        it = cells % self.nt
        u = jax.random.uniform(key, (cells.shape[0], 3), dtype=jnp.float32)
        rb3 = self.rb * self.rb * self.rb
        r = jnp.cbrt(rb3[ir] + u[:, 0] * (rb3[ir + 1] - rb3[ir])) * self.scale
        mu = self.costb[it] + u[:, 1] * (self.costb[it + 1] - self.costb[it])
        st = jnp.sqrt(jnp.maximum(0.0, 1.0 - mu * mu))
        phi = 2.0 * jnp.pi * u[:, 2]
        return jnp.stack([r * st * jnp.cos(phi), r * st * jnp.sin(phi),
                          r * mu], axis=-1)

    # -- device-side -------------------------------------------------------

    def cell_of(self, state: Sphere2DState):
        ok = (state.ir >= 0) & (state.ir < self.nr) \
            & (state.it >= 0) & (state.it < self.nt)
        return jnp.where(ok, state.ir * self.nt + state.it, -1)

    def _scaled(self, pos):
        return pos * jnp.float32(1.0 / self.scale)

    def _indices(self, p):
        r = jnp.sqrt(jnp.sum(p * p, axis=-1))
        mu = p[..., 2] / jnp.maximum(r, 1e-30)
        ir = jnp.searchsorted(self.rb, r, side="right").astype(jnp.int32) - 1
        # costb is decreasing; searchsorted needs ascending -> use -costb
        it = jnp.searchsorted(-self.costb, -mu, side="right").astype(jnp.int32) - 1
        ir = jnp.where((ir >= 0) & (ir < self.nr), ir, -1)
        it = jnp.clip(it, 0, self.nt - 1)
        return ir, it

    def start(self, pos) -> Sphere2DState:
        p = self._scaled(pos)
        ir, it = self._indices(p)
        return Sphere2DState(ir, it, jnp.zeros(pos.shape[:-1], jnp.float32))

    def locate(self, pos):
        return self.cell_of(self.start(pos))

    # -- analytic-mode panel quadrature support ---------------------------

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the outer sphere, SI meters."""
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
        """(r, theta) cell ids for (..., 3) SI points, -1 outside.

        Compare-all binning instead of a per-element binary search (the
        border tables are small)."""
        p = self._scaled(points)
        r = jnp.sqrt(jnp.sum(p * p, axis=-1))
        mu = p[..., 2] / jnp.maximum(r, 1e-30)
        ir = jnp.sum((r[..., None] >= self.rb[..., :]).astype(jnp.int32),
                     axis=-1) - 1
        # costb is DECREASING in theta index
        it = jnp.sum((mu[..., None] <= self.costb[..., :]).astype(jnp.int32),
                     axis=-1) - 1
        it = jnp.clip(it, 0, self.nt - 1)
        ok = (ir >= 0) & (ir < self.nr)
        return jnp.where(ok, jnp.clip(ir, 0) * self.nt + it, -1)

    def enter(self, pos, direction):
        p = self._scaled(pos)
        b = 2.0 * jnp.sum(p * direction, axis=-1)
        c = jnp.sum(p * p, axis=-1) - self.rb2[-1]
        disc = b * b - 4.0 * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t_lo = (-b - sq) / 2.0
        hit = (disc > 0) & (t_lo > 0)
        s0 = jnp.where(hit, t_lo, _BIG / 1e6)
        entry = p + (s0 + 1e-6)[..., None] * direction
        ir, it = self._indices(entry)
        ir = jnp.where(hit, ir, -1)
        s0_m = s0 * self.scale
        return s0_m, Sphere2DState(ir, it, s0_m)

    def _cone_crossing(self, o, d, cosv, t):
        """Earliest crossing (> t) of the half-cone z = cos(theta)*r.

        Cone equation: z^2 = c^2 (x^2+y^2+z^2) with sign(z) = sign(c);
        theta = pi/2 is the z = 0 plane.
        """
        c = cosv
        oz, dz = o[..., 2], d[..., 2]
        plane = jnp.abs(c) < 1e-7
        # plane crossing
        tp = jnp.where(jnp.abs(dz) > 1e-30, -oz / jnp.where(
            jnp.abs(dz) > 1e-30, dz, 1.0), _BIG)
        tp = jnp.where(plane & (tp > t), tp, _BIG)
        # cone quadratic: (dz^2 - c^2) t^2 + 2(oz dz - c^2 o.d) t + oz^2 - c^2 o.o
        c2 = c * c
        a = dz * dz - c2
        bq = 2.0 * (oz * dz - c2 * jnp.sum(o * d, axis=-1))
        cq = oz * oz - c2 * jnp.sum(o * o, axis=-1)
        disc = bq * bq - 4.0 * a * cq
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        safe_a = jnp.where(jnp.abs(a) > 1e-12, a, 1.0)
        r1 = (-bq - sq) / (2.0 * safe_a)
        r2 = (-bq + sq) / (2.0 * safe_a)
        # linear case a ~ 0: t = -cq / bq
        lin = -cq / jnp.where(jnp.abs(bq) > 1e-30, bq, 1.0)
        r1 = jnp.where(jnp.abs(a) > 1e-12, r1, lin)
        r2 = jnp.where(jnp.abs(a) > 1e-12, r2, _BIG)

        def valid(tc):
            z = oz + tc * dz
            ok = (disc >= 0) & (tc > t) & (jnp.sign(z) == jnp.sign(c))
            return jnp.where(ok, tc, _BIG)

        tq = jnp.minimum(valid(jnp.minimum(r1, r2)), valid(jnp.maximum(r1, r2)))
        return jnp.where(plane, tp, tq)

    def step(self, state: Sphere2DState, origin, direction):
        o = self._scaled(origin)
        ir, it, t_m = state
        t = t_m * jnp.float32(1.0 / self.scale)
        inside = (ir >= 0) & (it >= 0)
        cir = jnp.clip(ir, 0, self.nr - 1)
        cit = jnp.clip(it, 0, self.nt - 1)

        b = 2.0 * jnp.sum(o * direction, axis=-1)
        c0 = jnp.sum(o * o, axis=-1)

        # radial crossings (as in Sphere1DGrid)
        c_out = c0 - self.rb2[cir + 1]
        t_rout = jnp.maximum((-b + jnp.sqrt(jnp.maximum(
            b * b - 4.0 * c_out, 0.0))) / 2.0, t)
        has_inner = cir > 0
        c_in = c0 - self.rb2[jnp.maximum(cir, 1)]
        disc_in = b * b - 4.0 * c_in
        t_rin = (-b - jnp.sqrt(jnp.maximum(disc_in, 0.0))) / 2.0
        t_rin = jnp.where(has_inner & (disc_in > 0) & (t_rin > t), t_rin, _BIG)

        # polar cone crossings: upper border (it) and lower border (it+1)
        t_up = jnp.where(cit > 0,
                         self._cone_crossing(o, direction, self.costb[cit], t),
                         _BIG)
        t_dn = jnp.where(cit < self.nt - 1,
                         self._cone_crossing(o, direction,
                                             self.costb[cit + 1], t), _BIG)

        tmin = jnp.minimum(jnp.minimum(t_rout, t_rin),
                           jnp.minimum(t_up, t_dn))
        ds = jnp.maximum(tmin - t, 0.0)

        nir = jnp.where(tmin == t_rout, cir + 1,
                        jnp.where(tmin == t_rin, cir - 1, cir))
        nit = jnp.where((tmin == t_up) & (tmin < t_rout) & (tmin < t_rin),
                        cit - 1,
                        jnp.where((tmin == t_dn) & (tmin < t_rout)
                                  & (tmin < t_rin), cit + 1, cit))
        nir = jnp.where((nir < 0) | (nir >= self.nr), -1, nir)
        nit = jnp.clip(nit, 0, self.nt - 1)

        new_state = Sphere2DState(
            jnp.where(inside, nir, ir),
            jnp.where(inside, nit, it),
            jnp.where(inside, tmin * self.scale, t_m),
        )
        return jnp.where(inside, ds, 0.0) * self.scale, new_state
