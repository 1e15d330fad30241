"""Geometry decorators: coordinate transforms, cavities, clumps, spirals.

ref: SKIRTcore/OffsetGeometryDecorator.cpp, RotateGeometryDecorator.cpp,
SpheroidalGeometryDecorator.cpp, TriaxialGeometryDecorator.cpp,
SphericalCavityGeometryDecorator.cpp / CylindricalCavityGeometryDecorator.cpp,
CropGeometryDecorator.cpp, CombineGeometryDecorator.cpp,
ClumpyGeometryDecorator.cpp, SpiralStructureGeometryDecorator.cpp.

Batched deviations: rejection loops are replaced by bounded masked
resampling (`_resample_until`) or exact inverse-CDF sampling (spiral
azimuth); Monte Carlo renormalization integrals are computed once at setup.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from .base import (Geometry, SpheGeometry, AxGeometry, build_inverse_cdf,
                   array_namespace)
from .kernels import CubicSplineSmoothingKernel


def _resample_until(sample_fn, valid_fn, key, n: int, max_rounds: int = 64):
    """Draw n samples, redrawing invalid ones for up to max_rounds rounds.

    SPMD replacement for per-sample rejection loops: each round redraws the
    whole batch but keeps already-valid entries.
    """
    pos0 = sample_fn(jax.random.fold_in(key, 0), n)
    ok0 = valid_fn(pos0)

    def cond(state):
        i, _, ok = state
        return (i < max_rounds) & jnp.logical_not(jnp.all(ok))

    def body(state):
        i, pos, ok = state
        cand = sample_fn(jax.random.fold_in(key, i + 1), n)
        cand_ok = valid_fn(cand)
        take = jnp.logical_not(ok) & cand_ok
        pos = jnp.where(take[:, None], cand, pos)
        return i + 1, pos, ok | cand_ok

    _, pos, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), pos0, ok0))
    return pos


class _Decorator(Geometry):
    def __init__(self, geometry: Geometry):
        self.base = geometry
        self.dimension = 3

    def sigma_x(self) -> float:
        return self.base.sigma_x()

    def sigma_y(self) -> float:
        return self.base.sigma_y()

    def sigma_z(self) -> float:
        return self.base.sigma_z()


class OffsetGeometryDecorator(_Decorator):
    """Translate a geometry by (dx,dy,dz) (ref: OffsetGeometryDecorator.cpp)."""

    def __init__(self, geometry: Geometry, offset):
        super().__init__(geometry)
        self.offset = np.asarray(offset, dtype=np.float64)

    def density(self, pos):
        xp = array_namespace(pos)
        return self.base.density(pos - xp.asarray(self.offset, dtype=pos.dtype))

    def generate_position(self, key, n: int):
        p = self.base.generate_position(key, n)
        return p + jnp.asarray(self.offset, p.dtype)


class RotateGeometryDecorator(_Decorator):
    """Rotate a geometry by ZXZ Euler angles (alpha, beta, gamma).

    ref: RotateGeometryDecorator.cpp — the decorated density at x equals the
    base density at R^T x.
    """

    def __init__(self, geometry: Geometry, alpha: float, beta: float, gamma: float):
        super().__init__(geometry)
        ca, sa = np.cos(alpha), np.sin(alpha)
        cb, sb = np.cos(beta), np.sin(beta)
        cg, sg = np.cos(gamma), np.sin(gamma)
        Rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
        Rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
        self.R = Rz2 @ Rx @ Rz1

    def density(self, pos):
        xp = array_namespace(pos)
        if xp is np:
            return self.base.density(pos @ self.R.astype(pos.dtype))
        # (R^T pos) row-vector form; HIGHEST: a default float32 product
        # may run in TF32 on the GPU
        return self.base.density(jnp.matmul(
            pos, jnp.asarray(self.R, pos.dtype),
            precision=jax.lax.Precision.HIGHEST))

    def generate_position(self, key, n: int):
        p = self.base.generate_position(key, n)
        return jnp.matmul(p, jnp.asarray(self.R, p.dtype).T,
                          precision=jax.lax.Precision.HIGHEST)


class SpheroidalGeometryDecorator(_Decorator):
    """Flatten a spherical geometry along z: rho'(R,z) = rho(sqrt(R^2+z^2/q^2))/q.

    ref: SpheroidalGeometryDecorator.cpp.
    """

    def __init__(self, geometry: SpheGeometry, flattening: float):
        super().__init__(geometry)
        self.q = float(flattening)
        self.dimension = 2

    def density(self, pos):
        xp = array_namespace(pos)
        scaled = xp.concatenate([pos[..., :2], pos[..., 2:] / self.q], axis=-1)
        return self.base.density(scaled) / self.q

    def generate_position(self, key, n: int):
        p = self.base.generate_position(key, n)
        return jnp.concatenate([p[..., :2], p[..., 2:] * self.q], axis=-1)

    def sigma_z(self) -> float:
        return self.base.sigma_z()

    def sigma_x(self) -> float:
        return self.base.sigma_x() / self.q

    sigma_y = sigma_x


class TriaxialGeometryDecorator(_Decorator):
    """rho'(x,y,z) = rho(sqrt(x^2 + y^2/p^2 + z^2/q^2))/(p q).

    ref: TriaxialGeometryDecorator.cpp.
    """

    def __init__(self, geometry: SpheGeometry, p: float, q: float):
        super().__init__(geometry)
        self.p = float(p)
        self.q = float(q)

    def density(self, pos):
        xp = array_namespace(pos)
        scale = xp.asarray([1.0, 1.0 / self.p, 1.0 / self.q], dtype=pos.dtype)
        return self.base.density(pos * scale) / (self.p * self.q)

    def generate_position(self, key, n: int):
        p = self.base.generate_position(key, n)
        return p * jnp.asarray([1.0, self.p, self.q], p.dtype)

    def sigma_x(self) -> float:
        return self.base.sigma_x() / (self.p * self.q)

    def sigma_y(self) -> float:
        return self.base.sigma_y() / self.q

    def sigma_z(self) -> float:
        return self.base.sigma_z() / self.p


class _CavityDecorator(_Decorator):
    """Common machinery: zero density in a region, renormalize by MC."""

    def __init__(self, geometry: Geometry, mc_samples: int = 1 << 20, seed: int = 12345):
        super().__init__(geometry)
        # estimate removed mass fraction by sampling the base geometry
        key = rng.root_key(seed)
        pos = geometry.generate_position(key, mc_samples)
        inside = np.asarray(self._in_cavity(pos))
        removed = inside.mean()
        if removed >= 1.0:
            raise ValueError("cavity removes all mass")
        self.norm = 1.0 / (1.0 - float(removed))

    def _in_cavity(self, pos):
        raise NotImplementedError

    def density(self, pos):
        xp = array_namespace(pos)
        rho = self.base.density(pos) * self.norm
        return xp.where(self._in_cavity(pos), 0.0, rho)

    def generate_position(self, key, n: int):
        return _resample_until(
            self.base.generate_position,
            lambda p: jnp.logical_not(self._in_cavity(p)), key, n)


class SphericalCavityDecorator(_CavityDecorator):
    """Zero density inside radius r0 (ref: SphericalCavityGeometryDecorator.cpp)."""

    def __init__(self, geometry: Geometry, radius: float, **kw):
        self.r0 = float(radius)
        super().__init__(geometry, **kw)

    def _in_cavity(self, pos):
        xp = array_namespace(pos)
        return xp.sum(pos * pos, axis=-1) < self.r0 * self.r0


class CylindricalCavityDecorator(_CavityDecorator):
    """Zero density inside cylindrical radius R0 (ref: CylindricalCavity...)."""

    def __init__(self, geometry: Geometry, radius: float, **kw):
        self.R0 = float(radius)
        super().__init__(geometry, **kw)

    def _in_cavity(self, pos):
        return pos[..., 0] ** 2 + pos[..., 1] ** 2 < self.R0 * self.R0


class CropGeometryDecorator(_CavityDecorator):
    """Crop to an axis-aligned box (ref: CropGeometryDecorator.cpp)."""

    def __init__(self, geometry: Geometry, xmin, xmax, ymin, ymax, zmin, zmax, **kw):
        self.lo = np.array([xmin, ymin, zmin], dtype=np.float64)
        self.hi = np.array([xmax, ymax, zmax], dtype=np.float64)
        super().__init__(geometry, **kw)

    def _in_cavity(self, pos):
        xp = array_namespace(pos)
        lo = xp.asarray(self.lo, dtype=pos.dtype)
        hi = xp.asarray(self.hi, dtype=pos.dtype)
        inside_box = xp.all((pos >= lo) & (pos <= hi), axis=-1)
        return xp.logical_not(inside_box)


class CombineGeometryDecorator(_Decorator):
    """Weighted sum of geometries, renormalized to unit mass.

    ref: CombineGeometryDecorator.cpp.
    """

    def __init__(self, geometries, weights):
        self.parts = list(geometries)
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.base = self.parts[0]
        self.dimension = 3
        self._cdf = np.asarray(np.concatenate([[0.0], np.cumsum(self.weights)]),
                               np.float32)

    def density(self, pos):
        rho = 0.0
        for g, w in zip(self.parts, self.weights):
            rho = rho + w * g.density(pos)
        return rho

    def generate_position(self, key, n: int):
        ks = jax.random.split(key, len(self.parts) + 1)
        u = rng.uniform_open(ks[0], (n,))
        which = jnp.clip(jnp.searchsorted(jnp.asarray(self._cdf), u,
                                          side="right") - 1,
                         0, len(self.parts) - 1)
        samples = [g.generate_position(ks[i + 1], n) for i, g in enumerate(self.parts)]
        out = samples[0]
        for i in range(1, len(self.parts)):
            out = jnp.where((which == i)[:, None], samples[i], out)
        return out

    def sigma_x(self) -> float:
        return float(sum(w * g.sigma_x() for g, w in zip(self.parts, self.weights)))

    def sigma_y(self) -> float:
        return float(sum(w * g.sigma_y() for g, w in zip(self.parts, self.weights)))

    def sigma_z(self) -> float:
        return float(sum(w * g.sigma_z() for g, w in zip(self.parts, self.weights)))


class ClumpyGeometryDecorator(_Decorator):
    """Move a fraction f of the mass into N smoothed clumps.

    ref: ClumpyGeometryDecorator.cpp — clump centers are drawn once from the
    base geometry at setup with a fixed seed; density adds kernel
    contributions; sampling mixes smooth and clump draws.  The reference's
    x-sorted neighbor pruning is replaced by a dense vectorized kernel sum
    (device-friendly; N_clumps is typically <= a few thousand).
    """

    def __init__(self, geometry: Geometry, clump_fraction: float, clump_count: int,
                 clump_radius: float, kernel=None, seed: int = 4357, cutoff: bool = False):
        super().__init__(geometry)
        self.f = float(clump_fraction)
        self.N = int(clump_count)
        self.h = float(clump_radius)
        self.kernel = kernel or CubicSplineSmoothingKernel()
        self.cutoff = bool(cutoff)
        key = rng.root_key(seed)
        self.centers = np.asarray(
            np.asarray(geometry.generate_position(key, self.N)), np.float32)

    def density(self, pos):
        xp = array_namespace(pos)
        rho_smooth = (1.0 - self.f) * self.base.density(pos)
        centers = self.centers if xp is np else jnp.asarray(self.centers)
        # vectorized kernel sum over all clumps: (..., N)
        diff = pos[..., None, :] - xp.asarray(centers, dtype=pos.dtype)
        d = xp.sqrt(xp.sum(diff * diff, axis=-1)) / self.h
        rho_clumpy = (self.f / self.N) * xp.sum(self.kernel.density(d), axis=-1) \
            / self.h ** 3
        if self.cutoff:
            rho_clumpy = xp.where(self.base.density(pos) > 0, rho_clumpy, 0.0)
        return rho_smooth + rho_clumpy

    def generate_position(self, key, n: int):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        smooth = self.base.generate_position(k1, n)
        which = jax.random.randint(k2, (n,), 0, self.N)
        u = self.kernel.generate_radius(rng.uniform_open(k3, (n,)))
        d = rng.isotropic_direction(k4, (n,))
        clumpy = jnp.asarray(self.centers)[which] + (u * self.h)[:, None] * d
        use_clump = jax.random.uniform(k5, (n,)) < self.f
        return jnp.where(use_clump[:, None], clumpy, smooth)


class SpiralStructureDecorator(_Decorator):
    """Apply an m-armed logarithmic spiral perturbation to an axisymmetric
    geometry.

    ref: SpiralStructureGeometryDecorator.cpp — perturbation
    xi(R,phi) = (1-w) + w C_N sin^{2N}(0.5 m (gamma(R) - phi)) with
    gamma = ln(R/R0)/tan(p) + phi0 + pi/(2m).  The reference samples phi by
    rejection; here phi is sampled exactly from the (R-independent, shifted)
    azimuthal profile via an inverse-CDF table.
    """

    def __init__(self, geometry: AxGeometry, arms: int, pitch: float, radius: float,
                 phase: float = 0.0, perturb_weight: float = 1.0, index: int = 1):
        super().__init__(geometry)
        from scipy import special as sps
        self.m = int(arms)
        self.pitch = float(pitch)
        self.R0 = float(radius)
        self.phi0 = float(phase)
        self.w = float(perturb_weight)
        self.N = int(index)
        self.tanp = np.tan(self.pitch)
        self.CN = np.sqrt(np.pi) * sps.gamma(self.N + 1.0) / sps.gamma(self.N + 0.5)
        self.dimension = 3

        # azimuthal sampler for psi = gamma - phi (period 2 pi / m covered
        # over the full circle): p(psi) ∝ (1-w) + w C_N sin^{2N}(m psi / 2)
        self._psi_sampler = build_inverse_cdf(
            lambda psi: (1.0 - self.w)
            + self.w * self.CN * np.sin(0.5 * self.m * psi) ** (2 * self.N),
            0.0, 2.0 * np.pi, n=8192)

    def _gamma(self, R):
        xp = array_namespace(R)
        return (xp.log(xp.maximum(R, 1e-30) / self.R0) / self.tanp
                + self.phi0 + 0.5 * np.pi / self.m)

    def perturbation(self, R, phi):
        xp = array_namespace(R)
        return ((1.0 - self.w) + self.w * self.CN
                * xp.sin(0.5 * self.m * (self._gamma(R) - phi)) ** (2 * self.N))

    def density(self, pos):
        xp = array_namespace(pos)
        R = xp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
        phi = xp.arctan2(pos[..., 1], pos[..., 0])
        return self.base.density(pos) * self.perturbation(R, phi)

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        p = self.base.generate_position(k1, n)
        R = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        z = p[..., 2]
        psi = self._psi_sampler.sample(rng.uniform_open(k2, (n,)))
        phi = self._gamma(R) - psi
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), z], axis=-1)
