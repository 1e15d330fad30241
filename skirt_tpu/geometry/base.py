"""Geometry base classes and inverse-CDF sampling machinery.

ref: SKIRTcore/Geometry.hpp:26-88 (abstract Geometry: density,
generatePosition, SigmaX/Y/Z), SpheGeometry/AxGeometry/SepAxGeometry bases.

Design: the reference samples positions with per-photon rejection loops and
special-function inversions; here every 1-D profile gets a dense host-side
inverse-CDF table sampled on device with a single gather + lerp — exact for
truncated profiles (no rejection), branch-free, and vmap-friendly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng


def array_namespace(x):
    """Return np for host (float64) inputs, jnp for device arrays.

    Geometry densities in SI units span ~1e-60..1e-10 kg/m^3-equivalents,
    far outside float32 range; setup-time evaluation therefore runs through
    NumPy float64, while device-side callers (dimensionless uses only) get
    jax arrays.
    """
    if isinstance(x, (np.ndarray, np.generic, float, int)):
        return np
    return jnp


class InverseCdf:
    """Tabulated inverse CDF: maps u in [0,1] to x; device-side sampling."""

    def __init__(self, xv: np.ndarray, cdfv: np.ndarray, total: float):
        self.xv = np.asarray(xv, dtype=np.float32)
        self.cdfv = np.asarray(cdfv, dtype=np.float32)
        # float64 copies for host-side quadrature checks
        self.xv64 = np.asarray(xv)
        self.cdfv64 = np.asarray(cdfv)
        self.total = float(total)
        # equal-probability quantile table: xq[k] = invCDF(k/M).  Device
        # sampling becomes index arithmetic + ONE lerp gather pair instead
        # of a searchsorted (~log2(n) sequential dependent gathers).  The
        # quantile grid adapts to probability mass,
        # so interpolation accuracy matches the source table's.
        M = max(4096, self.xv64.size)
        self._M = M
        self.xq = np.asarray(
            np.interp(np.linspace(0.0, 1.0, M + 1), self.cdfv64, self.xv64),
            np.float32)

    def sample(self, u):
        xq = jnp.asarray(self.xq)
        f = u * np.float32(self._M)
        i = jnp.clip(f.astype(jnp.int32), 0, self._M - 1)
        frac = f - i.astype(jnp.float32)
        x0 = xq[i]
        return x0 + frac * (xq[i + 1] - x0)


def build_inverse_cdf(pdf, xmin: float, xmax: float, n: int = 8192,
                      log: bool = False, log_floor: float = 0.0) -> InverseCdf:
    """Build an inverse-CDF table for density `pdf` (host callable) on [xmin,xmax].

    Uses trapezoid accumulation on an n-point grid (log-spaced when log=True,
    with `log_floor` as the smallest positive abscissa when xmin == 0).
    """
    if log:
        lo = log_floor if xmin <= 0 else xmin
        xv = np.concatenate([[xmin], np.logspace(np.log10(lo), np.log10(xmax), n - 1)]) \
            if xmin <= 0 else np.logspace(np.log10(xmin), np.log10(xmax), n)
    else:
        xv = np.linspace(xmin, xmax, n)
    pv = np.clip(np.asarray(pdf(xv), dtype=np.float64), 0.0, None)
    seg = 0.5 * (pv[1:] + pv[:-1]) * np.diff(xv)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    if total <= 0:
        raise ValueError("profile has zero integral on the requested range")
    return InverseCdf(xv, cdf / total, total)


class Geometry:
    """A normalized (unit total mass) spatial density distribution.

    Subclasses implement `density(pos)` (SI positions, shape (...,3)) and
    `generate_position(key, n)`.  Directions are isotropic unless the
    subclass overrides `generate_direction` / `direction_probability`
    (the reference's AngularDistribution hook, Geometry.hpp:73-88).
    """

    dimension = 3
    is_isotropic = True

    def density(self, pos):
        raise NotImplementedError

    def generate_position(self, key, n: int):
        raise NotImplementedError

    def generate_direction(self, key, ell, pos):
        return rng.isotropic_direction(key, pos.shape[:-1], dtype=pos.dtype)

    def direction_probability(self, ell, pos, direction):
        """Probability (relative to isotropic) of emission along `direction`."""
        return jnp.ones(pos.shape[:-1], dtype=pos.dtype)

    # surface densities along the coordinate axes (full axis integral)
    def sigma_x(self) -> float:
        raise NotImplementedError

    def sigma_y(self) -> float:
        raise NotImplementedError

    def sigma_z(self) -> float:
        raise NotImplementedError

    # -- analytic-density traversal support (fast path) ----------------
    # The gather of per-cell density tables is the costliest op of the
    # gridded lifecycle; for analytic media the traversal can instead EVALUATE rho at segment
    # midpoints with pure elementwise math.  Geometries opt in by
    # implementing density_scaled(pos_s, lscale) -> rho(pos) * lscale**3,
    # where pos_s = pos / lscale has O(1) coordinates.  Implementations
    # must be float32-safe on device: divide by scale lengths BEFORE any
    # squaring (SI meters overflow float32 when squared) and fold the
    # rho0 * lscale**3 prefactor in float64 host-side (SI densities
    # underflow float32).

    @property
    def supports_analytic(self) -> bool:
        # the generic SpheGeometry/AxGeometry density hooks only work when
        # the subclass provides the shape hook; a class counts as
        # analytic-capable if it defines its OWN density_scaled[_xyz] or a
        # shape hook
        generic = (Geometry, SpheGeometry, AxGeometry)
        if type(self).density_scaled not in (c.density_scaled
                                             for c in generic):
            return True
        if type(self).density_scaled_xyz not in (c.density_scaled_xyz
                                                 for c in generic):
            return True
        return hasattr(self, "radial_shape") or hasattr(self, "shape_rz")

    def density_scaled(self, pos_s, lscale: float):
        """rho(pos) * lscale**3 from scaled positions pos_s = pos/lscale.

        Thin wrapper over density_scaled_xyz — the coordinate-wise
        primitive that the fused event bodies call directly on (N,)
        coordinate arrays)."""
        return self.density_scaled_xyz(pos_s[..., 0], pos_s[..., 1],
                                       pos_s[..., 2], lscale)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        raise NotImplementedError(
            f"{type(self).__name__} has no analytic device density; use "
            "density_mode='gridded'")

    def device_sampler_xyz(self):
        """Kernel-safe position sampler, or None.

        Returns (nu, fn) where fn maps a list of nu uniform (0,1) arrays
        to SI coordinate arrays (x, y, z) using ONLY elementwise ops (no
        table gathers) — usable inside the fused event bodies for
        persistent-lane relaunch (engine/fused.py refill).  None = no closed-form sampler;
        the fused refill path is then unavailable for this geometry.
        """
        return None


class SpheGeometry(Geometry):
    """Spherically symmetric geometry defined by a radial profile rho(r).

    Subclasses provide `radial_density(r)` (host+device callable) and
    `max_radius`; sampling uses an inverse CDF of 4 pi r^2 rho(r).
    ref: SKIRTcore/SpheGeometry.
    """

    dimension = 1

    def __init__(self, rmax: float, table_n: int = 8192, rmin: float = 0.0,
                 log_floor_frac: float = 1e-6):
        self._rmax = float(rmax)
        self._rmin = float(rmin)
        self._sampler = build_inverse_cdf(
            lambda r: 4.0 * np.pi * r * r * self._radial_density_host(r),
            self._rmin, self._rmax, n=table_n, log=True,
            log_floor=self._rmax * log_floor_frac)

    def _radial_density_host(self, r):
        """NumPy radial density used to build tables; default: same function."""
        return self.radial_density(r)

    def radial_density(self, r):
        raise NotImplementedError

    @property
    def max_radius(self) -> float:
        return self._rmax

    def density(self, pos):
        xp = array_namespace(pos)
        r = xp.sqrt(xp.sum(pos * pos, axis=-1))
        rho = self.radial_density(r)
        return xp.where((r <= self._rmax) & (r >= self._rmin), rho, 0.0)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        """Generic analytic-mode density for subclasses with radial_shape
        (rho/rho0 as O(1) float32-safe math in r [m])."""
        if not hasattr(self, "radial_shape"):
            return Geometry.density_scaled_xyz(self, x_s, y_s, z_s, lscale)
        r = jnp.sqrt(x_s * x_s + y_s * y_s + z_s * z_s) * jnp.float32(lscale)
        pref = jnp.float32(float(self.rho0) * lscale ** 3)
        rho = pref * self.radial_shape(r)
        return jnp.where((r <= self._rmax) & (r >= self._rmin), rho, 0.0)

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        u = rng.uniform_open(k1, (n,))
        r = self._sampler.sample(u)
        d = rng.isotropic_direction(k2, (n,))
        return r[:, None] * d

    def sigma_x(self) -> float:
        rv = self._sampler.xv64
        pv = np.clip(self._radial_density_host(np.maximum(rv, rv[-1] * 1e-12)), 0, None)
        return float(2.0 * np.trapezoid(pv, rv))

    sigma_y = sigma_x
    sigma_z = sigma_x


class AxGeometry(Geometry):
    """Axisymmetric geometry rho(R, z) with separable or joint sampling.

    ref: SKIRTcore/AxGeometry / SepAxGeometry.
    """

    dimension = 2

    def density(self, pos):
        xp = array_namespace(pos)
        R = xp.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
        return self.density_rz(R, pos[..., 2])

    def density_rz(self, R, z):
        raise NotImplementedError

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        """Generic analytic-mode density for subclasses with shape_rz
        (rho/rho0 as O(1) float32-safe math in R, z [m])."""
        if not hasattr(self, "shape_rz"):
            return Geometry.density_scaled_xyz(self, x_s, y_s, z_s, lscale)
        L = jnp.float32(lscale)
        R = jnp.sqrt(x_s * x_s + y_s * y_s) * L
        z = z_s * L
        pref = jnp.float32(float(self.rho0) * lscale ** 3)
        return pref * self.shape_rz(R, z)

    @staticmethod
    def cylindrical_to_cartesian(key, R, z):
        phi = jax.random.uniform(key, R.shape, dtype=R.dtype,
                                 minval=0.0, maxval=2.0 * jnp.pi)
        return jnp.stack([R * jnp.cos(phi), R * jnp.sin(phi), z], axis=-1)
