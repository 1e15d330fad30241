"""Axisymmetric geometries (disks, rings, tori).

ref: SKIRTcore/ExpDiskGeometry.cpp, BrokenExpDiskGeometry.cpp,
RingGeometry.cpp, TorusGeometry.cpp, ConicalShellGeometry.cpp,
TTauriDiskGeometry.cpp.  Sampling replaces the reference's rejection loops
and Lambert-W inversions with exact inverse-CDF tables (SPMD-friendly).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from .base import AxGeometry, build_inverse_cdf, array_namespace


class ExpDiskGeometry(AxGeometry):
    """Double-exponential disk: rho = rho0 exp(-R/hR) exp(-|z|/hz).

    Optional truncation: Rmax, zmax, inner hole Rmin (0 = none).
    ref: SKIRTcore/ExpDiskGeometry.cpp (density, rho0, SigmaR/SigmaZ).
    """

    def __init__(self, radial_scale: float, axial_scale: float,
                 radial_trunc: float = 0.0, axial_trunc: float = 0.0,
                 inner_radius: float = 0.0):
        self.hR = float(radial_scale)
        self.hz = float(axial_scale)
        self.Rmax = float(radial_trunc)
        self.zmax = float(axial_trunc)
        self.Rmin = float(inner_radius)

        # central density so that total mass is 1 (ref: ExpDiskGeometry.cpp
        # setupSelfBefore)
        intphi = 2.0 * np.pi
        intz = (-2.0 * self.hz * np.expm1(-self.zmax / self.hz)
                if self.zmax > 0 else 2.0 * self.hz)
        tmin = (np.exp(-self.Rmin / self.hR) * (1.0 + self.Rmin / self.hR)
                if self.Rmin > 0 else 1.0)
        tmax = (np.exp(-self.Rmax / self.hR) * (1.0 + self.Rmax / self.hR)
                if self.Rmax > 0 else 0.0)
        intR = self.hR * self.hR * (tmin - tmax)
        self.rho0 = 1.0 / (intR * intphi * intz)

        rhi = self.Rmax if self.Rmax > 0 else 15.0 * self.hR
        self._r_sampler = build_inverse_cdf(
            lambda R: R * np.exp(-R / self.hR), self.Rmin, rhi, n=8192)
        self._zcut = self.zmax if self.zmax > 0 else 40.0 * self.hz

    def density_rz(self, R, z):
        xp = array_namespace(R)
        absz = xp.abs(z)
        rho = self.rho0 * xp.exp(-R / self.hR) * xp.exp(-absz / self.hz)
        inside = (R >= self.Rmin)
        if self.Rmax > 0:
            inside &= R <= self.Rmax
        if self.zmax > 0:
            inside &= absz <= self.zmax
        return xp.where(inside, rho, 0.0)

    def shape_rz(self, R, z):
        """rho/rho0 with float32-safe math (analytic traversal mode)."""
        absz = jnp.abs(z)
        shape = jnp.exp(-R / jnp.float32(self.hR)
                        - absz / jnp.float32(self.hz))
        inside = (R >= self.Rmin)
        if self.Rmax > 0:
            inside &= R <= self.Rmax
        if self.zmax > 0:
            inside &= absz <= self.zmax
        return jnp.where(inside, shape, 0.0)

    def generate_position(self, key, n: int):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        if self.Rmin > 0 or self.Rmax > 0:
            R = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        else:
            # R exp(-R/hR) is a Gamma(2, hR) density: R = -hR ln(u1 u2) —
            # closed form, no table gathers (the inverse-CDF gather costs
            # more than a whole fused scattering event per launch)
            u1 = rng.uniform_open(k1, (n,))
            u2 = rng.uniform_open(k4, (n,))
            R = -self.hR * jnp.log(u1 * u2)
        # |z| from truncated exponential, sign from the same deviate
        uz = rng.uniform_open(k2, (n,))
        cut = -jnp.expm1(-self._zcut / self.hz)
        absz = -self.hz * jnp.log1p(-jnp.abs(2.0 * uz - 1.0) * cut)
        z = jnp.sign(uz - 0.5) * absz
        return self.cylindrical_to_cartesian(k3, R, z)

    def device_sampler_xyz(self):
        """Closed-form (gather-free) sampler: Gamma(2) radius + truncated
        Laplace height — kernel-safe for the fused refill path."""
        if self.Rmin > 0 or self.Rmax > 0:
            return None
        hR = np.float32(self.hR)
        hz = np.float32(self.hz)
        cut = np.float32(-np.expm1(-self._zcut / self.hz))

        def fn(u):
            u1, u2, uz, uphi = u
            R = -hR * jnp.log(u1 * u2)
            absz = -hz * jnp.log(jnp.maximum(
                1.0 - jnp.abs(2.0 * uz - 1.0) * cut, 1e-37))
            z = jnp.where(uz < 0.5, -absz, absz)
            phi = np.float32(2.0 * np.pi) * uphi
            return R * jnp.cos(phi), R * jnp.sin(phi), z

        return 4, fn

    def sigma_r(self) -> float:
        if self.Rmax > 0:
            return float(self.rho0 * self.hR
                         * (np.exp(-self.Rmin / self.hR) - np.exp(-self.Rmax / self.hR)))
        return float(self.rho0 * self.hR * np.exp(-self.Rmin / self.hR))

    def sigma_x(self) -> float:
        return 2.0 * self.sigma_r()

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        if self.Rmin > 0:
            return 0.0
        if self.zmax > 0:
            return float(-2.0 * self.rho0 * self.hz * np.expm1(-self.zmax / self.hz))
        return float(2.0 * self.rho0 * self.hz)


class BrokenExpDiskGeometry(AxGeometry):
    """Radially broken double-exponential disk.

    rho ∝ exp(-|z|/hz) * S(R), with S an inner/outer broken exponential of
    scales h_inn / h_out, break radius Rb and sharpness s.
    ref: SKIRTcore/BrokenExpDiskGeometry.cpp.
    """

    def __init__(self, inner_scale: float, outer_scale: float, axial_scale: float,
                 break_radius: float, sharpness: float = 3.0):
        self.hinn = float(inner_scale)
        self.hout = float(outer_scale)
        self.hz = float(axial_scale)
        self.Rb = float(break_radius)
        self.s = float(sharpness)

        rmax = self.Rb + 15.0 * self.hout

        def radial(R):
            return self._radial_host(np.asarray(R, dtype=np.float64))

        rv = np.linspace(0.0, rmax, 65536)
        integral = 2.0 * np.pi * np.trapezoid(radial(rv) * rv, rv) * 2.0 * self.hz
        self.rho0 = 1.0 / integral
        self._r_sampler = build_inverse_cdf(lambda R: radial(R) * R, 0.0, rmax, n=8192)

    def _radial_host(self, R):
        e = np.exp(-self.s * (R - self.Rb) / np.minimum(self.hinn, self.hout))
        # smooth break between the two exponentials
        inner = np.exp(-R / self.hinn)
        outer = np.exp(-self.Rb * (1.0 / self.hinn - 1.0 / self.hout)) * np.exp(-R / self.hout)
        w = 1.0 / (1.0 + e)
        return (1.0 - w) * inner + w * outer

    def _radial_dev(self, R):
        xp = array_namespace(R)
        e = xp.exp(-self.s * (R - self.Rb) / min(self.hinn, self.hout))
        inner = xp.exp(-R / self.hinn)
        outer = (np.exp(-self.Rb * (1.0 / self.hinn - 1.0 / self.hout))
                 * xp.exp(-R / self.hout))
        w = 1.0 / (1.0 + e)
        return (1.0 - w) * inner + w * outer

    def density_rz(self, R, z):
        xp = array_namespace(R)
        return self.rho0 * self._radial_dev(R) * xp.exp(-xp.abs(z) / self.hz)

    def shape_rz(self, R, z):
        """rho/rho0 (the radial profile divides by scale lengths first,
        so it is float32-safe as written)."""
        return self._radial_dev(R) * jnp.exp(
            -jnp.abs(z) * jnp.float32(1.0 / self.hz))

    def generate_position(self, key, n: int):
        k1, k2, k3 = jax.random.split(key, 3)
        R = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        uz = rng.uniform_open(k2, (n,))
        absz = -self.hz * jnp.log1p(-jnp.abs(2.0 * uz - 1.0))
        z = jnp.sign(uz - 0.5) * absz
        return self.cylindrical_to_cartesian(k3, R, z)

    def sigma_z(self) -> float:
        return float(2.0 * self.rho0 * self._radial_host(np.array(0.0)) * self.hz)

    def sigma_x(self) -> float:
        rv = np.linspace(0.0, self.Rb + 15 * self.hout, 65536)
        return float(2.0 * self.rho0 * np.trapezoid(self._radial_host(rv), rv))

    sigma_y = sigma_x


class RingGeometry(AxGeometry):
    """Gaussian ring: rho ∝ exp(-(R-R0)^2/2w^2) exp(-|z|/hz).

    ref: SKIRTcore/RingGeometry.cpp.
    """

    def __init__(self, ring_radius: float, width: float, height: float):
        self.R0 = float(ring_radius)
        self.w = float(width)
        self.hz = float(height)
        rmax = self.R0 + 10.0 * self.w

        def radial(R):
            return np.exp(-0.5 * ((R - self.R0) / self.w) ** 2)

        rv = np.linspace(0.0, rmax, 65536)
        integral = 2.0 * np.pi * np.trapezoid(radial(rv) * rv, rv) * 2.0 * self.hz
        self.rho0 = 1.0 / integral
        self._r_sampler = build_inverse_cdf(lambda R: radial(R) * R, 0.0, rmax, n=8192)

    def density_rz(self, R, z):
        xp = array_namespace(R)
        return (self.rho0 * xp.exp(-0.5 * ((R - self.R0) / self.w) ** 2)
                * xp.exp(-xp.abs(z) / self.hz))

    def shape_rz(self, R, z):
        """rho/rho0, float32-safe (divide by scales before squaring)."""
        u = (R - jnp.float32(self.R0)) * jnp.float32(1.0 / self.w)
        return jnp.exp(-0.5 * u * u - jnp.abs(z) * jnp.float32(1.0 / self.hz))

    def generate_position(self, key, n: int):
        k1, k2, k3 = jax.random.split(key, 3)
        R = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        uz = rng.uniform_open(k2, (n,))
        absz = -self.hz * jnp.log1p(-jnp.abs(2.0 * uz - 1.0))
        z = jnp.sign(uz - 0.5) * absz
        return self.cylindrical_to_cartesian(k3, R, z)

    def sigma_z(self) -> float:
        return float(2.0 * self.rho0 * np.exp(-0.5 * (self.R0 / self.w) ** 2) * self.hz)

    def sigma_x(self) -> float:
        rv = np.linspace(0.0, self.R0 + 10 * self.w, 65536)
        return float(2.0 * self.rho0
                     * np.trapezoid(np.exp(-0.5 * ((rv - self.R0) / self.w) ** 2), rv))

    sigma_y = sigma_x


class TorusGeometry(AxGeometry):
    """AGN torus: rho ∝ r^(-p) exp(-q|cos(theta)|) within rmin<r<rmax and
    |pi/2 - theta| <= Delta (opening angle).

    ref: SKIRTcore/TorusGeometry.cpp (Stalevski et al. 2012 flared torus).
    """

    def __init__(self, exponent_p: float, index_q: float, open_angle: float,
                 rmin: float, rmax: float):
        self.p = float(exponent_p)
        self.q = float(index_q)
        self.delta = float(open_angle)
        self.rmin = float(rmin)
        self.rmax = float(rmax)

        # normalization by 2-D quadrature over (r, theta)
        rv = np.logspace(np.log10(self.rmin), np.log10(self.rmax), 2048)
        tv = np.linspace(np.pi / 2 - self.delta, np.pi / 2 + self.delta, 1025)
        rr, tt = np.meshgrid(rv, tv, indexing="ij")
        f = rr ** (-self.p) * np.exp(-self.q * np.abs(np.cos(tt)))
        integrand = f * rr * rr * np.sin(tt)
        integral = 2.0 * np.pi * np.trapezoid(np.trapezoid(integrand, tv, axis=1), rv)
        self.A = 1.0 / integral

        self._r_sampler = build_inverse_cdf(
            lambda r: r ** (2.0 - self.p), self.rmin, self.rmax, n=8192, log=True,
            log_floor=self.rmin)
        # polar sampler over mu = cos(theta) in [-sin(delta), sin(delta)]:
        # p(mu) ∝ exp(-q |mu|)
        smax = np.sin(self.delta)
        self._mu_sampler = build_inverse_cdf(
            lambda mu: np.exp(-self.q * np.abs(mu)), -smax, smax, n=4096)

    def density_rz(self, R, z):
        xp = array_namespace(R)
        r = xp.sqrt(R * R + z * z)
        r_safe = xp.maximum(r, 1e-30)
        costheta = z / r_safe
        rho = self.A * r_safe ** (-self.p) * xp.exp(-self.q * xp.abs(costheta))
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (xp.abs(costheta) <= np.sin(self.delta)))
        return xp.where(inside, rho, 0.0)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        """rho * L^3 with float32-safe math: radii scaled by rmax before
        any power (r^-p in SI meters under/overflows float32)."""
        invr = 1.0 / self.rmax
        Rn = jnp.sqrt(x_s * x_s + y_s * y_s) \
            * jnp.float32(lscale * invr)
        zn = z_s * jnp.float32(lscale * invr)
        rn = jnp.sqrt(Rn * Rn + zn * zn)
        rs = jnp.maximum(rn, 1e-20)
        amu = jnp.abs(zn) / rs
        pref = jnp.float32(self.A * self.rmax ** (-self.p) * lscale ** 3)
        rho = pref * rs ** jnp.float32(-self.p) * jnp.exp(
            jnp.float32(-self.q) * amu)
        inside = ((rn >= self.rmin * invr) & (rn <= 1.0)
                  & (amu <= np.sin(self.delta)))
        return jnp.where(inside, rho, 0.0)

    def generate_position(self, key, n: int):
        k1, k2, k3 = jax.random.split(key, 3)
        r = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        mu = self._mu_sampler.sample(rng.uniform_open(k2, (n,)))
        sintheta = jnp.sqrt(jnp.maximum(0.0, 1.0 - mu * mu))
        R = r * sintheta
        z = r * mu
        return self.cylindrical_to_cartesian(k3, R, z)

    def sigma_x(self) -> float:
        rv = np.logspace(np.log10(self.rmin), np.log10(self.rmax), 65536)
        return float(2.0 * self.A * np.trapezoid(rv ** (-self.p), rv))

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        return 0.0  # the z-axis is inside the opening cone


class ConicalShellGeometry(AxGeometry):
    """Conical shell between polar angles [Delta_min, Delta_max] around the
    equator, with the same r^(-p) exp(-q|cos theta|) profile as the torus.

    ref: SKIRTcore/ConicalShellGeometry.cpp.
    """

    def __init__(self, exponent_p: float, index_q: float,
                 open_angle_min: float, open_angle_max: float,
                 rmin: float, rmax: float):
        self.p = float(exponent_p)
        self.q = float(index_q)
        self.dmin = float(open_angle_min)
        self.dmax = float(open_angle_max)
        self.rmin = float(rmin)
        self.rmax = float(rmax)

        rv = np.logspace(np.log10(self.rmin), np.log10(self.rmax), 2048)
        mu_lo, mu_hi = np.sin(self.dmin), np.sin(self.dmax)
        mv = np.linspace(mu_lo, mu_hi, 513)
        rr, mm = np.meshgrid(rv, mv, indexing="ij")
        f = rr ** (-self.p) * np.exp(-self.q * np.abs(mm))
        # both hemispheres: factor 2
        integral = 2.0 * 2.0 * np.pi * np.trapezoid(
            np.trapezoid(f * rr * rr, mv, axis=1), rv)
        self.A = 1.0 / integral

        self._r_sampler = build_inverse_cdf(
            lambda r: r ** (2.0 - self.p), self.rmin, self.rmax, n=8192, log=True,
            log_floor=self.rmin)
        self._mu_sampler = build_inverse_cdf(
            lambda mu: np.exp(-self.q * np.abs(mu)), mu_lo, mu_hi, n=4096)

    def density_rz(self, R, z):
        xp = array_namespace(R)
        r = xp.sqrt(R * R + z * z)
        r_safe = xp.maximum(r, 1e-30)
        amu = xp.abs(z) / r_safe
        rho = self.A * r_safe ** (-self.p) * xp.exp(-self.q * amu)
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (amu >= np.sin(self.dmin)) & (amu <= np.sin(self.dmax)))
        return xp.where(inside, rho, 0.0)

    def density_scaled_xyz(self, x_s, y_s, z_s, lscale: float):
        """rho * L^3, float32-safe (see TorusGeometry.density_scaled_xyz)."""
        invr = 1.0 / self.rmax
        Rn = jnp.sqrt(x_s * x_s + y_s * y_s) \
            * jnp.float32(lscale * invr)
        zn = z_s * jnp.float32(lscale * invr)
        rn = jnp.sqrt(Rn * Rn + zn * zn)
        rs = jnp.maximum(rn, 1e-20)
        amu = jnp.abs(zn) / rs
        pref = jnp.float32(self.A * self.rmax ** (-self.p) * lscale ** 3)
        rho = pref * rs ** jnp.float32(-self.p) * jnp.exp(
            jnp.float32(-self.q) * amu)
        inside = ((rn >= self.rmin * invr) & (rn <= 1.0)
                  & (amu >= np.sin(self.dmin)) & (amu <= np.sin(self.dmax)))
        return jnp.where(inside, rho, 0.0)

    def generate_position(self, key, n: int):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        r = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        mu = self._mu_sampler.sample(rng.uniform_open(k2, (n,)))
        sign = jnp.sign(jax.random.uniform(k4, (n,)) - 0.5)
        mu = mu * sign
        sintheta = jnp.sqrt(jnp.maximum(0.0, 1.0 - mu * mu))
        return self.cylindrical_to_cartesian(k3, r * sintheta, r * mu)

    def sigma_x(self) -> float:
        return 0.0  # the x-axis (equator) is outside the shell

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        return 0.0


class TTauriDiskGeometry(AxGeometry):
    """T Tauri protoplanetary disk.

    rho ∝ (R/Rd)^(-1) exp(-pi/4 (z / (zd (R/Rd)^(9/8)))^2) for Rinn<R<Rout.
    ref: SKIRTcore/TTauriDiskGeometry.cpp.
    """

    def __init__(self, rinn: float, rout: float, rd: float, zd: float):
        self.rinn = float(rinn)
        self.rout = float(rout)
        self.rd = float(rd)
        self.zd = float(zd)

        def h(R):
            return self.zd * (R / self.rd) ** (9.0 / 8.0)

        rv = np.logspace(np.log10(self.rinn), np.log10(self.rout), 65536)
        # int over z of exp(-pi/4 (z/h)^2) = h * sqrt(4/pi) * sqrt(pi)/... :
        # int_-inf^inf exp(-pi z^2 / (4 h^2)) dz = 2h
        radial = (rv / self.rd) ** (-1.0) * 2.0 * h(rv)
        integral = 2.0 * np.pi * np.trapezoid(radial * rv, rv)
        self.rho0 = 1.0 / integral
        self._r_sampler = build_inverse_cdf(
            lambda R: (R / self.rd) ** (-1.0) * 2.0 * h(R) * R,
            self.rinn, self.rout, n=8192, log=True, log_floor=self.rinn)

    def density_rz(self, R, z):
        xp = array_namespace(R)
        Rs = xp.maximum(R, 1e-30)
        h = self.zd * (Rs / self.rd) ** (9.0 / 8.0)
        rho = self.rho0 * (Rs / self.rd) ** (-1.0) * xp.exp(
            -np.pi / 4.0 * (z / h) ** 2)
        inside = (R >= self.rinn) & (R <= self.rout)
        return xp.where(inside, rho, 0.0)

    def shape_rz(self, R, z):
        """rho/rho0, float32-safe (all ratios before powers)."""
        x = jnp.maximum(R * jnp.float32(1.0 / self.rd), 1e-20)
        zh = (z * jnp.float32(1.0 / self.zd)) / (x ** jnp.float32(9.0 / 8.0))
        rho = jnp.exp(-jnp.float32(np.pi / 4.0) * zh * zh) / x
        inside = (R >= self.rinn) & (R <= self.rout)
        return jnp.where(inside, rho, 0.0)

    def generate_position(self, key, n: int):
        k1, k2, k3 = jax.random.split(key, 3)
        R = self._r_sampler.sample(rng.uniform_open(k1, (n,)))
        h = self.zd * (R / self.rd) ** (9.0 / 8.0)
        # z | R is Gaussian with sigma = h sqrt(2/pi)
        z = jax.random.normal(k2, (n,)) * h * jnp.sqrt(2.0 / jnp.pi)
        return self.cylindrical_to_cartesian(k3, R, z)

    def sigma_x(self) -> float:
        rv = np.logspace(np.log10(self.rinn), np.log10(self.rout), 65536)
        return float(2.0 * self.rho0 * np.trapezoid((rv / self.rd) ** (-1.0), rv))

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        return 0.0  # inner hole contains the z-axis


class MGEGeometry(AxGeometry):
    """Multi-gaussian expansion geometry (Emsellem et al. 1994; Cappellari 2002).

    rho(R,z) = sum_j rho_{0,j} exp(-R^2/(2 sigma_j^2) - z^2/(2 q_j^2 sigma_j^2))
    with rho_{0,j} = M_j / ((2 pi)^{3/2} sigma_j^3 q_j).

    `components` is an (N,3) array of rows (count N_j, scalelength in pixels,
    apparent flattening q'_j); the intrinsic flattening is deprojected with
    q_j = sqrt(q'_j^2 - cos^2 i)/sin i (Bacon 1985).
    ref: SKIRTcore/MGEGeometry.cpp (setupSelfBefore, density,
    generatePosition, SigmaR/SigmaZ).
    """

    def __init__(self, components, pixelscale: float, inclination: float):
        comp = np.atleast_2d(np.asarray(components, dtype=np.float64))
        if comp.shape[1] != 3:
            raise ValueError("MGE components must be rows of (count, sigma_pix, q')")
        if pixelscale <= 0:
            raise ValueError("MGE pixel scale must be positive")
        if not (0.0 < inclination <= np.pi / 2.0):
            raise ValueError("MGE inclination must be in (0, pi/2]")
        cosi, sini = np.cos(inclination), np.sin(inclination)
        qapp = comp[:, 2]
        if np.any(qapp * qapp <= cosi * cosi):
            raise ValueError("apparent flattening incompatible with inclination"
                             " (q'^2 must exceed cos^2 i)")
        self.Mv = comp[:, 0] / comp[:, 0].sum()
        self.sigmav = comp[:, 1] * float(pixelscale)
        self.qv = np.sqrt(qapp * qapp - cosi * cosi) / sini
        self._cum = np.asarray(np.cumsum(self.Mv), np.float32)
        self._sig_d = np.asarray(self.sigmav, np.float32)
        self._q_d = np.asarray(self.qv, np.float32)

    @classmethod
    def from_file(cls, path, pixelscale: float, inclination: float):
        """Read the 3-column (N_j, sigma_pix, q'_j) MGE expansion file,
        dropping consecutive duplicate rows as the reference does."""
        rows = np.atleast_2d(np.loadtxt(path))
        keep = np.ones(len(rows), dtype=bool)
        keep[1:] = np.any(rows[1:] != rows[:-1], axis=1)
        return cls(rows[keep], pixelscale, inclination)

    def density_rz(self, R, z):
        xp = array_namespace(R)
        rho = xp.zeros_like(R)
        for M, sigma, q in zip(self.Mv, self.sigmav, self.qv):
            rho0 = M / ((2.0 * np.pi) ** 1.5 * sigma ** 3 * q)
            m2 = R * R + (z * z) / (q * q)
            rho = rho + rho0 * xp.exp(-0.5 * m2 / (sigma * sigma))
        return rho

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        u = rng.uniform_open(k1, (n,))
        cum = jnp.asarray(self._cum)
        j = jnp.clip(jnp.searchsorted(cum, u, side="left"),
                     0, cum.shape[0] - 1)
        sigma = jnp.asarray(self._sig_d)[j]
        q = jnp.asarray(self._q_d)[j]
        g = jax.random.normal(k2, (n, 3))
        return jnp.stack([sigma * g[:, 0], sigma * g[:, 1],
                          q * sigma * g[:, 2]], axis=-1)

    def sigma_r(self) -> float:
        return float(np.sum(self.Mv / (4.0 * np.pi * self.qv * self.sigmav ** 2)))

    def sigma_x(self) -> float:
        return 2.0 * self.sigma_r()

    sigma_y = sigma_x

    def sigma_z(self) -> float:
        return float(np.sum(self.Mv / (2.0 * np.pi * self.sigmav ** 2)))
