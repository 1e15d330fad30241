"""Polarization: Stokes-vector algebra and Mueller-matrix scattering.

ref: SKIRTcore/StokesVector.cpp (I,Q,U,V + reference normal, applyMueller,
rotateStokes), DustMix.cpp:537-671 (polarized scattering: theta from the
per-wavelength S11 CDF, phi from 1 + p (S12/S11) cos 2(phi - gamma),
Stokes rotation into the scattering plane, Mueller application, peel-off
polarization), ElectronDustMix.cpp (Thomson Mueller matrix).

Conventions: the packet luminosity L carries the intensity; q, u, v are
the normalized Stokes ratios Q/I, U/I, V/I; `normal` is the unit normal
of the current reference plane (zero vector = unpolarized reference).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng


# ---------------------------------------------------------------------------
# Stokes algebra (device side)
# ---------------------------------------------------------------------------

def rotate_stokes(q, u, phi):
    """Rotate the reference frame by phi about the propagation direction.

    ref: StokesVector::rotateStokes — Q' = Q cos2phi + U sin2phi,
    U' = -Q sin2phi + U cos2phi.
    """
    c = jnp.cos(2.0 * phi)
    s = jnp.sin(2.0 * phi)
    return q * c + u * s, -q * s + u * c


def apply_mueller(q, u, v, S11, S12, S33, S34):
    """Apply a (block-diagonal) Mueller matrix to normalized Stokes ratios.

    Returns (intensity_factor, q', u', v') where intensity_factor is the
    multiplicative change of I (ref: StokesVector::applyMueller).

    The normalized ratios are clamped to the physical ball
    q'^2+u'^2+v'^2 <= 1: when I2 underflows (a fully-polarized packet
    scattering into its zero-intensity direction, e.g. Thomson at 90
    degrees with q=1) the raw ratios blow up to ~1/eps and a peel
    contribution w*q' would inject unbounded spurious Q (the
    Chandrasekhar Milne experiment caught +50 Q/I outliers).
    """
    I2 = S11 + S12 * q
    Q2 = S12 + S11 * q
    U2 = S33 * u + S34 * v
    V2 = -S34 * u + S33 * v
    safe = jnp.maximum(I2, 1e-37)
    q2, u2, v2 = Q2 / safe, U2 / safe, V2 / safe
    norm = jnp.sqrt(q2 * q2 + u2 * u2 + v2 * v2)
    scale = jnp.where(norm > 1.0, 1.0 / jnp.maximum(norm, 1e-30), 1.0)
    return I2, q2 * scale, u2 * scale, v2 * scale


def rotate_normal(normal, direction, phi):
    """Rotate the reference normal about the propagation direction by phi."""
    k = direction
    cosphi = jnp.cos(phi)[..., None]
    sinphi = jnp.sin(phi)[..., None]
    kxn = jnp.cross(k, normal)
    kdotn = jnp.sum(k * normal, axis=-1, keepdims=True)
    return normal * cosphi + kxn * sinphi + k * kdotn * (1.0 - cosphi)


def angle_between_planes(np_normal, kc, kn):
    """Angle phi between the previous scattering plane (normal np_normal)
    and the plane spanned by (kc, kn).

    ref: DustMix.cpp angleBetweenScatteringPlanes.
    """
    nc = jnp.cross(kc, kn)
    norm = jnp.linalg.norm(nc, axis=-1, keepdims=True)
    nc = nc / jnp.maximum(norm, 1e-30)
    cosphi = jnp.sum(np_normal * nc, axis=-1)
    sinphi = jnp.sum(jnp.cross(np_normal, nc) * kc, axis=-1)
    phi = jnp.arctan2(sinphi, cosphi)
    degenerate = norm[..., 0] < 1e-20
    return jnp.where(degenerate, 0.0, phi)


# ---------------------------------------------------------------------------
# Mueller tables
# ---------------------------------------------------------------------------

class MuellerTables:
    """Tabulated S11, S12, S33, S34 over (wavelength, theta) + samplers.

    ref: DustMix polarization tables (_S11vv.., theta-CDF sampling).
    """

    def __init__(self, thetav: np.ndarray, S11, S12, S33, S34):
        self.thetav64 = np.asarray(thetav, dtype=np.float64)
        self.ntheta = self.thetav64.size
        S11 = np.asarray(S11, dtype=np.float64)
        self.S11 = np.asarray(S11, np.float32)
        self.S12 = np.asarray(S12, np.float32)
        self.S33 = np.asarray(S33, np.float32)
        self.S34 = np.asarray(S34, np.float32)
        self.thetav = np.asarray(self.thetav64, np.float32)

        # per-wavelength theta CDF ~ S11 sin(theta) (ref: DustMix.cpp:716)
        w = S11 * np.sin(self.thetav64)[None, :]
        cdf = np.concatenate([np.zeros((S11.shape[0], 1)),
                              np.cumsum(0.5 * (w[:, 1:] + w[:, :-1])
                                        * np.diff(self.thetav64), axis=1)],
                             axis=1)
        total = cdf[:, -1:]
        self.theta_cdf = np.asarray(cdf / np.maximum(total, 1e-300),
                                    np.float32)
        # phase function normalization: mean of S11 over solid angle = 1/N
        # (ref: _pfnormv) — N = 2 / int S11 sin dtheta
        self.pfnorm = np.asarray(
            2.0 / np.maximum(total[:, 0], 1e-300), np.float32)

        # inverse-CDF quantile table for theta sampling: theta(u) at NQ+1
        # uniform u-knots per wavelength — sampling costs 2 flat gathers
        # + a lerp instead of a per-lane (ntheta,) CDF row gather + a
        # one-hot search (the gather-free launch-sampler trick; same
        # piecewise-linear accuracy class as the CDF-bin inversion)
        NQ = 512
        self.nq = NQ
        uq = np.linspace(0.0, 1.0, NQ + 1)
        qt = np.empty((S11.shape[0], NQ + 1), np.float64)
        for l in range(S11.shape[0]):
            qt[l] = np.interp(uq, self.theta_cdf[l].astype(np.float64),
                              self.thetav64)
        self.theta_quantile = np.asarray(qt, np.float32)
        # packed S-matrix rows: ONE 4-wide row gather per (ell, theta)
        # lookup instead of four scalar gathers
        self.S_packed = np.ascontiguousarray(
            np.stack([self.S11, self.S12, self.S33, self.S34],
                     axis=-1).reshape(-1, 4))
        # theta-major packed rows for POLYCHROMATIC lanes: one (4W,)-wide
        # contiguous row gather per lane serves every wavelength at once
        nl = self.S11.shape[0]
        self.S_theta_major = np.ascontiguousarray(
            np.stack([self.S11.T, self.S12.T, self.S33.T, self.S34.T],
                     axis=1).reshape(self.ntheta, 4 * nl))

    def theta_index(self, theta):
        """ref: DustMix.cpp indexForTheta."""
        dt = np.pi / (self.ntheta - 1)
        t = jnp.round(theta / dt).astype(jnp.int32)
        return jnp.clip(t, 0, self.ntheta - 1)

    def sample_theta(self, key, ell):
        """Sample theta from the S11 sin(theta) distribution per packet.

        Inverse-CDF quantile table: 2 flat gathers + a lerp per packet
        (the per-lane CDF-row search cost ~(ntheta,) gathers + compares
        and dominated the polarized event loop)."""
        u = rng.uniform_open(key, ell.shape)
        x = u * np.float32(self.nq)
        i = jnp.clip(x.astype(jnp.int32), 0, self.nq - 1)
        frac = x - i.astype(jnp.float32)
        qt = jnp.asarray(self.theta_quantile).reshape(-1)
        base = ell * (self.nq + 1) + i
        q0 = qt[base]
        q1 = qt[base + 1]
        return q0 + frac * (q1 - q0)

    def sample_phi(self, key, ell, theta, pol_degree, pol_angle):
        """Sample phi from 1 + p (S12/S11) cos(2(phi - gamma)) by Newton
        inversion of the analytic CDF (ref: DustMix::samplePhi).
        """
        t = self.theta_index(theta)
        S11 = jnp.asarray(self.S11)[ell, t]
        S12 = jnp.asarray(self.S12)[ell, t]
        ratio = jnp.where(S11 > 0, S12 / jnp.maximum(S11, 1e-30), 0.0)
        a = pol_degree * ratio
        u = rng.uniform_open(key, ell.shape)
        target = 2.0 * jnp.pi * u

        # bisection on the (monotone) CDF: F'(phi) = 1 + a cos(..) >= 0
        # touches zero at |a| = 1 (fully-polarized Thomson at 90 deg),
        # where Newton stalls and skews the azimuthal distribution —
        # measured E[sin 2(phi-gamma)] = -0.066 at a = -1, which
        # accumulated into percent-level spurious Q over multiple
        # scatterings (the Chandrasekhar Milne test caught it)
        def F(phi):
            return phi + 0.5 * a * (jnp.sin(2.0 * (phi - pol_angle))
                                    + jnp.sin(2.0 * pol_angle))

        lo = jnp.zeros_like(target)
        hi = jnp.full_like(target, 2.0 * jnp.pi)
        for _ in range(26):
            mid = 0.5 * (lo + hi)
            below = F(mid) < target
            lo = jnp.where(below, mid, lo)
            hi = jnp.where(below, hi, mid)
        return 0.5 * (lo + hi)

    def lookup(self, ell, theta):
        """One packed 4-wide row gather per (ell, theta) pair."""
        t = self.theta_index(theta)
        rows = jnp.asarray(self.S_packed)[ell * self.ntheta + t]  # (N, 4)
        return rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]

    def lookup_all(self, theta):
        """S rows at one theta per lane for ALL wavelengths: 4 x (W, N).

        One contiguous (4W,)-wide row gather per lane from the
        theta-major packed table (the row-gather trick) — the
        polychromatic lanes' per-event Mueller lookup.
        """
        t = self.theta_index(theta)
        rows = jnp.asarray(self.S_theta_major)[t]         # (N, 4W)
        nl = self.S11.shape[0]
        r = rows.reshape(theta.shape[0], 4, nl)
        return tuple(jnp.moveaxis(r[:, i, :], 0, 1) for i in range(4))


def thomson_mueller(nlambda: int, ntheta: int = 181) -> MuellerTables:
    """Thomson scattering Mueller matrix (wavelength independent).

    ref: ElectronDustMix.cpp — S11 = (cos^2+1)/2, S12 = (cos^2-1)/2,
    S33 = cos, S34 = 0.
    """
    theta = np.linspace(0.0, np.pi, ntheta)
    c = np.cos(theta)
    S11 = np.tile(0.5 * (c * c + 1.0), (nlambda, 1))
    S12 = np.tile(0.5 * (c * c - 1.0), (nlambda, 1))
    S33 = np.tile(c, (nlambda, 1))
    S34 = np.zeros((nlambda, ntheta))
    return MuellerTables(theta, S11, S12, S33, S34)
