"""SPH particle import: smoothed-particle mass distributions.

ref: SKIRTcore/SPHDustDistribution.hpp:22 / .cpp (particles + smoothing
kernel; density = sum of kernel contributions), SPHGasParticleGrid.cpp
(spatial hash for kernel summation), SPHStellarComp.cpp (particle
sources).  File format (ref: SPHDustDistribution::setupSelfBefore): text
columns x, y, z, h (smoothing length), M (mass) — positions/lengths in pc
and masses in Msun in the reference's import convention.

Batched re-design: density evaluation is host-side (setup time) through a
cKDTree neighbor query; position sampling is exact (particle choice by
mass + kernel-radius offset), which doubles as the photon launch sampler
for SPH stellar components.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

from .. import rng
from ..constants import PC, M_SUN
from ..geometry.base import Geometry, array_namespace
from ..geometry.kernels import CubicSplineSmoothingKernel


def load_sph_particles(path: str, length_unit: float = PC,
                       mass_unit: float = M_SUN,
                       max_temperature: float | None = None):
    """Read a text SPH particle file: columns x, y, z, h, M (+ extras).

    max_temperature: when given and the file has a 6th column (gas
    temperature [K]), particles above it are excluded (ref:
    SPHGeometry.hpp:30-35, default 75000 K)."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    if max_temperature is not None and data.shape[1] >= 6:
        data = data[data[:, 5] <= float(max_temperature)]
    pos = data[:, 0:3] * length_unit
    h = data[:, 3] * length_unit
    m = data[:, 4] * mass_unit
    return pos, h, m


class SPHParticleGeometry(Geometry):
    """Normalized mass density from smoothed particles.

    Density and sampling follow the reference's kernel-sum model; the
    geometry is normalized to unit total mass (Geometry convention) and
    scaled by the dust/stellar normalization downstream.
    """

    dimension = 3

    def __init__(self, positions: np.ndarray, smoothing: np.ndarray,
                 masses: np.ndarray, kernel=None):
        self.pos = np.asarray(positions, dtype=np.float64)
        self.h = np.asarray(smoothing, dtype=np.float64)
        self.m = np.asarray(masses, dtype=np.float64)
        if not (self.pos.shape[0] == self.h.size == self.m.size):
            raise ValueError("particle arrays must have matching lengths")
        self.kernel = kernel or CubicSplineSmoothingKernel()
        self.total_mass = float(self.m.sum())
        self._w = self.m / self.total_mass
        self._tree = cKDTree(self.pos)
        self._hmax = float(self.h.max())
        # device arrays for sampling
        self._pos_dev = np.asarray(self.pos, np.float32)
        self._h_dev = np.asarray(self.h, np.float32)
        self._cdf = np.asarray(
            np.concatenate([[0.0], np.cumsum(self._w)]), np.float32)

    def density(self, pos):
        """Normalized density (1/m^3): host NumPy path only (setup time)."""
        xp = array_namespace(pos)
        if xp is not np:
            raise NotImplementedError(
                "SPH density is evaluated host-side at setup")
        pts = np.atleast_2d(np.asarray(pos, dtype=np.float64))
        out = np.zeros(pts.shape[0])
        # neighbor particles within their own smoothing radius of each point
        groups = self._tree.query_ball_point(pts, self._hmax, workers=-1)
        for i, idx in enumerate(groups):
            if not idx:
                continue
            idx = np.asarray(idx)
            d = np.linalg.norm(self.pos[idx] - pts[i], axis=1)
            u = d / self.h[idx]
            contrib = self._w[idx] * self.kernel.density(u) / self.h[idx] ** 3
            out[i] = contrib.sum()
        return out.reshape(np.asarray(pos).shape[:-1])

    def generate_position(self, key, n: int):
        """Particle selection by mass + kernel-radius offset (exact)."""
        k1, k2, k3, k4 = jax.random.split(key, 4)
        u = rng.uniform_open(k1, (n,))
        i = jnp.clip(jnp.searchsorted(jnp.asarray(self._cdf), u,
                                      side="right") - 1,
                     0, self.pos.shape[0] - 1)
        r = self.kernel.generate_radius(rng.uniform_open(k2, (n,)))
        d = rng.isotropic_direction(k3, (n,))
        return jnp.asarray(self._pos_dev)[i] \
            + (r * jnp.asarray(self._h_dev)[i])[:, None] * d

    def sigma_x(self) -> float:
        # column through the origin along x, by quadrature of the host density
        span = np.abs(self.pos).max() + self._hmax
        x = np.linspace(-span, span, 4096)
        pts = np.zeros((x.size, 3))
        pts[:, 0] = x
        return float(np.trapezoid(self.density(pts), x))

    sigma_y = sigma_x
    sigma_z = sigma_x
