"""Dust mixes: per-wavelength optical properties and scattering physics.

ref: SKIRTcore/DustMix.cpp:96-620 (population tables, albedo, HG phase
function and sampling), SimpleOligoDustMix.cpp, MeanZubkoDustMix.cpp,
TrustMeanDustMix.cpp, DraineLiDustMix.cpp, InterstellarDustMix.cpp,
ElectronDustMix.cpp, Benchmark1DDustMix.cpp.

A mix holds absorption/scattering opacities kappa [m^2/kg] sampled on the
simulation wavelength grid, plus the scattering asymmetry parameter g for
the Henyey-Greenstein phase function.  Tabulated mixes read the reference's
resource data files (SKIRT_TPU_DAT); the file formats are documented in the
loaders.  Device-side methods are jit/vmap friendly.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from .. import DATA_DIR, rng
from ..constants import M_PROTON, M_ELECTRON, SIGMA_THOMSON
from ..numerics import resample_loglog
from ..wavelengths import WavelengthGrid


class DustMix:
    """Optical properties on a wavelength grid (single summed population).

    kappaabs/kappasca [m^2/kg] and asymmetry g per wavelength bin; mu is the
    dust mass per cross-section unit used during construction.
    """

    polarization = False
    mueller = None  # media.polarization.MuellerTables when polarized

    def __init__(self, wavelength_grid: WavelengthGrid,
                 kappaabs: np.ndarray, kappasca: np.ndarray, g: np.ndarray):
        self.wavelength_grid = wavelength_grid
        self.kappaabs64 = np.asarray(kappaabs, dtype=np.float64)
        self.kappasca64 = np.asarray(kappasca, dtype=np.float64)
        self.kappaext64 = self.kappaabs64 + self.kappasca64
        with np.errstate(invalid="ignore", divide="ignore"):
            self.albedo64 = np.where(self.kappaext64 > 0,
                                     self.kappasca64 / self.kappaext64, 0.0)
        self.g64 = np.asarray(g, dtype=np.float64)

        self.kappaabs = np.asarray(self.kappaabs64, np.float32)
        self.kappasca = np.asarray(self.kappasca64, np.float32)
        self.kappaext = np.asarray(self.kappaext64, np.float32)
        self.albedo = np.asarray(self.albedo64, np.float32)
        self.g = np.asarray(self.g64, np.float32)

    # -- scattering (device side) -----------------------------------------

    def phase_function(self, ell, cosalpha):
        """HG phase function normalized to mean 1 over directions.

        ref: SKIRTcore/DustMix.cpp:648-671 phaseFunctionValue:
        (1-g^2) / (1 + g^2 - 2 g cos a)^{3/2}.
        """
        g = jnp.asarray(self.g)[ell]
        t = 1.0 + g * g - 2.0 * g * cosalpha
        return (1.0 - g) * (1.0 + g) / jnp.sqrt(t * t * t)

    def sample_costheta(self, key, ell):
        """Sample the HG scattering angle cosine.

        ref: SKIRTcore/DustMix.cpp scatteringDirectionAndPolarization (the
        unpolarized branch): f = (1-g^2)/(1-g+2gX), cos t = (1+g^2-f^2)/2g.
        """
        g = jnp.asarray(self.g)[ell]
        u = rng.uniform_open(key, ell.shape)
        f = (1.0 - g) * (1.0 + g) / (1.0 - g + 2.0 * g * u)
        cos_hg = (1.0 + g * g - f * f) / (2.0 * jnp.where(jnp.abs(g) < 1e-6, 1.0, g))
        cos_iso = 2.0 * u - 1.0
        return jnp.where(jnp.abs(g) < 1e-6, cos_iso, jnp.clip(cos_hg, -1.0, 1.0))

    def sample_direction(self, key, ell, direction):
        """New propagation direction after scattering."""
        import jax
        k1, k2 = jax.random.split(key)
        ct = self.sample_costheta(k1, ell)
        return rng.direction_about_axis(k2, direction, ct)


class SimpleOligoDustMix(DustMix):
    """User-specified opacity/albedo/asymmetry per oligochromatic wavelength.

    ref: SKIRTcore/SimpleOligoDustMix.cpp.  (The reference contains an
    apparent bug, kappaabs = kappaext*(albedo+1); we use the physical
    kappaabs = kappaext*(1-albedo).)
    """

    def __init__(self, wavelength_grid: WavelengthGrid, kappaext, albedo, g=None):
        ke = np.asarray(kappaext, dtype=np.float64)
        al = np.asarray(albedo, dtype=np.float64)
        gv = np.zeros_like(ke) if g is None else np.asarray(g, dtype=np.float64)
        if not (ke.size == al.size == gv.size == wavelength_grid.nlambda):
            raise ValueError("property lists must match the wavelength grid")
        super().__init__(wavelength_grid, ke * (1.0 - al), ke * al, gv)


def _load_columns(path: str) -> np.ndarray:
    return np.loadtxt(path, comments="#", ndmin=2)


class MeanDustMixFromFile(DustMix):
    """Mean (single-population) mix from a reference-format data table.

    File columns: lambda [micron], Cabs [cm^2], Csca [cm^2], tau [cm^2/H],
    albedo, g — as in dat/DustMix/MeanZubkoDustMix.dat.  `mu` is the dust
    mass per H nucleon [kg].
    """

    def __init__(self, wavelength_grid: WavelengthGrid, path: str, mu: float):
        data = _load_columns(path)
        lam = data[:, 0] * 1e-6
        sigmaext = data[:, 3] * 1e-4      # cm^2/H -> m^2/H
        albedo = data[:, 4]
        gv = data[:, 5]
        sigmaabs = (1.0 - albedo) * sigmaext
        sigmasca = albedo * sigmaext

        lv = wavelength_grid.lambdav
        kabs = resample_loglog(lv, lam, sigmaabs) / mu
        ksca = resample_loglog(lv, lam, sigmasca) / mu
        g_res = np.interp(np.log(lv), np.log(lam), gv)
        super().__init__(wavelength_grid, kabs, ksca, g_res)
        self.mu = mu


class MeanZubkoDustMix(MeanDustMixFromFile):
    """ref: SKIRTcore/MeanZubkoDustMix.cpp (mu = 1.44e-29 kg/H)."""

    def __init__(self, wavelength_grid: WavelengthGrid, data_dir: str | None = None):
        path = os.path.join(data_dir or DATA_DIR, "DustMix/MeanZubkoDustMix.dat")
        super().__init__(wavelength_grid, path, mu=1.44e-29)


class TrustMeanDustMix(MeanDustMixFromFile):
    """ref: SKIRTcore/TrustMeanDustMix.cpp (mu = 1.434e-29 kg/H)."""

    def __init__(self, wavelength_grid: WavelengthGrid, data_dir: str | None = None):
        path = os.path.join(data_dir or DATA_DIR, "DustMix/TrustMeanDustMix.dat")
        super().__init__(wavelength_grid, path, mu=1.434e-29)


class TrustPolarizedMeanDustMix(TrustMeanDustMix):
    """TRUST mean mix with the ZDA BARE-GR-S Mueller scattering matrices.

    ref: SKIRTcore/TrustPolarizedMeanDustMix.cpp — optical properties from
    DustMix/TrustMeanDustMix.dat plus S11/S12/S33/S34 tables read from 181
    per-degree files (DustMix/TrustMDMScatMatrix/ZDA_BARE_GR_S_ESM_*deg.dat,
    1201 wavelengths each), resampled onto the simulation wavelength grid
    with log-lin interpolation.
    """

    N_THETA = 181

    def __init__(self, wavelength_grid: WavelengthGrid,
                 data_dir: str | None = None):
        super().__init__(wavelength_grid, data_dir)
        from .polarization import MuellerTables
        base = os.path.join(data_dir or DATA_DIR, "DustMix/TrustMDMScatMatrix")
        lv = wavelength_grid.lambdav
        nl = lv.size
        S = np.empty((4, nl, self.N_THETA))
        lam_file = None
        for t in range(self.N_THETA):
            data = np.loadtxt(
                os.path.join(base, f"ZDA_BARE_GR_S_ESM_{t:03d}deg.dat"))
            if lam_file is None:
                lam_file = data[:, 0] * 1e-6
            loglam = np.log(lam_file)
            for c in range(4):
                S[c, :, t] = np.interp(np.log(lv), loglam, data[:, c + 1])
        thetav = np.radians(np.arange(self.N_THETA, dtype=np.float64))
        self.polarization = True
        self.mueller = MuellerTables(thetav, S[0], S[1], S[2], S[3])


class DraineLiDustMix(DustMix):
    """Draine & Li (2007) mean mix.

    ref: SKIRTcore/DraineLiDustMix.cpp — columns lambda [micron],
    sigmaabs [cm^2/H], sigmasca [cm^2/H], em, albedo, g; dust mass per H =
    (5.4e-4+5.4e-4+1.8e-4+2.33e-3+8.27e-3) * m_p.
    """

    def __init__(self, wavelength_grid: WavelengthGrid, data_dir: str | None = None):
        path = os.path.join(data_dir or DATA_DIR, "DustMix/DraineLiDustMix.dat")
        data = _load_columns(path)
        lam = data[:, 0] * 1e-6
        sigmaabs = data[:, 1] * 1e-4
        sigmasca = data[:, 2] * 1e-4
        gv = data[:, 5]
        mu = (5.4e-4 + 5.4e-4 + 1.8e-4 + 2.33e-3 + 8.27e-3) * M_PROTON
        lv = wavelength_grid.lambdav
        kabs = resample_loglog(lv, lam, sigmaabs) / mu
        ksca = resample_loglog(lv, lam, sigmasca) / mu
        g_res = np.interp(np.log(lv), np.log(lam), gv)
        super().__init__(wavelength_grid, kabs, ksca, g_res)
        self.mu = mu


class InterstellarDustMix(DustMix):
    """Draine 2003 Milky Way R_V=3.1 mix.

    ref: SKIRTcore/InterstellarDustMix.cpp — file columns: lambda [micron],
    albedo, <cos>, C_ext/H [cm^2/H], K_abs [cm^2/g], <cos^2>; kappaabs =
    K_abs*0.1 [m^2/kg], kappasca = kappaabs*albedo/(1-albedo); dust mass 1.
    """

    def __init__(self, wavelength_grid: WavelengthGrid, data_dir: str | None = None):
        path = os.path.join(data_dir or DATA_DIR, "DustMix/InterstellarDustMix.dat")
        data = _load_columns(path)
        # file is ordered by decreasing wavelength
        data = data[::-1]
        lam = data[:, 0] * 1e-6
        albedo = data[:, 1]
        gv = data[:, 2]
        kabs_raw = data[:, 4] * 1e-1   # cm^2/g -> m^2/kg
        with np.errstate(divide="ignore", invalid="ignore"):
            ksca_raw = np.where(albedo < 1.0,
                                kabs_raw * albedo / (1.0 - albedo), 0.0)
        lv = wavelength_grid.lambdav
        kabs = resample_loglog(lv, lam, kabs_raw)
        ksca = resample_loglog(lv, lam, ksca_raw)
        g_res = np.interp(np.log(lv), np.log(lam), gv)
        super().__init__(wavelength_grid, kabs, ksca, g_res)
        self.mu = 1.0


class ElectronDustMix(DustMix):
    """Thomson scattering by free electrons: grey, pure scattering, g = 0.

    ref: SKIRTcore/ElectronDustMix.cpp (kappa = sigma_T / m_e).
    """

    def __init__(self, wavelength_grid: WavelengthGrid):
        n = wavelength_grid.nlambda
        ksca = np.full(n, SIGMA_THOMSON / M_ELECTRON)
        super().__init__(wavelength_grid, np.zeros(n), ksca, np.zeros(n))
        # the reference electron mix is always polarized (addpolarization
        # with the Thomson Mueller matrix)
        from .polarization import thomson_mueller
        self.polarization = True
        self.mueller = thomson_mueller(n)


class Benchmark2DDustMix(DustMix):
    """Pascucci et al. (2004) 2-D benchmark mix.

    ref: SKIRTcore/Benchmark2DDustMix.cpp — file columns lambda [micron],
    Csca [m^2], Cext [m^2]; g = 0; dust mass Cext(V)/kappaV.
    """

    KAPPA_V = 2600.0

    def __init__(self, wavelength_grid: WavelengthGrid, data_dir: str | None = None):
        path = os.path.join(data_dir or DATA_DIR, "DustMix/Benchmark2DDustMix.dat")
        data = _load_columns(path)
        lam = data[:, 0] * 1e-6
        Csca = data[:, 1]
        Cext = data[:, 2]
        Cabs = Cext - Csca
        iV = int(np.argmin(np.abs(lam - 0.55e-6)))
        mu = Cext[iV] / self.KAPPA_V
        lv = wavelength_grid.lambdav
        kabs = resample_loglog(lv, lam, Cabs) / mu
        ksca = resample_loglog(lv, lam, Csca) / mu
        super().__init__(wavelength_grid, kabs, ksca, np.zeros(lv.size))
        self.mu = mu


class Benchmark1DDustMix(DustMix):
    """Ivezic et al. (1997) 1-D benchmark mix: analytic opacity law.

    ref: SKIRTcore/Benchmark1DDustMix.cpp — for lambda <= 1 micron,
    kappaabs = kappasca = 1 (albedo 1/2); above the break,
    kappaabs ~ (1um/lambda), kappasca ~ (1um/lambda)^4; g = 0; scaled by
    dust mass 2/kappaV so kappaext(V) = kappaV.
    """

    KAPPA_V = 2600.0  # m^2/kg, Units::kappaV() in the reference

    def __init__(self, wavelength_grid: WavelengthGrid):
        lv = wavelength_grid.lambdav
        x = 1e-6 / lv
        kabs = np.where(lv <= 1e-6, 1.0, x)
        ksca = np.where(lv <= 1e-6, 1.0, x ** 4)
        scale = self.KAPPA_V / 2.0
        super().__init__(wavelength_grid, kabs * scale, ksca * scale,
                         np.zeros(lv.size))
