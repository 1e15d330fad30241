"""Stellar systems: components with geometry + SED + normalization, and the
batched launch kernel.

ref: SKIRTcore/StellarSystem.cpp:48-158 (per-wavelength luminosity CDF,
biased component selection with weight compensation),
GeometricStellarComp.cpp (launch = geometry position + direction),
OligoStellarComp.cpp (luminosities in solar monochromatic units),
StellarCompNormalization family.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..geometry.base import Geometry
from ..wavelengths import WavelengthGrid
from .sed import SED, load_sun_sed


@dataclass
class BolometricLuminosityNormalization:
    """Total luminosity in W (ref: BolLuminosityStellarCompNormalization)."""
    luminosity: float

    def luminosities_for(self, sed: SED) -> np.ndarray:
        return self.luminosity * sed.fractions


@dataclass
class SpectralLuminosityNormalization:
    """Monochromatic luminosity L_lambda [W/m] at a given wavelength.

    ref: SpectralLuminosityStellarCompNormalization.
    """
    wavelength: float
    luminosity_lambda: float

    def luminosities_for(self, sed: SED) -> np.ndarray:
        wg = sed.wavelength_grid
        ell = wg.nearest(self.wavelength)
        if ell < 0:
            raise ValueError("normalization wavelength outside the grid")
        # L_lambda at ell implied by a unit-luminosity SED
        llambda_unit = sed.fractions[ell] / wg.dlambdav[ell]
        if llambda_unit <= 0:
            raise ValueError("SED has no luminosity at the normalization wavelength")
        return (self.luminosity_lambda / llambda_unit) * sed.fractions


@dataclass
class BandLuminosityNormalization:
    """Luminosity integrated over a wavelength band [lambda_min, lambda_max].

    ref: LuminosityStellarCompNormalization (band-integrated variant).
    """
    lambda_min: float
    lambda_max: float
    luminosity: float

    def luminosities_for(self, sed: SED) -> np.ndarray:
        wg = sed.wavelength_grid
        sel = (wg.lambdav >= self.lambda_min) & (wg.lambdav <= self.lambda_max)
        frac_in_band = sed.fractions[sel].sum()
        if frac_in_band <= 0:
            raise ValueError("SED has no luminosity in the normalization band")
        return (self.luminosity / frac_in_band) * sed.fractions


# broadband effective wavelengths, ref:
# LuminosityStellarCompNormalization.cpp:74-99 (WISE1 is 3.35e-9 there —
# an evident typo for the 3.35 um W1 band; corrected here)
BROADBAND_WAVELENGTHS = {
    "FUV": 152e-9, "NUV": 231e-9, "U": 365e-9, "B": 445e-9, "V": 551e-9,
    "R": 658e-9, "I": 806e-9, "J": 1.22e-6, "H": 1.63e-6, "K": 2.19e-6,
    "SDSSu": 354e-9, "SDSSg": 477e-9, "SDSSr": 623e-9, "SDSSi": 763e-9,
    "SDSSz": 913e-9, "IRAC1": 3.56e-6, "IRAC2": 4.51e-6,
    "WISE1": 3.35e-6, "WISE2": 4.60e-6,
}


@dataclass
class BroadbandLuminosityNormalization:
    """Luminosity in a named broadband, in solar units of that band.

    ref: LuminosityStellarCompNormalization.cpp — the nearest wavelength
    bin to the band's effective wavelength carries L_X * Lsun * sunfrac,
    and the SED scales so its luminosity in that bin matches:
    totluminosity = L_X * Lsun * sun.luminosity(ell) / sed.luminosity(ell).
    """
    band: str
    luminosity: float          # in solar band luminosities
    data_dir: str | None = None

    def luminosities_for(self, sed: SED) -> np.ndarray:
        from ..constants import L_SUN
        from .sed import SunSED

        if self.band not in BROADBAND_WAVELENGTHS:
            raise ValueError(f"unknown broadband '{self.band}'")
        wg = sed.wavelength_grid
        ell = wg.nearest(BROADBAND_WAVELENGTHS[self.band])
        if ell < 0:
            raise ValueError("the band is outside the wavelength grid")
        sun = SunSED(wg, self.data_dir)
        if sed.fractions[ell] <= 0:
            raise ValueError("SED has no luminosity in the band bin")
        LX_W = self.luminosity * L_SUN * sun.fractions[ell]
        return (LX_W / sed.fractions[ell]) * sed.fractions


class StellarComponent:
    """Geometry + SED + normalization (ref: PanStellarComp)."""

    def __init__(self, geometry: Geometry, sed: SED, normalization):
        self.geometry = geometry
        self.sed = sed
        self.luminosities = np.asarray(normalization.luminosities_for(sed))

    @property
    def wavelength_grid(self) -> WavelengthGrid:
        return self.sed.wavelength_grid


class OligoStellarComponent(StellarComponent):
    """Component for oligochromatic runs: per-wavelength luminosities given
    as multiples of the solar monochromatic luminosity at that wavelength.

    ref: SKIRTcore/OligoStellarComp.cpp setupSelfBefore — L_ell =
    input_ell * Lsun_lambda(lambda_ell) * dlambda_ell.
    """

    def __init__(self, geometry: Geometry, wavelength_grid: WavelengthGrid,
                 luminosities_solar, data_dir: str | None = None):
        lam_sun, L_sun = load_sun_sed(data_dir)
        lv = wavelength_grid.lambdav
        if np.any(lv < lam_sun[0]) or np.any(lv > lam_sun[-1]):
            raise ValueError("the sun does not emit at a simulation wavelength")
        Lsun_at = np.interp(lv, lam_sun, L_sun)
        Lv = np.asarray(luminosities_solar, dtype=np.float64) * Lsun_at \
            * wavelength_grid.dlambdav
        self.geometry = geometry
        self.sed = None
        self._wg = wavelength_grid
        self.luminosities = Lv

    @property
    def wavelength_grid(self) -> WavelengthGrid:
        return self._wg


class LuminosityStellarComponent(StellarComponent):
    """Component with explicitly given per-bin luminosities [W].

    Convenience for tests and oligochromatic setups that bypass the solar
    normalization of OligoStellarComponent.
    """

    def __init__(self, geometry: Geometry, wavelength_grid: WavelengthGrid,
                 luminosities_w):
        self.geometry = geometry
        self.sed = None
        self._wg = wavelength_grid
        self.luminosities = np.asarray(luminosities_w, dtype=np.float64)

    @property
    def wavelength_grid(self) -> WavelengthGrid:
        return self._wg


class StellarSystem:
    """All stellar components + the batched launch kernel.

    ref: SKIRTcore/StellarSystem.cpp.  Biased component selection: with
    probability `emission_bias` the component is drawn uniformly, otherwise
    from the per-wavelength luminosity distribution; the packet luminosity
    carries the compensating weight (StellarSystem.cpp:116-158).
    """

    def __init__(self, components, emission_bias: float = 0.5):
        if not components:
            raise ValueError("need at least one stellar component")
        self.components = list(components)
        self.ncomp = len(self.components)
        self.emission_bias = float(emission_bias)
        self.wavelength_grid = self.components[0].wavelength_grid

        # per-wavelength total luminosity and component CDF
        Lvv = np.stack([c.luminosities for c in self.components])  # (Ncomp, Nl)
        self.Lvv = Lvv
        self.Lv = Lvv.sum(axis=0)                                  # (Nl,)
        self.Ltot = float(self.Lv.sum())
        with np.errstate(invalid="ignore", divide="ignore"):
            cdf = np.cumsum(Lvv, axis=0) / np.where(self.Lv > 0, self.Lv, 1.0)
        self.comp_cdf = np.asarray(
            np.concatenate([np.zeros((1, self.Lv.size)), cdf], axis=0).T,
            np.float32)                                            # (Nl, Ncomp+1)
        self.Lvv_dev = np.asarray(Lvv, np.float32)
        self.Lv_dev = np.asarray(self.Lv, np.float32)

    def luminosity(self, ell: int) -> float:
        return float(self.Lv[ell])

    @property
    def is_isotropic(self) -> bool:
        return all(c.geometry.is_isotropic for c in self.components)

    def direction_probability(self, ell, pos, direction, comp):
        """Emission-direction probability relative to isotropic per packet.

        ref: PhotonPackage::launchEmissionPeelOff applies the angular
        distribution's probabilityForDirection to peel-off luminosities.
        """
        out = self.components[0].geometry.direction_probability(
            ell, pos, direction)
        for i in range(1, self.ncomp):
            pi = self.components[i].geometry.direction_probability(
                ell, pos, direction)
            out = jnp.where(comp == i, pi, out)
        return out

    def launch(self, key, ell, L):
        """Launch a batch: returns (positions, directions, luminosities, comp).

        ell: (N,) wavelength indices; L: (N,) base luminosities (already
        Lv[ell]/Npp).  Weight compensation follows StellarSystem.cpp:116-158.
        """
        n = ell.shape[0]
        if self.ncomp == 1:
            kpos, kdir = jax.random.split(key)
            comp = jnp.zeros(n, dtype=jnp.int32)
            pos = self.components[0].geometry.generate_position(kpos, n)
            d = self.components[0].geometry.generate_direction(kdir, ell, pos)
            return pos, d, L, comp

        ksel, kpos, kdir = jax.random.split(key, 3)
        X = rng.uniform_open(ksel, (n,))
        xi = self.emission_bias
        # uniform branch
        h_uni = jnp.clip((self.ncomp * X / xi).astype(jnp.int32), 0, self.ncomp - 1)
        # luminosity branch: CDF per wavelength
        Xl = (X - xi) / (1.0 - xi)
        cdf_rows = jnp.asarray(self.comp_cdf)[ell]       # (N, Ncomp+1)
        h_lum = jnp.clip(
            jnp.sum((cdf_rows[:, 1:-1] <= Xl[:, None]).astype(jnp.int32), axis=1),
            0, self.ncomp - 1)
        h = jnp.where(X < xi, h_uni, h_lum)

        # compensating weight: 1 / (1 - xi + xi * Lmean / Lh)
        Lh = jnp.asarray(self.Lvv_dev)[h, ell]
        Lmean = jnp.asarray(self.Lv_dev)[ell] / self.ncomp
        weight = 1.0 / (1.0 - xi + xi * Lmean / jnp.maximum(Lh, 1e-37))
        weight = jnp.where(Lh > 0, weight, 0.0)

        # sample every component's geometry, select per packet
        pos = self.components[0].geometry.generate_position(
            jax.random.fold_in(kpos, 0), n)
        d = self.components[0].geometry.generate_direction(
            jax.random.fold_in(kdir, 0), ell, pos)
        for i in range(1, self.ncomp):
            pos_i = self.components[i].geometry.generate_position(
                jax.random.fold_in(kpos, i), n)
            d_i = self.components[i].geometry.generate_direction(
                jax.random.fold_in(kdir, i), ell, pos_i)
            sel = (h == i)[:, None]
            pos = jnp.where(sel, pos_i, pos)
            d = jnp.where(sel, d_i, d)
        return pos, d, L * weight, h


def sph_stellar_components(positions, smoothing, luminosities,
                           wavelength_grid, nbins: int = 8, kernel=None):
    """Spectrally-binned stellar components from smoothed particles.

    ref: SKIRTcore/SPHStellarComp.cpp — the reference samples a particle
    per packet from a per-wavelength luminosity CDF over all particles.
    Batched re-design: particles are grouped into at most `nbins` bins of
    similar spectral hardness (luminosity-weighted mean wavelength); each
    bin becomes a LuminosityStellarComponent whose SPHParticleGeometry is
    weighted by the particles' bolometric luminosities, and the existing
    StellarSystem per-wavelength component CDF reproduces the reference's
    spectral selection across bins exactly (within-bin spectral variation
    is what the binning approximates).

    luminosities: (Nparticles, Nlambda) per-bin luminosities [W].
    Returns a list of LuminosityStellarComponent.
    """
    from ..imports.sph import SPHParticleGeometry

    pos = np.asarray(positions, np.float64)
    h = np.asarray(smoothing, np.float64)
    L = np.asarray(luminosities, np.float64)
    if L.ndim != 2 or L.shape[0] != pos.shape[0]:
        raise ValueError("luminosities must be (Nparticles, Nlambda)")
    Lbol = L.sum(axis=1)
    keep = Lbol > 0
    if not keep.any():
        raise ValueError("all particles have zero luminosity")
    pos, h, L, Lbol = pos[keep], h[keep], L[keep], Lbol[keep]

    which, nbins = _spectral_bins(L, Lbol, wavelength_grid.lambdav, nbins)

    comps = []
    for b in range(nbins):
        sel = which == b
        if not sel.any():
            continue
        geom = SPHParticleGeometry(pos[sel], h[sel], Lbol[sel], kernel=kernel)
        comps.append(LuminosityStellarComponent(
            geom, wavelength_grid, L[sel].sum(axis=0)))
    return comps


def _spectral_bins(L, Lbol, lam, nbins):
    """Group entities into <= nbins bins of similar spectral hardness
    (luminosity-weighted mean wavelength), with luminosity-weighted
    quantile edges so each bin carries similar power.  Returns (which,
    nbins): the bin index per entity."""
    hardness = (L * lam[None, :]).sum(axis=1) / Lbol
    nbins = min(int(nbins), L.shape[0])
    order = np.argsort(hardness)
    cumL = np.cumsum(Lbol[order])
    targets = np.linspace(0.0, cumL[-1], nbins + 1)[1:-1]
    edge_idx = np.searchsorted(cumL, targets)
    edges = np.concatenate([[-np.inf], hardness[order][edge_idx], [np.inf]])
    which = np.clip(np.searchsorted(edges, hardness, "right") - 1, 0,
                    nbins - 1)
    return which, nbins


def mesh_stellar_components(make_geometry, luminosities, wavelength_grid,
                            nbins: int = 8):
    """Spectrally-binned stellar components over mesh cells.

    ref: SKIRTcore/VoronoiStellarComp.cpp:40-90 /
    AdaptiveMeshStellarComp.cpp — the reference samples an emitting cell
    per packet from a per-wavelength luminosity CDF over all cells
    (position uniform in the cell).  Batched re-design: same spectral-bin
    scheme as sph_stellar_components — cells group into <= nbins bins of
    similar spectral hardness, each bin becomes a
    LuminosityStellarComponent over a cell-weighted mesh geometry, and
    the StellarSystem per-wavelength component CDF reproduces the
    reference's spectral selection across bins.

    make_geometry(weights): (Ncells,) per-cell bolometric luminosities
    (zero outside the bin) -> a Geometry sampling cells ~ weights with
    uniform in-cell positions.  luminosities: (Ncells, Nlambda) [W].
    """
    L = np.asarray(luminosities, np.float64)
    ncells = L.shape[0]
    Lbol_full = L.sum(axis=1)
    keep = Lbol_full > 0
    if not keep.any():
        raise ValueError("all cells have zero luminosity")
    idx_keep = np.nonzero(keep)[0]
    Lk = L[keep]
    which, nbins = _spectral_bins(Lk, Lbol_full[keep],
                                  wavelength_grid.lambdav, nbins)
    comps = []
    for b in range(nbins):
        sel = which == b
        if not sel.any():
            continue
        w = np.zeros(ncells)
        w[idx_keep[sel]] = Lbol_full[idx_keep[sel]]
        comps.append(LuminosityStellarComponent(
            make_geometry(w), wavelength_grid, Lk[sel].sum(axis=0)))
    return comps
