"""Parameterized SED families for imported (particle) stellar components.

ref: SKIRTcore/SEDFamily.hpp:14-50 — a family maps per-particle physical
parameters to a spectrum via `luminosities_generic` (with optional
redshift); SKIRTcore/MappingsSEDFamily.cpp (SFR, Z, logC, pressure, f_PDR
-> MAPPINGS III starburst template, Groves et al. 2008) and
SKIRTcore/BruzualCharlotSEDFamily.cpp (Z, age -> BC03 SSP).

Batched re-design: instead of evaluating one spectrum per launched packet the
family evaluates all particles at once host-side (vectorized trilinear
interpolation over the library grid) during setup, and the resulting
per-particle luminosity matrix is spectrally binned into a handful of
luminosity-weighted components (sources.stellar.sph_stellar_components),
which the batched launch kernel then samples exactly.
"""

from __future__ import annotations

import os

import numpy as np

from .. import DATA_DIR
from ..constants import K_BOLTZMANN
from ..numerics import resample_loglog
from ..wavelengths import WavelengthGrid


class SEDFamily:
    """Base: spectra from per-source physical parameters."""

    nparams = 0

    def luminosities(self, wavelength_grid, params, z=0.0):
        """(N, nparams) parameter rows -> (N, Nlambda) luminosities [W]."""
        raise NotImplementedError


class MappingsSEDFamily(SEDFamily):
    """MAPPINGS III starburst templates (Groves et al. 2008).

    ref: SKIRTcore/MappingsSEDFamily.cpp — library grid over relative
    metallicity Zrel {0.05,0.2,0.4,1,2}, compactness logC {4..6.5}, and
    ISM pressure log(p/k) {4..8}; each entry holds emissivities for
    f_PDR = 0 and 1; parameters per source: (SFR [Msun/yr], Z, logC,
    pressure [Pa], f_PDR).  Templates are normalized to SFR = 1 Msun/yr.
    """

    nparams = 5
    ZSUN = 0.0122
    ZREL = np.array([0.05, 0.20, 0.40, 1.00, 2.00])
    ZNAMES = ("Z005", "Z020", "Z040", "Z100", "Z200")
    LOGC = np.array([4.0, 4.5, 5.0, 5.5, 6.0, 6.5])
    CNAMES = ("C40", "C45", "C50", "C55", "C60", "C65")
    LOGP = np.array([4.0, 5.0, 6.0, 7.0, 8.0])
    PNAMES = ("p4", "p5", "p6", "p7", "p8")
    NLAMBDA = 1800

    _cache: dict = {}

    def __init__(self, data_dir: str | None = None):
        base = os.path.join(data_dir or DATA_DIR, "SED/Mappings")
        if base not in MappingsSEDFamily._cache:
            nz, nc, npp = len(self.ZREL), len(self.LOGC), len(self.LOGP)
            j = np.empty((nz, nc, npp, self.NLAMBDA, 2))
            lam = None
            for i, zn in enumerate(self.ZNAMES):
                for c, cn in enumerate(self.CNAMES):
                    for k, pn in enumerate(self.PNAMES):
                        data = np.loadtxt(os.path.join(
                            base, f"Mappings_{zn}_{cn}_{pn}.dat"))
                        if lam is None:
                            lam = data[:, 0]
                        j[i, c, k] = data[:, 1:3]
            MappingsSEDFamily._cache[base] = (lam, j)
        self.lambdav, self.j = MappingsSEDFamily._cache[base]

    def luminosities(self, wavelength_grid: WavelengthGrid, params,
                     z: float = 0.0):
        """Trilinear interpolation in (Zrel, logC, logp) + f_PDR blend.

        params rows: (SFR, Z, logC, pressure, f_PDR); ref:
        MappingsSEDFamily::luminosities (clamping and Zsun = 0.0122).
        """
        p = np.atleast_2d(np.asarray(params, np.float64))
        sfr, Z, logC, pressure, fpdr = p.T
        zrel = np.clip(Z / self.ZSUN, 0.05, 2.0 - 1e-8)
        logC = np.clip(logC, 4.0, 6.5 - 1e-8)
        with np.errstate(divide="ignore"):
            logp = np.log10(np.maximum(pressure, 1e-300) / K_BOLTZMANN * 1e-6)
        logp = np.clip(logp, 4.0, 8.0 - 1e-8)

        def bracket(grid, x):
            i = np.clip(np.searchsorted(grid, x, "right") - 1, 0,
                        grid.size - 2)
            h = (x - grid[i]) / (grid[i + 1] - grid[i])
            return i, h

        i, hz = bracket(self.ZREL, zrel)
        c, hc = bracket(self.LOGC, logC)
        k, hp = bracket(self.LOGP, logp)
        jv = np.zeros((p.shape[0], self.NLAMBDA, 2))
        for di in (0, 1):
            wi = np.where(di, hz, 1.0 - hz)
            for dc in (0, 1):
                wc = np.where(dc, hc, 1.0 - hc)
                for dk in (0, 1):
                    wk = np.where(dk, hp, 1.0 - hp)
                    w = (wi * wc * wk)[:, None, None]
                    jv += w * self.j[i + di, c + dc, k + dk]
        jmix = (1.0 - fpdr)[:, None] * jv[:, :, 0] + fpdr[:, None] * jv[:, :, 1]

        # resample to the (possibly blueshifted-rest-frame) simulation grid,
        # convert emissivity -> per-bin luminosity, scale by SFR
        lam_target = wavelength_grid.lambdav * (1.0 - z)
        out = np.empty((p.shape[0], wavelength_grid.nlambda))
        for r in range(p.shape[0]):
            out[r] = resample_loglog(lam_target, self.lambdav, jmix[r]) \
                * wavelength_grid.dlambdav * sfr[r]
        return out

    @staticmethod
    def mass(params) -> np.ndarray:
        """ref: MappingsSEDFamily::mass_generic — SFR x 10 Myr [Msun]."""
        p = np.atleast_2d(np.asarray(params, np.float64))
        return p[:, 0] * 1e7


def read_ised_ascii(path: str):
    """Parse one BC03 `.ised_ASCII` SSP file.

    ref: BruzualCharlotSEDFamily.cpp:68-120 — token stream: Nt ages [yr];
    6 lines of auxiliary records skipped; Nlambda; Nlambda wavelengths
    [Angstrom]; then per age (Nlambda, Nlambda emissivities [Lsun/A per
    Msun], Ndummy, Ndummy values).  Returns (tv [yr], lambdav [m],
    j (Nt, Nlambda) [W/m per Msun]).
    """
    LSUN = 3.839e26            # ref: Units::Lsun()
    ANGSTROM = 1e-10
    from ..io.tokenstream import CxxTokenStream
    with open(path) as f:
        ts = CxxTokenStream(f.read(), path)

    nt = ts.next_int()
    tv = np.array([ts.next_float() for _ in range(nt)])
    for _ in range(6):         # ref: "skip six lines" (remainder + 5 full)
        ts.getline()
    nl = ts.next_int()
    lam = np.array([ts.next_float() for _ in range(nl)]) * ANGSTROM
    j = np.empty((nt, nl))
    for p in range(nt):
        inl = ts.next_int()
        if inl != nl:
            raise ValueError(f"inconsistent Nlambda in {path}")
        j[p] = [ts.next_float() for _ in range(nl)]
        ndummy = ts.next_int()
        for _ in range(ndummy):
            ts.next_tok()
    return tv, lam, j * (LSUN / ANGSTROM)


class BruzualCharlotSEDFamily(SEDFamily):
    """Bruzual & Charlot (2003) SSP family (M, Z, age).

    ref: SKIRTcore/BruzualCharlotSEDFamily.cpp — six metallicity tracks
    (m22..m72), bilinear interpolation in (Z, t), log-log resampling to
    the simulation grid.  The shipped data mount carries only stub files
    (.MISSING_LARGE_BLOBS): the reader is fully implemented and tested on
    synthetic fixtures in the reference format; construction raises only
    when the files are genuinely absent.
    """

    nparams = 3
    ZV = np.array([0.0001, 0.0004, 0.004, 0.008, 0.02, 0.05])
    ZCODES = ("m22", "m32", "m42", "m52", "m62", "m72")

    _cache: dict = {}

    def __init__(self, data_dir: str | None = None):
        base = os.path.join(data_dir or DATA_DIR, "SED/BruzualCharlot")
        if base not in BruzualCharlotSEDFamily._cache:
            tv = lam = jv = None
            for m, code in enumerate(self.ZCODES):
                path = os.path.join(
                    base, "chabrier", f"bc2003_lr_{code}_chab_ssp.ised_ASCII")
                if not os.path.exists(path) or os.path.getsize(path) == 0:
                    raise FileNotFoundError(
                        f"Bruzual-Charlot spectrum '{path}' is absent or a "
                        "stub (the reference data mount ships "
                        ".MISSING_LARGE_BLOBS); fetch the resource pack")
                t_m, lam_m, j_m = read_ised_ascii(path)
                if tv is None:
                    tv, lam = t_m, lam_m
                    jv = np.empty((len(self.ZCODES),) + j_m.shape)
                jv[m] = j_m
            BruzualCharlotSEDFamily._cache[base] = (tv, lam, jv)
        self.tv, self.lambdav, self.j = BruzualCharlotSEDFamily._cache[base]

    def luminosities(self, wavelength_grid: WavelengthGrid, params,
                     z: float = 0.0):
        """params rows: (M [Msun], Z, t [yr]) -> (N, Nlambda) W per bin.

        ref: BruzualCharlotSEDFamily::luminosities — clamped bilinear
        (Z, t) blend, then loglog resample x dlambda x M.
        """
        p = np.atleast_2d(np.asarray(params, np.float64))
        M, Z, t = p.T

        def bracket(grid, x):
            i = np.clip(np.searchsorted(grid, x, "right") - 1, 0,
                        grid.size - 2)
            h = np.clip((x - grid[i]) / (grid[i + 1] - grid[i]), 0.0, 1.0)
            return i, h

        mi, hZ = bracket(self.ZV, Z)
        pi, ht = bracket(self.tv, t)
        jv = ((1 - ht)[:, None] * (1 - hZ)[:, None] * self.j[mi, pi]
              + (1 - ht)[:, None] * hZ[:, None] * self.j[mi + 1, pi]
              + ht[:, None] * (1 - hZ)[:, None] * self.j[mi, pi + 1]
              + ht[:, None] * hZ[:, None] * self.j[mi + 1, pi + 1])
        lam_target = wavelength_grid.lambdav * (1.0 - z)
        out = np.empty((p.shape[0], wavelength_grid.nlambda))
        for r in range(p.shape[0]):
            out[r] = resample_loglog(lam_target, self.lambdav, jv[r]) \
                * wavelength_grid.dlambdav * M[r]
        return out

    @staticmethod
    def mass(params) -> np.ndarray:
        """ref: BruzualCharlotSEDFamily::mass_generic — params[0] [Msun]."""
        p = np.atleast_2d(np.asarray(params, np.float64))
        return p[:, 0]
