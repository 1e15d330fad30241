"""Distant instruments with parallel projection.

ref: SKIRTcore/Instrument.hpp:27-87, DistantInstrument.cpp (observer frame
from inclination/azimuth/position angle), SingleFrameInstrument.cpp
(pixelondetector :119-145, 4-step calibration :151-226), SEDInstrument /
FrameInstrument / SimpleInstrument / FullInstrument (decomposed tallies).

Batched re-design: `detect` is a pure function producing scatter-add updates
into per-instrument tally arrays carried through the jitted lifecycle; the
reference's LockFree::add tallies (SimpleInstrument.cpp:34-49) become
jnp scatter-adds.  Calibration and FITS/sed output run host-side in float64.
"""

from __future__ import annotations

import math
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import C_LIGHT
from ..io.fits import write_fits
from ..ops import binned_add, drop_add
from ..units import Units


class DistantInstrument:
    """Base: parallel projection from (inclination, azimuth, position angle)
    at a large distance.  Angles in radians, distance in meters.
    """

    def __init__(self, name: str, distance: float, inclination: float = 0.0,
                 azimuth: float = 0.0, position_angle: float = 0.0):
        self.name = name
        self.distance = float(distance)
        self.inclination = float(inclination)
        self.azimuth = float(azimuth)
        self.position_angle = float(position_angle)

        ct, st = math.cos(self.inclination), math.sin(self.inclination)
        cp, sp = math.cos(self.azimuth), math.sin(self.azimuth)
        cpa, spa = math.cos(self.position_angle), math.sin(self.position_angle)
        self._trig = (ct, st, cp, sp, cpa, spa)

        # ref: DistantInstrument.cpp setupSelfBefore
        self.kobs = np.array([st * cp, st * sp, ct])
        self.kx = np.array([cp * ct * spa - sp * cpa,
                            sp * ct * spa + cp * cpa,
                            -st * spa])
        self.ky = np.array([-cp * ct * cpa - sp * spa,
                            -sp * ct * cpa + cp * spa,
                            st * cpa])
        self.kobs_dev = np.asarray(self.kobs, np.float32)

    # -- device-side -------------------------------------------------------

    def observer_direction(self, pos):
        """Unit direction toward the observer from each position.

        Constant for distant instruments (ref: DistantInstrument::bfkobs).
        """
        return jnp.broadcast_to(jnp.asarray(self.kobs_dev), pos.shape)

    def project(self, pos):
        """Model position -> detector-plane (xp, yp).

        ref: SingleFrameInstrument::pixelondetector.
        """
        ct, st, cp, sp, cpa, spa = self._trig
        x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
        xpp = -sp * x + cp * y
        ypp = -cp * ct * x - sp * ct * y + st * z
        xp = cpa * xpp - spa * ypp
        yp = spa * xpp + cpa * ypp
        return xp, yp

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        """Polychromatic detect: contrib is (W, N) — row i carries
        wavelength index wls[i] (a static numpy int array) for the SAME
        positions.  Default implementation loops; SED/Frame subclasses
        override with one vectorized tally update per stream (the
        polychromatic lifecycles call this once per event instead of W
        scalar detects).  `tags['transparent']`, if present, is (W, N).
        """
        n = contrib.shape[1]
        for i, w in enumerate(np.asarray(wls)):
            t = dict(tags) if tags else None
            if t is not None and "transparent" in t:
                t["transparent"] = tags["transparent"][i]
            tallies = self.detect(tallies, pos,
                                  jnp.full((n,), int(w), jnp.int32),
                                  contrib[i], t)
        return tallies


def _bin_sum(values, ell, nlambda, mask=None):
    """Per-wavelength-bin sum as a matvec (tree reduction).

    A scatter-add into a handful of bins collides on every lane, so its
    float32 error grows ~N*eps; the one-hot matvec reduces pairwise:
    error ~sqrt(N)*eps.  HIGHEST precision: a default float32 product may
    run in TF32 on the GPU (~1e-3 relative error on every flux).
    ref: LockFree::add tallies (SKIRTcore/SimpleInstrument.cpp:34-49).
    """
    oh = (ell[:, None] == jnp.arange(nlambda, dtype=ell.dtype)[None, :])
    if mask is not None:
        values = jnp.where(mask, values, 0.0)
    return jnp.matmul(oh.astype(values.dtype).T, values,
                      precision=jax.lax.Precision.HIGHEST)


class SEDInstrument(DistantInstrument):
    """Integrated SED only (ref: SKIRTcore/SEDInstrument.cpp)."""

    has_frame = False
    has_sed = True

    def __init__(self, name: str, distance: float, nlambda: int, **kw):
        super().__init__(name, distance, **kw)
        self.nlambda = int(nlambda)

    def zero_tallies(self):
        return {"Ftot": jnp.zeros((self.nlambda,), jnp.float32)}

    def detect(self, tallies, pos, ell, contribution, tags=None):
        """Accumulate the (already extincted) contributions into the tallies."""
        tallies = dict(tallies)
        tallies["Ftot"] = tallies["Ftot"] + _bin_sum(contribution, ell,
                                                     self.nlambda)
        return tallies

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        # per-row wavelength index is constant: the per-bin sum is a plain
        # row reduction + one W-element scatter (vs W one-hot matvecs)
        tallies = dict(tallies)
        tallies["Ftot"] = tallies["Ftot"].at[jnp.asarray(
            np.asarray(wls, np.int32))].add(contrib.sum(axis=1))
        return tallies

    # -- output ------------------------------------------------------------

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_sed(self, {"total": accumulated["Ftot"]}, wavelength_grid,
                   units, out_dir, prefix)


class FrameInstrument(DistantInstrument):
    """Data cube only (ref: SKIRTcore/FrameInstrument.cpp)."""

    has_frame = True
    has_sed = False

    def __init__(self, name: str, distance: float, nlambda: int,
                 nx: int, ny: int, fov_x: float, fov_y: float,
                 center_x: float = 0.0, center_y: float = 0.0, **kw):
        super().__init__(name, distance, **kw)
        self.nlambda = int(nlambda)
        self.nx = int(nx)
        self.ny = int(ny)
        self.fov_x = float(fov_x)
        self.fov_y = float(fov_y)
        self.center_x = float(center_x)
        self.center_y = float(center_y)
        self.psize_x = self.fov_x / self.nx
        self.psize_y = self.fov_y / self.ny
        self.xmin = self.center_x - self.fov_x / 2.0
        self.ymin = self.center_y - self.fov_y / 2.0

    def pixel(self, pos):
        """Flat pixel index (iy * nx + ix), -1 outside the frame."""
        xp, yp = self.project(pos)
        i = jnp.floor((xp - self.xmin) / self.psize_x).astype(jnp.int32)
        j = jnp.floor((yp - self.ymin) / self.psize_y).astype(jnp.int32)
        ok = (i >= 0) & (i < self.nx) & (j >= 0) & (j < self.ny)
        return jnp.where(ok, i + self.nx * j, -1)

    def zero_tallies(self):
        return {"ftot": jnp.zeros((self.nlambda * self.nx * self.ny,), jnp.float32)}

    def detect(self, tallies, pos, ell, contribution, tags=None):
        tallies = dict(tallies)
        pix = self.pixel(pos)
        idx = jnp.where(pix >= 0, ell * (self.nx * self.ny) + pix, -1)
        tallies["ftot"] = binned_add(tallies["ftot"], idx, contribution)
        return tallies

    def _poly_idx(self, pos, wls):
        """(W, N) flat cube bins sharing ONE pixel projection per lane."""
        pix = self.pixel(pos)
        wcol = jnp.asarray(np.asarray(wls, np.int32))[:, None]
        return jnp.where(pix[None, :] >= 0,
                         wcol * (self.nx * self.ny) + pix[None, :], -1)

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        tallies = dict(tallies)
        idx = self._poly_idx(pos, wls)
        tallies["ftot"] = binned_add(tallies["ftot"], idx.reshape(-1),
                                     contrib.reshape(-1))
        return tallies

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_cube(self, {"total": accumulated["ftot"]}, wavelength_grid,
                    units, out_dir, prefix)


class SimpleInstrument(FrameInstrument):
    """SED + data cube (ref: SKIRTcore/SimpleInstrument.cpp)."""

    has_sed = True

    def zero_tallies(self):
        t = super().zero_tallies()
        t["Ftot"] = jnp.zeros((self.nlambda,), jnp.float32)
        return t

    def detect(self, tallies, pos, ell, contribution, tags=None):
        tallies = super().detect(tallies, pos, ell, contribution, tags)
        tallies["Ftot"] = tallies["Ftot"] + _bin_sum(contribution, ell,
                                                     self.nlambda)
        return tallies

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        tallies = super().detect_poly(tallies, pos, wls, contrib, tags)
        tallies["Ftot"] = tallies["Ftot"].at[jnp.asarray(
            np.asarray(wls, np.int32))].add(contrib.sum(axis=1))
        return tallies

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        _write_cube(self, {"total": accumulated["ftot"]}, wavelength_grid,
                    units, out_dir, prefix)
        _write_sed(self, {"total": accumulated["Ftot"]}, wavelength_grid,
                   units, out_dir, prefix)


class FullInstrument(SimpleInstrument):
    """Decomposed tallies: direct/scattered x stellar/dust + transparent +
    per-scattering-level frames.

    ref: SKIRTcore/FullInstrument.cpp:107-230.  The `tags` dict carries
    per-packet provenance: nscatt (0 = direct) and is_dust (dust emission).
    """

    def __init__(self, *args, nscatt_levels: int = 0,
                 polarization: bool = False, **kw):
        super().__init__(*args, **kw)
        self.nscatt_levels = int(nscatt_levels)
        self.polarization = bool(polarization)

    def zero_tallies(self):
        t = super().zero_tallies()
        npix = self.nlambda * self.nx * self.ny
        for key in ("fdirstel", "fscastel", "fdirdust", "fscadust", "ftra"):
            t[key] = jnp.zeros((npix,), jnp.float32)
        for key in ("Fdirstel", "Fscastel", "Fdirdust", "Fscadust", "Ftra"):
            t[key] = jnp.zeros((self.nlambda,), jnp.float32)
        if self.nscatt_levels > 0:
            t["fscatlev"] = jnp.zeros((self.nscatt_levels, npix), jnp.float32)
            t["Fscatlev"] = jnp.zeros((self.nscatt_levels, self.nlambda), jnp.float32)
        if self.polarization:
            # Stokes Q/U/V frames + SEDs (ref: FullInstrument.cpp
            # polarization arrays)
            for key in ("fQ", "fU", "fV"):
                t[key] = jnp.zeros((npix,), jnp.float32)
            for key in ("FQ", "FU", "FV"):
                t[key] = jnp.zeros((self.nlambda,), jnp.float32)
        return t

    def detect(self, tallies, pos, ell, contribution, tags=None):
        tallies = super().detect(tallies, pos, ell, contribution, tags)
        if tags is None:
            return tallies
        nscatt = tags["nscatt"]
        is_dust = tags.get("is_dust")
        transparent = tags.get("transparent")  # contribution without extinction
        pix = self.pixel(pos)
        npix = self.nx * self.ny
        idx = jnp.where(pix >= 0, ell * npix + pix, -1)

        direct = nscatt == 0
        if is_dust is None:
            is_dust = jnp.zeros_like(direct)

        def add(t, key_f, key_F, mask, value):
            t[key_f] = binned_add(t[key_f], jnp.where(mask, idx, -1), value)
            t[key_F] = t[key_F] + _bin_sum(value, ell, self.nlambda, mask)
            return t

        t = dict(tallies)
        t = add(t, "fdirstel", "Fdirstel", direct & ~is_dust, contribution)
        t = add(t, "fscastel", "Fscastel", ~direct & ~is_dust, contribution)
        t = add(t, "fdirdust", "Fdirdust", direct & is_dust, contribution)
        t = add(t, "fscadust", "Fscadust", ~direct & is_dust, contribution)
        if transparent is not None:
            t = add(t, "ftra", "Ftra", direct & ~is_dust, transparent)
        if self.nscatt_levels > 0:
            lev = jnp.clip(nscatt - 1, 0, self.nscatt_levels - 1)
            level_idx = jnp.where((nscatt >= 1) & (nscatt <= self.nscatt_levels),
                                  lev * self.nlambda * npix + idx, -1)
            t["fscatlev"] = binned_add(
                t["fscatlev"].reshape(-1),
                jnp.where(idx >= 0, level_idx, -1),
                contribution).reshape(self.nscatt_levels, -1)
            Fidx = jnp.where((nscatt >= 1) & (nscatt <= self.nscatt_levels),
                             lev * self.nlambda + ell, -1)
            t["Fscatlev"] = binned_add(
                t["Fscatlev"].reshape(-1), Fidx,
                contribution).reshape(self.nscatt_levels, -1)
        if self.polarization and tags.get("stokes") is not None:
            q, u, v = tags["stokes"]
            for key_f, key_F, ratio in (("fQ", "FQ", q), ("fU", "FU", u),
                                        ("fV", "FV", v)):
                val = contribution * ratio
                t[key_f] = binned_add(t[key_f], idx, val)
                t[key_F] = t[key_F] + _bin_sum(val, ell, self.nlambda)
        return t

    def detect_poly(self, tallies, pos, wls, contrib, tags=None):
        t = super().detect_poly(tallies, pos, wls, contrib, tags)
        if tags is None:
            return t
        nscatt = tags["nscatt"]
        is_dust = tags.get("is_dust")
        transparent = tags.get("transparent")          # (W, N) or None
        idx = self._poly_idx(pos, wls)                 # (W, N)
        wl_i = jnp.asarray(np.asarray(wls, np.int32))
        npix = self.nx * self.ny

        direct = nscatt == 0
        if is_dust is None:
            is_dust = jnp.zeros_like(direct)

        def add(t, key_f, key_F, mask, value):
            t[key_f] = binned_add(t[key_f],
                                  jnp.where(mask[None], idx, -1).reshape(-1),
                                  value.reshape(-1))
            t[key_F] = t[key_F].at[wl_i].add(
                jnp.where(mask[None], value, 0.0).sum(axis=1))
            return t

        t = dict(t)
        t = add(t, "fdirstel", "Fdirstel", direct & ~is_dust, contrib)
        t = add(t, "fscastel", "Fscastel", ~direct & ~is_dust, contrib)
        t = add(t, "fdirdust", "Fdirdust", direct & is_dust, contrib)
        t = add(t, "fscadust", "Fscadust", ~direct & is_dust, contrib)
        if transparent is not None:
            t = add(t, "ftra", "Ftra", direct & ~is_dust, transparent)
        if self.nscatt_levels > 0:
            lev = jnp.clip(nscatt - 1, 0, self.nscatt_levels - 1)
            in_lev = (nscatt >= 1) & (nscatt <= self.nscatt_levels)
            level_idx = jnp.where(in_lev[None] & (idx >= 0),
                                  lev[None] * (self.nlambda * npix) + idx,
                                  -1)
            t["fscatlev"] = binned_add(
                t["fscatlev"].reshape(-1), level_idx.reshape(-1),
                contrib.reshape(-1)).reshape(self.nscatt_levels, -1)
            Fidx = jnp.where(in_lev[None],
                             lev[None] * self.nlambda + wl_i[:, None], -1)
            t["Fscatlev"] = binned_add(
                t["Fscatlev"].reshape(-1), Fidx.reshape(-1),
                contrib.reshape(-1)).reshape(self.nscatt_levels, -1)
        if self.polarization and tags.get("stokes") is not None:
            # stokes ratios broadcast against (W, N): per-lane (N,) for
            # lambda-independent Mueller matrices, (W, N) otherwise
            q, u, v = tags["stokes"]
            for key_f, key_F, ratio in (("fQ", "FQ", q), ("fU", "FU", u),
                                        ("fV", "FV", v)):
                val = jnp.broadcast_to(contrib * ratio, contrib.shape)
                t[key_f] = binned_add(t[key_f], idx.reshape(-1),
                                      val.reshape(-1))
                t[key_F] = t[key_F].at[wl_i].add(val.sum(axis=1))
        return t

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        frames = {"total": accumulated["ftot"],
                  "direct": accumulated["fdirstel"] + accumulated["fdirdust"],
                  "scattered": accumulated["fscastel"] + accumulated["fscadust"],
                  "transparent": accumulated["ftra"]}
        seds = {"total": accumulated["Ftot"],
                "direct": accumulated["Fdirstel"] + accumulated["Fdirdust"],
                "scattered": accumulated["Fscastel"] + accumulated["Fscadust"],
                "transparent": accumulated["Ftra"]}
        if self.polarization:
            for name, key in (("stokesQ", "fQ"), ("stokesU", "fU"),
                              ("stokesV", "fV")):
                frames[name] = accumulated[key]
            for name, key in (("stokesQ", "FQ"), ("stokesU", "FU"),
                              ("stokesV", "FV")):
                seds[name] = accumulated[key]
        _write_cube(self, frames, wavelength_grid, units, out_dir, prefix)
        _write_sed(self, seds, wavelength_grid, units, out_dir, prefix)


class InstrumentSystem:
    """ref: SKIRTcore/InstrumentSystem.hpp:20."""

    def __init__(self, instruments):
        self.instruments = list(instruments)

    def zero_tallies(self):
        return [ins.zero_tallies() for ins in self.instruments]

    def write(self, accumulated, wavelength_grid, units: Units, out_dir: str,
              prefix: str):
        for ins, acc in zip(self.instruments, accumulated):
            ins.write(acc, wavelength_grid, units, out_dir, prefix)


# ---------------------------------------------------------------------------
# calibration + output (host side, float64)
# ---------------------------------------------------------------------------

def calibrate_sed(instrument, Ftot: np.ndarray, wavelength_grid) -> np.ndarray:
    """W per bin -> F_lambda [W/m^3] at the instrument distance.

    ref: DistantInstrument::calibrateAndWriteSEDs (DistantInstrument.cpp:131+):
    divide by bin width, then by 4 pi d^2.
    """
    fourpid2 = 4.0 * np.pi * instrument.distance ** 2
    return np.asarray(Ftot, np.float64) / wavelength_grid.dlambdav / fourpid2


def calibrate_cube(instrument, ftot: np.ndarray, wavelength_grid) -> np.ndarray:
    """W per bin per pixel -> surface brightness f_lambda [W/m^3/sr].

    ref: SingleFrameInstrument::calibrateAndWriteDataCubes
    (SingleFrameInstrument.cpp:151-226): divide by bin width, pixel solid
    angle, and 4 pi d^2.
    """
    cube = np.asarray(ftot, np.float64).reshape(
        wavelength_grid.nlambda, instrument.ny, instrument.nx)
    d = instrument.distance
    omega = (2.0 * np.arctan(instrument.psize_x / (2.0 * d))
             * 2.0 * np.arctan(instrument.psize_y / (2.0 * d)))
    fourpid2 = 4.0 * np.pi * d * d
    return cube / wavelength_grid.dlambdav[:, None, None] / omega / fourpid2


def _write_sed(instrument, seds: dict, wavelength_grid, units: Units,
               out_dir: str, prefix: str):
    lam = wavelength_grid.lambdav
    cols = [units.out("wavelength", lam)]
    header = [f"lambda ({units.unit('wavelength')})"]
    for name, F in seds.items():
        Flam = calibrate_sed(instrument, F, wavelength_grid)
        cols.append(units.out_fluxdensity(lam, Flam))
        header.append(f"{name} flux ({units.fluxdensity_unit()})")
    path = os.path.join(out_dir, f"{prefix}_{instrument.name}_sed.dat")
    np.savetxt(path, np.column_stack(cols), header="  ".join(header))


def _write_cube(instrument, frames: dict, wavelength_grid, units: Units,
                out_dir: str, prefix: str):
    lam = wavelength_grid.lambdav
    for name, f in frames.items():
        cube = calibrate_cube(instrument, f, wavelength_grid)
        out = units.out_surfacebrightness(lam[:, None, None], cube)
        path = os.path.join(out_dir, f"{prefix}_{instrument.name}_{name}.fits")
        write_fits(path, out,
                   incx=units.out("length", instrument.psize_x),
                   incy=units.out("length", instrument.psize_y),
                   xc=instrument.center_x, yc=instrument.center_y,
                   units=units.surfacebrightness_unit())
