"""Multi-frame instrument: a distinct pixel frame per wavelength.

ref: SKIRTcore/MultiFrameInstrument.cpp:85 + InstrumentFrame — each
wavelength bin gets its own pixel count / field of view (used for
matching observations taken with different cameras).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..ops import binned_add

from ..io.fits import write_fits
from .instruments import DistantInstrument


@dataclass
class InstrumentFrame:
    """Per-wavelength frame spec (ref: SKIRTcore/InstrumentFrame.cpp)."""
    nx: int
    ny: int
    fov_x: float
    fov_y: float
    center_x: float = 0.0
    center_y: float = 0.0


class MultiFrameInstrument(DistantInstrument):
    has_frame = True
    has_sed = False

    def __init__(self, name: str, distance: float, frames, **kw):
        super().__init__(name, distance, **kw)
        self.frames = list(frames)
        self.nlambda = len(self.frames)
        self._npix = [f.nx * f.ny for f in self.frames]
        self._offsets = np.concatenate([[0], np.cumsum(self._npix)])
        # device-side per-frame constants indexed by ell
        self.psx = np.asarray([f.fov_x / f.nx for f in self.frames], np.float32)
        self.psy = np.asarray([f.fov_y / f.ny for f in self.frames], np.float32)
        self.xmin = np.asarray([f.center_x - f.fov_x / 2 for f in self.frames],
                               np.float32)
        self.ymin = np.asarray([f.center_y - f.fov_y / 2 for f in self.frames],
                               np.float32)
        self.nxs = np.asarray([f.nx for f in self.frames], np.int32)
        self.nys = np.asarray([f.ny for f in self.frames], np.int32)
        self.offsets_dev = np.asarray(self._offsets[:-1], np.int32)

    def zero_tallies(self):
        return {"ftot": jnp.zeros((int(self._offsets[-1]),), jnp.float32)}

    def detect(self, tallies, pos, ell, contribution, tags=None):
        xp, yp = self.project(pos)
        xmin = jnp.asarray(self.xmin)[ell]
        ymin = jnp.asarray(self.ymin)[ell]
        nxs = jnp.asarray(self.nxs)[ell]
        nys = jnp.asarray(self.nys)[ell]
        i = jnp.floor((xp - xmin) / jnp.asarray(self.psx)[ell]).astype(jnp.int32)
        j = jnp.floor((yp - ymin) / jnp.asarray(self.psy)[ell]).astype(jnp.int32)
        ok = (i >= 0) & (i < nxs) & (j >= 0) & (j < nys)
        idx = jnp.where(ok, jnp.asarray(self.offsets_dev)[ell] + i + nxs * j,
                        -1)
        tallies = dict(tallies)
        tallies["ftot"] = binned_add(tallies["ftot"], idx, contribution)
        return tallies

    def write(self, accumulated, wavelength_grid, units, out_dir, prefix):
        flat = np.asarray(accumulated["ftot"], np.float64)
        d = self.distance
        fourpid2 = 4.0 * np.pi * d * d
        for ell, f in enumerate(self.frames):
            lam = wavelength_grid.lambdav[ell]
            frame = flat[self._offsets[ell]:self._offsets[ell + 1]].reshape(
                f.ny, f.nx)
            omega = (2 * np.arctan(f.fov_x / f.nx / (2 * d))
                     * 2 * np.arctan(f.fov_y / f.ny / (2 * d)))
            cal = frame / wavelength_grid.dlambdav[ell] / omega / fourpid2
            out = units.out_surfacebrightness(lam, cal)
            path = os.path.join(out_dir,
                                f"{prefix}_{self.name}_frame{ell}_total.fits")
            write_fits(path, out, incx=units.out("length", f.fov_x / f.nx),
                       incy=units.out("length", f.fov_y / f.ny),
                       units=units.surfacebrightness_unit())
