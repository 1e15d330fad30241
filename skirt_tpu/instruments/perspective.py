"""Perspective camera instrument for fly-through views.

ref: SKIRTcore/PerspectiveInstrument.hpp:30 / .cpp — pinhole camera with
viewport origin V, crosshair C, up U, focal length Fe; eye at
E = V + Fe * normalize(V - C); luminosity adjusted by (r/atan r)^2 with
r = s/(2 d) (detect, :325+); optical depth accumulated only up to the
eye distance.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import binned_add


class PerspectiveInstrument:
    has_frame = True
    has_sed = False

    def __init__(self, name: str, nlambda: int, nx: int, ny: int,
                 width: float, view, crosshair, up, focal: float):
        self.name = name
        self.nlambda = int(nlambda)
        self.nx = int(nx)
        self.ny = int(ny)
        self.Sx = float(width)
        self.s = self.Sx / self.nx  # pixel size (square pixels)
        self.focal = float(focal)

        V = np.asarray(view, dtype=np.float64)
        C = np.asarray(crosshair, dtype=np.float64)
        U = np.asarray(up, dtype=np.float64)
        n = V - C
        G = np.linalg.norm(n)
        if G < 1e-20:
            raise ValueError("crosshair too close to viewport origin")
        n /= G
        self.eye = V + self.focal * n
        # viewport axes (ref: setupSelfBefore cross products)
        ky = np.cross(n, np.cross(U, n))
        ky /= np.linalg.norm(ky)
        kx = np.cross(ky, n)
        kx /= np.linalg.norm(kx)
        self.kx = kx
        self.ky = ky
        self.kz = -n  # viewing direction from the eye

        # device methods wrap these with jnp.asarray (inlined HLO literals)
        self.eye_dev = np.asarray(self.eye, np.float32)
        self.kx_dev = np.asarray(kx, np.float32)
        self.ky_dev = np.asarray(ky, np.float32)
        self.kz_dev = np.asarray(self.kz, np.float32)

    # -- device-side -------------------------------------------------------

    def observer_direction(self, pos):
        """Unit vector from each position toward the eye (ref: bfkobs)."""
        rel = jnp.asarray(self.eye_dev) - pos
        d = jnp.linalg.norm(rel, axis=-1, keepdims=True)
        return rel / jnp.maximum(d, 1e-30)

    def observer_distance(self, pos):
        """Path-length cap for extinction: the axial eye distance."""
        rel = pos - jnp.asarray(self.eye_dev)
        return jnp.maximum(jnp.sum(rel * jnp.asarray(self.kz_dev), axis=-1),
                           0.0)

    def _project(self, pos):
        rel = pos - jnp.asarray(self.eye_dev)
        xe = jnp.sum(rel * jnp.asarray(self.kx_dev), axis=-1)
        ye = jnp.sum(rel * jnp.asarray(self.ky_dev), axis=-1)
        ze = jnp.sum(rel * jnp.asarray(self.kz_dev), axis=-1)
        return xe, ye, ze

    def pixel(self, pos):
        xe, ye, ze = self._project(pos)
        safe_z = jnp.where(ze > self.s / 10.0, ze, 1.0)
        i = jnp.floor(self.focal * xe / safe_z / self.s
                      + self.nx / 2.0).astype(jnp.int32)
        j = jnp.floor(self.focal * ye / safe_z / self.s
                      + self.ny / 2.0).astype(jnp.int32)
        ok = ((ze > self.s / 10.0) & (i >= 0) & (i < self.nx)
              & (j >= 0) & (j < self.ny))
        return jnp.where(ok, i + self.nx * j, -1)

    def zero_tallies(self):
        return {"ftot": jnp.zeros((self.nlambda * self.nx * self.ny,),
                                  jnp.float32)}

    def detect(self, tallies, pos, ell, contribution, tags=None):
        _, _, ze = self._project(pos)
        r = self.s / (2.0 * jnp.maximum(ze, self.s / 10.0))
        rar = r / jnp.arctan(r)
        value = contribution * rar * rar
        pix = self.pixel(pos)
        idx = jnp.where(pix >= 0, ell * (self.nx * self.ny) + pix, -1)
        tallies = dict(tallies)
        tallies["ftot"] = binned_add(tallies["ftot"], idx, value)
        return tallies

    # -- output ------------------------------------------------------------

    def write(self, accumulated, wavelength_grid, units, out_dir, prefix):
        import os
        from ..io.fits import write_fits
        cube = np.asarray(accumulated["ftot"], np.float64).reshape(
            wavelength_grid.nlambda, self.ny, self.nx)
        # calibration: per-pixel solid angle s^2/Fe^2, bin width, 4 pi Fe^2
        omega = (self.s / self.focal) ** 2
        fourpid2 = 4.0 * np.pi * self.focal ** 2
        cube = cube / wavelength_grid.dlambdav[:, None, None] / omega / fourpid2
        lam = wavelength_grid.lambdav
        out = units.out_surfacebrightness(lam[:, None, None], cube)
        path = os.path.join(out_dir, f"{prefix}_{self.name}_total.fits")
        write_fits(path, out, incx=units.out("length", self.s),
                   incy=units.out("length", self.s),
                   units=units.surfacebrightness_unit())
