"""Config-3 accuracy: fused table mode vs the exact voxel DDA walk.

Reference chain: the voxelized octree torus traced with the exact
Cartesian DDA (reference-exact estimators: per-crossing tau, path
deposition).  Candidate: the fused table kernel (panel quadrature,
sampled deposition, staged peel) at several panel counts.

Both share the launch + emission-peel RNG stream, so the direct flux
matches exactly; the scattered flux carries the panel-quadrature error
plus independent event streams (MC noise ~ 1/sqrt(N) per lambda).

TABLE_LOG2N (default 18), TABLE_PANELS (comma list, default 16,24,32).
"""

import os
import time

import numpy as np
import jax


import jax.numpy as jnp
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from skirt_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from skirt_tpu import rng
from skirt_tpu.constants import KPC
from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
from skirt_tpu.geometry import TorusGeometry, PointGeometry
from skirt_tpu.grids.octree import OctreeGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization, SimpleOligoDustMix)
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid


def _sync(o):
    return jax.block_until_ready(o)


def main():
    wg = OligoWavelengthGrid([0.55e-6, 2.2e-6])
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36, 1e36])])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    extent = (-half, -half, -half, half, half, half)
    grid0 = OctreeGrid(extent, lambda p: np.asarray(torus.density(p)),
                       min_level=2, max_level=5)
    mix = SimpleOligoDustMix(wg, [2600.0, 600.0], [0.5, 0.4], [0.4, 0.2])
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], 5.0))
    dsys0 = DustSystem(grid0, [comp], samples_per_cell=8,
                       density_mode="gridded")
    vds, _fold = dsys0.voxelized()
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2)]

    n = 1 << int(os.environ.get("TABLE_LOG2N", "18"))
    nbatch = max(1, n >> 17)
    nb = n // nbatch
    ell = jnp.asarray(np.arange(nb, dtype=np.int32) % 2)
    L0 = jnp.full((nb,), 1e36 / n, jnp.float32)
    key = rng.root_key(4357)

    def run_chain(dsys, grid, opts, tag):
        run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, 2))
        t = {"instruments": [ins[0].zero_tallies()],
             "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)}
        t0 = time.perf_counter()
        for b in range(nbatch):
            t = run(jax.random.fold_in(key, b), ell, L0, t)
        F = np.asarray(t["instruments"][0]["Ftot"], np.float64)
        labs = float(np.asarray(t["labs"], np.float64).sum())
        print(f"{tag}: F={F} labs={labs:.4e} "
              f"({time.perf_counter()-t0:.1f}s)", flush=True)
        return F, labs

    # reference: exact voxel DDA, reference-exact estimators
    Fr, lr = run_chain(vds, vds.grid,
                       LifecycleOptions(store_absorption=True,
                                        max_scatt_events=64,
                                        deposition="path"),
                       "exact voxel DDA (path est.)")

    tds = vds.as_table()

    if os.environ.get("TABLE_POLY", "0") == "1":
        # polychromatic lanes at matched per-wavelength sample counts:
        # n/2 lanes each carrying BOTH wavelengths = n/2 paths per
        # wavelength, same as the n-packet monochromatic reference
        for P in [int(p) for p in
                  os.environ.get("TABLE_PANELS", "16").split(",")]:
            run = jax.jit(make_lifecycle(
                tds.grid, tds, ss, ins,
                LifecycleOptions(store_absorption=True, max_scatt_events=64,
                                 deposition="sampled", quadrature_panels=P,
                                 fused=True, polychromatic=True,
                                 table_peel="exact"), 2))
            npl = nb // 2
            ellp = jnp.zeros((npl,), jnp.int32)
            L0p = jnp.full((npl, 2), 1e36 / n, jnp.float32)
            t = {"instruments": [ins[0].zero_tallies()],
                 "labs": jnp.zeros((tds.grid.ncells * 2,), jnp.float32)}
            t0 = time.perf_counter()
            for b in range(nbatch):
                t = run(jax.random.fold_in(key, b), ellp, L0p, t)
            Fp = np.asarray(t["instruments"][0]["Ftot"], np.float64)
            lp = float(np.asarray(t["labs"], np.float64).sum())
            print(f"poly table P={P}: F={Fp} labs={lp:.4e} "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
            print(f"  poly P={P}: SED rel delta = {np.abs(Fp/Fr-1.0)}, "
                  f"labs delta = {abs(lp/lr-1):.4%}", flush=True)
        return

    for P in [int(p) for p in
              os.environ.get("TABLE_PANELS", "16,24,32").split(",")]:
        for peel_mode, pp in (("exact", 0), ("staged", int(os.environ.get(
                "TABLE_PEELP", "8"))), ("taumap", 0)):
            if os.environ.get("TABLE_PEELMODE", peel_mode) != peel_mode:
                continue
            Ff, lf = run_chain(
                tds, tds.grid,
                LifecycleOptions(store_absorption=True, max_scatt_events=64,
                                 deposition="sampled", quadrature_panels=P,
                                 peel_panels=(pp or None), fused=True,
                                 table_peel=peel_mode),
                f"fused table P={P} peel={peel_mode}{pp or ''}")
            dF = np.abs(Ff / Fr - 1.0)
            print(f"  P={P} {peel_mode}{pp or ''}: SED rel delta = {dF}, "
                  f"labs delta = {abs(lf/lr-1):.4%}", flush=True)


if __name__ == "__main__":
    main()
