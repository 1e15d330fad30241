"""Config-4 accuracy: fused/poly table mode vs the exact voxel DDA walk
on the Voronoi uniform-sphere harness (the bench_voronoi.py model).

Reference chain: the 47^3 rasterized Voronoi sphere traced with the
exact Cartesian DDA (reference-exact estimators).  Candidates: the
fused table kernel and the polychromatic kernel at several panel
counts — validates the per-model P floor the bench defaults use
(the octree torus needs P=16; the smoother sphere may admit P=12).

VORONOI_SITES (4096), ACC_LOG2N (18), ACC_PANELS ("12,16").
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
from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
from skirt_tpu.grids.voronoi import VoronoiGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.media import (DustComponent, DustMassNormalization,
                             DustSystem, SimpleOligoDustMix)
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid


def main():
    nsites = int(os.environ.get("VORONOI_SITES", "4096"))
    half = 2.0 * KPC
    extent = (-half, -half, -half, half, half, half)
    rs = np.random.default_rng(3)
    sites = rs.uniform(-0.98 * half, 0.98 * half, size=(nsites, 3))
    grid = VoronoiGrid(sites, extent, volume_samples=32)

    # ACC_NLAM>2: the bench_voronoi.py production-width mix (log-spaced
    # wavelengths, power-law-interpolated optics)
    nlam = int(os.environ.get("ACC_NLAM", "2"))
    lams = np.geomspace(0.55e-6, 2.2e-6, nlam)
    fpl = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlam)])
    sphere = UniformSphereGeometry(1.8 * KPC)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                             list(0.5 + (0.4 - 0.5) * fpl),
                             list(0.4 + (0.2 - 0.4) * fpl))
    mass = 2.0 / 2600.0 * (4 / 3 * np.pi * (1.8 * KPC) ** 3) / (1.8 * KPC)
    comp = DustComponent(sphere, mix, DustMassNormalization(mass))
    dsys = DustSystem(grid, [comp], density_mode="gridded")
    vds, _fold = dsys.voxelized(max_voxels=47 ** 3)
    print(f"voxelized: {vds.grid.nx}^3", flush=True)
    ins = [SEDInstrument("sed", 3.08e23, nlam, inclination=1.2)]

    n = 1 << int(os.environ.get("ACC_LOG2N", "18"))
    nbatch = max(1, n >> 17)
    nb = n // nbatch
    key = rng.root_key(4357)

    def run_chain(dsys_c, grid_c, opts, tag, poly=False):
        run = jax.jit(make_lifecycle(grid_c, dsys_c, ss, ins, opts, nlam))
        t = {"instruments": [ins[0].zero_tallies()],
             "labs": jnp.zeros((grid_c.ncells * nlam,), jnp.float32)}
        if poly:
            npl = nb // nlam
            ellc = jnp.zeros((npl,), jnp.int32)
            # per-lambda totals match the mono chain: n/nlam packets per
            # lambda at L0 = nlam*1e36/n each
            L0c = jnp.full((npl, nlam), nlam * 1e36 / n, jnp.float32)
        else:
            ellc = jnp.asarray(np.arange(nb, dtype=np.int32) % nlam)
            L0c = jnp.full((nb,), nlam * 1e36 / n, jnp.float32)
        t0 = time.perf_counter()
        for b in range(nbatch):
            t = run(jax.random.fold_in(key, b), ellc, L0c, t)
        F = np.asarray(t["instruments"][0]["Ftot"], np.float64)
        labs = float(np.asarray(t["labs"], np.float64).sum())
        print(f"{tag}: F={F} labs={labs:.4e} "
              f"({time.perf_counter()-t0:.1f}s)", flush=True)
        return F, labs

    if os.environ.get("ACC_DIRECT", "0") == "1":
        # direct-table mode validation: candidates run the panel
        # quadrature on the EXACT tessellation, so the reference is the
        # exact bisector-plane crossing walk on the same field (not the
        # rasterized voxel view)
        Fr, lr = run_chain(dsys, grid,
                           LifecycleOptions(store_absorption=True,
                                            max_scatt_events=64,
                                            deposition="path"),
                           "exact tessellation walk (path est.)")
        tdir = dsys.as_table()
        for P in [int(p) for p in
                  os.environ.get("ACC_PANELS", "16").split(",")]:
            for poly in (False, True):
                Ff, lf = run_chain(
                    tdir, grid,
                    LifecycleOptions(store_absorption=True,
                                     max_scatt_events=64,
                                     deposition="sampled",
                                     quadrature_panels=P,
                                     peel_panels=int(os.environ.get(
                                         "ACC_PEELP", "32")),
                                     fused=True, polychromatic=poly,
                                     table_peel="staged"),
                    f"{'poly' if poly else 'mono'} DIRECT P={P}",
                    poly=poly)
                dF = np.abs(Ff / Fr - 1.0)
                print(f"  DIRECT P={P} poly={poly}: SED rel delta = {dF},"
                      f" labs delta = {abs(lf/lr-1):.4%}", flush=True)
        return

    Fr, lr = run_chain(vds, vds.grid,
                       LifecycleOptions(store_absorption=True,
                                        max_scatt_events=64,
                                        deposition="path"),
                       "exact voxel DDA (path est.)")

    tds = vds.as_table()
    for P in [int(p) for p in
              os.environ.get("ACC_PANELS", "12,16").split(",")]:
        for poly in (False, True):
            Ff, lf = run_chain(
                tds, tds.grid,
                LifecycleOptions(store_absorption=True, max_scatt_events=64,
                                 deposition="sampled", quadrature_panels=P,
                                 fused=True, polychromatic=poly,
                                 table_peel="exact"),
                f"{'poly' if poly else 'mono'} table P={P}", poly=poly)
            dF = np.abs(Ff / Fr - 1.0)
            print(f"  P={P} poly={poly}: SED rel delta = {dF}, "
                  f"labs delta = {abs(lf/lr-1):.4%}", flush=True)


if __name__ == "__main__":
    main()
