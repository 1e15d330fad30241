"""Honest octree-grid lifecycle throughput (capability config 3 class).

The octree uses the streaming traversal sweep (top-down re-descend per
step) — gather-bound.  This records the honest number for BASELINE.md.
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
    # OCTREE_NLAM>2 (production panchromatic regime): log-spaced
    # wavelengths with power-law-interpolated optics — the fused table
    # kernel's gathers are lambda-independent so per-lambda packets ride
    # the same descriptors
    nlam = int(os.environ.get("OCTREE_NLAM", "2"))
    lams = np.geomspace(0.55e-6, 2.2e-6, nlam)
    fpl = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlam)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    extent = (-half, -half, -half, half, half, half)

    def rho_np(pos):
        return np.asarray(torus.density(pos))

    # OCTREE_WALK=neighbor: the reference's Neighbor search method (baked
    # face rows, one row gather per step) instead of the root re-descend
    grid = OctreeGrid(extent, rho_np, min_level=2, max_level=5,
                      traversal=os.environ.get("OCTREE_WALK", "redescend"))
    print(f"octree: {grid.ncells} cells, max_steps={grid.max_steps}",
          flush=True)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                             list(0.5 + (0.4 - 0.5) * fpl),
                             list(0.4 + (0.2 - 0.4) * fpl))
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], 5.0))
    # Defaults are the ACCURACY-VALIDATED headline configuration measured
    # in BASELINE.md (fused table kernel, P_prop=16, exact column-DDA
    # peel, refill K=128, absorption on): plain `python bench_octree.py`
    # reproduces both the quoted throughput and the validated flux.
    # Override any knob via env (OCTREE_MODE=gridded OCTREE_TABLE=0 ...
    # for the exact leaf-walk reference mode).
    dmode = os.environ.get("OCTREE_MODE", "gridded")
    table = os.environ.get("OCTREE_TABLE", "1") == "1"
    fused = os.environ.get("OCTREE_FUSED", "1" if table else "0") == "1"
    store_abs = os.environ.get("OCTREE_ABS",
                               "1" if table else
                               ("0" if fused else "1")) == "1"
    voxel = os.environ.get("OCTREE_VOXEL", "0") == "1"
    fast_peel = os.environ.get("OCTREE_PEEL", "0") == "1"
    dsys = DustSystem(grid, [comp], samples_per_cell=8, density_mode=dmode)
    fold = None
    if voxel or table:
        # exact uniform-voxel view: Cartesian DDA instead of the tree walk
        dsys, fold = dsys.voxelized()
        grid = dsys.grid
        print(f"voxelized: {grid.nx}x{grid.ny}x{grid.nz}", flush=True)
    if table:
        # panel-sampled table densities (gathers at panel midpoints)
        dsys = dsys.as_table()
        dmode = "table"
    ins = [SEDInstrument("sed", 3.08e23, nlam, inclination=1.2)]
    n = 1 << int(os.environ.get("OCTREE_LOG2N", "15"))
    sim_mode = os.environ.get("OCTREE_SIM", "0") == "1"
    if sim_mode:
        # driver-level timing: auto-voxelize + survivor compaction +
        # dispatch folding, i.e. what `OligoSimulation.run` actually does
        from skirt_tpu.engine.simulation import OligoSimulation
        from skirt_tpu.log import SilentLog
        comp_k = int(os.environ.get("OCTREE_COMPACT", "8"))
        opts = LifecycleOptions(store_absorption=store_abs,
                                max_scatt_events=64,
                                deposition=("sampled" if dmode == "analytic"
                                            else "path"),
                                fast_peeloff=fast_peel)
        sim = OligoSimulation(stellar_system=ss, instruments=ins,
                              dust_system=dsys, packets=n,
                              batch_size=min(n, 1 << 17),
                              options=opts, log=SilentLog(),
                              compaction_iterations=comp_k)
        key = rng.root_key(4357)
        acc = sim._run_phase(key, phase_tag=0)   # warm-up/compile
        t0 = time.perf_counter()
        acc = sim._run_phase(jax.random.fold_in(key, 1), phase_tag=0)
        dt = time.perf_counter() - t0
        print(f"octree driver (mode={dmode} voxel=auto compact={comp_k} "
              f"peel={fast_peel}): {n / dt:,.0f} packets/s "
              f"({dt:.2f}s per {n} packets)", flush=True)
        return
    poly = os.environ.get("OCTREE_POLY", "1") == "1"
    refill = int(os.environ.get("OCTREE_REFILL",
                                 ("256" if poly else "128")
                                 if table else "0"))
    opts = LifecycleOptions(store_absorption=store_abs, max_scatt_events=64,
                            polychromatic=poly,
                            deposition=("sampled" if dmode in ("analytic",
                                                               "table")
                                        else "path"),
                            quadrature_panels=(
                                int(os.environ.get(
                                    "OCTREE_PANELS",
                                    "16" if table else "32"))
                                if (fused or table) else None),
                            peel_panels=(
                                int(os.environ.get("OCTREE_PEELP", "32"))
                                if table else None),
                            fast_peeloff=fast_peel,
                            table_peel=os.environ.get("OCTREE_PEELMODE",
                                                      "exact"),
                            refill_batches=refill,
                            fused=fused)
    run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, nlam))

    n = 1 << int(os.environ.get("OCTREE_LOG2N", "17" if table else "15"))
    if poly:
        # every lane carries ALL wavelengths: packets = n * K * nlambda,
        # per-wavelength launch totals match the monochromatic run
        npackets = n * max(refill, 1) * nlam
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n, nlam), 1e36 / (n * max(refill, 1)), jnp.float32)
    else:
        npackets = n * max(refill, 1)
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % nlam)
        L0 = jnp.full((n,), 1e36 / npackets, jnp.float32)

    def tallies():
        t = {"instruments": [i.zero_tallies() for i in ins]}
        if store_abs:
            t["labs"] = jnp.zeros((grid.ncells * nlam,), jnp.float32)
        return t

    key = rng.root_key(4357)
    out = run(key, ell, L0, tallies())
    _sync(out)
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        out = run(jax.random.fold_in(key, 1 + rep), ell, L0, tallies())
        _sync(out)
        dt = min(dt, time.perf_counter() - t0)
    print(f"octree lifecycle (mode={dmode} fused={fused} abs={store_abs} "
          f"voxel={voxel} peel={fast_peel} refill={refill} poly={poly}): "
          f"{npackets / dt:,.0f} packets/s "
          f"({dt:.2f}s per {npackets} packets)", flush=True)


if __name__ == "__main__":
    main()
