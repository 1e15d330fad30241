"""Voronoi-grid lifecycle throughput: gridded sweep vs analytic panels.

Gridded Voronoi traversal is the worst case for a batched engine
(sequential bisector-plane stepping, dependent gathers per step).  With
device point location (locate_batched: matmul distance scan / block
candidates) the grid
qualifies for the analytic panel fast path, which needs only the ray box
span plus two (N,)-sized locates per event.

VORONOI_MODE=gridded|analytic, VORONOI_SITES, VORONOI_LOG2N env overrides.
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


def _sync(o):
    return jax.block_until_ready(o)


def main():
    nsites = int(os.environ.get("VORONOI_SITES", "4096"))
    direct_mode = os.environ.get("VORONOI_DIRECT", "0") == "1"
    # headline default: table mode rides the voxelized GRIDDED density
    mode = os.environ.get("VORONOI_MODE",
                          "gridded" if os.environ.get("VORONOI_TABLE",
                                                      "1") == "1"
                          else "analytic")
    n = 1 << int(os.environ.get("VORONOI_LOG2N",
                                ("16" if direct_mode else "17")
                                if os.environ.get("VORONOI_TABLE",
                                                  "1") == "1"
                                else "15"))

    half = 2.0 * KPC
    extent = (-half, -half, -half, half, half, half)
    rs = np.random.default_rng(3)
    sites = rs.uniform(-0.98 * half, 0.98 * half, size=(nsites, 3))
    t0 = time.perf_counter()
    grid = VoronoiGrid(sites, extent, volume_samples=32)
    print(f"voronoi: {nsites} sites built in {time.perf_counter()-t0:.1f}s "
          f"(native={grid.used_native}), max_steps={grid.max_steps}",
          flush=True)

    # VORONOI_NLAM>2 (direct-table poly production regime): log-spaced
    # wavelengths with power-law-interpolated optical properties — the
    # gather budget is lambda-independent, so per-lambda packets ride
    # free on the same panel/locate descriptors
    nlam = int(os.environ.get("VORONOI_NLAM", "2"))
    lams = np.geomspace(0.55e-6, 2.2e-6, nlam)
    f = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlam)])
    sphere = UniformSphereGeometry(1.8 * KPC)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** f),
                             list(0.5 + (0.4 - 0.5) * f),
                             list(0.4 + (0.2 - 0.4) * f))
    mass = 2.0 / (2600.0) * (4 / 3 * np.pi * (1.8 * KPC) ** 3) / (1.8 * KPC)
    comp = DustComponent(sphere, mix, DustMassNormalization(mass))
    dsys = DustSystem(grid, [comp], density_mode=mode)
    table = os.environ.get("VORONOI_TABLE", "1") == "1"
    direct = os.environ.get("VORONOI_DIRECT", "0") == "1"
    if (os.environ.get("VORONOI_VOXEL", "0") == "1" or table) and not direct:
        # default 47 ~ 3*ncells^(1/3): the validated headline resolution
        # (matches the reference's search-block heuristic,
        # VoronoiMesh.cpp:314); 0 = the ~8 voxels/cell-axis auto default
        res = int(os.environ.get("VORONOI_RES", "47"))
        mv = res ** 3 if res else 1 << 24
        dsys, _fold = dsys.voxelized(max_voxels=mv)
        grid = dsys.grid
        print(f"voxelized: {grid.nx}^3", flush=True)
    if table:
        # direct=1: panel table quadrature on the EXACT tessellation
        # (point location at panel midpoints), no rasterization
        dsys = dsys.as_table()
        mode = "table-direct" if direct else "table"
    ins = [SEDInstrument("sed", 3.08e23, nlam, inclination=1.2)]
    fused = os.environ.get("VORONOI_FUSED",
                           "1" if table else "0") == "1"
    # direct mode runs the EXACT tessellation; poly lanes ride it too
    # (the kernel emits deposit distance+wavelength, the lifecycle
    # locates the bin on the tessellation)
    poly = os.environ.get("VORONOI_POLY", "1") == "1"
    refill = int(os.environ.get("VORONOI_REFILL",
                                 ("32" if direct else
                                  "256" if poly else "128")
                                 if table else "0"))
    opts = LifecycleOptions(store_absorption=True, max_scatt_events=64,
                            polychromatic=poly,
                            deposition=("sampled" if (table or mode ==
                                                      "analytic")
                                        else "path"),
                            quadrature_panels=(
                                int(os.environ.get("VORONOI_PANELS", "16"))
                                if table else None),
                            peel_panels=(
                                int(os.environ.get("VORONOI_PEELP", "32"))
                                if table else None),
                            table_peel=os.environ.get("VORONOI_PEELMODE",
                                                      "exact"),
                            refill_batches=refill, fused=fused)
    run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, nlam))

    if poly:
        npackets = n * max(refill, 1) * nlam
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n, nlam), 1e36 / (n * max(refill, 1)), jnp.float32)
    else:
        npackets = n * max(refill, 1)
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % nlam)
        L0 = jnp.full((n,), 1e36 / npackets, jnp.float32)

    def tallies():
        return {"instruments": [i.zero_tallies() for i in ins],
                "labs": jnp.zeros((grid.ncells * nlam,), jnp.float32)}

    key = rng.root_key(4357)
    out = run(key, ell, L0, tallies())
    _sync(out)
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        out = run(jax.random.fold_in(key, 1 + rep), ell, L0, tallies())
        _sync(out)
        dt = min(dt, time.perf_counter() - t0)
    print(f"voronoi {mode} lifecycle (fused={fused} refill={refill} "
          f"poly={poly}): "
          f"{npackets / dt:,.0f} packets/s "
          f"({dt:.2f}s per {npackets} packets)", flush=True)


if __name__ == "__main__":
    main()
