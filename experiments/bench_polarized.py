"""Polarized flagship throughput: fused megakernel vs the vector path.

The round-3 engine ran Mueller physics only on the unfused vector path
(forfeiting the 30-60x fused gain); round 4 puts the Stokes machinery
XLA-side around the unchanged fused kernel.  Flagship-style dusty disc
with a polarizing (Thomson) mix, FullInstrument with polarization.

POL_FUSED=0/1, POL_LOG2N (17), POL_REFILL (64 fused / 0 vector).
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
from skirt_tpu.geometry import ExpDiskGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import FullInstrument, SEDInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization, SimpleOligoDustMix)
from skirt_tpu.media.polarization import thomson_mueller
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid


def _sync(o):
    return jax.block_until_ready(o)


def main():
    fused = os.environ.get("POL_FUSED", "1") == "1"
    table = os.environ.get("POL_TABLE", "0") == "1"
    poly = os.environ.get("POL_POLY", "0") == "1" and table
    nlam = int(os.environ.get("POL_NLAM", "2"))
    n = 1 << int(os.environ.get("POL_LOG2N", "17"))
    refill = int(os.environ.get("POL_REFILL", "64" if fused else "0"))

    lams = np.geomspace(0.55e-6, 2.2e-6, nlam)
    fpl = np.log(lams / 0.55e-6) / np.log(2.2 / 0.55)
    wg = OligoWavelengthGrid(list(lams))
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nlam)])
    half = 12 * KPC
    b = np.linspace(-half, half, 33)
    bz = np.linspace(-2 * KPC, 2 * KPC, 17)
    grid = CartesianGrid(b, b, bz)
    mix = SimpleOligoDustMix(wg, list(2600.0 * (600.0 / 2600.0) ** fpl),
                             list(0.5 + (0.4 - 0.5) * fpl),
                             list(0.4 + (0.2 - 0.4) * fpl))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    if table:
        # POL_TABLE=1: polarized fused TABLE chain (config-3 class) — an
        # octree AGN torus voxelized to the uniform table (round-5)
        from skirt_tpu.geometry import PointGeometry, TorusGeometry
        from skirt_tpu.grids.octree import OctreeGrid
        torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
        half3 = 2.2 * KPC
        grid = OctreeGrid((-half3,) * 3 + (half3,) * 3,
                          lambda p: np.asarray(torus.density(p)),
                          min_level=2, max_level=5)
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1e36] * nlam)])
        comp = DustComponent(torus, mix,
                             OpticalDepthNormalization("x",
                                                       wg.lambdav[0],
                                                       5.0))
        dsys = DustSystem(grid, [comp], samples_per_cell=8)
        dsys, _fold = dsys.voxelized()
        dsys = dsys.as_table()
        grid = dsys.grid
    else:
        dsys = DustSystem(grid, [comp], density_mode="analytic")
    mueller = thomson_mueller(nlam)
    # azimuth off the lattice plane: an azimuth-0 observer of a
    # grid-center point source rides the y=0 knife edge (ROADMAP r4 B)
    az = float(os.environ.get("POL_AZ", "0.7" if table else "0.0"))
    ins = [FullInstrument("pol", 3.08e23, nlam, 16, 16, fov_x=26 * KPC,
                          fov_y=26 * KPC, inclination=1.2, azimuth=az,
                          polarization=True),
           SEDInstrument("sed", 3.08e23, nlam, inclination=1.2,
                         azimuth=az)]

    opts = LifecycleOptions(max_scatt_events=64, deposition="sampled",
                            quadrature_panels=(16 if table else 32),
                            peel_panels=int(os.environ.get("POL_PEELP", "8")),
                            table_peel="exact", polychromatic=poly,
                            fused=fused, refill_batches=refill)
    run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, nlam,
                                 mueller=mueller))
    K = max(refill, 1)
    if poly:
        npackets = n * K * nlam
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n, nlam), 1e36 / (n * K), jnp.float32)
    else:
        npackets = n * K
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % nlam)
        L0 = jnp.full((n,), 1e36 / npackets, jnp.float32)

    def tallies():
        return {"instruments": [i.zero_tallies() for i in ins]}

    key = rng.root_key(4357)
    out = run(key, ell, L0, tallies())
    _sync(out)
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        out = run(jax.random.fold_in(key, 1 + rep), ell, L0, tallies())
        _sync(out)
        dt = min(dt, time.perf_counter() - t0)
    t = out["instruments"][0]
    F = float(np.asarray(t["Ftot"]).sum())
    P = np.hypot(float(np.asarray(t["FQ"])[0]),
                 float(np.asarray(t["FU"])[0]))
    kind = ("octree-table-poly" if poly else
            "octree-table" if table else "flagship")
    print(f"polarized {kind} fused={fused} refill={refill}: "
          f"{npackets / dt:,.0f} packets/s ({dt:.2f}s per {npackets}); "
          f"Ftot={F:.4e} |P0|={P:.3e}", flush=True)


if __name__ == "__main__":
    main()
