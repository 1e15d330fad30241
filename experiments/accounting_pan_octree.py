"""Per-event accounting for the pan-on-octree rate (VERDICT r4 #6).

The AGN-torus PAN configuration (24 log wavelengths 0.1-1000 um,
tau(0.1um) = 27.5) runs far fewer packets/s than the 2-wavelength oligo
torus bench on the SAME fused table kernel.  This experiment pins the
gap to physics vs engineering by instrumenting the kernel loop
(options.count_events): for each configuration it reports

    packets/s  =  events/s  x  packets/event

where events/s is the kernel's event-processing rate (the engineering
number — should match across configurations) and packets/event = 1 /
(events/packet) is set by the optical depth (the physics number).

Best-of-N with the spread printed (VERDICT asked <= 1.3x).
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
from skirt_tpu.geometry import PointGeometry, TorusGeometry
from skirt_tpu.grids.octree import OctreeGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization)
from skirt_tpu.media.mix import DustMix
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import LogWavelengthGrid, OligoWavelengthGrid


def _sync(o):
    return jax.block_until_ready(o)


def run_case(tag, wg, kappa, albedo, gg, n, refill, tau_x):
    nlam = wg.nlambda
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36] * nlam)])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC

    def rho_np(pos):
        return np.asarray(torus.density(pos))

    grid = OctreeGrid((-half,) * 3 + (half,) * 3, rho_np,
                      min_level=2, max_level=5)
    mix = DustMix(wg, kappa * (1 - albedo), kappa * albedo, gg)
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0],
                                                   tau_x))
    dsys = DustSystem(grid, [comp], samples_per_cell=8)
    vds, _ = dsys.voxelized()
    tds = vds.as_table()
    ins = [SEDInstrument("sed", 3.08e23, nlam, inclination=1.2,
                         azimuth=0.7)]
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=16, table_peel="exact",
                            max_scatt_events=64, fused=True,
                            polychromatic=True,
                            refill_batches=refill, count_events=True)
    run = jax.jit(make_lifecycle(tds.grid, tds, ss, ins, opts, nlam))
    ell = jnp.zeros((n,), jnp.int32)
    L0 = jnp.full((n, nlam), 1e36 / (n * refill), jnp.float32)

    def tallies():
        return {"instruments": [i.zero_tallies() for i in ins],
                "labs": jnp.zeros((tds.grid.ncells * nlam,), jnp.float32)}

    key = rng.root_key(4357)
    out = run(key, ell, L0, tallies())
    _sync(out)
    dts = []
    for rep in range(4):
        t0 = time.perf_counter()
        out = run(jax.random.fold_in(key, 1 + rep), ell, L0, tallies())
        _sync(out)
        dts.append(time.perf_counter() - t0)
    dt = min(dts)
    spread = max(dts) / min(dts)
    nev = float(np.asarray(out["nevents"]))
    packets = n * refill * nlam
    lane_packets = n * refill            # geometric paths
    print(f"{tag}: {packets/dt:,.0f} packets/s  "
          f"(best-of-4, spread x{spread:.2f})")
    print(f"  events/lane-packet = {nev/lane_packets:.2f}   "
          f"events/s = {nev/dt:,.0f}   "
          f"packets/event = {packets/nev:.2f}", flush=True)
    return packets / dt, nev / dt, nev / lane_packets


def main():
    n = 1 << int(os.environ.get("ACC_LOG2N", "15"))

    # (a) the 2-wavelength oligo torus bench model (tau_x = 5)
    lams2 = np.geomspace(0.55e-6, 2.2e-6, 2)
    f2 = np.log(lams2 / 0.55e-6) / np.log(2.2 / 0.55)
    wg2 = OligoWavelengthGrid(list(lams2))
    p2, e2, epp2 = run_case(
        "oligo torus 2-lambda (bench_octree model)", wg2,
        2600.0 * (600.0 / 2600.0) ** f2,
        0.5 + (0.4 - 0.5) * f2, 0.4 + (0.2 - 0.4) * f2,
        n, 256, 5.0)

    # (b) the PAN torus model (24 log wavelengths, tau(0.1um) = 27.5
    #     at tau(0.55um) = 5 with the 1/lambda opacity law)
    wg24 = LogWavelengthGrid(0.1e-6, 1000e-6, 24)
    lam = wg24.lambdav
    kappa = np.minimum(2600.0 * (0.55e-6 / lam), 2.0e4)
    albedo = np.where(lam < 3e-6, 0.5, 0.1)
    p24, e24, epp24 = run_case(
        "pan torus 24-lambda (bench_pan_octree model)", wg24,
        kappa, albedo, np.full(24, 0.4), n, 64, 5.0)

    print(f"\nevents/s ratio pan/oligo = {e24/e2:.2f} "
          f"(the engineering number — near 1 means the kernel runs at "
          f"the same event rate)")
    print(f"events/lane-packet ratio = {epp24/epp2:.2f} "
          f"(the physics number — the UV wavelengths' tau drives it)")


if __name__ == "__main__":
    main()
