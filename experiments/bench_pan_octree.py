"""Pan loop on an octree torus via the voxel table (VERDICT r3 #6).

Times a full PanSimulation.run() — stellar phase + emission solve +
dust-emission phase — on the capability-3-class AGN torus octree, with
the traversal on the voxel table (options.voxelize='table' +
fused=True: the fused table kernel through every phase; emission stays
at leaf resolution).  PANO_TABLE=0 runs the leaf-walk baseline.

Target (VERDICT): >=1M pps phase rates with energy conservation <=1%.
"""

import os
import time

import numpy as np

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from skirt_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from skirt_tpu.constants import KPC
from skirt_tpu.engine.lifecycle import LifecycleOptions
from skirt_tpu.engine.pan import PanSimulation
from skirt_tpu.geometry import PointGeometry, TorusGeometry
from skirt_tpu.grids.octree import OctreeGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.log import Log, SilentLog
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization)
from skirt_tpu.media.mix import DustMix
from skirt_tpu.sources.sed import BlackBodySED
from skirt_tpu.sources.stellar import (BolometricLuminosityNormalization,
                                       StellarComponent, StellarSystem)
from skirt_tpu.wavelengths import LogWavelengthGrid


def main():
    table = os.environ.get("PANO_TABLE", "1") == "1"
    packets = 1 << int(os.environ.get("PANO_LOG2N", "17"))
    nlambda = int(os.environ.get("PANO_NLAMBDA", "24"))

    wg = LogWavelengthGrid(0.1e-6, 1000e-6, nlambda)
    star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                            BolometricLuminosityNormalization(1e37))
    ss = StellarSystem([star])
    torus = TorusGeometry(1.0, 2.0, 0.7, 0.05 * KPC, 2 * KPC)
    half = 2.2 * KPC
    extent = (-half, -half, -half, half, half, half)

    def rho_np(pos):
        return np.asarray(torus.density(pos))

    grid = OctreeGrid(extent, rho_np, min_level=2, max_level=5)
    lam = wg.lambdav
    kappa = 2600.0 * (0.55e-6 / lam) ** 1.0
    kappa = np.minimum(kappa, 2.0e4)
    albedo = np.where(lam < 3e-6, 0.5, 0.1)
    mix = DustMix(wg, kappa * (1 - albedo), kappa * albedo,
                  np.full(nlambda, 0.4))
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", 0.55e-6, 5.0))
    dsys = DustSystem(grid, [comp], samples_per_cell=8)
    # azimuth off the lattice plane: a point source at the exact grid
    # center with an azimuth-0 observer makes the direct-flux peel ray
    # ride the y=0 lattice plane, where octree vs Cartesian locate
    # tie-break to opposite sides of the MC-sampled field (measured
    # 14% tau knife-edge; ROADMAP round-4 item B)
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2,
                         azimuth=0.7)]

    if table:
        opts = LifecycleOptions(store_absorption=True,
                                deposition="sampled", fused=True,
                                voxelize="table", quadrature_panels=16,
                                table_peel="exact", max_scatt_events=64,
                                polychromatic=os.environ.get(
                                    "PANO_POLY", "1") == "1",
                                refill_batches=int(
                                    os.environ.get("PANO_REFILL", "64")))
    else:
        opts = LifecycleOptions(store_absorption=True, deposition="path",
                                max_scatt_events=64)

    def build():
        return PanSimulation(stellar_system=ss, instruments=ins,
                             dust_system=dsys, packets=packets,
                             self_absorption=os.environ.get(
                                 "PANO_SA", "0") == "1",
                             log=SilentLog(), batch_size=packets,
                             options=opts, seed=4357)

    sim = build()
    print(f"octree {grid.ncells} leaves; traversal grid "
          f"{type(sim.grid).__name__} ({sim.grid.ncells} cells); "
          f"table={getattr(sim.dust_system, 'table', False)}", flush=True)
    t0 = time.perf_counter()
    acc = sim.run()
    dt_cold = time.perf_counter() - t0
    # warm rerun in-process: the steady-state number
    sim2 = build()
    t0 = time.perf_counter()
    acc = sim2.run()
    dt = time.perf_counter() - t0
    total_packets = packets * nlambda * 2  # stellar + dust phases
    F = np.asarray(acc["instruments"][0]["Ftot"], np.float64)
    ls = float(np.asarray(acc["labs_stellar"]).sum())
    ld = float(np.asarray(acc["labs_dust"]).sum())
    print(f"pan-octree table={table}: {total_packets/dt:,.0f} packets/s "
          f"warm ({dt:.1f}s; cold incl. compile {dt_cold:.1f}s); "
          f"detected {F.sum():.4e} W on 1e37 W "
          f"({(F.sum()/1e37-1)*100:+.2f}%); "
          f"labs_stellar {ls:.4e} labs_dust {ld:.4e} "
          f"(detected+absorbed {(F.sum()+ls)/1e37:.4f})", flush=True)


if __name__ == "__main__":
    main()
