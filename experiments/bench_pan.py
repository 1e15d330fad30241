"""Panchromatic dust-loop throughput (capability config 2 class).

Times a full PanSimulation.run() — stellar phase + emission-spectrum
solve + dust-emission phase — on the flagship-style analytic disc, with
and without the fused event megakernel (PAN_FUSED=0/1), at PAN_LOG2N
packets per wavelength.
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
from skirt_tpu.geometry import ExpDiskGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.log import SilentLog
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization)
from skirt_tpu.media.mix import DustMix
from skirt_tpu.sources.sed import BlackBodySED
from skirt_tpu.sources.stellar import (BolometricLuminosityNormalization,
                                       StellarComponent, StellarSystem)
from skirt_tpu.wavelengths import LogWavelengthGrid


def main():
    fused = os.environ.get("PAN_FUSED", "1") == "1"
    packets = 1 << int(os.environ.get("PAN_LOG2N", "17"))
    nlambda = int(os.environ.get("PAN_NLAMBDA", "24"))

    wg = LogWavelengthGrid(0.1e-6, 1000e-6, nlambda)
    star = StellarComponent(ExpDiskGeometry(4 * KPC, 0.35 * KPC),
                            BlackBodySED(wg, 6000.0),
                            BolometricLuminosityNormalization(1e37))
    ss = StellarSystem([star])
    half = 12 * KPC
    b = np.linspace(-half, half, 33)
    bz = np.linspace(-2 * KPC, 2 * KPC, 17)
    grid = CartesianGrid(b, b, bz)
    lam = wg.lambdav
    # ISM-like opacity: opaque UV/optical, transparent far-IR
    kappa = 2600.0 * (0.55e-6 / lam) ** 1.0
    kappa = np.minimum(kappa, 2.0e4)
    albedo = np.where(lam < 3e-6, 0.5, 0.1)
    mix = DustMix(wg, kappa * (1 - albedo), kappa * albedo,
                  np.full(nlambda, 0.4))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", 0.55e-6, 1.0))
    dsys = DustSystem(grid, [comp], density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2)]
    refill = int(os.environ.get("PAN_REFILL", "128"))
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=32, max_scatt_events=64,
                            peel_panels=int(os.environ.get("PAN_PEEL", "8"))
                            or None,
                            polychromatic=os.environ.get(
                                "PAN_POLY", "1") == "1",
                            refill_batches=refill, fused=fused)
    sim = PanSimulation(stellar_system=ss, instruments=ins,
                        dust_system=dsys, packets=packets,
                        self_absorption=False, log=SilentLog(),
                        batch_size=packets, options=opts,
                        dispatch_batches=1)

    t0 = time.perf_counter()
    acc = sim.run()
    dt_cold = time.perf_counter() - t0
    # the first run is compile-dominated; the warm second run is the
    # steady-state number
    t0 = time.perf_counter()
    acc = sim.run()
    dt = time.perf_counter() - t0
    total_packets = packets * nlambda * 2  # stellar + dust emission phase
    F = acc["instruments"][0]["Ftot"]
    print(f"pan fused={fused} refill={refill}: {total_packets/dt:,.0f} "
          f"packets/s warm ({dt:.1f}s; cold incl. compile {dt_cold:.1f}s); "
          f"Ftot={F.sum():.3e} W", flush=True)


if __name__ == "__main__":
    main()
