"""Timed 1e7-packet-class panchromatic disc run (driver accuracy config).

Full PanSimulation with the 3-stage self-absorption convergence loop
(ref: PanMonteCarloSimulation.cpp:106-183) on the 24-wavelength analytic
disc: 2^19 packets per wavelength per phase (12.6M per full-strength
phase — the 1e7-packet class of BASELINE.json's accuracy target).

PAN_FULL_LOG2N / PAN_FULL_NLAMBDA env overrides.
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
from skirt_tpu.log import Log
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization)
from skirt_tpu.media.mix import DustMix
from skirt_tpu.sources.sed import BlackBodySED
from skirt_tpu.sources.stellar import (BolometricLuminosityNormalization,
                                       StellarComponent, StellarSystem)
from skirt_tpu.wavelengths import LogWavelengthGrid


def main():
    packets = 1 << int(os.environ.get("PAN_FULL_LOG2N", "19"))
    nlambda = int(os.environ.get("PAN_FULL_NLAMBDA", "24"))

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
    kappa = np.minimum(2600.0 * (0.55e-6 / lam) ** 1.0, 2.0e4)
    albedo = np.where(lam < 3e-6, 0.5, 0.1)
    mix = DustMix(wg, kappa * (1 - albedo), kappa * albedo,
                  np.full(nlambda, 0.4))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", 0.55e-6, 1.0))
    dsys = DustSystem(grid, [comp], density_mode="analytic")
    ins = [SEDInstrument("sed", 3.08e23, nlambda, inclination=1.2)]
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=32, max_scatt_events=64,
                            peel_panels=8, refill_batches=128, fused=True)
    sim = PanSimulation(stellar_system=ss, instruments=ins,
                        dust_system=dsys, packets=packets,
                        self_absorption=True, log=Log(),
                        batch_size=min(packets, 1 << 19), options=opts,
                        dispatch_batches=1)
    t0 = time.perf_counter()
    acc = sim.run()
    dt = time.perf_counter() - t0
    F = float(np.asarray(acc["instruments"][0]["Ftot"]).sum())
    Ld = float(np.asarray(acc["labs_dust"]).sum())
    print(f"pan full (self-absorption, {packets} packets/lambda, "
          f"{nlambda} lambdas): {dt:.1f}s wall incl. compile; "
          f"Ftot={F:.4e} W (source 1e37), Labs_dust={Ld:.3e} W",
          flush=True)


if __name__ == "__main__":
    main()
