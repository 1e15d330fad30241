"""Slab-decomposed lifecycle scaling on the 8-virtual-CPU-device mesh.

Fixed TOTAL work (packets and grid), D = 1/2/4/8 x-slabs: measures
packets/s and per-device Labs shard size.  Virtual CPU devices share
one host, so the timing shows the decomposition's compute overhead and
collective count, NOT interconnect bandwidth — the device number needs
a multi-card run (ROADMAP).  Run:

XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python experiments/scaling_virtual.py
"""

import os
import time

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from skirt_tpu import rng
from skirt_tpu.constants import KPC
from skirt_tpu.engine.lifecycle import LifecycleOptions
from skirt_tpu.geometry import ExpDiskGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             OpticalDepthNormalization, SimpleOligoDustMix)
from skirt_tpu.parallel import make_slab_lifecycle
from skirt_tpu.parallel.slab import SLAB_AXIS
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid
from jax.sharding import Mesh


def main():
    wg = OligoWavelengthGrid([0.5e-6, 1.0e-6])
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36, 1e36])])
    half = 12 * KPC
    nc = 32
    b = np.linspace(-half, half, nc + 1)
    bz = np.linspace(-2 * KPC, 2 * KPC, nc // 2 + 1)
    grid = CartesianGrid(b, b, bz)
    mix = SimpleOligoDustMix(wg, [2600.0] * 2, [0.6] * 2, [0.5] * 2)
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    dsys = DustSystem(grid, [comp], samples_per_cell=2)
    n = 1 << int(os.environ.get("SCALE_LOG2N", "13"))
    ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
    L0 = jnp.full((n,), 1e36 / n, jnp.float32)
    opts = LifecycleOptions(store_absorption=True, max_scatt_events=32)

    base = None
    print(f"packets={n}, grid={nc}x{nc}x{nc//2} "
          f"({grid.ncells} cells x 2 lambda)")
    exchange = os.environ.get("SCALE_EXCHANGE", "allgather")
    if exchange == "migrate":
        # the migrating engine needs sampled deposition
        opts = LifecycleOptions(store_absorption=True, max_scatt_events=32,
                                deposition="sampled", quadrature_panels=16)
    elif exchange == "fused":
        # the slab-fused engine runs the fused table event per device on
        # a table dust system
        dsys = dsys.as_table()
        opts = LifecycleOptions(
            store_absorption=True, max_scatt_events=32,
            deposition="sampled", quadrature_panels=16, peel_panels=16,
            fused=True, table_peel="exact",
            refill_batches=int(os.environ.get("SCALE_REFILL", "0")))
    # SCALE_WEAK=1: fixed PER-DEVICE work (n lanes per device) — the
    # pod-scaling proxy: per-device throughput retention as D grows
    weak = os.environ.get("SCALE_WEAK", "0") == "1"
    for D in (1, 2, 4, 8):
        devs = jax.devices()[:D]
        if len(devs) < D:
            print(f"D={D}: not enough devices")
            continue
        if weak:
            nD = n * D
            ellD = jnp.asarray(np.arange(nD, dtype=np.int32) % 2)
            L0D = jnp.full((nD,), 1e36 / nD, jnp.float32)
        else:
            nD, ellD, L0D = n, ell, L0
        mesh = Mesh(np.asarray(devs), (SLAB_AXIS,))
        run = make_slab_lifecycle(mesh, grid, dsys, ss,
                                  [SEDInstrument("sed", 3.08e23, 2)],
                                  opts, 2, exchange=exchange)
        out = run(rng.root_key(2), ellD, L0D)
        float(np.asarray(out["labs"]).sum())
        t0 = time.perf_counter()
        out = run(rng.root_key(3), ellD, L0D)
        tot = float(np.asarray(out["labs"]).sum())
        dt = time.perf_counter() - t0
        if base is None:
            base = dt
        # virtual devices SHARE one host: D x total work at fixed
        # per-device lanes costs ~D x wall even for perfect parallel
        # code, so the honest weak metric here is the overhead beyond
        # that (ring hops + collectives): dt / (base * D).  On real
        # chips the D x compute runs concurrently and only the overhead
        # term remains.
        print(f"D={D} [{exchange}{' weak' if weak else ''}]: "
              f"{nD/dt:10,.0f} packets/s  ({dt:.2f}s)  "
              f"Labs shard = {grid.ncells*2//D} bins/device  "
              f"rel-time x{dt/base:.2f}"
              + (f"  overhead-vs-shared-host-ideal x{dt/(base*D):.2f}"
                 if weak else "")
              + f"  labs={tot:.3e}")


if __name__ == "__main__":
    main()
