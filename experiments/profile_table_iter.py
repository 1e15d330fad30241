"""Per-iteration cost breakdown of the XLA table-mode lifecycle.

Times the octree voxel-table config at several max_iterations values:
slope = ms/iteration, intercept = per-batch fixed cost.  Also times the
staging pieces (locate + gather + cums chain) standalone at the same
shapes for comparison.
"""

import time

import numpy as np
import jax


import jax.numpy as jnp
import os
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

    def rho_np(pos):
        return np.asarray(torus.density(pos))

    grid = OctreeGrid(extent, rho_np, min_level=2, max_level=5)
    mix = SimpleOligoDustMix(wg, [2600.0, 600.0], [0.5, 0.4], [0.4, 0.2])
    comp = DustComponent(torus, mix,
                         OpticalDepthNormalization("x", wg.lambdav[0], 5.0))
    dsys = DustSystem(grid, [comp], samples_per_cell=8,
                      density_mode="gridded")
    dsys, fold = dsys.voxelized()
    grid = dsys.grid
    dsys = dsys.as_table()
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2)]
    n = 1 << 17
    ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
    L0 = jnp.full((n,), 1e36 / n, jnp.float32)

    def tallies():
        return {"instruments": [i.zero_tallies() for i in ins],
                "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)}

    key = rng.root_key(4357)
    times = {}
    for iters in (2, 4, 8, 16):
        opts = LifecycleOptions(store_absorption=True, max_scatt_events=64,
                                deposition="sampled", quadrature_panels=32,
                                peel_panels=8)
        run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, 2,
                                     max_iterations=iters))
        out = run(key, ell, L0, tallies())
        _sync(out)
        t0 = time.perf_counter()
        out = run(jax.random.fold_in(key, 1), ell, L0, tallies())
        _sync(out)
        dt = time.perf_counter() - t0
        times[iters] = dt
        print(f"iters={iters:3d}: {dt*1e3:8.1f}ms", flush=True)
    it = sorted(times)
    for a, b in zip(it, it[1:]):
        sl = (times[b] - times[a]) / (b - a)
        print(f"  slope {a}->{b}: {sl*1e3:.1f} ms/iter", flush=True)

    # standalone staging pieces at (N,P)
    P = 32
    pos = jax.random.uniform(key, (n, 3), jnp.float32,
                             -1.5 * KPC, 1.5 * KPC)
    d = jax.random.normal(jax.random.fold_in(key, 2), (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    @jax.jit
    def stage(pos, d):
        mid = jnp.linspace(0.1 * KPC, 2.0 * KPC, P)[None, :] \
            * jnp.ones((n, 1))
        ksca_pk, kext_pk = dsys.packet_kappas(ell)
        ksca, kext = dsys.analytic_rows(pos, d, mid, ksca_pk, kext_pk)
        return jnp.sum(ksca) + jnp.sum(kext)

    stage(pos, d)
    _sync(stage(pos, d))
    t0 = time.perf_counter()
    _sync(stage(pos, d))
    print(f"analytic_rows(table) standalone: "
          f"{(time.perf_counter()-t0)*1e3:.1f}ms", flush=True)


if __name__ == "__main__":
    main()
