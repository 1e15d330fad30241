"""Chandrasekhar Milne-atmosphere polarization pin (GPU, big statistics).

Conservative Thomson slab (tau_z = 8), narrow central source sheet at
the bottom (the wide-slab/narrow-source split keeps side-exit 'rim'
contamination out of the low-mu sightlines), distant FullInstruments at
mu = cos(i).  Published anchor: p(mu=0) = 11.713 % (Chandrasekhar 1960,
Table XXIV), p(mu=1) = 0.

MILNE_LOG2N (default 16), MILNE_SEEDS (default 16).
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
from skirt_tpu.geometry import BoxGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import FullInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             DustMassNormalization, ElectronDustMix)
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid


def main():
    wg = OligoWavelengthGrid([0.55e-6])
    H = 0.1 * KPC
    W = 8.0 * KPC
    WS = 0.4 * KPC
    ss = StellarSystem([LuminosityStellarComponent(
        BoxGeometry(-WS / 2, WS / 2, -WS / 2, WS / 2,
                    -H / 2, -H / 2 + H / 40.0), wg, [1e36])])
    b = np.linspace(-W / 2, W / 2, 5)
    bz = np.linspace(-H / 2, H / 2, 9)
    grid = CartesianGrid(b, b, bz)
    cub = BoxGeometry(-W / 2, W / 2, -W / 2, W / 2, -H / 2, H / 2)
    emix = ElectronDustMix(wg)
    mass = 8.0 / float(emix.kappaext[0]) * W * W
    dsys = DustSystem(grid, [DustComponent(cub, emix,
                                           DustMassNormalization(mass))],
                      samples_per_cell=4)
    mus = [0.1, 0.2, 0.4, 0.7, 1.0]
    ins = [FullInstrument(f"m{j}", 3.08e23, 1, 3, 3,
                          fov_x=2 * W, fov_y=2 * W,
                          inclination=float(np.arccos(mu)),
                          polarization=True)
           for j, mu in enumerate(mus)]
    opts = LifecycleOptions(max_scatt_events=96, min_weight_reduction=1e4)
    run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, 1,
                                 mueller=dsys.muellers))
    n = 1 << int(os.environ.get("MILNE_LOG2N", "16"))
    nseeds = int(os.environ.get("MILNE_SEEDS", "16"))
    ell = jnp.zeros((n,), jnp.int32)
    L0 = jnp.full((n,), 1e36 / n, jnp.float32)
    t0 = time.perf_counter()
    I = np.zeros(len(mus))
    Q = np.zeros(len(mus))
    per = [[] for _ in mus]
    for seed in range(nseeds):
        t = run(rng.root_key(1000 + seed), ell, L0,
                {"instruments": [i.zero_tallies() for i in ins]})
        for j in range(len(mus)):
            Ij = float(np.asarray(t["instruments"][j]["ftot"],
                                  np.float64).sum())
            Qj = float(np.asarray(t["instruments"][j]["fQ"],
                                  np.float64).sum())
            I[j] += Ij
            Q[j] += Qj
            per[j].append(Qj / Ij)
        print(f"seed {seed}: " + " ".join(
            f"{Q[j]/I[j]:+.4f}" for j in range(len(mus))), flush=True)
    print(f"total {n*nseeds} packets, {time.perf_counter()-t0:.0f}s")
    for j, mu in enumerate(mus):
        se = np.std(per[j]) / np.sqrt(nseeds)
        print(f"mu={mu}: p = {Q[j]/I[j]:+.5f} +- {se:.5f}")
    p0_lin = (Q[0] / I[0]) + ((Q[0] / I[0]) - (Q[1] / I[1])) \
        * mus[0] / (mus[1] - mus[0])
    print(f"extrapolated p(mu->0) = {abs(p0_lin):.5f}  "
          f"(Chandrasekhar: 0.11713)")


if __name__ == "__main__":
    main()
