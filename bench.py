"""Benchmark: photon packets/s on the flagship dusty-disc configuration.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card"}.

The flagship: an exponential disc with stars and dust, 128 wavelengths
on polychromatic lanes, 2^15 lanes with refill K=128, a 32x32x16
Cartesian grid, 32 propagation and 8 peel panels, two distant
instruments, max_scatt=64.  Two batches fold into one jitted call; after
a warm-up call, three calls run in one timed window that ends in
block_until_ready, and the rate is all their packets over all its time.
Environment overrides: BENCH_NLAMBDA, BENCH_LOG2_PACKETS (lanes),
BENCH_REFILL, BENCH_POLY=0 (monochromatic lanes), BENCH_FUSED=0 (vector
path), BENCH_BATCHES.
"""

import json
import os
import subprocess
import time

import numpy as np

CALLS = 3   # calls in the timed window


def card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main():
    from skirt_tpu.cache import enable_compile_cache
    enable_compile_cache()

    import jax

    from __graft_entry__ import _build
    from skirt_tpu.engine.lifecycle import make_multibatch

    env = os.environ.get
    nlambda = int(env("BENCH_NLAMBDA", "128"))
    packets = 1 << int(env("BENCH_LOG2_PACKETS", "15"))
    refill = int(env("BENCH_REFILL", "128"))
    poly = env("BENCH_POLY", "1") == "1"
    nbatches = int(env("BENCH_BATCHES", "2"))
    run_batch, zero_tallies, ell, L0 = _build(
        nlambda=nlambda, ncells=32, packets=packets, n_instruments=2,
        store_absorption=True, max_scatt=64, density_mode="analytic",
        deposition="sampled", quadrature_panels=32, peel_panels=8,
        refill_batches=refill, fused=env("BENCH_FUSED", "1") == "1",
        polychromatic=poly)

    run_many = make_multibatch(run_batch, nbatches)
    fn = jax.jit(lambda k, e, l: run_many(k, e, l, zero_tallies()))
    key = jax.random.key(4357)
    jax.block_until_ready(fn(key, ell, L0))          # compile + warm up

    t0 = time.perf_counter()
    outs = [fn(jax.random.fold_in(key, i), ell, L0) for i in range(CALLS)]
    jax.block_until_ready(outs)
    seconds = time.perf_counter() - t0
    for out in outs:
        assert np.isfinite(float(np.sum(out["instruments"][0]["Ftot"])))

    lanes_w = nlambda if poly else 1
    pps = packets * max(refill, 1) * nbatches * CALLS * lanes_w / seconds
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "photon_packets_per_second",
        "value": pps,
        "unit": "packets/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
    }))


if __name__ == "__main__":
    main()
