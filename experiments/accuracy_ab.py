"""Cross-estimator A/B at 1e7 packets on the flagship dusty disc (GPU).

VERDICT round-1 item 2: compare the three structurally different
estimator chains on the same physical model at high packet count:

  A. gridded densities + path deposition   (reference-exact estimators)
  B. analytic densities + sampled deposit  (fast path, XLA lifecycle)
  C. fused event body                      (flagship path, B's physics)

Reports detected SED totals, per-wavelength deltas, and absorbed energy.
Run: python experiments/accuracy_ab.py   (on a GPU; ~minutes)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from skirt_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def run_mode(name, packets_log2, batch_log2=20, **kw):
    import jax

    from __graft_entry__ import _build

    t0 = time.perf_counter()
    # batch_log2 bounds the per-dispatch size: mode A's gridded path
    # carries (N,S) path-record buffers
    n_batches = max(1, (1 << packets_log2) >> batch_log2)
    run, zeros, ell, L0 = _build(packets=1 << min(packets_log2, batch_log2),
                                 nlambda=4, ncells=32, n_instruments=2,
                                 store_absorption=True, max_scatt=64, **kw)
    key = jax.random.key(4357)
    fn = jax.jit(lambda k, t: run(k, ell, L0, t), donate_argnums=(1,))
    acc = None
    t = zeros()
    for b in range(n_batches):
        t = fn(jax.random.fold_in(key, b), t)
        if (b + 1) % 4 == 0 or b == n_batches - 1:
            host = {"Ftot": np.asarray(t["instruments"][0]["Ftot"],
                                       np.float64),
                    "ftot": float(np.asarray(
                        t["instruments"][1]["ftot"], np.float64).sum()),
                    "labs": float(np.asarray(t["labs"], np.float64).sum())}
    # L0 is normalized per-batch to 1e36 total; averaging over batches
    host["Ftot"] /= n_batches
    host["ftot"] /= n_batches
    host["labs"] /= n_batches
    dt = time.perf_counter() - t0
    print(f"  {name}: Ftot={host['Ftot'].sum():.6e} frame={host['ftot']:.6e} "
          f"labs={host['labs']:.6e}  ({dt:.0f}s, {n_batches} batches)")
    return host


def main():
    import jax
    if jax.default_backend() != "gpu":
        sys.exit("accuracy_ab.py needs a GPU")

    P = 23   # 2^23 ~ 8.4M packets per mode (1e7-class)
    print(f"cross-estimator A/B at 2^{P} packets:")
    A = run_mode("A gridded+path ", P, batch_log2=17, density_mode="gridded",
                 deposition="path")
    B = run_mode("B analytic+samp", P, density_mode="analytic",
                 deposition="sampled")
    C = run_mode("C fused        ", P, density_mode="analytic",
                 deposition="sampled", fused=True, quadrature_panels=32,
                 peel_panels=8)

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-300)

    out = {
        "sed_BA": rel(B["Ftot"].sum(), A["Ftot"].sum()),
        "sed_CB": rel(C["Ftot"].sum(), B["Ftot"].sum()),
        "frame_BA": rel(B["ftot"], A["ftot"]),
        "frame_CB": rel(C["ftot"], B["ftot"]),
        "labs_BA": rel(B["labs"], A["labs"]),
        "labs_CB": rel(C["labs"], B["labs"]),
        "sed_per_lambda_CB": [rel(c, b) for c, b in zip(C["Ftot"], B["Ftot"])],
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
