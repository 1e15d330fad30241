"""Flagship poly-vs-mono A/B at device scale: the polychromatic analytic
kernel must reproduce the monochromatic fused SED/labs at matched
per-wavelength launch totals (per-lambda rel deltas ~ MC noise)."""
import os
import sys

import numpy as np
import jax


import jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from skirt_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
from __graft_entry__ import _build

n = 1 << int(os.environ.get("AB_LOG2N", "19"))
K = int(os.environ.get("AB_REFILL", "16"))
W = int(os.environ.get("AB_NLAMBDA", "4"))
kw = dict(nlambda=W, ncells=32, n_instruments=2, store_absorption=True,
          max_scatt=64, quadrature_panels=32, peel_panels=8,
          refill_batches=K, fused=True, vary_lambda=True)
key = jax.random.key(4357)

run_m, zt_m, ell_m, L0_m = _build(packets=n, **kw)
tm = jax.jit(lambda k, e, l: run_m(k, e, l, zt_m()))(key, ell_m, L0_m)
Fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
lm = np.asarray(tm["labs"], np.float64).reshape(-1, W).sum(0)

# poly: n/W lanes x W lambda = same per-lambda path count.  The mono run
# gives each lambda n*K/W packets at L0=1e36/(n*K) -> 1e36/W per lambda;
# poly (n/W)*K lanes per lambda at L0_w -> L0_w = 1e36/(W*(n/W)*K)
run_p, zt_p, ell_p, L0_p = _build(packets=n // W, polychromatic=True, **kw)
L0_p = jnp.full((n // W, W), 1e36 / W / (n // W * K), jnp.float32)
tp = jax.jit(lambda k, e, l: run_p(k, e, l, zt_p()))(key, ell_p, L0_p)
Fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
lp = np.asarray(tp["labs"], np.float64).reshape(-1, W).sum(0)

print("mono SED:", Fm)
print("poly SED:", Fp)
print("SED rel delta max:", np.abs(Fp / Fm - 1.0).max())
print("SED rel delta:", np.abs(Fp / Fm - 1.0))
print("labs rel delta:", np.abs(lp / lm - 1.0))
fr_m = np.asarray(tm["instruments"][1]["ftot"], np.float64).sum()
fr_p = np.asarray(tp["instruments"][1]["ftot"], np.float64).sum()
print("frame total rel delta:", abs(fr_p / fr_m - 1.0))
