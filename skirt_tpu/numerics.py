"""Numerical building blocks: grid construction, interpolation, CDF sampling.

Batched replacement for the reference's NR numerics toolbox
(ref: Fundamentals/NR.hpp:27-404).  Host-side (setup-time) routines use
NumPy float64; device-side routines are jax.numpy and jit/vmap friendly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "lingrid",
    "loggrid",
    "powgrid",
    "sympowgrid",
    "zerocentergrid",
    "locate_clip",
    "interp_linlin",
    "interp_loglog",
    "resample_loglog",
    "build_cdf",
    "build_cdf_from_grid",
    "sample_cdf",
    "sample_cdf_indices",
]


# ----------------------------------------------------------------------------
# grid builders (host side, float64) — ref: Fundamentals/NR.hpp lin/log/pow
# ----------------------------------------------------------------------------

def lingrid(xmin: float, xmax: float, n: int) -> np.ndarray:
    """n+1 linearly spaced border points over [xmin, xmax]."""
    return np.linspace(xmin, xmax, n + 1)


def loggrid(xmin: float, xmax: float, n: int) -> np.ndarray:
    """n+1 logarithmically spaced border points over [xmin, xmax]."""
    return np.logspace(np.log10(xmin), np.log10(xmax), n + 1)


def powgrid(xmin: float, xmax: float, n: int, ratio: float) -> np.ndarray:
    """n+1 border points with power-law bin widths; `ratio` = last/first width.

    ref: Fundamentals/NR.hpp (powgrid) / SKIRTcore/PowMesh.
    """
    if abs(ratio - 1.0) < 1e-12 or n == 1:
        return lingrid(xmin, xmax, n)
    q = ratio ** (1.0 / (n - 1))
    widths = q ** np.arange(n)
    widths *= (xmax - xmin) / widths.sum()
    return np.concatenate([[xmin], xmin + np.cumsum(widths)])


def sympowgrid(xmin: float, xmax: float, n: int, ratio: float) -> np.ndarray:
    """Symmetric power-law grid: smallest bins in the center.

    ref: SKIRTcore/SymPowMesh. For even n the two central bins share the
    smallest width; the widths grow by `ratio` overall toward both edges.
    """
    if abs(ratio - 1.0) < 1e-12 or n == 1:
        return lingrid(xmin, xmax, n)
    half = n // 2
    center = 0.5 * (xmin + xmax)
    if n % 2 == 0:
        right = powgrid(center, xmax, half, ratio)
    else:
        # odd: central bin straddles the center
        right = powgrid(center, xmax, half + 1, ratio)
        # shift so that the first border lands half a central bin to the right
        w0 = right[1] - right[0]
        right = np.concatenate([[center + 0.5 * w0], right[1:] + 0.5 * w0])
        right = center + (right - center) * (xmax - center) / (right[-1] - center)
        right = np.concatenate([[center + 0.5 * (right[0] - center) * 0], right]) \
            if False else right
    left = center - (right[::-1] - center)
    if n % 2 == 0:
        return np.concatenate([left[:-1], right])
    else:
        return np.concatenate([left, right])


def zerocentergrid(xmax: float, n: int) -> np.ndarray:
    """Symmetric linear grid on [-xmax, xmax]."""
    return np.linspace(-xmax, xmax, n + 1)


# ----------------------------------------------------------------------------
# searching and interpolation (device side)
# ----------------------------------------------------------------------------

def locate_clip(xv, x):
    """Index i such that xv[i] <= x < xv[i+1], clipped to [0, len-2].

    ref: Fundamentals/NR.hpp locate_clip.  Works under jit/vmap.
    """
    i = jnp.searchsorted(xv, x, side="right") - 1
    return jnp.clip(i, 0, xv.shape[0] - 2)


def interp_linlin(x, xv, yv):
    """Piecewise-linear interpolation with clamped extrapolation."""
    i = locate_clip(xv, x)
    x0, x1 = xv[i], xv[i + 1]
    y0, y1 = yv[i], yv[i + 1]
    t = (x - x0) / jnp.where(x1 == x0, 1.0, x1 - x0)
    return y0 + jnp.clip(t, 0.0, 1.0) * (y1 - y0)


def interp_loglog(x, xv, yv, floor=1e-300):
    """Log-log interpolation (power-law within each bin)."""
    i = locate_clip(xv, x)
    lx0, lx1 = jnp.log(xv[i]), jnp.log(xv[i + 1])
    ly0 = jnp.log(jnp.maximum(yv[i], floor))
    ly1 = jnp.log(jnp.maximum(yv[i + 1], floor))
    t = (jnp.log(x) - lx0) / jnp.where(lx1 == lx0, 1.0, lx1 - lx0)
    return jnp.exp(ly0 + jnp.clip(t, 0.0, 1.0) * (ly1 - ly0))


def resample_loglog(xnew: np.ndarray, xv: np.ndarray, yv: np.ndarray) -> np.ndarray:
    """Host-side log-log resampling onto a new abscissa (0 outside range).

    ref: Fundamentals/NR.hpp resample<interpolate_loglog>.
    """
    xnew = np.asarray(xnew, dtype=np.float64)
    xv = np.asarray(xv, dtype=np.float64)
    yv = np.asarray(yv, dtype=np.float64)
    pos = yv > 0
    logy = np.full_like(yv, -690.0)
    logy[pos] = np.log(yv[pos])
    out = np.exp(np.interp(np.log(xnew), np.log(xv), logy, left=-np.inf, right=-np.inf))
    out[(xnew < xv[0]) | (xnew > xv[-1])] = 0.0
    return out


# ----------------------------------------------------------------------------
# CDF construction and sampling
# ----------------------------------------------------------------------------

def build_cdf(weights) -> np.ndarray:
    """Normalized CDF border array of length n+1 from n nonnegative weights.

    ref: Fundamentals/NR.hpp cdf(). cdf[0] = 0, cdf[n] = 1.
    """
    w = np.clip(np.asarray(weights, dtype=np.float64), 0.0, None)
    c = np.concatenate([[0.0], np.cumsum(w)])
    total = c[-1]
    if total <= 0:
        return np.linspace(0.0, 1.0, w.size + 1)
    return c / total


def build_cdf_from_grid(xv: np.ndarray, pv: np.ndarray):
    """CDF for a piecewise-constant density pv over bins with borders xv.

    Returns (cdf, total) with cdf of length len(xv).
    """
    xv = np.asarray(xv, dtype=np.float64)
    pv = np.clip(np.asarray(pv, dtype=np.float64), 0.0, None)
    bin_mass = pv * np.diff(xv)
    c = np.concatenate([[0.0], np.cumsum(bin_mass)])
    total = c[-1]
    if total > 0:
        c = c / total
    return c, total


def sample_cdf_indices(cdf, u):
    """Sample discrete indices from a CDF border array (device side)."""
    i = jnp.searchsorted(cdf, u, side="right") - 1
    return jnp.clip(i, 0, cdf.shape[0] - 2)


def sample_cdf(cdf, xv, u):
    """Sample a continuous value: pick bin from cdf then interpolate in x."""
    i = sample_cdf_indices(cdf, u)
    c0, c1 = cdf[i], cdf[i + 1]
    t = (u - c0) / jnp.where(c1 == c0, 1.0, c1 - c0)
    return xv[i] + jnp.clip(t, 0.0, 1.0) * (xv[i + 1] - xv[i])


def build_alias_tables(weights: "np.ndarray"):
    """Walker alias tables for R discrete distributions (host side).

    weights: (R, N) nonnegative.  Returns (prob (R, N) float32,
    alias (R, N) int32): sample row r with two uniforms as
      j = floor(u1 * N);  m = j if u2 < prob[r, j] else alias[r, j]
    — EXACT discrete sampling in 2 gathers, replacing a per-sample
    searchsorted (~log2(N) sequential dependent gathers).  Rows with zero total weight sample uniformly.

    ref: the reference samples its dust-emission cell CDF with NR::locate
    binary searches (PanMonteCarloSimulation.cpp:303); alias tables are
    the batched-hardware equivalent.
    """
    w = np.asarray(weights, np.float64)
    R, N = w.shape
    from . import native as _native
    out = _native.alias_tables(w)
    if out is not None:
        return out
    prob = np.ones((R, N), np.float32)
    alias = np.tile(np.arange(N, dtype=np.int32), (R, 1))
    for r in range(R):
        total = w[r].sum()
        if total <= 0:
            continue
        p = w[r] * (N / total)
        small = [i for i in range(N) if p[i] < 1.0]
        large = [i for i in range(N) if p[i] >= 1.0]
        while small and large:
            s = small.pop()
            l = large.pop()
            prob[r, s] = p[s]
            alias[r, s] = l
            p[l] = (p[l] + p[s]) - 1.0
            (small if p[l] < 1.0 else large).append(l)
        for i in small + large:
            prob[r, i] = 1.0
    return prob, alias
