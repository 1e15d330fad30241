"""Dust thermal emissivity: grey-body (LTE equilibrium) emission.

ref: SKIRTcore/GreyBodyDustEmissivity.hpp:14-40 / .cpp (equilibrium-T
modified blackbody per population), DustMix.cpp:243-260 (temperature grid
NR::powgrid(0, 5000, NT, ratio 500) and the planck-absorption table),
DustMix::equilibrium (:absorbed = sum sigmaabs Jv dlambda -> invert table).

Batched re-design: the per-cell scalar root solve becomes a batched
table-inversion: planckabs and B_lambda(T) are precomputed on a
temperature grid host-side; per-cell equilibrium temperatures and
emission spectra are gathered + lerped on device for all cells at once.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..numerics import powgrid
from ..sources.sed import PlanckFunction
from .mix import DustMix

N_TEMP = 1000  # temperature grid resolution (ref uses NT comparable)
T_MAX = 5000.0
T_RATIO = 500.0  # last/first bin width ratio (ref: DustMix.cpp:243)


class GreyBodyEmissivity:
    """Batched LTE grey-body emissivity for a (single-population) mix."""

    def __init__(self, mix: DustMix):
        self.mix = mix
        wg = mix.wavelength_grid
        lam = wg.lambdav
        dlam = wg.dlambdav

        # temperature grid and tables (host, float64)
        Tv = powgrid(0.0, T_MAX, N_TEMP, T_RATIO)[1:]  # drop T=0
        planckabs = np.empty(Tv.size)
        Btab = np.empty((Tv.size, lam.size))
        for p, T in enumerate(Tv):
            B = PlanckFunction(T)(lam)
            Btab[p] = B
            planckabs[p] = float(np.sum(mix.kappaabs64 * B * dlam))
        self.Tv64 = Tv
        self.planckabs64 = planckabs

        self.Tv = np.asarray(Tv, np.float32)
        # log-space for dynamic range (planckabs spans ~1e-30..1e10)
        self.log_planckabs = np.asarray(
            np.log(np.maximum(planckabs, 1e-300)), np.float32)
        self.Btab = np.asarray(Btab, np.float32)
        self.kappaabs = np.asarray(mix.kappaabs, np.float32)
        self.dlambda = np.asarray(dlam, np.float32)

    def equilibrium_T(self, absorbed_per_mass):
        """Equilibrium temperature for absorbed power per unit dust mass.

        absorbed_per_mass: (...,) = int kappaabs J dlambda [W/kg].
        ref: DustMix::equilibrium + invplanckabs.
        """
        la = jnp.log(jnp.maximum(absorbed_per_mass, 1e-37))
        lp = jnp.asarray(self.log_planckabs)
        Tv = jnp.asarray(self.Tv)
        i = jnp.clip(jnp.searchsorted(lp, la, side="right") - 1,
                     0, lp.shape[0] - 2)
        l0 = lp[i]
        l1 = lp[i + 1]
        t = jnp.clip((la - l0) / jnp.maximum(l1 - l0, 1e-30), 0.0, 1.0)
        return Tv[i] + t * (Tv[i + 1] - Tv[i])

    def emissivity_fractions(self, absorbed_per_mass):
        """Normalized per-bin emission fractions for each input cell.

        Returns (..., Nlambda) with rows summing to 1: the dust emission
        SED lambda-bin fractions kappaabs_l B_l(T) dlambda_l, normalized.
        ref: GreyBodyDustEmissivity::emissivity + DustLib normalization.
        """
        la = jnp.log(jnp.maximum(absorbed_per_mass, 1e-37))
        lp = jnp.asarray(self.log_planckabs)
        Btab = jnp.asarray(self.Btab)
        i = jnp.clip(jnp.searchsorted(lp, la, side="right") - 1,
                     0, lp.shape[0] - 2)
        l0 = lp[i]
        l1 = lp[i + 1]
        t = jnp.clip((la - l0) / jnp.maximum(l1 - l0, 1e-30), 0.0, 1.0)
        # interpolate the Planck table rows, then weight by kappaabs dlambda
        B = Btab[i] + t[..., None] * (Btab[i + 1] - Btab[i])
        j = B * jnp.asarray(self.kappaabs) * jnp.asarray(self.dlambda)
        total = jnp.sum(j, axis=-1, keepdims=True)
        return j / jnp.maximum(total, 1e-37)
