"""Transient (stochastically heated) dust emissivity.

ref: SKIRTcore/TransientDustEmissivity.hpp:16-60 / .cpp — per population:
temperature grid, enthalpy bins, upward transition rates
HR(f,i) = hc sigma_abs(ell_fi) dH_f / (H_f - H_i)^3 evaluated at the
transition wavelength lambda = hc/(H_f - H_i), adjacent-bin cooling rates
CR(i) = int sigma_abs B(T_i) dlambda / (H_i - H_{i-1}), the
Guhathakurta-Draine cumulative-matrix trick, and the O(N^2) recursive
solve for the occupation probabilities P_i (calcprobs, :150-235).

Batched re-design: the reference solves per cell with adaptive temperature
ranges; here a fixed power-law temperature grid per population turns the
solve into batched dense linear algebra over cell chunks — the transition
matrix is built by a gather of J at precomputed wavelength indices, the
cumulative sum is a reversed cumsum, and the recursion is a fori loop of
masked matrix-vector products.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import C_LIGHT, H_PLANCK
from ..numerics import powgrid
from ..sources.sed import PlanckFunction
from ..wavelengths import WavelengthGrid
from .grains import MultiGrainDustMix

HC = H_PLANCK * C_LIGHT


class _PopulationTables:
    """Precomputed per-population transition tables (host, then device)."""

    def __init__(self, pop, wg: WavelengthGrid, NT: int, Tmax: float,
                 ratio: float):
        lam = wg.lambdav
        dlam = wg.dlambdav
        Tv = powgrid(1.0, Tmax, NT - 1, ratio)  # NT grid points
        sigma = pop.mean_section_abs            # per-grain sigma_abs (Nl,)

        # enthalpy per grain across the temperature grid
        Hv = pop.mean_mass * np.asarray(pop.composition.enthalpy(Tv))
        dHv = np.empty(NT)
        dHv[0] = Hv[1] - Hv[0]
        for i in range(1, NT - 1):
            Tmin_ = 0.5 * (Tv[i - 1] + Tv[i])
            Tmax_ = 0.5 * (Tv[i + 1] + Tv[i])
            dHv[i] = (pop.mean_mass
                      * (pop.composition.enthalpy(Tmax_)
                         - pop.composition.enthalpy(Tmin_)))
        dHv[NT - 1] = Hv[NT - 1] - Hv[NT - 2]

        # upward heating rates and transition wavelength indices
        HR = np.zeros((NT, NT))
        ELL = np.full((NT, NT), -1, dtype=np.int64)
        for f in range(1, NT):
            Hdiff = Hv[f] - Hv[:f]
            lam_t = HC / np.maximum(Hdiff, 1e-300)
            for i in range(f):
                ell = wg.nearest(lam_t[i])
                ELL[f, i] = ell
                if ell >= 0:
                    HR[f, i] = HC * sigma[ell] * dHv[f] / Hdiff[i] ** 3

        # adjacent-bin cooling rates and the blackbody table
        Btab = np.empty((NT, lam.size))
        for i in range(NT):
            Btab[i] = PlanckFunction(Tv[i])(lam)
        CR = np.zeros(NT)
        for i in range(1, NT):
            CR[i] = np.sum(sigma * Btab[i] * dlam) / (Hv[i] - Hv[i - 1])

        self.Tv = Tv
        self.Tv_dev = np.asarray(Tv, np.float32)
        self.HR = np.asarray(HR, np.float32)
        self.ELL = np.asarray(np.maximum(ELL, 0), np.int32)
        self.ELL_valid = np.asarray(ELL >= 0)
        self.CR = np.asarray(CR, np.float32)
        # emission table: sigma_abs(ell) * B_i(ell), scaled per grain
        self.emis = np.asarray(sigma[None, :] * Btab, np.float32)  # (NT, Nl)
        # per-grain equilibrium solve table: planckabs(T_i) = int sigma B dlam
        planckabs = np.einsum("l,il,l->i", sigma, Btab, dlam)
        self.log_planckabs = np.asarray(
            np.log(np.maximum(planckabs, 1e-300)), np.float32)
        self.sigma_dlam = np.asarray(sigma * dlam, np.float32)


class TransientEmissivity:
    """Batched stochastic-heating emissivity for a MultiGrainDustMix."""

    def __init__(self, mix: MultiGrainDustMix, NT: int = 128,
                 Tmax: float = 3000.0, ratio: float = 500.0,
                 chunk: int = 256):
        self.mix = mix
        self.wavelength_grid = mix.wavelength_grid
        self.NT = int(NT)
        self.chunk = int(chunk)
        self.pops = [_PopulationTables(p, mix.wavelength_grid, self.NT, Tmax,
                                       ratio)
                     for p in mix.populations]
        for tab, p in zip(self.pops, mix.populations):
            # number of grains of this population per kg of total dust
            tab.grains_per_kg_dust = (p.mu / mix.mu) / p.mean_mass
        self.dlambda = np.asarray(mix.wavelength_grid.dlambdav, np.float32)

    def _probabilities(self, tab: _PopulationTables, J):
        """Occupation probabilities for a chunk of cells.

        J: (C, Nl) mean intensity; returns (C, NT).
        ref: TDE_Calculator::calcprobs.
        """
        C = J.shape[0]
        NT = self.NT
        # transition matrix: A[f, i] = HR[f, i] * J[ell(f, i)] for f > i
        Jg = J[:, jnp.asarray(tab.ELL).reshape(-1)].reshape(C, NT, NT)
        A = jnp.asarray(tab.HR)[None] * jnp.where(
            jnp.asarray(tab.ELL_valid)[None], Jg, 0.0)
        # cumulative over f (reversed cumsum along axis 1)
        B = jnp.flip(jnp.cumsum(jnp.flip(A, axis=1), axis=1), axis=1)

        # recursion: P_0 = 1; P_i = sum_{j<i} B[i, j] P_j / CR_i
        P0 = jnp.zeros((C, NT), jnp.float32).at[:, 0].set(1.0)

        def body(i, P):
            mask = (jnp.arange(NT) < i).astype(jnp.float32)
            s = jnp.einsum("cj,cj->c", B[:, i, :], P * mask[None, :],
                           precision=jax.lax.Precision.HIGHEST)
            Pi = s / jnp.maximum(jnp.asarray(tab.CR)[i], 1e-37)
            P = P.at[:, i].set(Pi)
            # rescale to avoid overflow (ref: calcprobs rescale)
            big = Pi > 1e10
            P = jnp.where(big[:, None], P / jnp.maximum(Pi, 1.0)[:, None], P)
            return P

        P = jax.lax.fori_loop(1, NT, body, P0)
        total = jnp.sum(P, axis=1, keepdims=True)
        return P / jnp.maximum(total, 1e-37)

    DELTA_T_EQ = 10.0  # ref: TransientDustEmissivity.cpp deltaTeq

    def _equilibrium_weights(self, tab: _PopulationTables, J):
        """Per-cell (Teq, one-hot-ish interpolation weights over the T grid).

        Batched replacement for TDE_Calculator::addequilibrium: the
        equilibrium emissivity is a lerp of adjacent Btab rows.
        """
        absorbed = jnp.matmul(J, jnp.asarray(tab.sigma_dlam),
                              precision=jax.lax.Precision.HIGHEST)  # (C,)
        la = jnp.log(jnp.maximum(absorbed, 1e-37))
        lp = jnp.asarray(tab.log_planckabs)
        i = jnp.clip(jnp.searchsorted(lp, la, side="right") - 1,
                     0, lp.shape[0] - 2)
        l0 = lp[i]
        l1 = lp[i + 1]
        t = jnp.clip((la - l0) / jnp.maximum(l1 - l0, 1e-30), 0.0, 1.0)
        NT = self.NT
        W = (jnp.zeros((J.shape[0], NT), jnp.float32)
             .at[jnp.arange(J.shape[0]), i].set(1.0 - t)
             .at[jnp.arange(J.shape[0]), i + 1].set(t))
        Tvd = jnp.asarray(tab.Tv_dev)
        Teq = Tvd[i] + t * (Tvd[i + 1] - Tvd[i])
        return Teq, W

    def emissivity_per_mass(self, J):
        """Emissivity per unit dust mass [W/m/sr/kg]: (C, Nl) for (C, Nl) J.

        ref: TransientDustEmissivity::emissivity — per population, the
        transient occupation-probability spectrum, falling back to the
        equilibrium spectrum when the probability distribution is narrower
        than deltaTeq or does not cover the equilibrium temperature
        (the reference's LTE shortcut conditions, TransientDustEmissivity.cpp
        configuration constants block).
        """
        e = jnp.zeros((J.shape[0], self.dlambda.shape[0]), jnp.float32)
        for tab in self.pops:
            P = self._probabilities(tab, J)
            Teq, W = self._equilibrium_weights(tab, J)
            # support range of the transient distribution
            thresh = 1e-20 * jnp.max(P, axis=1, keepdims=True)
            covered = P > thresh
            Tvd = jnp.asarray(tab.Tv_dev)
            Tmin = jnp.min(jnp.where(covered, Tvd[None, :], jnp.inf),
                           axis=1)
            Tmax = jnp.max(jnp.where(covered, Tvd[None, :], -jnp.inf),
                           axis=1)
            use_eq = ((Tmax - Tmin < self.DELTA_T_EQ)
                      | (Teq < Tmin) | (Teq > Tmax))
            Psel = jnp.where(use_eq[:, None], W, P)
            e = e + tab.grains_per_kg_dust * jnp.matmul(
                Psel, jnp.asarray(tab.emis),
                precision=jax.lax.Precision.HIGHEST)
        return e

    def fractions_from_J(self, J):
        """Normalized per-bin emission fractions (rows sum to 1)."""
        e = self.emissivity_per_mass(J) * jnp.asarray(self.dlambda)
        total = jnp.sum(e, axis=1, keepdims=True)
        return e / jnp.maximum(total, 1e-37)
