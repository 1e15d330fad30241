"""Multi-component polarization (ref: MonteCarloSimulation.cpp:319-363
peeloffscattering wv blending; simulatescattering + randomMixForPosition)
and the Chandrasekhar semi-infinite-atmosphere external pin.

The limb polarization of a conservatively-scattering (Thomson)
semi-infinite plane-parallel atmosphere is the classic closed-form
anchor: p(mu=0) = 11.713% (Chandrasekhar 1960, "Radiative Transfer",
Table XXIV), dropping monotonically to 0 at mu=1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt_tpu import rng
from skirt_tpu.constants import KPC
from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
from skirt_tpu.geometry import BoxGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import FullInstrument
from skirt_tpu.media import (DustComponent, DustSystem,
                             DustMassNormalization, ElectronDustMix,
                             SimpleOligoDustMix)
from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                       StellarSystem)
from skirt_tpu.wavelengths import OligoWavelengthGrid


def _sphere_setup(two_comp: str | None):
    """Polarized (Thomson) uniform-sphere config; optionally with a
    second component: 'zero' (no opacity — must not change anything)
    or 'hg' (unpolarized dust)."""
    wg = OligoWavelengthGrid([0.55e-6])
    s_ = 0.01 * KPC
    ss = StellarSystem([LuminosityStellarComponent(
        BoxGeometry(-s_, s_, -s_, s_, -s_, s_), wg, [1e36])])
    half = 1.0 * KPC
    b = np.linspace(-half, half, 9)
    grid = CartesianGrid(b, b, b)
    cub = BoxGeometry(-0.8 * KPC, 0.8 * KPC, -0.8 * KPC,
                      0.8 * KPC, -0.8 * KPC, 0.8 * KPC)
    emix = ElectronDustMix(wg)
    # mass for a moderate optical depth
    sigma = float(emix.kappaext[0])
    mass = 2.0 / sigma * (1.6 * KPC) ** 2
    comps = [DustComponent(cub, emix, DustMassNormalization(mass))]
    if two_comp == "zero":
        z = SimpleOligoDustMix(wg, [1e-12], [0.5], [0.3])
        comps.append(DustComponent(cub, z, DustMassNormalization(1.0)))
    elif two_comp == "hg":
        z = SimpleOligoDustMix(wg, [sigma], [0.9], [0.3])
        comps.append(DustComponent(cub, z, DustMassNormalization(mass / 2)))
    dsys = DustSystem(grid, comps, samples_per_cell=4)
    ins = [FullInstrument("full", 3.08e23, 1, 9, 9,
                          fov_x=4 * KPC, fov_y=4 * KPC,
                          inclination=1.1, azimuth=0.4,
                          polarization=True)]
    return wg, ss, dsys, ins


def _run(two_comp, n=1 << 12, seed=7):
    wg, ss, dsys, ins = _sphere_setup(two_comp)
    opts = LifecycleOptions(max_scatt_events=32)
    run = jax.jit(make_lifecycle(dsys.grid, dsys, ss, ins, opts, 1,
                                 mueller=dsys.muellers))
    ell = jnp.zeros((n,), jnp.int32)
    L0 = jnp.full((n,), 1e36 / n, jnp.float32)
    return run(rng.root_key(seed), ell, L0,
               {"instruments": [ins[0].zero_tallies()]})


class TestMultiComponent:
    def test_zero_opacity_second_component_is_noop(self):
        """A second component with ~zero opacity must reproduce the
        single-component polarized run (the selection always picks comp
        0).  Small residual: with Ncomp>1 the reference aborts peel-off
        for packets whose cell lookup fails (m==-1,
        MonteCarloSimulation.cpp:336) while the Ncomp==1 branch skips
        the cell check — boundary-landing packets differ (~0.2% here)."""
        t1 = _run(None)
        t2 = _run("zero")
        for k in ("ftot", "fQ"):
            a = np.asarray(t1["instruments"][0][k], np.float64)
            b = np.asarray(t2["instruments"][0][k], np.float64)
            np.testing.assert_allclose(b.sum(), a.sum(), rtol=7e-3)

    def test_mixed_polarized_unpolarized_runs(self):
        """Thomson + unpolarized HG components: finite tallies, nonzero
        polarized flux, and less polarization than pure Thomson (the HG
        component dilutes Q)."""
        t2 = _run("hg")
        for leaf in jax.tree.leaves(t2):
            assert np.isfinite(np.asarray(leaf)).all()
        q2 = np.asarray(t2["instruments"][0]["fQ"], np.float64)
        u2 = np.asarray(t2["instruments"][0]["fU"], np.float64)
        i2 = np.asarray(t2["instruments"][0]["ftot"], np.float64)
        assert i2.sum() > 0 and np.abs(q2).sum() > 0
        # physical bound per pixel: sqrt(Q^2+U^2) <= I (small fp slack)
        pl_ = np.sqrt(q2 ** 2 + u2 ** 2)
        assert (pl_ <= i2 * (1 + 1e-6) + 1e-12 * i2.max()).all()


@pytest.mark.slow
class TestChandrasekharMilne:
    def test_limb_polarization_11_7_percent(self):
        """Milne problem: source plane below tau=8 of conservative
        Thomson scatterers; the emergent polarization degree
        extrapolated to the limb must hit Chandrasekhar's 11.713%.

        The slab is wide (40x its height) so lateral escape is
        negligible; three distant instruments at mu = cos(i) in
        {0.035, 0.14, 1.0} sample the emergent p(mu); p is monotonic in
        mu with p(1) = 0 by symmetry.
        """
        from skirt_tpu.instruments import SEDInstrument

        wg = OligoWavelengthGrid([0.55e-6])
        H = 0.1 * KPC
        W = 4.0 * KPC
        ss = StellarSystem([LuminosityStellarComponent(
            BoxGeometry(-W / 2, W / 2, -W / 2, W / 2,
                        -H / 2, -H / 2 + H / 40.0), wg, [1e36])])
        b = np.linspace(-W / 2, W / 2, 5)
        bz = np.linspace(-H / 2, H / 2, 9)
        grid = CartesianGrid(b, b, bz)
        cub = BoxGeometry(-W / 2, W / 2, -W / 2, W / 2,
                          -H / 2, H / 2)
        emix = ElectronDustMix(wg)
        sigma = float(emix.kappaext[0])
        tau_z = 8.0
        mass = tau_z / sigma * W * W
        dsys = DustSystem(grid,
                          [DustComponent(cub, emix,
                                         DustMassNormalization(mass))],
                          samples_per_cell=4)
        mus = [0.035, 0.14, 1.0]
        ins = [FullInstrument(f"m{j}", 3.08e23, 1, 3, 3,
                              fov_x=2 * W, fov_y=2 * W,
                              inclination=float(np.arccos(mu)),
                              polarization=True)
               for j, mu in enumerate(mus)]
        # min_weight_reduction at the default 1e4 bounds the forced-
        # scattering weight tail (deep-order contributions carry |q|~1
        # with heavy-tailed weights — the dominant Q/I variance)
        opts = LifecycleOptions(max_scatt_events=96,
                                min_weight_reduction=1e4)
        run = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts, 1,
                                     mueller=dsys.muellers))
        n = 1 << 15
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n,), 1e36 / n, jnp.float32)
        t = run(rng.root_key(4357), ell, L0,
                {"instruments": [i.zero_tallies() for i in ins]})
        ps = []
        for j in range(len(mus)):
            I = np.asarray(t["instruments"][j]["ftot"], np.float64).sum()
            Q = np.asarray(t["instruments"][j]["fQ"], np.float64).sum()
            ps.append(Q / I)
        p = [abs(x) for x in ps]
        # The Q/I estimator is heavy-tailed (forced-scattering weights x
        # |q|~1 contributions): single-seed sigma ~ 0.05-0.1 here, so
        # this is a catastrophic-regression tripwire (it caught a
        # +0.42 face-on Q from the phi-sampler Newton bias and a +50
        # outlier from unclamped Mueller ratios); the tight-statistics
        # pin is experiments/milne_chandrasekhar.py on the GPU:
        # p(mu=0.1) = 0.122 +- 0.039 at 3.1M packets (Chandrasekhar
        # ~0.10), p(mu=1) consistent with 0.
        assert np.isfinite(p).all() if hasattr(np, "isfinite") else True
        assert p[2] < 0.25                      # mu=1: zero by symmetry
        assert p[0] < 0.45                      # limb: 0.117 + noise
        p0 = p[0] + (p[0] - p[1]) * mus[0] / (mus[1] - mus[0])
        assert abs(p0 - 0.11713) < 0.30
