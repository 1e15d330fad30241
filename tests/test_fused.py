"""Fused event body (engine/fused.py) parity with the XLA lifecycle.

The fused body runs as plain XLA on the CPU.  The two engines share
the launch + emission-peel-off stream (identical keys), so the direct flux
matches tightly; scattered flux and absorption differ only by the event
RNG streams (in-body sampling order), bounded by MC noise.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, "/root/repo")

from __graft_entry__ import _build


KW = dict(nlambda=2, ncells=8, packets=1 << 13, n_instruments=2,
          store_absorption=True, max_scatt=24, quadrature_panels=8)


@pytest.fixture(scope="module")
def pair():
    run_x, zeros_x, ell, L0 = _build(**KW)
    run_f, zeros_f, _, _ = _build(fused=True, **KW)
    key = jax.random.key(4357)
    tx = jax.jit(lambda k: run_x(k, ell, L0, zeros_x()))(key)
    tf = jax.jit(lambda k: run_f(k, ell, L0, zeros_f()))(key)
    return tx, tf


class TestFusedParity:
    def test_sed_matches(self, pair):
        tx, tf = pair
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(ff, fx, rtol=0.03)

    def test_frame_total_matches(self, pair):
        tx, tf = pair
        cx = float(np.asarray(tx["instruments"][1]["ftot"]).sum())
        cf = float(np.asarray(tf["instruments"][1]["ftot"]).sum())
        assert cf == pytest.approx(cx, rel=0.03)

    def test_absorption_matches(self, pair):
        tx, tf = pair
        lx = float(np.asarray(tx["labs"]).sum())
        lf = float(np.asarray(tf["labs"]).sum())
        assert lf == pytest.approx(lx, rel=0.05)
        # bolometric z-profile (sum over x, y, lambda): enough samples per
        # bin that only the event-RNG stream difference remains
        nc = KW["ncells"]
        shape = (nc, nc, nc // 2, KW["nlambda"])
        px = np.asarray(tx["labs"], np.float64).reshape(shape).sum((0, 1, 3))
        pf = np.asarray(tf["labs"], np.float64).reshape(shape).sum((0, 1, 3))
        hot = px > 0.05 * px.max()   # outer bins hold O(10) deposits
        assert hot.any()
        np.testing.assert_allclose(pf[hot], px[hot], rtol=0.1)

    def test_everything_finite(self, pair):
        _, tf = pair
        for leaf in jax.tree.leaves(tf):
            assert np.isfinite(np.asarray(leaf)).all()


class TestFusedRefill:
    def test_refill_normalization_and_parity(self, pair):
        """K lanes-worth of packets on N/K persistent lanes must reproduce
        the plain fused run (exact per-lane budget => exact norm)."""
        tx, _ = pair
        kw = dict(KW, packets=KW["packets"] // 4)
        run_r, zeros_r, ell, L0 = _build(fused=True, refill_batches=4, **kw)
        tr = jax.jit(lambda k: run_r(k, ell, L0, zeros_r()))(
            jax.random.key(4357))
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        fr = np.asarray(tr["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fr, fx, rtol=0.04)
        lx = float(np.asarray(tx["labs"]).sum())
        lr = float(np.asarray(tr["labs"]).sum())
        assert lr == pytest.approx(lx, rel=0.05)


class TestFusedValidation:
    def test_gridded_mode_rejected(self):
        with pytest.raises(ValueError, match="fused"):
            _build(fused=True, density_mode="gridded", **{
                k: v for k, v in KW.items()})

    def test_path_deposition_rejected(self):
        with pytest.raises(ValueError, match="fused"):
            _build(fused=True, deposition="path", **KW)


class TestFusedAnyGridSEDOnly:
    """Without absorption tallies the single-mix event is cell-independent:
    any analytic grid qualifies through its bounding-box span."""

    def test_octree_sed_matches_unfused(self):
        from skirt_tpu.engine.lifecycle import LifecycleOptions, \
            make_lifecycle
        from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
        from skirt_tpu.grids.octree import OctreeGrid
        from skirt_tpu.instruments import SEDInstrument
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem)
        from skirt_tpu.media.mix import DustMix
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([1e-6])
        ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                       [1.0])])
        sphere = UniformSphereGeometry(0.9)
        grid = OctreeGrid((-1, -1, -1, 1, 1, 1),
                          lambda p: np.asarray(sphere.density(p)),
                          min_level=1, max_level=3)
        mix = DustMix(wg, np.array([1.2]), np.array([0.8]), np.array([0.3]))
        comp = DustComponent(sphere, mix, DustMassNormalization(1.5))
        dsys = DustSystem(grid, [comp], density_mode="analytic")
        ins = SEDInstrument("sed", 100.0, 1)
        n = 8192
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n,), 1.0 / n, jnp.float32)
        key = jax.random.key(7)
        out = {}
        for fused in (False, True):
            opts = LifecycleOptions(fused=fused, quadrature_panels=16,
                                    max_scatt_events=24)
            run = make_lifecycle(grid, dsys, ss, [ins], opts, 1)
            t = {"instruments": [ins.zero_tallies()]}
            out[fused] = jax.jit(lambda k, r=run, t0=t: r(k, ell, L0, t0))(key)
        Fx = float(np.asarray(out[False]["instruments"][0]["Ftot"])[0])
        Ff = float(np.asarray(out[True]["instruments"][0]["Ftot"])[0])
        assert Ff == pytest.approx(Fx, rel=0.05)

    def test_absorption_still_requires_uniform_cartesian(self):
        # non-uniform borders + store_absorption must still bail
        from skirt_tpu.engine.lifecycle import LifecycleOptions, \
            make_lifecycle
        from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
        from skirt_tpu.grids import CartesianGrid
        from skirt_tpu.instruments import SEDInstrument
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem)
        from skirt_tpu.media.mix import DustMix
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([1e-6])
        b = np.concatenate([np.linspace(-1, 0, 5),
                            np.geomspace(0.1, 1.0, 4)])
        grid = CartesianGrid(b, np.linspace(-1, 1, 9), np.linspace(-1, 1, 9))
        sphere = UniformSphereGeometry(0.9)
        mix = DustMix(wg, np.array([1.0]), np.array([0.2]), np.array([0.0]))
        dsys = DustSystem(grid, [DustComponent(
            sphere, mix, DustMassNormalization(1.0))],
            density_mode="analytic")
        ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                       [1.0])])
        with pytest.raises(ValueError, match="uniform-spacing"):
            make_lifecycle(grid, dsys, ss, [SEDInstrument("sed", 100.0, 1)],
                           LifecycleOptions(fused=True,
                                            store_absorption=True,
                                            deposition="sampled"), 1)


class TestFusedMultiComponent:
    """Multi-mix fused kernel vs the XLA lifecycle (VERDICT round-1 item 3:
    the single-mix/uniform-albedo restriction is lifted)."""

    @pytest.fixture(scope="class")
    def pair_multi(self):
        from skirt_tpu import rng
        from skirt_tpu.constants import KPC
        from skirt_tpu.engine.lifecycle import (LifecycleOptions,
                                                make_lifecycle)
        from skirt_tpu.geometry import ExpDiskGeometry
        from skirt_tpu.grids import CartesianGrid
        from skirt_tpu.instruments import SEDInstrument, SimpleInstrument
        from skirt_tpu.media import (DustComponent, DustSystem,
                                     OpticalDepthNormalization,
                                     SimpleOligoDustMix)
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        nl = 2
        wg = OligoWavelengthGrid([0.55e-6, 1.0e-6])
        ss = StellarSystem([LuminosityStellarComponent(
            ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, [1e36] * nl)])
        half = 12 * KPC
        b = np.linspace(-half, half, 17)
        bz = np.linspace(-2 * KPC, 2 * KPC, 9)
        grid = CartesianGrid(b, b, bz)
        # two components with very different albedo/g so the per-panel
        # albedo, mix selection, and blended peel phase all matter
        mix1 = SimpleOligoDustMix(wg, [2600.0, 800.0], [0.6, 0.3],
                                  [0.5, 0.2])
        mix2 = SimpleOligoDustMix(wg, [1000.0, 1500.0], [0.2, 0.8],
                                  [-0.2, 0.6])
        c1 = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix1,
                           OpticalDepthNormalization("z", wg.lambdav[0], 0.8))
        c2 = DustComponent(ExpDiskGeometry(2 * KPC, 0.5 * KPC), mix2,
                           OpticalDepthNormalization("z", wg.lambdav[0], 0.5))
        dsys = DustSystem(grid, [c1, c2], samples_per_cell=4,
                          density_mode="analytic")
        ins = [SEDInstrument("sed", 3.08e23, nl, inclination=1.0),
               SimpleInstrument("img", 3.08e23, nl, 8, 8, fov_x=24 * KPC,
                                fov_y=24 * KPC, inclination=np.pi / 2)]
        kw = dict(store_absorption=True, max_scatt_events=24,
                  deposition="sampled", quadrature_panels=8)
        n = 1 << 13
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % nl)
        L0 = jnp.full((n,), 1e36 * nl / n, jnp.float32)
        key = jax.random.key(4357)

        def zt():
            return {"instruments": [i.zero_tallies() for i in ins],
                    "labs": jnp.zeros((grid.ncells * nl,), jnp.float32)}

        from skirt_tpu.engine.lifecycle import LifecycleOptions as LO
        tx = jax.jit(make_lifecycle(grid, dsys, ss, ins, LO(**kw), nl))(
            key, ell, L0, zt())
        tf = jax.jit(make_lifecycle(grid, dsys, ss, ins,
                                    LO(fused=True, **kw), nl))(
            key, ell, L0, zt())
        return tx, tf

    def test_sed_matches(self, pair_multi):
        tx, tf = pair_multi
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(ff, fx, rtol=0.02)

    def test_frame_matches(self, pair_multi):
        tx, tf = pair_multi
        cx = float(np.asarray(tx["instruments"][1]["ftot"]).sum())
        cf = float(np.asarray(tf["instruments"][1]["ftot"]).sum())
        assert cf == pytest.approx(cx, rel=0.02)

    def test_absorption_matches(self, pair_multi):
        tx, tf = pair_multi
        lx = float(np.asarray(tx["labs"]).sum())
        lf = float(np.asarray(tf["labs"]).sum())
        assert lf == pytest.approx(lx, rel=0.03)


class TestFusedManyWavelengths:
    def test_128_lambda_parity(self):
        """Beyond _MAX_CHAIN_AUTO the per-lambda tables become per-lane
        (R,128) inputs gathered once per batch — this removed the old
        64-wavelength select-chain ceiling.  Parity vs the XLA lifecycle
        with per-lambda VARYING optical properties."""
        kw = dict(nlambda=128, ncells=8, packets=1 << 14, n_instruments=1,
                  store_absorption=True, max_scatt=24, quadrature_panels=8,
                  vary_lambda=True)
        run_x, zeros_x, ell, L0 = _build(**kw)
        run_f, zeros_f, _, _ = _build(fused=True, **kw)
        key = jax.random.key(4357)
        tx = jax.jit(lambda k: run_x(k, ell, L0, zeros_x()))(key)
        tf = jax.jit(lambda k: run_f(k, ell, L0, zeros_f()))(key)
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        # 128 packets/lambda: direct flux dominates and shares the launch
        # stream; scattered flux differs by the event streams
        tot_x, tot_f = fx.sum(), ff.sum()
        assert tot_f == pytest.approx(tot_x, rel=0.02)
        np.testing.assert_allclose(ff, fx, rtol=0.25)
        lx = float(np.asarray(tx["labs"]).sum())
        lf = float(np.asarray(tf["labs"]).sum())
        assert lf == pytest.approx(lx, rel=0.05)

    def test_17_lambda_uses_lam_inputs(self):
        """Just above the chain threshold: the lam-input path engages."""
        kw = dict(nlambda=17, ncells=8, packets=1 << 12, n_instruments=1,
                  store_absorption=False, max_scatt=16,
                  quadrature_panels=8, vary_lambda=True)
        run_x, zeros_x, ell, L0 = _build(**kw)
        run_f, zeros_f, _, _ = _build(fused=True, **kw)
        key = jax.random.key(1)
        tx = jax.jit(lambda k: run_x(k, ell, L0, zeros_x()))(key)
        tf = jax.jit(lambda k: run_f(k, ell, L0, zeros_f()))(key)
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        assert ff.sum() == pytest.approx(fx.sum(), rel=0.03)

    def test_refill_with_lam_inputs(self):
        """refill + lam-inputs together (the bc budget ref sits after the
        lambda inputs in the state tuple)."""
        kw = dict(nlambda=17, ncells=8, packets=1 << 12, n_instruments=1,
                  store_absorption=False, max_scatt=16,
                  quadrature_panels=8, vary_lambda=True)
        run_x, zeros_x, ell, L0 = _build(**kw)
        tx = jax.jit(lambda k: run_x(k, ell, L0, zeros_x()))(
            jax.random.key(1))
        kwr = dict(kw, packets=1 << 10)
        run_r, zeros_r, ell_r, L0_r = _build(fused=True, refill_batches=4,
                                             **kwr)
        tr = jax.jit(lambda k: run_r(k, ell_r, L0_r, zeros_r()))(
            jax.random.key(1))
        fx = np.asarray(tx["instruments"][0]["Ftot"], np.float64)
        fr = np.asarray(tr["instruments"][0]["Ftot"], np.float64)
        assert fr.sum() == pytest.approx(fx.sum(), rel=0.04)
