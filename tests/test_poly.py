"""Polychromatic fused table event (engine/fused_table_poly.py) parity.

Each lane carries ALL wavelengths on one mixture-sampled geometric path;
fluxes and absorption must agree with the monochromatic fused table
path within MC noise at MATCHED per-wavelength launch totals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt_tpu import rng
from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
from skirt_tpu.instruments import SEDInstrument

from test_voxelize import _torus_setup

N = 1 << 13


def _table_setup():
    wg, ss, grid, dsys = _torus_setup()
    vds, fold = dsys.voxelized()
    tds = vds.as_table()
    ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2, azimuth=0.7)]
    return wg, ss, tds, ins


def _run_mono(tds, ss, ins, **opt_kw):
    ell = jnp.asarray(np.arange(N, dtype=np.int32) % 2)
    L0 = jnp.full((N,), 1e36 / N, jnp.float32)
    opts = LifecycleOptions(store_absorption=True, max_scatt_events=48,
                            deposition="sampled", quadrature_panels=24,
                            fused=True, table_peel="exact", **opt_kw)
    run = jax.jit(make_lifecycle(tds.grid, tds, ss, ins, opts, 2))
    return run(rng.root_key(4357), ell, L0, {
        "instruments": [ins[0].zero_tallies()],
        "labs": jnp.zeros((tds.grid.ncells * 2,), jnp.float32)})


def _run_poly(tds, ss, ins, n, refill=0, seed=4357, **opt_kw):
    # per-wavelength launch total must match the mono run: the mono run
    # launches N/2 packets per wavelength at L0 = 1e36/N each
    K = max(refill, 1)
    L0 = jnp.full((n, 2), 5e35 / (n * K), jnp.float32)
    ell = jnp.zeros((n,), jnp.int32)
    opts = LifecycleOptions(store_absorption=True, max_scatt_events=48,
                            deposition="sampled", quadrature_panels=24,
                            fused=True, polychromatic=True,
                            table_peel="exact", refill_batches=refill,
                            **opt_kw)
    run = jax.jit(make_lifecycle(tds.grid, tds, ss, ins, opts, 2))
    return run(rng.root_key(seed), ell, L0, {
        "instruments": [ins[0].zero_tallies()],
        "labs": jnp.zeros((tds.grid.ncells * 2,), jnp.float32)})


@pytest.fixture(scope="module")
def duo():
    wg, ss, tds, ins = _table_setup()
    tm = _run_mono(tds, ss, ins)
    tp = _run_poly(tds, ss, ins, N // 2)
    return tm, tp


class TestPolyParity:
    def test_sed_matches_mono(self, duo):
        tm, tp = duo
        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.06)

    def test_absorption_matches_mono(self, duo):
        tm, tp = duo
        lm = np.asarray(tm["labs"], np.float64)
        lp = np.asarray(tp["labs"], np.float64)
        assert lp.sum() == pytest.approx(lm.sum(), rel=0.05)
        # per-wavelength absorption split must match too (the sampled
        # single-deposit stream is unbiased per wavelength)
        assert lp.reshape(-1, 2).sum(0) == pytest.approx(
            lm.reshape(-1, 2).sum(0), rel=0.06)

    def test_everything_finite(self, duo):
        for t in duo:
            for leaf in jax.tree.leaves(t):
                assert np.isfinite(np.asarray(leaf)).all()


class TestPolyRefill:
    def test_refill_normalization(self, duo):
        """K packets on n/K persistent polychromatic lanes reproduces
        the plain poly run."""
        tm, _ = duo
        wg, ss, tds, ins = _table_setup()
        tr = _run_poly(tds, ss, ins, N // 8, refill=4)
        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fr = np.asarray(tr["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fr, fm, rtol=0.08)
        lm = float(np.asarray(tm["labs"]).sum())
        lr = float(np.asarray(tr["labs"]).sum())
        assert lr == pytest.approx(lm, rel=0.08)


class TestPolyGates:
    def test_multicomponent_direct_grid_bails(self):
        """Multi-component poly needs the uniform Cartesian voxel view
        (round 5 lifted the single-component cap there); direct-table
        grids (exact Voronoi) stay single-component."""
        from skirt_tpu.engine.fused_table_poly import (
            make_fused_table_poly_lifecycle)
        wg, ss, tds, ins = _table_setup()

        class FakeGrid:
            pass                       # no _uniform attribute

        class FakeDS:
            table = True
            ncomp = 2

        opts = LifecycleOptions(fused=True, polychromatic=True,
                                deposition="sampled")
        with pytest.raises(ValueError, match="uniform Cartesian"):
            make_fused_table_poly_lifecycle(FakeGrid(), FakeDS(), ss,
                                            ins, opts, 2)


class TestPolyAnalytic:
    """Polychromatic lanes on the fused ANALYTIC megakernel
    (engine/fused_poly.py): one set of panel density evaluations serves
    every wavelength.  Parity vs the monochromatic fused kernel at
    matched per-wavelength launch totals."""

    def _setup(self):
        from skirt_tpu.constants import KPC
        from skirt_tpu.geometry import ExpDiskGeometry, PointGeometry
        from skirt_tpu.grids import CartesianGrid
        from skirt_tpu.media import (DustComponent, DustSystem,
                                     OpticalDepthNormalization,
                                     SimpleOligoDustMix)
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([0.55e-6, 2.2e-6])
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1e36, 1e36])])
        half = 12 * 3.086e19
        b = np.linspace(-half, half, 33)
        bz = np.linspace(-half / 6, half / 6, 17)
        grid = CartesianGrid(b, b, bz)
        mix = SimpleOligoDustMix(wg, [2600.0, 600.0], [0.5, 0.4],
                                 [0.4, 0.2])
        comp = DustComponent(ExpDiskGeometry(half / 3, half / 60), mix,
                             OpticalDepthNormalization("z", 0.55e-6, 1.0))
        dsys = DustSystem(grid, [comp], density_mode="analytic")
        ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2,
                             azimuth=0.7)]
        return wg, ss, grid, dsys, ins

    def test_matches_mono_fused(self):
        wg, ss, grid, dsys, ins = self._setup()
        n = 1 << 13
        opts_m = LifecycleOptions(store_absorption=True,
                                  deposition="sampled",
                                  quadrature_panels=24, peel_panels=8,
                                  max_scatt_events=48, fused=True)
        run_m = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts_m, 2))
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
        L0 = jnp.full((n,), 1e36 / n, jnp.float32)
        tm = run_m(rng.root_key(4357), ell, L0, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})

        opts_p = LifecycleOptions(store_absorption=True,
                                  deposition="sampled",
                                  quadrature_panels=24, peel_panels=8,
                                  max_scatt_events=48, fused=True,
                                  polychromatic=True)
        run_p = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts_p, 2))
        npl = n // 2
        L0p = jnp.full((npl, 2), 5e35 / npl, jnp.float32)
        tp = run_p(rng.root_key(4357), jnp.zeros(npl, jnp.int32), L0p, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})

        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.06)
        lm = float(np.asarray(tm["labs"]).sum())
        lp = float(np.asarray(tp["labs"]).sum())
        assert lp == pytest.approx(lm, rel=0.06)
        for t in (tm, tp):
            for leaf in jax.tree.leaves(t):
                assert np.isfinite(np.asarray(leaf)).all()

    def test_refill_normalization(self):
        wg, ss, grid, dsys, ins = self._setup()
        n = 1 << 13
        opts_p = LifecycleOptions(store_absorption=True,
                                  deposition="sampled",
                                  quadrature_panels=24, peel_panels=8,
                                  max_scatt_events=48, fused=True,
                                  polychromatic=True)
        run_p = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts_p, 2))
        npl = n // 2
        L0p = jnp.full((npl, 2), 5e35 / npl, jnp.float32)
        tp = run_p(rng.root_key(4357), jnp.zeros(npl, jnp.int32), L0p, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})

        opts_r = LifecycleOptions(store_absorption=True,
                                  deposition="sampled",
                                  quadrature_panels=24, peel_panels=8,
                                  max_scatt_events=48, fused=True,
                                  polychromatic=True, refill_batches=4)
        run_r = jax.jit(make_lifecycle(grid, dsys, ss, ins, opts_r, 2))
        npr = npl // 4
        L0r = jnp.full((npr, 2), 5e35 / npl, jnp.float32)
        tr = run_r(rng.root_key(4357), jnp.zeros(npr, jnp.int32), L0r, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        fr = np.asarray(tr["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fr, fp, rtol=0.08)


class TestPolyWide:
    """Production-width wavelength vectors (nlambda > 8): the W axis is
    a vectorized leading array dimension in both poly kernels, so the
    old per-lane unroll cap is gone.  Parity vs the monochromatic fused
    kernel at matched per-wavelength launch totals, with per-lambda
    VARYING optical properties (catches W-axis indexing errors)."""

    W = 12

    def _setup(self):
        from skirt_tpu.geometry import ExpDiskGeometry, PointGeometry
        from skirt_tpu.grids import CartesianGrid
        from skirt_tpu.media import (DustComponent, DustSystem,
                                     OpticalDepthNormalization,
                                     SimpleOligoDustMix)
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        W = self.W
        wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 2.4e-6, W)))
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1e36] * W)])
        half = 12 * 3.086e19
        b = np.linspace(-half, half, 17)
        bz = np.linspace(-half / 6, half / 6, 9)
        grid = CartesianGrid(b, b, bz)
        fac = np.linspace(1.0, 0.25, W)
        mix = SimpleOligoDustMix(wg, list(2600.0 * fac),
                                 list(0.6 * np.linspace(1.0, 0.5, W)),
                                 list(0.5 * np.linspace(1.0, 0.3, W)))
        comp = DustComponent(ExpDiskGeometry(half / 3, half / 60), mix,
                             OpticalDepthNormalization("z", 0.4e-6, 1.5))
        dsys = DustSystem(grid, [comp], density_mode="analytic")
        ins = [SEDInstrument("sed", 3.08e23, W, inclination=1.2,
                             azimuth=0.7)]
        return wg, ss, grid, dsys, ins

    def test_wide_matches_mono(self):
        wg, ss, grid, dsys, ins = self._setup()
        W = self.W
        n = 6 * 1024
        common = dict(store_absorption=True, deposition="sampled",
                      quadrature_panels=16, peel_panels=8,
                      max_scatt_events=32, fused=True)
        run_m = jax.jit(make_lifecycle(
            grid, dsys, ss, ins, LifecycleOptions(**common), W))
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % W)
        L0 = jnp.full((n,), W * 1e36 / n, jnp.float32)
        tm = run_m(rng.root_key(4357), ell, L0, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})

        run_p = jax.jit(make_lifecycle(
            grid, dsys, ss, ins,
            LifecycleOptions(polychromatic=True, **common), W))
        # the sampled single-deposit stream splits ~n_events deposits
        # over W wavelengths: keep the lane count high enough that the
        # per-wavelength split is measured above MC noise
        npl = 4096
        L0p = jnp.full((npl, W), 1e36 / npl, jnp.float32)
        tp = run_p(rng.root_key(4357), jnp.zeros(npl, jnp.int32), L0p, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})

        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.15)
        lm = np.asarray(tm["labs"], np.float64).reshape(-1, W).sum(0)
        lp = np.asarray(tp["labs"], np.float64).reshape(-1, W).sum(0)
        # per-wavelength absorption split stays unbiased at wide W
        np.testing.assert_allclose(lp.sum(), lm.sum(), rtol=0.05)
        np.testing.assert_allclose(lp, lm, rtol=0.2)
        for t in (tm, tp):
            for leaf in jax.tree.leaves(t):
                assert np.isfinite(np.asarray(leaf)).all()


class TestPolyMulti:
    """Multi-component polychromatic lanes (round 5): H raw rho row sets
    staged per event, per-(component, wavelength) blending in the body, the
    interaction sampled from the uniform-driver mixture of composite-
    biased forced pdfs in path length.  Parity vs the monochromatic
    multi-component fused kernel at matched per-wavelength totals."""

    def test_two_component_matches_mono(self):
        from test_fused_table import TestMultiComponentFused, _run
        wg, ss, tds = TestMultiComponentFused()._setup2()
        ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2,
                             azimuth=0.7)]
        n = 1 << 13
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
        L0 = jnp.full((n,), 1e36 / n, jnp.float32)
        assert tds.ncomp == 2
        tm = _run(tds, ss, ins, ell, L0, fused=True, table_peel="exact")

        npl = n // 2
        L0p = jnp.full((npl, 2), 5e35 / npl, jnp.float32)
        opts = LifecycleOptions(store_absorption=True, max_scatt_events=48,
                                deposition="sampled", quadrature_panels=24,
                                fused=True, polychromatic=True,
                                table_peel="exact")
        run = jax.jit(make_lifecycle(tds.grid, tds, ss, ins, opts, 2))
        tp = run(rng.root_key(4357), jnp.zeros(npl, jnp.int32), L0p, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((tds.grid.ncells * 2,), jnp.float32)})

        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.06)
        lm = np.asarray(tm["labs"], np.float64)
        lp = np.asarray(tp["labs"], np.float64)
        assert lp.sum() == pytest.approx(lm.sum(), rel=0.06)
        # per-wavelength absorption split stays unbiased
        np.testing.assert_allclose(lp.reshape(-1, 2).sum(0),
                                   lm.reshape(-1, 2).sum(0), rtol=0.08)
        for t in (tm, tp):
            for leaf in jax.tree.leaves(t):
                assert np.isfinite(np.asarray(leaf)).all()


class TestPolyAnisotropic:
    """Anisotropic stellar components on polychromatic lanes (round 5):
    the emission-peel direction weight is wavelength-free for every
    catalog angular distribution (matching the reference's concrete
    classes), so one probability call serves all lanes."""

    def test_anisotropic_matches_mono(self):
        from skirt_tpu.geometry import NetzerAccretionDiskGeometry
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        wg, _ss, tds, ins = _table_setup()
        ss = StellarSystem([LuminosityStellarComponent(
            NetzerAccretionDiskGeometry(), wg, [1e36, 1e36])])
        assert not ss.is_isotropic
        n = 1 << 13
        tm = _run_mono(tds, ss, ins)
        tp = _run_poly(tds, ss, ins, n // 2)
        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.06)
        lm = float(np.asarray(tm["labs"]).sum())
        lp = float(np.asarray(tp["labs"]).sum())
        assert lp == pytest.approx(lm, rel=0.06)


class TestPolyDirect:
    """Polychromatic lanes on a DIRECT-table grid (the exact Voronoi
    tessellation, no voxel rasterization): the kernel emits the deposit
    distance + sampled wavelength and the lifecycle finishes the bin
    with one locate_batched per iteration.  Parity vs the monochromatic
    direct-table path at matched per-wavelength launch totals."""

    def _setup(self):
        from skirt_tpu.constants import KPC
        from skirt_tpu.geometry import (PointGeometry,
                                        UniformSphereGeometry)
        from skirt_tpu.grids.voronoi import VoronoiGrid
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem, SimpleOligoDustMix)
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([0.55e-6, 2.2e-6])
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1e36, 1e36])])
        half = 2.0 * KPC
        rs = np.random.default_rng(11)
        sites = rs.uniform(-0.98 * half, 0.98 * half, size=(300, 3))
        grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                           volume_samples=16)
        mix = SimpleOligoDustMix(wg, [2600.0, 600.0], [0.5, 0.4],
                                 [0.4, 0.2])
        mass = 2.0 / 2600.0 * (4 / 3 * np.pi * (1.8 * KPC) ** 3) \
            / (1.8 * KPC)
        comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                             DustMassNormalization(mass))
        tds = DustSystem(grid, [comp], density_mode="gridded").as_table()
        ins = [SEDInstrument("sed", 3.08e23, 2, inclination=1.2,
                             azimuth=0.7)]
        return wg, ss, tds, ins

    def test_matches_mono_direct(self):
        wg, ss, tds, ins = self._setup()
        grid = tds.grid
        n = 1 << 13
        common = dict(store_absorption=True, deposition="sampled",
                      quadrature_panels=16, peel_panels=32,
                      max_scatt_events=48, fused=True,
                      table_peel="staged")
        opts_m = LifecycleOptions(**common)
        run_m = jax.jit(make_lifecycle(grid, tds, ss, ins, opts_m, 2))
        ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
        L0 = jnp.full((n,), 1e36 / n, jnp.float32)
        tm = run_m(rng.root_key(4357), ell, L0, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})

        opts_p = LifecycleOptions(polychromatic=True, **common)
        run_p = jax.jit(make_lifecycle(grid, tds, ss, ins, opts_p, 2))
        npl = n // 2
        L0p = jnp.full((npl, 2), 5e35 / npl, jnp.float32)
        tp = run_p(rng.root_key(4357), jnp.zeros(npl, jnp.int32), L0p, {
            "instruments": [ins[0].zero_tallies()],
            "labs": jnp.zeros((grid.ncells * 2,), jnp.float32)})

        fm = np.asarray(tm["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, fm, rtol=0.08)
        lm = np.asarray(tm["labs"], np.float64)
        lp = np.asarray(tp["labs"], np.float64)
        assert lp.sum() == pytest.approx(lm.sum(), rel=0.06)
        # per-wavelength absorption split (sampled single-deposit
        # stream must stay unbiased per wavelength on the direct grid)
        assert lp.reshape(-1, 2).sum(0) == pytest.approx(
            lm.reshape(-1, 2).sum(0), rel=0.08)
        for t in (tm, tp):
            for leaf in jax.tree.leaves(t):
                assert np.isfinite(np.asarray(leaf)).all()
