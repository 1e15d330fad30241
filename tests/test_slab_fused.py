"""Fused table event composed with slab sharding
(parallel/slab_fused.py, VERDICT r4 #3).

Packets sharded N/D per device, rho/labs slab-sharded, the per-event
physics in the same fused table event per device; the panel
rows are assembled by a ppermute ring sweep.  Parity vs the
single-device fused table engine within MC tolerance (per-device RNG
streams differ).  Runs on the 8-virtual-CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt_tpu import rng as srng
from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
from skirt_tpu.parallel.slab_fused import make_slab_fused_lifecycle

from test_slab import build, slab_mesh8


def _opts(**kw):
    base = dict(store_absorption=True, max_scatt_events=32,
                deposition="sampled", quadrature_panels=16,
                peel_panels=32, fused=True, table_peel="exact")
    base.update(kw)
    return LifecycleOptions(**base)


@pytest.fixture(scope="module")
def trio():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    wg, ss, grid, dsys, instruments = build(tau=2.0, albedo=0.4)
    tds = dsys.as_table()
    npk = 1 << 12          # quick-tier size; MC tolerances below match
    key = srng.root_key(7)
    ell = jnp.zeros((npk,), jnp.int32)
    L0 = jnp.full((npk,), 1.0 / npk, jnp.float32)

    run1 = make_lifecycle(grid, tds, ss, instruments, _opts(), 1)
    t1 = jax.jit(run1)(key, ell, L0, {
        "instruments": [i.zero_tallies() for i in instruments],
        "labs": jnp.zeros((grid.ncells,), jnp.float32)})

    runf = make_slab_fused_lifecycle(slab_mesh8(), grid, tds, ss,
                                     instruments, _opts(), 1)
    tf = runf(key, ell, L0)
    return t1, tf, grid


class TestSlabFusedParity:
    def test_sed_matches_single_device(self, trio):
        t1, tf, _ = trio
        f1 = np.asarray(t1["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(ff, f1, rtol=0.07)
        i1 = np.asarray(t1["instruments"][1]["Ftot"], np.float64)
        im = np.asarray(tf["instruments"][1]["Ftot"], np.float64)
        np.testing.assert_allclose(im, i1, rtol=0.07)

    def test_labs_sharded_and_matching(self, trio):
        t1, tf, grid = trio
        l1 = np.asarray(t1["labs"], np.float64)
        lf = np.asarray(tf["labs"], np.float64)
        assert lf.shape == l1.shape           # global order, slab-sharded
        assert lf.sum() == pytest.approx(l1.sum(), rel=0.07)
        # deposits landed in the right slab shards
        s1 = l1.reshape(8, -1).sum(1)
        sf = lf.reshape(8, -1).sum(1)
        # rtol for the bulk slabs, atol floor for the thin outer slabs
        # (per-device RNG streams differ -> MC noise at small counts)
        np.testing.assert_allclose(sf, s1, rtol=0.3, atol=5e-3)

    def test_finite(self, trio):
        _, tf, _ = trio
        for leaf in jax.tree.leaves(tf):
            assert np.isfinite(np.asarray(leaf)).all()


class TestSlabFusedRefill:
    def test_refill_matches_plain(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        wg, ss, grid, dsys, instruments = build(tau=2.0, albedo=0.4)
        tds = dsys.as_table()
        key = srng.root_key(9)
        npk = 1 << 13
        ell = jnp.zeros((npk,), jnp.int32)
        L0 = jnp.full((npk,), 1.0 / npk, jnp.float32)
        runf = make_slab_fused_lifecycle(slab_mesh8(), grid, tds, ss,
                                         instruments, _opts(), 1)
        tf = runf(key, ell, L0)

        # K=4 refill on npk/4 lanes covers the same packet total
        nl = npk // 4
        ell_r = jnp.zeros((nl,), jnp.int32)
        L0_r = jnp.full((nl,), 1.0 / npk, jnp.float32)
        runr = make_slab_fused_lifecycle(
            slab_mesh8(), grid, tds, ss, instruments,
            _opts(refill_batches=4), 1)
        tr = runr(key, ell_r, L0_r)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        fr = np.asarray(tr["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fr, ff, rtol=0.08)
        lf = float(np.asarray(tf["labs"]).sum())
        lr = float(np.asarray(tr["labs"]).sum())
        assert lr == pytest.approx(lf, rel=0.08)


class TestSlabFusedPoly:
    """Polychromatic lanes composed with slab sharding (round 5): the
    production-width estimator per device on sharded lanes, raw-rho ring
    fill, lambda-shared peel sweep.  Parity vs the single-device poly
    engine at matched per-wavelength launch totals."""

    def test_poly_matches_single_device(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from skirt_tpu.parallel.slab_fused import (
            make_slab_fused_poly_lifecycle)
        wg, ss, grid, dsys, instruments = build(tau=2.0, albedo=0.4,
                                                nlambda=2)
        tds = dsys.as_table()
        W = 2
        npl = 1 << 12
        key = srng.root_key(21)
        ell = jnp.zeros((npl,), jnp.int32)
        L0 = jnp.full((npl, W), 1.0 / npl, jnp.float32)
        opts = _opts(polychromatic=True)

        run1 = make_lifecycle(grid, tds, ss, instruments, opts, W)
        t1 = jax.jit(run1)(key, ell, L0, {
            "instruments": [i.zero_tallies() for i in instruments],
            "labs": jnp.zeros((grid.ncells * W,), jnp.float32)})

        runp = make_slab_fused_poly_lifecycle(
            slab_mesh8(), grid, tds, ss, instruments, opts, W)
        tp = runp(key, ell, L0)
        f1 = np.asarray(t1["instruments"][0]["Ftot"], np.float64)
        fp = np.asarray(tp["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(fp, f1, rtol=0.08)
        l1 = np.asarray(t1["labs"], np.float64)
        lp = np.asarray(tp["labs"], np.float64)
        assert lp.shape == l1.shape
        assert lp.sum() == pytest.approx(l1.sum(), rel=0.08)
        s1 = l1.reshape(8, -1).sum(1)
        sp = lp.reshape(8, -1).sum(1)
        np.testing.assert_allclose(sp, s1, rtol=0.3, atol=5e-3)
        for leaf in jax.tree.leaves(tp):
            assert np.isfinite(np.asarray(leaf)).all()


class TestSlabFusedMulti:
    """Round-5 addendum: multi-component dust on the slab-fused engine
    ((kext*rho, ksca*rho) row pairs through the ring; component
    selection + blended peel XLA-side with a psum publishing the
    interaction cell's per-component densities)."""

    def test_two_component_parity(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        wg, ss, grid, dsys, instruments = build(ncomp=2)
        tds = dsys.as_table()
        assert tds.ncomp == 2
        npk = 1 << 12
        key = srng.root_key(17)
        ell = jnp.zeros((npk,), jnp.int32)
        L0 = jnp.full((npk,), 1.0 / npk, jnp.float32)
        run1 = make_lifecycle(grid, tds, ss, instruments, _opts(), 1)
        t1 = jax.jit(run1)(key, ell, L0, {
            "instruments": [i.zero_tallies() for i in instruments],
            "labs": jnp.zeros((grid.ncells,), jnp.float32)})
        runf = make_slab_fused_lifecycle(slab_mesh8(), grid, tds, ss,
                                         instruments, _opts(), 1)
        tf = runf(key, ell, L0)
        f1 = np.asarray(t1["instruments"][0]["Ftot"], np.float64)
        ff = np.asarray(tf["instruments"][0]["Ftot"], np.float64)
        np.testing.assert_allclose(ff, f1, rtol=0.07)
        l1 = float(np.asarray(t1["labs"]).sum())
        lf = float(np.asarray(tf["labs"]).sum())
        assert lf == pytest.approx(l1, rel=0.07)


class TestSlabFusedGates:
    def test_gates(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        wg, ss, grid, dsys, instruments = build()
        with pytest.raises(ValueError, match="table dust"):
            make_slab_fused_lifecycle(slab_mesh8(), grid, dsys, ss,
                                      instruments, _opts(), 1)
