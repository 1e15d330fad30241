"""Voronoi grid construction and traversal tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from skirt_tpu.engine import traversal
from skirt_tpu.grids.voronoi import VoronoiGrid


EXTENT = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)


def make_grid(n_sites=200, seed=5, volume_samples=256):
    rs = np.random.default_rng(seed)
    sites = rs.uniform(-0.98, 0.98, size=(n_sites, 3))
    return VoronoiGrid(sites, EXTENT, volume_samples=volume_samples)


def random_rays(n, seed=0):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(pos), jnp.asarray(d.astype(np.float32))


class TestConstruction:
    def test_volumes_sum_to_box(self):
        g = make_grid()
        assert g.cell_volumes().sum() == pytest.approx(8.0, rel=1e-6)

    def test_locate_matches_kdtree(self):
        g = make_grid()
        rs = np.random.default_rng(1)
        pts = rs.uniform(-0.99, 0.99, size=(500, 3))
        _, expected = g._tree.query(pts)
        got = np.asarray(g.locate(jnp.asarray(pts, jnp.float32)))
        assert (got == expected).mean() > 0.995  # float32 ties at boundaries

    def test_locate_outside(self):
        g = make_grid()
        got = np.asarray(g.locate(jnp.asarray([[2.0, 0.0, 0.0]], jnp.float32)))
        assert got[0] == -1


class TestTraversal:
    def test_chord_sums(self):
        g = make_grid()
        pos, d = random_rays(200)

        def seg(carry, cell, ds, t):
            return carry + ds, jnp.ones_like(carry, dtype=bool)

        total, _ = traversal.sweep(g, pos, d, seg, jnp.zeros(pos.shape[0]))
        p, dd = np.asarray(pos, np.float64), np.asarray(d, np.float64)
        with np.errstate(divide="ignore"):
            t2 = np.where(np.abs(dd) > 1e-12, (np.sign(dd) - p) / dd, np.inf)
        expected = np.min(t2, axis=1)
        np.testing.assert_allclose(np.asarray(total), expected, rtol=1e-2,
                                   atol=5e-3)

    def test_cells_crossed_match_bruteforce(self):
        # sample points along each ray; the set of nearest sites visited
        # must match the traversal's cell sequence support
        g = make_grid(n_sites=100, seed=7)
        pos, d = random_rays(20, seed=3)
        visited = jnp.zeros((20, g.ncells))

        def seg(carry, cell, ds, t):
            upd = jnp.where((cell >= 0) & (ds > 1e-6), 1.0, 0.0)
            rows = jnp.arange(20)
            return carry.at[rows, jnp.clip(cell, 0)].add(upd), jnp.ones(20, bool)

        visited, _ = traversal.sweep(g, pos, d, seg, visited)
        visited = np.asarray(visited) > 0

        p, dd = np.asarray(pos, np.float64), np.asarray(d, np.float64)
        with np.errstate(divide="ignore"):
            t2 = np.where(np.abs(dd) > 1e-12, (np.sign(dd) - p) / dd, np.inf)
        tmax = np.min(t2, axis=1)
        agree = 0
        checks = 0
        for i in range(20):
            svals = np.linspace(1e-4, tmax[i] - 1e-4, 500)
            pts = p[i] + svals[:, None] * dd[i]
            _, owner = g._tree.query(pts)
            brute = np.zeros(g.ncells, bool)
            brute[np.unique(owner)] = True
            # traversal may miss razor-thin crossings; demand high overlap
            checks += brute.sum()
            agree += (brute & visited[i]).sum()
        assert agree / checks > 0.95

    def test_optical_depth_uniform(self):
        g = make_grid()
        pos, d = random_rays(200, seed=4)
        kr = 1.3
        kapparho = lambda cell: jnp.where(cell >= 0, jnp.float32(kr), 0.0)
        tau = np.asarray(traversal.optical_depth(g, kapparho, pos, d))
        p, dd = np.asarray(pos, np.float64), np.asarray(d, np.float64)
        with np.errstate(divide="ignore"):
            t2 = np.where(np.abs(dd) > 1e-12, (np.sign(dd) - p) / dd, np.inf)
        expected = kr * np.min(t2, axis=1)
        np.testing.assert_allclose(tau, expected, rtol=1e-2, atol=5e-3)

    def test_in_cell_sampling(self):
        import jax
        g = make_grid(n_sites=64, seed=9)
        cells = jnp.asarray(np.arange(64, dtype=np.int32))
        p = np.asarray(g.random_position_in_cell_dev(jax.random.key(0), cells))
        _, owner = g._tree.query(p)
        assert (owner == np.arange(64)).mean() > 0.9


class TestNativeBuilder:
    def test_exact_volumes(self):
        g = make_grid(n_sites=150, seed=11)
        if not g.used_native:
            pytest.skip("native builder unavailable")
        # exact volumes: machine-precision tiling of the box
        assert g.cell_volumes().sum() == pytest.approx(8.0, abs=1e-9)

    def test_native_adjacency_supports_traversal(self):
        import jax.numpy as jnp
        from skirt_tpu.engine import traversal
        g = make_grid(n_sites=150, seed=11)
        pos, d = random_rays(100, seed=12)

        def seg(carry, cell, ds, t):
            return carry + ds, jnp.ones_like(carry, dtype=bool)

        total, _ = traversal.sweep(g, pos, d, seg, jnp.zeros(pos.shape[0]))
        p, dd = np.asarray(pos, np.float64), np.asarray(d, np.float64)
        with np.errstate(divide="ignore"):
            t2 = np.where(np.abs(dd) > 1e-12, (np.sign(dd) - p) / dd, np.inf)
        np.testing.assert_allclose(np.asarray(total), np.min(t2, axis=1),
                                   rtol=1e-2, atol=5e-3)


class TestDevicePointLocation:
    """Device locate_batched (matmul scan + block-candidate schemes)."""

    def test_scan_matches_kdtree(self):
        g = make_grid(n_sites=300)
        rs = np.random.default_rng(7)
        pts = rs.uniform(-0.99, 0.99, size=(800, 3))
        _, expected = g._tree.query(pts)
        got = np.asarray(g.locate_batched(jnp.asarray(pts, jnp.float32)))
        assert (got == expected).mean() > 0.995  # float32 boundary ties

    def test_blocks_match_kdtree(self):
        g = make_grid(n_sites=300)
        g._SCAN_MAX_SITES = 0  # force the block-candidate path
        rs = np.random.default_rng(8)
        pts = rs.uniform(-0.99, 0.99, size=(800, 3))
        _, expected = g._tree.query(pts)
        got = np.asarray(g.locate_batched(jnp.asarray(pts, jnp.float32)))
        assert (got == expected).mean() > 0.995

    def test_walk_matches_scan_exactly(self):
        """Neighbor-walk locate (round 5, the import-scale path): seed
        map + adjacency descent is EXACT — the walk's local minimum is
        the containing cell because the walls only clip, they never add
        bisectors."""
        g = make_grid(n_sites=700)
        rs = np.random.default_rng(9)
        pts = rs.uniform(-0.99, 0.99, size=(4000, 3))
        ps = g._scaled(jnp.asarray(pts, jnp.float32))
        ref = np.asarray(g._nearest_scan(ps))
        walk = np.asarray(g._nearest_walk(ps))
        assert (ref == walk).all()

    def test_outside_is_minus_one(self):
        g = make_grid()
        pts = jnp.asarray([[1.5, 0.0, 0.0], [0.0, 0.0, 0.5]], jnp.float32)
        got = np.asarray(g.locate_batched(pts))
        assert got[0] == -1 and got[1] >= 0

    def test_ray_span_matches_box(self):
        g = make_grid()
        pos, d = random_rays(64, seed=9)
        t0, t1 = g.ray_span(pos, d)
        p, dd = np.asarray(pos, np.float64), np.asarray(d, np.float64)
        with np.errstate(divide="ignore"):
            tfar = np.min(np.where(np.abs(dd) > 1e-12,
                                   (np.sign(dd) - p) / dd, np.inf), axis=1)
        np.testing.assert_allclose(np.asarray(t1), tfar, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(t0), 0.0, atol=1e-6)


class TestAnalyticFastPath:
    """Voronoi grids qualify for the analytic panel quadrature
    (ray_span + locate_batched): lifecycle results match gridded mode."""

    def test_lifecycle_analytic_vs_gridded(self):
        import jax
        from skirt_tpu import rng as _rng
        from skirt_tpu.engine.lifecycle import (LifecycleOptions,
                                                make_lifecycle)
        from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
        from skirt_tpu.instruments import SEDInstrument
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem, SimpleOligoDustMix)
        from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                               StellarSystem)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        g = make_grid(n_sites=400, volume_samples=512)
        wg = OligoWavelengthGrid([1e-6])
        ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                       [1.0])])
        mix = SimpleOligoDustMix(wg, [1.0], [0.4], [0.2])
        sphere = UniformSphereGeometry(0.9)
        mass = 2.0 * (4.0 / 3.0) * np.pi * 0.9 ** 3 / 0.9  # tau_r ~ 2
        comp = DustComponent(sphere, mix, DustMassNormalization(mass))
        ins = SEDInstrument("sed", 100.0, 1)
        n = 8192
        ell = jnp.zeros((n,), jnp.int32)
        L0 = jnp.full((n,), 1.0 / n, jnp.float32)

        outs = {}
        for mode in ("gridded", "analytic"):
            dsys = DustSystem(g, [comp], density_mode=mode)
            run = make_lifecycle(g, dsys, ss, [ins],
                                 LifecycleOptions(store_absorption=True),
                                 1)
            t0 = {"instruments": [ins.zero_tallies()],
                  "labs": jnp.zeros((g.ncells,), jnp.float32)}
            outs[mode] = jax.jit(run)(_rng.root_key(21), ell, L0, t0)
        Fg = float(np.asarray(outs["gridded"]["instruments"][0]["Ftot"])[0])
        Fa = float(np.asarray(outs["analytic"]["instruments"][0]["Ftot"])[0])
        # same MC stream; modes differ only in density discretization
        assert Fa == pytest.approx(Fg, rel=0.1)
        la = float(np.asarray(outs["analytic"]["labs"]).sum())
        lg = float(np.asarray(outs["gridded"]["labs"]).sum())
        assert la == pytest.approx(lg, rel=0.1)
        # energy balance: emitted = detected-direction flux + absorbed is
        # not closed (scattering), but both tallies must be positive
        assert Fa > 0 and la > 0


class TestVoxelizationErrorBound:
    def test_error_measured_and_refusal(self):
        """The approximate (nearest-site) rasterization's mass-weighted
        field error is measured at voxelize time; a tolerance below the
        measured value refuses the voxelization (callers fall back to
        the exact bisector walk).  High-contrast field: smooth sphere +
        10^3-contrast clumps sampled onto Voronoi sites."""
        import numpy as np
        from skirt_tpu.constants import KPC
        from skirt_tpu.geometry import UniformSphereGeometry
        from skirt_tpu.grids.voronoi import VoronoiGrid
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem, SimpleOligoDustMix)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([0.55e-6])
        half = 2.0 * KPC
        rs = np.random.default_rng(3)
        sites = rs.uniform(-0.98 * half, 0.98 * half, size=(1500, 3))
        grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                           volume_samples=16)
        mix = SimpleOligoDustMix(wg, [2600.0], [0.5], [0.4])
        comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                             DustMassNormalization(1e33))
        dsys = DustSystem(grid, [comp], density_mode="gridded")
        # inject 1e3 contrast into a random 3% of cells (clumpy import)
        hot = rs.random(grid.ncells) < 0.03
        dsys.rho64[:, hot] *= 1e3
        dsys.rho = np.asarray(dsys.rho64, np.float32)

        out = dsys.voxelized(max_voxels=48 ** 3)
        assert out is not None
        vds, _ = out
        err = vds.voxelization_error
        assert err is not None and 0.0 < err < 1.0
        # tolerance below the measurement refuses
        assert dsys.voxelized(max_voxels=48 ** 3,
                              max_field_error=err * 0.5) is None
        # tolerance above it accepts
        out2 = dsys.voxelized(max_voxels=48 ** 3,
                              max_field_error=err * 2.0)
        assert out2 is not None

    def test_error_decreases_with_resolution(self):
        import numpy as np
        from skirt_tpu.constants import KPC
        from skirt_tpu.geometry import UniformSphereGeometry
        from skirt_tpu.grids.voronoi import VoronoiGrid
        from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                     DustSystem, SimpleOligoDustMix)
        from skirt_tpu.wavelengths import OligoWavelengthGrid

        wg = OligoWavelengthGrid([0.55e-6])
        half = 2.0 * KPC
        rs = np.random.default_rng(4)
        sites = rs.uniform(-0.9 * half, 0.9 * half, size=(800, 3))
        grid = VoronoiGrid(sites, (-half, -half, -half, half, half, half),
                           volume_samples=16)
        mix = SimpleOligoDustMix(wg, [2600.0], [0.5], [0.4])
        comp = DustComponent(UniformSphereGeometry(1.8 * KPC), mix,
                             DustMassNormalization(1e33))
        dsys = DustSystem(grid, [comp], density_mode="gridded")
        dsys.rho64[:, rs.random(grid.ncells) < 0.05] *= 100.0
        dsys.rho = np.asarray(dsys.rho64, np.float32)
        e_lo = dsys.voxelized(max_voxels=24 ** 3)[0].voxelization_error
        e_hi = dsys.voxelized(max_voxels=64 ** 3)[0].voxelization_error
        assert e_hi < e_lo
