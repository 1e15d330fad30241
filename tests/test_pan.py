"""Panchromatic dust-emission loop tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from skirt_tpu import rng
from skirt_tpu.constants import K_BOLTZMANN, C_LIGHT, H_PLANCK
from skirt_tpu.engine.lifecycle import LifecycleOptions
from skirt_tpu.engine.pan import PanSimulation
from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.log import SilentLog
from skirt_tpu.media import (DustComponent, DustMassNormalization, DustSystem,
                             SimpleOligoDustMix)
from skirt_tpu.media.emissivity import GreyBodyEmissivity
from skirt_tpu.sources.sed import BlackBodySED
from skirt_tpu.sources.stellar import (BolometricLuminosityNormalization,
                                       StellarComponent, StellarSystem)
from skirt_tpu.wavelengths import LogWavelengthGrid

SIGMA_SB = 5.670374419e-8


class TestGreyBodyEmissivity:
    def test_equilibrium_temperature_grey_dust(self):
        # grey opacity kappa: planckabs(T) = kappa sigma T^4 / pi
        wg = LogWavelengthGrid(0.05e-6, 3000e-6, 200)
        kappa = 10.0
        mix = SimpleOligoDustMix.__new__(SimpleOligoDustMix)  # bypass oligo check
        from skirt_tpu.media.mix import DustMix
        mix = DustMix(wg, np.full(200, kappa), np.zeros(200), np.zeros(200))
        em = GreyBodyEmissivity(mix)
        for T_true in [20.0, 50.0, 200.0, 1000.0]:
            target = kappa * SIGMA_SB * T_true ** 4 / np.pi
            T = float(em.equilibrium_T(jnp.asarray([target], jnp.float32))[0])
            assert T == pytest.approx(T_true, rel=0.02), T_true

    def test_emission_spectrum_peak_wien(self):
        wg = LogWavelengthGrid(0.5e-6, 3000e-6, 300)
        from skirt_tpu.media.mix import DustMix
        mix = DustMix(wg, np.full(300, 5.0), np.zeros(300), np.zeros(300))
        em = GreyBodyEmissivity(mix)
        T_true = 40.0
        target = 5.0 * SIGMA_SB * T_true ** 4 / np.pi
        frac = np.asarray(em.emissivity_fractions(
            jnp.asarray([target], jnp.float32))[0])
        assert frac.sum() == pytest.approx(1.0, rel=1e-4)
        lam_peak = wg.lambdav[np.argmax(frac / wg.dlambdav)]
        # Wien: lambda_max = 2.898e-3 / T
        assert lam_peak == pytest.approx(2.898e-3 / T_true, rel=0.1)


def build_pan_sim(tau=2.0, packets=2000, nlambda=24, self_absorption=False,
                  density_mode="gridded", deposition="path", **opt_kw):
    wg = LogWavelengthGrid(0.1e-6, 1000e-6, nlambda)
    star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                            BolometricLuminosityNormalization(100.0))
    ss = StellarSystem([star])

    half, n = 1.0, 8
    b = np.linspace(-half, half, n + 1)
    grid = CartesianGrid(b, b, b)
    R = 0.9 * half
    # realistic-shaped opacity: opaque in UV/optical, nearly transparent in
    # the IR (otherwise dust re-absorbs its own emission and, without the
    # self-absorption loop, that energy is legitimately lost)
    kappa = np.where(wg.lambdav < 1e-6, 3.0, 0.003)
    from skirt_tpu.media.mix import DustMix
    mix = DustMix(wg, kappa, np.zeros(nlambda), np.zeros(nlambda))  # albedo 0
    volume = 4.0 / 3.0 * np.pi * R ** 3
    mass = tau / (3.0 * R) * volume  # kappa_UV * rho * R = tau
    comp = DustComponent(UniformSphereGeometry(R), mix,
                         DustMassNormalization(mass))
    dsys = DustSystem(grid, [comp], samples_per_cell=8,
                      density_mode=density_mode)
    ins = SEDInstrument("sed", 1e4, nlambda, inclination=0.7, azimuth=0.3)
    return PanSimulation(stellar_system=ss, instruments=[ins],
                         dust_system=dsys, packets=packets,
                         self_absorption=self_absorption, log=SilentLog(),
                         batch_size=1 << 14,
                         options=LifecycleOptions(store_absorption=True,
                                                  deposition=deposition,
                                                  **opt_kw))


class TestPanSimulation:
    def test_energy_conservation_with_reemission(self):
        # spherically symmetric pure-absorption cloud: everything absorbed is
        # re-emitted in the IR; total observed flux = L by symmetry
        sim = build_pan_sim(tau=2.0, packets=2000)
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        total = F.sum()
        assert total == pytest.approx(100.0, rel=0.05)
        # absorbed stellar energy is re-emitted at long wavelengths
        lam = sim.wavelength_grid.lambdav
        ir = lam > 1e-6
        frac_ir = F[ir].sum() / total
        direct_escape = np.exp(-2.0 * 0.9)  # tau through sphere radius
        assert frac_ir > 0.3  # significant reprocessing at tau=2
        # temperatures are sensible (warm dust near star, cooler outside)
        T = sim.cell_temperatures(acc)
        assert T.max() > 20.0 and T.max() < 2000.0

    def test_self_absorption_converges_grey_dust(self):
        # grey dust (same kappa at all wavelengths) re-absorbs its own
        # emission; only the converged self-absorption loop restores energy
        # conservation (ref: rundustselfabsorption)
        wg = LogWavelengthGrid(0.1e-6, 1000e-6, 24)
        star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                                BolometricLuminosityNormalization(100.0))
        ss = StellarSystem([star])
        half, n = 1.0, 8
        b = np.linspace(-half, half, n + 1)
        grid = CartesianGrid(b, b, b)
        R = 0.9 * half
        from skirt_tpu.media.mix import DustMix
        mix = DustMix(wg, np.full(24, 3.0), np.zeros(24), np.zeros(24))
        volume = 4.0 / 3.0 * np.pi * R ** 3
        mass = 2.0 / (3.0 * R) * volume
        comp = DustComponent(UniformSphereGeometry(R), mix,
                             DustMassNormalization(mass))
        dsys = DustSystem(grid, [comp], samples_per_cell=8)
        ins = SEDInstrument("sed", 1e4, 24, inclination=0.7, azimuth=0.3)
        sim = PanSimulation(stellar_system=ss, instruments=[ins],
                            dust_system=dsys, packets=2000,
                            self_absorption=True, log=SilentLog(),
                            batch_size=1 << 14,
                            options=LifecycleOptions(store_absorption=True))
        acc = sim.run()
        total = acc["instruments"][0]["Ftot"].sum()
        assert total == pytest.approx(100.0, rel=0.10)
        # with self-absorption some dust emission is re-absorbed
        assert acc["labs_dust"].sum() > 0.0


class TestMultiComponent:
    def test_two_component_energy_conservation(self):
        # two dust components with different IR-transparent opacities;
        # spherical symmetry -> total observed flux = L
        from skirt_tpu.geometry import UniformSphereGeometry
        from skirt_tpu.media.mix import DustMix
        wg = LogWavelengthGrid(0.1e-6, 1000e-6, 24)
        star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                                BolometricLuminosityNormalization(100.0))
        ss = StellarSystem([star])
        b = np.linspace(-1, 1, 9)
        grid = CartesianGrid(b, b, b)
        R = 0.9
        k1 = np.where(wg.lambdav < 1e-6, 3.0, 0.003)
        k2 = np.where(wg.lambdav < 1e-6, 1.0, 0.001)
        mix1 = DustMix(wg, k1, np.zeros(24), np.zeros(24))
        mix2 = DustMix(wg, k2, np.zeros(24), np.zeros(24))
        volume = 4 / 3 * np.pi * R ** 3
        comps = [
            DustComponent(UniformSphereGeometry(R), mix1,
                          DustMassNormalization(1.0 / (3.0 * R) * volume)),
            DustComponent(UniformSphereGeometry(R * 0.7), mix2,
                          DustMassNormalization(0.5 / (1.0 * R) * volume)),
        ]
        dsys = DustSystem(grid, comps, samples_per_cell=4)
        ins = SEDInstrument("sed", 1e4, 24, inclination=0.8)
        sim = PanSimulation(stellar_system=ss, instruments=[ins],
                            dust_system=dsys, packets=2000,
                            self_absorption=False, log=SilentLog(),
                            batch_size=1 << 13,
                            options=LifecycleOptions(store_absorption=True))
        acc = sim.run()
        total = acc["instruments"][0]["Ftot"].sum()
        assert total == pytest.approx(100.0, rel=0.07)


class TestPanAnalyticFastPath:
    """Pan dust-emission loop with the fast estimators: analytic
    midpoint densities + sampled deposition through every phase (stellar,
    dust emission with cell-launch launch_fn)."""

    def test_energy_conservation_analytic_sampled(self):
        sim = build_pan_sim(tau=2.0, packets=3000,
                            density_mode="analytic", deposition="sampled")
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert F.sum() == pytest.approx(100.0, rel=0.05)
        lam = sim.wavelength_grid.lambdav
        assert F[lam > 1e-6].sum() / F.sum() > 0.3

    def test_matches_gridded(self):
        g = build_pan_sim(tau=1.0, packets=4000).run()
        a = build_pan_sim(tau=1.0, packets=4000, density_mode="analytic",
                          deposition="sampled").run()
        Fg = g["instruments"][0]["Ftot"]
        Fa = a["instruments"][0]["Ftot"]
        assert abs(Fa.sum() - Fg.sum()) / Fg.sum() < 0.05
        # spectral SHAPE must agree too — regression for the massless-cell
        # emission spike (absorbed energy deposited into cells whose
        # gridded density sampled to zero must not re-emit with the
        # coldest table spectrum and pile into the last bin)
        big = Fg > 1e-3 * Fg.sum()
        np.testing.assert_allclose(Fa[big], Fg[big], rtol=0.35)
        assert Fa[-1] < 3.0 * max(Fg[-1], 1e-30)


class TestPanFused:
    """Fused event body through every pan phase (stellar + dust
    emission launch_fn); refill stays stellar-only and is stripped from
    the dust variants automatically."""

    def test_fused_pan_energy_conservation(self):
        sim = build_pan_sim(tau=2.0, packets=1024, density_mode="analytic",
                            deposition="sampled", fused=True,
                            quadrature_panels=8, max_scatt_events=24)
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert F.sum() == pytest.approx(100.0, rel=0.12)
        lam = sim.wavelength_grid.lambdav
        assert F[lam > 1e-6].sum() / F.sum() > 0.25

    def test_fused_with_refill_builds_dust_variants(self):
        # refill_batches on the user options must not leak into the dust
        # launch_fn variants (which would raise in the fused validator)
        sim = build_pan_sim(tau=1.0, packets=1024, density_mode="analytic",
                            deposition="sampled", fused=True,
                            quadrature_panels=8, max_scatt_events=24,
                            refill_batches=2)
        assert sim._run_dust_emit is not None

    @pytest.mark.parametrize("density_mode,voxelize,fused,dust_refill", [
        ("analytic", None, True, 1),      # analytic body: refill stripped
        ("gridded", None, False, 1),      # falls back to the vector path
        ("gridded", "table", True, 2),    # table body keeps refill
    ])
    def test_dust_batches_follow_the_options_used(self, density_mode,
                                                  voxelize, fused,
                                                  dust_refill):
        sim = build_pan_sim(tau=1.0, packets=1024, density_mode=density_mode,
                            deposition="sampled", fused=True,
                            quadrature_panels=8, max_scatt_events=24,
                            refill_batches=2, voxelize=voxelize)
        assert sim.options.fused is fused
        assert sim._dust_refill == dust_refill
        # each dust lane launches _dust_refill packets: the batches cover
        # the requested packets per wavelength, and no more than a batch
        # of lanes over
        lanes = sum(c for *_, c in sim._dust_batches(
            1000, np.ones(sim.nlambda)))
        assert lanes == -(-1000 // dust_refill)


class TestPanPoly:
    """Polychromatic pan phases: every lane carries the full wavelength
    vector; dust-emission lanes launch from a bolometric-sampled cell and
    carry that cell's emission spectrum (make_dust_launch_poly)."""

    def test_analytic_poly_energy_conservation(self):
        sim = build_pan_sim(tau=2.0, packets=1536, density_mode="analytic",
                            deposition="sampled", fused=True,
                            quadrature_panels=8, max_scatt_events=16,
                            polychromatic=True)
        assert sim._poly and sim._dust_poly
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert F.sum() == pytest.approx(100.0, rel=0.12)
        lam = sim.wavelength_grid.lambdav
        assert F[lam > 1e-6].sum() / F.sum() > 0.25

    def test_multicomponent_poly_pan_conserves(self):
        """Round 5: multi-component dust + polychromatic lanes through
        the full pan loop (2 components, table grid, poly dust launch)."""
        from skirt_tpu.media.mix import DustMix
        wg = LogWavelengthGrid(0.1e-6, 1000e-6, 24)
        star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                                BolometricLuminosityNormalization(100.0))
        ss = StellarSystem([star])
        b = np.linspace(-1, 1, 9)
        grid = CartesianGrid(b, b, b)
        R = 0.9
        k1 = np.where(wg.lambdav < 1e-6, 3.0, 0.003)
        k2 = np.where(wg.lambdav < 1e-6, 1.0, 0.001)
        mix1 = DustMix(wg, k1, np.zeros(24), np.zeros(24))
        mix2 = DustMix(wg, k2, np.zeros(24), np.zeros(24))
        volume = 4 / 3 * np.pi * R ** 3
        comps = [
            DustComponent(UniformSphereGeometry(R), mix1,
                          DustMassNormalization(1.0 / (3.0 * R) * volume)),
            DustComponent(UniformSphereGeometry(0.6 * R), mix2,
                          DustMassNormalization(0.5 / (3.0 * R) * volume)),
        ]
        dsys = DustSystem(grid, comps, samples_per_cell=8)
        ins = SEDInstrument("sed", 1e4, 24, inclination=0.7, azimuth=0.3)
        sim = PanSimulation(
            stellar_system=ss, instruments=[ins], dust_system=dsys,
            packets=2048, self_absorption=False, log=SilentLog(),
            batch_size=1 << 14,
            options=LifecycleOptions(store_absorption=True,
                                     deposition="sampled",
                                     voxelize="table", fused=True,
                                     quadrature_panels=16,
                                     table_peel="exact",
                                     polychromatic=True,
                                     refill_batches=4))
        assert sim._poly and sim._dust_poly
        assert sim.dust_system.ncomp == 2
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert float(F.sum()) == pytest.approx(100.0, rel=0.10)
        lam = sim.wavelength_grid.lambdav
        assert F[lam > 1e-6].sum() / F.sum() > 0.25

    def test_poly_matches_mono_pan(self):
        kw = dict(tau=1.0, packets=4096, density_mode="analytic",
                  deposition="sampled", fused=True, quadrature_panels=8,
                  max_scatt_events=24)
        m = build_pan_sim(**kw).run()
        p = build_pan_sim(polychromatic=True, **kw).run()
        Fm = np.asarray(m["instruments"][0]["Ftot"], np.float64)
        Fp = np.asarray(p["instruments"][0]["Ftot"], np.float64)
        assert Fp.sum() == pytest.approx(Fm.sum(), rel=0.05)
        big = Fm > 1e-3 * Fm.sum()
        np.testing.assert_allclose(Fp[big], Fm[big], rtol=0.35)


class TestPanOnTable:
    """Pan phases on tree grids via the voxel table (VERDICT r3 #6):
    options.voxelize='table' + fused runs the fused table kernel through
    the stellar AND dust phases while the emission solve, launch CDFs,
    and checkpoint arrays stay at leaf resolution (labs fold voxel ->
    leaf after every phase).  ref: PanMonteCarloSimulation.cpp:106-183."""

    def _octree_sim(self, **opt_kw):
        from skirt_tpu.grids.octree import OctreeGrid

        nlambda = 24
        wg = LogWavelengthGrid(0.1e-6, 1000e-6, nlambda)
        star = StellarComponent(PointGeometry(), BlackBodySED(wg, 6000.0),
                                BolometricLuminosityNormalization(100.0))
        ss = StellarSystem([star])
        half = 1.0
        R = 0.9 * half
        sphere = UniformSphereGeometry(R)

        def rho_np(pos):
            return np.asarray(sphere.density(pos))

        grid = OctreeGrid((-half, -half, -half, half, half, half), rho_np,
                          min_level=2, max_level=3)
        kappa = np.where(wg.lambdav < 1e-6, 3.0, 0.003)
        from skirt_tpu.media.mix import DustMix
        mix = DustMix(wg, kappa, np.zeros(nlambda), np.zeros(nlambda))
        volume = 4.0 / 3.0 * np.pi * R ** 3
        mass = 2.0 / (3.0 * R) * volume
        comp = DustComponent(sphere, mix, DustMassNormalization(mass))
        dsys = DustSystem(grid, [comp], samples_per_cell=8)
        ins = SEDInstrument("sed", 1e4, nlambda, inclination=0.7,
                            azimuth=0.3)
        return PanSimulation(
            stellar_system=ss, instruments=[ins], dust_system=dsys,
            packets=2000, self_absorption=False, log=SilentLog(),
            batch_size=1 << 14,
            options=LifecycleOptions(store_absorption=True,
                                     deposition="sampled", **opt_kw))

    def test_table_energy_conservation_and_leaf_resolution(self):
        sim = self._octree_sim(voxelize="table", fused=True,
                               quadrature_panels=16, table_peel="exact")
        # the traversal grid is the voxel view; emission stays on leaves
        leaf = sim.dust_system_out.grid
        assert sim.grid is not leaf
        assert getattr(sim.dust_system, "table", False)
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert float(F.sum()) == pytest.approx(100.0, rel=0.06)
        # folded absorption arrays are leaf-sized
        assert acc["labs_stellar"].shape[0] == leaf.ncells
        T = sim.cell_temperatures(acc)
        assert T.shape[0] == leaf.ncells
        assert T.max() > 20.0

    def test_table_poly_conserves_energy(self):
        sim = self._octree_sim(voxelize="table", fused=True,
                               quadrature_panels=16, table_peel="exact",
                               polychromatic=True, refill_batches=4)
        assert sim._poly and sim._dust_poly
        acc = sim.run()
        F = acc["instruments"][0]["Ftot"]
        assert float(F.sum()) == pytest.approx(100.0, rel=0.08)
        # re-emission present and leaf-resolution outputs intact
        assert acc["labs_stellar"].shape[0] == \
            sim.dust_system_out.grid.ncells
        T = sim.cell_temperatures(acc)
        assert T.max() > 20.0

    def test_table_matches_leaf_walk(self):
        sim_t = self._octree_sim(voxelize="table", fused=True,
                                 quadrature_panels=16, table_peel="exact")
        acc_t = sim_t.run()
        sim_l = self._octree_sim()
        acc_l = sim_l.run()
        Ft = np.asarray(acc_t["instruments"][0]["Ftot"], np.float64)
        Fl = np.asarray(acc_l["instruments"][0]["Ftot"], np.float64)
        assert Ft.sum() == pytest.approx(Fl.sum(), rel=0.05)
        # absorbed totals agree (leaf resolution both)
        at = float(np.asarray(acc_t["labs_stellar"]).sum())
        al = float(np.asarray(acc_l["labs_stellar"]).sum())
        assert at == pytest.approx(al, rel=0.05)
