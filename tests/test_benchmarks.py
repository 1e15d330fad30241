"""Accuracy evidence against external physics, not against this framework.

The reference validates itself through published benchmark components
(ref: SKIRTcore/Benchmark1DDustMix.hpp — Ivezic et al. 1997 MNRAS 291,
121; SKIRTcore/Benchmark2DDustMix.hpp — Pascucci et al. 2004 A&A 417,
793; registered at Discover/RegisterSimulationItems.cpp:365-380).  The
published solution tables are not retrievable in this zero-egress
environment, so this suite substitutes validations whose expected values
come from OUTSIDE the framework:

  1. the published benchmark opacity LAWS themselves (closed-form,
     printed in Ivezic et al. 1997 / the reference's class docs);
  2. exact analytic solutions (pure-absorption attenuation e^-tau);
  3. an INDEPENDENT plain Monte Carlo in this file (numpy, analog
     sampling, no forced scattering, no biasing, no peel-off — zero
     shared estimator structure with the engine), which catches a
     consistently wrong estimator in a way self-pinned goldens cannot;
  4. independent radiative-equilibrium quadrature for dust temperature.

Every run goes through the same public pipeline a user would drive
(StellarSystem -> lifecycle -> instruments / PanSimulation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt_tpu import rng
from skirt_tpu.constants import C_LIGHT, H_PLANCK, K_BOLTZMANN
from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
from skirt_tpu.grids import CartesianGrid
from skirt_tpu.instruments import SEDInstrument
from skirt_tpu.media import (DustComponent, DustMassNormalization,
                             DustSystem)
from skirt_tpu.media.mix import Benchmark1DDustMix, Benchmark2DDustMix, DustMix
from skirt_tpu.sources.stellar import (BolometricLuminosityNormalization,
                                       StellarComponent, StellarSystem)
from skirt_tpu.sources.sed import BlackBodySED
from skirt_tpu.wavelengths import LogWavelengthGrid, OligoWavelengthGrid


# ---------------------------------------------------------------------------
# 1. Published benchmark opacity laws
# ---------------------------------------------------------------------------

class TestBenchmarkMixLaws:
    """The Ivezic (1997) §4 opacity law and Pascucci (2004) normalization,
    as published (and as encoded in the reference's Benchmark*DustMix)."""

    def test_ivezic_albedo_and_slopes(self):
        wg = OligoWavelengthGrid([0.25e-6, 0.55e-6, 1.0e-6, 2.0e-6, 8.0e-6])
        mix = Benchmark1DDustMix(wg)
        kabs = np.asarray(mix.kappaabs, np.float64)
        ksca = np.asarray(mix.kappasca, np.float64)
        # lambda <= 1um: albedo exactly 1/2, opacity flat
        assert ksca[0] == pytest.approx(kabs[0], rel=1e-12)
        assert kabs[0] == pytest.approx(kabs[1], rel=1e-12)
        # kappaext(0.55um) = kappaV = 2600 m^2/kg (Units::kappaV)
        assert kabs[1] + ksca[1] == pytest.approx(2600.0, rel=1e-12)
        # above the break: kabs ~ 1/lambda, ksca ~ 1/lambda^4
        assert kabs[3] / kabs[2] == pytest.approx(0.5, rel=1e-12)
        assert ksca[3] / ksca[2] == pytest.approx(0.5 ** 4, rel=1e-12)
        assert kabs[4] / kabs[2] == pytest.approx(1.0 / 8.0, rel=1e-12)
        # isotropic scattering: g = 0 at every wavelength
        assert np.all(np.asarray(mix.g) == 0.0)

    def test_pascucci_normalization(self):
        wg = OligoWavelengthGrid([0.55e-6, 1.0e-6, 10e-6])
        mix = Benchmark2DDustMix(wg)
        kext = np.asarray(mix.kappaabs) + np.asarray(mix.kappasca)
        # normalized so kappaext(V) = 2600 m^2/kg; the tabulated grid point
        # nearest 0.55um defines the scale (resampling wiggle < 2%)
        assert kext[0] == pytest.approx(2600.0, rel=0.02)
        assert np.all(np.asarray(mix.g) == 0.0)
        # extinction falls steeply to the IR (silicate-free benchmark dust)
        assert kext[2] < 0.2 * kext[0]


# ---------------------------------------------------------------------------
# 2. Exact analytic attenuation through the full pipeline
# ---------------------------------------------------------------------------

def _sphere_setup(tau, albedo, packets, nlambda=1, g=0.0,
                  density_mode="gridded", deposition="path", fused=False,
                  quadrature_panels=None, peel_panels=None,
                  refill_batches=0, seed=4357, min_weight_reduction=1e6,
                  max_scatt=200, ncells=12, L_src=1.0):
    """Central point source in a uniform sphere, tau = radial optical depth.

    Returns the detected SED tally (W) for one distant instrument.
    """
    lams = list(np.linspace(0.5e-6, 0.9e-6, nlambda))
    wg = OligoWavelengthGrid(lams)
    from skirt_tpu.sources.stellar import LuminosityStellarComponent
    ss = StellarSystem([LuminosityStellarComponent(
        PointGeometry(), wg, [L_src] * nlambda)])
    R = 1.0
    half = 1.1 * R
    b = np.linspace(-half, half, ncells + 1)
    grid = CartesianGrid(b, b, b)
    kext = 1000.0
    mix = DustMix(wg, np.full(nlambda, kext * (1 - albedo)),
                  np.full(nlambda, kext * albedo), np.full(nlambda, g))
    volume = 4.0 / 3.0 * np.pi * R ** 3
    rho = tau / (kext * R)            # tau = kext * rho * R
    comp = DustComponent(UniformSphereGeometry(R), mix,
                         DustMassNormalization(rho * volume))
    dsys = DustSystem(grid, [comp], samples_per_cell=6,
                      density_mode=density_mode)
    ins = SEDInstrument("sed", 1e4, nlambda, inclination=0.6, azimuth=1.1)
    opts = LifecycleOptions(store_absorption=False,
                            min_weight_reduction=min_weight_reduction,
                            max_scatt_events=max_scatt,
                            deposition=deposition,
                            quadrature_panels=quadrature_panels,
                            peel_panels=peel_panels,
                            refill_batches=refill_batches,
                            fused=fused)
    run = make_lifecycle(grid, dsys, ss, [ins], opts, nlambda)
    key = rng.root_key(seed)
    ell = jnp.asarray(np.arange(packets, dtype=np.int32) % nlambda)
    total = packets * max(refill_batches, 1)
    L0 = jnp.full((packets,), L_src * nlambda / total, jnp.float32)
    out = jax.jit(lambda k: run(k, ell, L0,
                                {"instruments": [ins.zero_tallies()]}))(key)
    return np.asarray(out["instruments"][0]["Ftot"], np.float64)


class TestExactAttenuation:
    """Pure absorption: detected = L * exp(-tau), exactly (the only MC
    element left is the launch; the peel-off estimator is deterministic)."""

    @pytest.mark.parametrize("tau", [0.5, 2.0, 5.0])
    def test_point_source_uniform_sphere(self, tau):
        # compare in tau space: ln(detected) = -tau exactly; the only
        # numerical error is the sphere-edge density discontinuity inside
        # one quadrature segment, O(tau * seglen/R)
        det = _sphere_setup(tau, albedo=0.0, packets=4096, ncells=24,
                            density_mode="analytic", deposition="sampled")
        tau_meas = -np.log(det[0])
        assert tau_meas == pytest.approx(tau, abs=5e-3 * max(tau, 1.0)), tau

    def test_gridded_matches_exact_too(self):
        # the reference-exact estimator path (discretized densities): the
        # cube discretization of the sphere changes tau slightly, so the
        # tolerance covers the gridding error at 12^3 cells
        tau = 2.0
        det = _sphere_setup(tau, albedo=0.0, packets=4096,
                            density_mode="gridded", deposition="path")
        assert det[0] == pytest.approx(np.exp(-tau), rel=0.08)


# ---------------------------------------------------------------------------
# 3. Independent plain Monte Carlo cross-check
# ---------------------------------------------------------------------------

def _plain_mc_escape_fraction(tau_r, albedo, g, n_photons, seed=7):
    """Analog MC for a central point source in a uniform sphere.

    Deliberately shares NOTHING with the engine: numpy Generator RNG,
    analog (unforced) path sampling, absorption as a coin flip, no
    peel-off, no weights.  Returns the escape fraction.
    """
    rs = np.random.default_rng(seed)
    pos = np.zeros((n_photons, 3))
    # isotropic initial directions
    mu = rs.uniform(-1, 1, n_photons)
    ph = rs.uniform(0, 2 * np.pi, n_photons)
    st = np.sqrt(1 - mu ** 2)
    d = np.stack([st * np.cos(ph), st * np.sin(ph), mu], axis=1)
    alive = np.ones(n_photons, bool)
    escaped = 0
    kr = tau_r  # kappa*rho with R=1
    for _ in range(10000):
        if not alive.any():
            break
        p, v = pos[alive], d[alive]
        # distance to sphere edge: |p + t v| = 1
        b = np.einsum("ij,ij->i", p, v)
        c = np.einsum("ij,ij->i", p, p) - 1.0
        t_edge = -b + np.sqrt(np.maximum(b * b - c, 0.0))
        s = rs.exponential(1.0 / kr, size=p.shape[0])
        esc = s >= t_edge
        escaped += int(esc.sum())
        # interaction: scatter with prob=albedo, absorb otherwise
        scat = (~esc) & (rs.uniform(size=p.shape[0]) < albedo)
        newpos = p + s[:, None] * v
        # isotropic or HG scatter
        nsc = int(scat.sum())
        if nsc:
            if abs(g) < 1e-12:
                mu2 = rs.uniform(-1, 1, nsc)
            else:
                u = rs.uniform(size=nsc)
                f = (1 - g * g) / (1 - g + 2 * g * u)
                mu2 = (1 + g * g - f * f) / (2 * g)
            ph2 = rs.uniform(0, 2 * np.pi, nsc)
            st2 = np.sqrt(np.maximum(0, 1 - mu2 ** 2))
            # rotate about old direction
            w = v[scat]
            # build frame
            a_ = np.where(np.abs(w[:, 2]) < 0.9,
                          np.tile([0.0, 0.0, 1.0], (nsc, 1)).T,
                          np.tile([1.0, 0.0, 0.0], (nsc, 1)).T).T
            u1 = np.cross(a_, w)
            u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
            u2v = np.cross(w, u1)
            nd = (st2[:, None] * (np.cos(ph2)[:, None] * u1
                                  + np.sin(ph2)[:, None] * u2v)
                  + mu2[:, None] * w)
            nd /= np.linalg.norm(nd, axis=1, keepdims=True)
        # write back
        idx = np.nonzero(alive)[0]
        pos[idx] = newpos
        if nsc:
            d[idx[scat]] = nd
        keep = np.zeros(p.shape[0], bool)
        keep[scat] = True
        alive[idx] = keep
    return escaped / n_photons


class TestIndependentMCCrossCheck:
    """The engine's biased estimator chain (forced scattering, composite
    bias, weight floor, peel-off) against an analog MC with no shared
    structure.  A consistently wrong weight anywhere in the chain shows up
    here as a systematic offset."""

    @pytest.mark.slow
    @pytest.mark.parametrize("tau,albedo,g", [(1.0, 0.5, 0.0),
                                              (4.0, 0.5, 0.0),
                                              (2.0, 0.8, 0.5)])
    def test_escape_fraction(self, tau, albedo, g):
        n_ind = 400_000
        f_ind = _plain_mc_escape_fraction(tau, albedo, g, n_ind)
        sigma = np.sqrt(f_ind * (1 - f_ind) / n_ind)
        det = _sphere_setup(tau, albedo=albedo, g=g, packets=1 << 16,
                            density_mode="analytic", deposition="sampled")
        f_eng = float(det[0])
        # point source + isotropic lifecycle => escape is isotropic, so the
        # detected luminosity at any direction estimates f_esc * L.
        # engine MC error (peel-off variance) ~ 1%; allow 4 sigma + 2%
        assert abs(f_eng - f_ind) < 4 * sigma + 0.02 * f_ind, (
            f"engine {f_eng:.4f} vs independent {f_ind:.4f} "
            f"(sigma {sigma:.4f})")

    @pytest.mark.slow
    def test_escape_fraction_ivezic_mix(self):
        """Same cross-check with the published Ivezic mix driving the
        albedo (exactly 1/2 below 1um) through the real mix machinery."""
        tau = 2.5
        n_ind = 300_000
        f_ind = _plain_mc_escape_fraction(tau, 0.5, 0.0, n_ind)
        sigma = np.sqrt(f_ind * (1 - f_ind) / n_ind)

        wg = OligoWavelengthGrid([0.55e-6])
        from skirt_tpu.sources.stellar import LuminosityStellarComponent
        ss = StellarSystem([LuminosityStellarComponent(
            PointGeometry(), wg, [1.0])])
        R, ncells = 1.0, 12
        b = np.linspace(-1.1 * R, 1.1 * R, ncells + 1)
        grid = CartesianGrid(b, b, b)
        mix = Benchmark1DDustMix(wg)
        kext = float(mix.kappaabs[0] + mix.kappasca[0])
        volume = 4.0 / 3.0 * np.pi * R ** 3
        comp = DustComponent(UniformSphereGeometry(R), mix,
                             DustMassNormalization(tau / (kext * R) * volume))
        dsys = DustSystem(grid, [comp], samples_per_cell=6,
                          density_mode="analytic")
        ins = SEDInstrument("sed", 1e4, 1, inclination=0.6, azimuth=1.1)
        opts = LifecycleOptions(store_absorption=False,
                                min_weight_reduction=1e6,
                                max_scatt_events=200, deposition="sampled")
        run = make_lifecycle(grid, dsys, ss, [ins], opts, 1)
        packets = 1 << 16
        ell = jnp.zeros(packets, jnp.int32)
        L0 = jnp.full((packets,), 1.0 / packets, jnp.float32)
        out = jax.jit(lambda k: run(k, ell, L0,
                                    {"instruments": [ins.zero_tallies()]}))(
            rng.root_key(4357))
        f_eng = float(np.asarray(out["instruments"][0]["Ftot"])[0])
        assert abs(f_eng - f_ind) < 4 * sigma + 0.02 * f_ind, (
            f"engine {f_eng:.4f} vs independent {f_ind:.4f}")


# ---------------------------------------------------------------------------
# 4. Radiative equilibrium: independent quadrature for dust temperature
# ---------------------------------------------------------------------------

def _planck_lam(lam, T):
    x = H_PLANCK * C_LIGHT / (lam * K_BOLTZMANN * T)
    return (2 * H_PLANCK * C_LIGHT ** 2 / lam ** 5
            / np.expm1(np.clip(x, 1e-9, 700.0)))


class TestEquilibriumTemperature:
    """Optically thin shell of Ivezic benchmark dust around a T*=2500 K
    blackbody (the Ivezic 1997 configuration class): the dust temperature
    at radius r follows from a radiative balance computed here with an
    independent numpy quadrature — no framework code in the expectation."""

    @pytest.mark.slow
    def test_thin_shell_temperature(self, tmp_path):
        from skirt_tpu.engine.pan import PanSimulation
        from skirt_tpu.log import SilentLog

        T_star = 2500.0
        L_star = 1e4 * 3.846e26            # arbitrary scale
        nlambda = 48
        wg = LogWavelengthGrid(0.15e-6, 300e-6, nlambda)
        star = StellarComponent(PointGeometry(), BlackBodySED(wg, T_star),
                                BolometricLuminosityNormalization(L_star))
        ss = StellarSystem([star])

        AU = 1.496e11
        r_in, r_out = 50 * AU, 150 * AU
        half = 1.05 * r_out
        n = 10
        b = np.linspace(-half, half, n + 1)
        grid = CartesianGrid(b, b, b)
        from skirt_tpu.geometry import ShellGeometry
        mix = Benchmark1DDustMix(wg)
        kext_V = 2600.0
        tau_V = 0.01                        # optically thin
        # shell rho ~ r^-2: tau = kext * rho0 * rmin^2 * (1/rmin - 1/rmax)
        geom = ShellGeometry(r_in, r_out, 2.0)
        # mass for the target tau_V through geometry's normalized density:
        # column N = int rho dr = M * int geom_rho dr (geom integrates to 1)
        rr = np.linspace(r_in, r_out, 20001)
        col_unit = np.trapezoid(np.asarray(geom.radial_density(rr)), rr)
        mass = tau_V / (kext_V * col_unit)
        comp = DustComponent(geom, mix, DustMassNormalization(mass))
        dsys = DustSystem(grid, [comp], samples_per_cell=8,
                          density_mode="gridded")
        ins = SEDInstrument("sed", 3.086e18, nlambda, inclination=0.5)
        sim = PanSimulation(stellar_system=ss, instruments=[ins],
                            dust_system=dsys, packets=60_000,
                            self_absorption=False, log=SilentLog(),
                            out_dir=str(tmp_path),
                            options=LifecycleOptions(store_absorption=True))
        acc = sim.run()
        T_cells = np.asarray(sim.cell_temperatures(acc))

        # independent prediction at each cell-center radius:
        # 4pi int kabs B_lam(T) dlam = int kabs L_lam/(4 pi r^2) dlam
        lam = np.asarray(wg.lambdav, np.float64)
        kabs = np.asarray(mix.kappaabs, np.float64)
        B_star = _planck_lam(lam, T_star)
        w_lam = B_star / np.trapezoid(B_star, lam)
        centers = grid.cell_centers()
        r_c = np.sqrt((np.asarray(centers) ** 2).sum(axis=1))
        sel = (r_c > r_in * 1.15) & (r_c < r_out * 0.85)
        assert sel.sum() > 20

        def T_balance(r):
            heat = np.trapezoid(kabs * w_lam, lam) * L_star / (4 * np.pi * r ** 2)
            from scipy.optimize import brentq
            def f(T):
                return (4 * np.pi * np.trapezoid(kabs * _planck_lam(lam, T), lam)
                        - heat)
            return brentq(f, 1.0, 2400.0)

        rs = r_c[sel]
        T_pred = np.array([T_balance(r) for r in np.unique(rs.round(-9))[:5]])
        # compare the framework's cells nearest those radii
        for r_u, tp in zip(np.unique(rs.round(-9))[:5], T_pred):
            cells = sel & (np.abs(r_c - r_u) < 1e-9 + 0.02 * r_u)
            t_eng = T_cells[cells]
            t_eng = t_eng[t_eng > 0]
            if t_eng.size == 0:
                continue
            assert np.median(t_eng) == pytest.approx(tp, rel=0.12), (
                f"r={r_u:.3e}: engine {np.median(t_eng):.1f} K vs "
                f"independent {tp:.1f} K")


# ---------------------------------------------------------------------------
# 5. Cross-estimator A/B: every estimator mode agrees on the same model
# ---------------------------------------------------------------------------

class TestCrossEstimator:
    """gridded+path (reference-exact) vs analytic+sampled vs fused: three
    structurally different estimator implementations must agree within MC
    noise on the same physical model (the CPU-sized version of the
    1e7-packet A/B documented in BASELINE.md)."""

    @pytest.mark.slow
    def test_three_way_agreement(self):
        tau, albedo, packets = 2.0, 0.6, 1 << 15
        kw = dict(tau=tau, albedo=albedo, packets=packets, ncells=16)
        det_grid = _sphere_setup(density_mode="gridded", deposition="path",
                                 **kw)
        det_ana = _sphere_setup(density_mode="analytic",
                                deposition="sampled", **kw)
        det_fused = _sphere_setup(density_mode="analytic",
                                  deposition="sampled", fused=True,
                                  quadrature_panels=32, peel_panels=8, **kw)
        a, b, c = det_grid[0], det_ana[0], det_fused[0]
        assert b == pytest.approx(a, rel=0.05), (a, b)
        assert c == pytest.approx(b, rel=0.03), (b, c)
