"""Platform plumbing: the supported platforms, float32 product precision,
the compile-cache placement, lowering for the GPU, and the fast-path
fallback bookkeeping."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt_tpu.ops import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestKernelMode:
    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_known_platforms(self, platform):
        assert backend.require_supported_platform(platform) is None

    @pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
    def test_unknown_platform_raises(self, platform):
        with pytest.raises(backend.BackendError, match=platform):
            backend.require_supported_platform(platform)

    def test_error_is_not_a_value_error(self):
        # the engine builders fall back to the vector path on ValueError;
        # an unsupported platform must not be swallowed there
        assert not issubclass(backend.BackendError, ValueError)

    def test_default_is_the_running_platform(self, monkeypatch):
        backend.require_supported_platform()
        # a fused engine build checks the running platform first
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(backend.BackendError, match="rocm"):
            _flagship(4)


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).as_text()


def _bin_sum_hlo():
    from skirt_tpu.instruments.instruments import _bin_sum
    return _hlo(lambda v, e: _bin_sum(v, e, 4), jnp.ones(64, jnp.float32),
                jnp.zeros(64, jnp.int32))


def _rotation_density_hlo():
    from skirt_tpu.geometry import PlummerGeometry
    from skirt_tpu.geometry.decorators import RotateGeometryDecorator
    g = RotateGeometryDecorator(PlummerGeometry(1.0), 0.3, 0.5, 0.7)
    return _hlo(g.density, jnp.ones((8, 3), jnp.float32))


def _rotation_position_hlo():
    from skirt_tpu.geometry import PlummerGeometry
    from skirt_tpu.geometry.decorators import RotateGeometryDecorator
    g = RotateGeometryDecorator(PlummerGeometry(1.0), 0.3, 0.5, 0.7)
    return _hlo(lambda k: g.generate_position(k, 8), jax.random.key(0))


def _row_cumsum_hlo():
    from skirt_tpu.engine.vector_traversal import row_cumsum
    return _hlo(row_cumsum, jnp.ones((4, 16), jnp.float32))


@pytest.mark.parametrize("site", [_bin_sum_hlo, _rotation_density_hlo,
                                  _rotation_position_hlo, _row_cumsum_hlo],
                         ids=["bin_sum", "rotation_density",
                              "rotation_position", "row_cumsum"])
def test_float32_products_ask_for_highest_precision(site):
    """A default float32 product may run in TF32 on the GPU (~1e-3
    relative error); these sites carry precision=HIGHEST."""
    text = site()
    assert "dot_general" in text
    assert "HIGHEST" in text


class TestCompileCache:
    def test_repo_default(self, monkeypatch):
        from skirt_tpu import cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")

    def test_environment_wins(self, monkeypatch, tmp_path):
        from skirt_tpu import cache
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)

    @pytest.mark.parametrize("env_dir", [None, "given"])
    def test_jax_config_in_a_fresh_process(self, env_dir, tmp_path):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(REPO, ".jax_cache")
        if env_dir:
            want = str(tmp_path / env_dir)
            env["JAX_COMPILATION_CACHE_DIR"] = want
        code = ("import jax; from skirt_tpu.cache import enable_compile_cache;"
                " print(enable_compile_cache());"
                " print(jax.config.jax_compilation_cache_dir)")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == [want, want]


def _flagship(nlambda, poly=True):
    import __graft_entry__ as ge
    return ge._build(nlambda=nlambda, ncells=8, packets=256, max_scatt=4,
                     quadrature_panels=8, peel_panels=4, refill_batches=2,
                     fused=True, polychromatic=poly)


@pytest.mark.parametrize("nlambda", [1, 24, 128])
def test_fused_poly_lowers_for_cuda(nlambda):
    """The polychromatic event lowers for the GPU at every width (lowering
    runs on the CPU host; compiling needs the card)."""
    run, zt, ell, L0 = _flagship(nlambda)
    lowered = jax.jit(lambda k, e, l: run(k, e, l, zt())).trace(
        jax.random.key(0), ell, L0).lower(lowering_platforms=("cuda",))
    assert "stablehlo.while" in lowered.as_text()


@pytest.mark.parametrize("nlambda", [1, 24, 128])
def test_fused_table_poly_lowers_for_cuda(nlambda):
    import __graft_entry__ as ge
    run, zt, ell, L0 = ge._build_torus(nlambda=nlambda, packets=256,
                                       refill_batches=2, polychromatic=True,
                                       min_level=2, max_level=3, panels=8,
                                       max_scatt=4)
    lowered = jax.jit(lambda k, e, l: run(k, e, l, zt())).trace(
        jax.random.key(0), ell, L0).lower(lowering_platforms=("cuda",))
    assert "stablehlo.while" in lowered.as_text()


@pytest.mark.parametrize("density_mode,fused,falls_back", [
    ("analytic", True, False), ("gridded", True, True),
    ("gridded", False, False)])
def test_fallback_returns_the_options_used(density_mode, fused, falls_back):
    from skirt_tpu.engine.lifecycle import (LifecycleOptions,
                                            make_lifecycle_with_fallback)
    from skirt_tpu.geometry import PointGeometry, UniformSphereGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.media import (DustComponent, DustMassNormalization,
                                 DustSystem)
    from skirt_tpu.media.mix import DustMix
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([0.5e-6, 1e-6])
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36, 2e36])])
    b = np.linspace(-1.0, 1.0, 5)
    ds = DustSystem(CartesianGrid(b, b, b),
                    [DustComponent(UniformSphereGeometry(0.9),
                                   DustMix(wg, np.ones(2), np.zeros(2),
                                           np.zeros(2)),
                                   DustMassNormalization(1.0))],
                    samples_per_cell=2, density_mode=density_mode)
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=4, fused=fused,
                            refill_batches=2)
    run, used = make_lifecycle_with_fallback(
        ds.grid, ds, ss, [SEDInstrument("sed", 3e23, 2)], opts, 2)
    assert callable(run)
    if falls_back:
        assert not used.fused and used.refill_batches == 0
        assert used.deposition == opts.deposition
    else:
        assert used is opts


def test_fallback_keeps_batch_count_with_the_options():
    """Fast options on a model outside the fused envelope (no dust) fall
    back to the vector path, and the options follow: without refill the
    batches launch every packet, so the detected flux equals the
    luminosity per band."""
    from skirt_tpu import rng
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.geometry import PointGeometry
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.log import SilentLog
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid([0.5e-6, 1e-6, 2e-6])
    ss = StellarSystem([LuminosityStellarComponent(PointGeometry(), wg,
                                                   [1e36, 2e36, 3e36])])
    opts = LifecycleOptions(fused=True, polychromatic=True,
                            refill_batches=4)
    sim = OligoSimulation(stellar_system=ss,
                          instruments=[SEDInstrument("sed", 3e23, 3)],
                          packets=2048, options=opts, batch_size=3 * 512,
                          log=SilentLog())
    assert not sim.options.fused and sim.options.refill_batches == 0
    acc = sim._run_phase(rng.root_key(1), 0)
    np.testing.assert_allclose(acc["instruments"][0]["Ftot"],
                               [1e36, 2e36, 3e36], rtol=2e-4)
