"""Smoke test of skirt_tpu on an NVIDIA GPU: the main path, once, at full width.

    python chip_smoke.py               # one card: phases (i)-(v)
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One card runs, in one process:
  (i)   device: the platform must be 'gpu'; prints the card and JAX devices;
  (ii)  end to end: the flagship dusty disc (128 wavelengths, 2^15 lanes,
        32x32x16 grid, 2 distant instruments) through OligoSimulation with
        the fast options (analytic, fused, refill, polychromatic), .run()
        writing its SED and FITS files; checked against the vector path
        (fused=False) at the same packets per wavelength: detected flux to
        2%, absorbed energy to 5%;
  (iii) no dust: detected flux equals the luminosity per band to 2e-4;
  (iv)  every other fused event engine (mono analytic, table, polychromatic
        table on the octree torus) compiled for the card at the flagship
        widths, against the vector path on the same model;
  (v)   timing of folded flagship batches (packets/s, per-iteration time,
        compile time).
With --four-cards it runs only the packet-sharded flagship and the
slab-sharded fused table engine on four cards, each against its one-card
run.  The last line is a JSON object naming the device; any failure exits
non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# models

NLAMBDA = 128
LANES = 1 << 15


def flagship_parts(nlambda=NLAMBDA, with_dust=True):
    """The flagship exponential disc: (stellar system, dust system or
    None, instruments)."""
    from skirt_tpu.constants import KPC
    from skirt_tpu.geometry import ExpDiskGeometry
    from skirt_tpu.grids import CartesianGrid
    from skirt_tpu.instruments import SEDInstrument, SimpleInstrument
    from skirt_tpu.media import (DustComponent, DustSystem,
                                 OpticalDepthNormalization,
                                 SimpleOligoDustMix)
    from skirt_tpu.sources.stellar import (LuminosityStellarComponent,
                                           StellarSystem)
    from skirt_tpu.wavelengths import OligoWavelengthGrid

    wg = OligoWavelengthGrid(list(np.linspace(0.4e-6, 1.2e-6, nlambda)))
    lum = list(np.linspace(1.0, 2.0, nlambda) * 1e36)
    ss = StellarSystem([LuminosityStellarComponent(
        ExpDiskGeometry(4 * KPC, 0.35 * KPC), wg, lum)])
    instruments = [
        SEDInstrument("sed", 3.08e23, nlambda, inclination=1.0),
        SimpleInstrument("img", 3.08e23, nlambda, 16, 16, fov_x=24 * KPC,
                         fov_y=24 * KPC, inclination=np.pi / 2)]
    if not with_dust:
        return ss, None, instruments
    half = 12 * KPC
    b = np.linspace(-half, half, 33)
    bz = np.linspace(-2 * KPC, 2 * KPC, 17)
    mix = SimpleOligoDustMix(wg, list(2600.0 * np.linspace(1.0, 0.3, nlambda)),
                             list(0.6 * np.linspace(1.0, 0.5, nlambda)),
                             list(0.5 * np.linspace(1.0, 0.4, nlambda)))
    comp = DustComponent(ExpDiskGeometry(4 * KPC, 0.2 * KPC), mix,
                         OpticalDepthNormalization("z", wg.lambdav[0], 1.0))
    ds = DustSystem(CartesianGrid(b, b, bz), [comp], samples_per_cell=4,
                    density_mode="analytic")
    return ss, ds, instruments


def fast_options(refill):
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    return LifecycleOptions(store_absorption=True, deposition="sampled",
                            max_scatt_events=64, quadrature_panels=32,
                            peel_panels=8, fused=True, polychromatic=True,
                            refill_batches=refill)


def simulation(fast, packets, out_dir, refill=2, use_mesh=False,
               with_dust=True):
    from skirt_tpu.engine.lifecycle import LifecycleOptions
    from skirt_tpu.engine.simulation import OligoSimulation
    from skirt_tpu.log import SilentLog

    ss, ds, instruments = flagship_parts(with_dust=with_dust)
    if fast:
        opts, batch = fast_options(refill), LANES * NLAMBDA
    else:
        opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                                max_scatt_events=64, quadrature_panels=32,
                                peel_panels=8)
        batch = 1 << 20
    return OligoSimulation(stellar_system=ss, dust_system=ds,
                           instruments=instruments, packets=packets,
                           options=opts, batch_size=batch, log=SilentLog(),
                           out_dir=out_dir, prefix="smoke",
                           use_mesh=use_mesh, seed=11)


def totals(acc):
    ftot = float(np.sum(acc["instruments"][0]["Ftot"]))
    labs = float(np.sum(acc["labs"])) if "labs" in acc else float("nan")
    return ftot, labs


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# one-card phases

def phase_end_to_end():
    packets = LANES * 2                      # per wavelength: one batch
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = simulation(True, packets, tmp)
        module = sim._lifecycle.__module__
        check(sim._poly and module.endswith("engine.fused_poly"),
              f"the fused polychromatic engine did not build ({module})")
        acc = sim.run()
        files = sorted(os.listdir(tmp))
        check(any(f.endswith(".dat") for f in files)
              and any(f.endswith(".fits") for f in files),
              f"run() wrote no SED/FITS files: {files}")
        t_fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = simulation(False, packets, tmp).run()
        t_ref = time.perf_counter() - t0
    f, l = totals(acc)
    fr, lr = totals(ref)
    check(np.isfinite(f) and np.isfinite(l) and f > 0 and l > 0,
          f"non-finite or empty tallies: {f}, {l}")
    print(f"(ii) end to end: fused poly engine {module}; "
          f"{packets} packets/wavelength x {NLAMBDA}; files {files}; "
          f"detected {f:.6e} W vs vector {fr:.6e} W (rel {rel(f, fr):.3e}, "
          f"limit 2e-2); absorbed {l:.6e} W vs {lr:.6e} W "
          f"(rel {rel(l, lr):.3e}, limit 5e-2); wall {t_fast:.1f} s fused, "
          f"{t_ref:.1f} s vector", flush=True)
    check(rel(f, fr) <= 2e-2, "detected flux differs from the vector path")
    check(rel(l, lr) <= 5e-2, "absorbed energy differs from the vector path")


def phase_no_dust():
    from skirt_tpu import rng

    packets = 1 << 15
    with tempfile.TemporaryDirectory() as tmp:
        sim = simulation(True, packets, tmp, with_dust=False)
        acc = sim._run_phase(rng.root_key(3), 0)
    ftot = np.asarray(acc["instruments"][0]["Ftot"], np.float64)
    lv = np.asarray(sim.stellar_system.Lv, np.float64)
    err = float(np.max(np.abs(ftot / lv - 1.0)))
    print(f"(iii) no dust: max |Ftot/L - 1| over {lv.size} bands = "
          f"{err:.3e} (limit 2e-4)", flush=True)
    check(err <= 2e-4, "no-dust flux does not equal the luminosity")


def _engine_vs_vector(name, build, lanes, refill, ref_lanes):
    """Run one fused engine and the vector path on the same model at
    matched packets per wavelength, and check that the detected and
    absorbed totals agree."""
    import jax
    from skirt_tpu import rng

    res = []
    for fused, n, k in ((True, lanes, refill), (False, ref_lanes, 1)):
        run, zero, ell, L0 = build(fused, n, k)
        out = jax.jit(lambda key, e, l: run(key, e, l, zero()))(
            rng.root_key(7), ell, L0)
        res.append(totals(jax.block_until_ready(out)))
    (f, l), (fr, lr) = res
    check(np.isfinite(f) and np.isfinite(l) and f > 0 and l > 0,
          f"{name}: non-finite or empty tallies")
    print(f"(iv) {name}: detected {f:.6e} W vs vector {fr:.6e} W (rel "
          f"{rel(f, fr):.3e}, limit 2e-2); absorbed {l:.6e} W vs "
          f"{lr:.6e} W (rel {rel(l, lr):.3e}, limit 5e-2)", flush=True)
    check(rel(f, fr) <= 2e-2 and rel(l, lr) <= 5e-2,
          f"{name} differs from the vector path")


def phase_kernels():
    """Every fused event engine, compiled for the card at the flagship
    widths, against the vector path (the plain reference) on its model.
    The polychromatic analytic engine is checked in phase (ii)."""
    import __graft_entry__ as ge

    def disc(poly):
        def build(fused, n, k):
            return ge._build(nlambda=NLAMBDA, ncells=32, packets=n,
                             max_scatt=64, quadrature_panels=32,
                             peel_panels=8, refill_batches=k, fused=fused,
                             polychromatic=poly and fused)
        return build

    def torus(nlambda, poly):
        def build(fused, n, k):
            return ge._build_torus(nlambda=nlambda, packets=n,
                                   refill_batches=k, fused=fused,
                                   polychromatic=poly and fused)
        return build

    # mono lanes: K=8 refill of LANES lanes vs LANES*8 vector lanes;
    # poly lanes carry NLAMBDA wavelengths each, so the vector reference
    # needs NLAMBDA times the lanes for the same packets per wavelength
    _engine_vs_vector("fused (mono analytic)", disc(False), LANES, 8,
                      LANES * 8)
    _engine_vs_vector("fused_table (octree torus, 2 wavelengths)",
                      torus(2, False), LANES, 8, LANES * 8)
    _engine_vs_vector(f"fused_table_poly (octree torus, {NLAMBDA} "
                      "wavelengths)", torus(NLAMBDA, True), LANES // 8, 2,
                      LANES // 4 * NLAMBDA)


def phase_timing(card):
    import jax
    import jax.numpy as jnp
    from skirt_tpu import rng
    from skirt_tpu.engine.lifecycle import make_lifecycle, make_multibatch

    ss, ds, instruments = flagship_parts()
    K, nb, reps = 128, 2, 2
    run_batch = make_lifecycle(ds.grid, ds, ss, instruments, fast_options(K),
                               NLAMBDA)
    run_many = make_multibatch(run_batch, nb)
    L0 = jnp.full((LANES, NLAMBDA), 1e36 / (LANES * K), jnp.float32)
    ell = jnp.zeros((LANES,), jnp.int32)

    def zero():
        return {"instruments": [i.zero_tallies() for i in instruments],
                "labs": jnp.zeros((ds.grid.ncells * NLAMBDA,), jnp.float32),
                "iterations": jnp.int32(0)}

    fn = jax.jit(lambda k: run_many(k, ell, L0, zero()))
    t0 = time.perf_counter()
    compiled = fn.lower(rng.root_key(1)).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(rng.root_key(1)))
    # one timed window over all the calls: all their packets over all
    # its time
    t0 = time.perf_counter()
    outs = [compiled(rng.root_key(2 + r)) for r in range(reps)]
    jax.block_until_ready(outs)
    seconds = time.perf_counter() - t0
    for out in outs:
        f = float(np.sum(out["instruments"][0]["Ftot"]))
        check(np.isfinite(f) and f > 0, "timing run produced no flux")
    iters = sum(int(out["iterations"]) for out in outs)
    packets = LANES * K * nb * NLAMBDA * reps
    print(f"(v) timing [{card}]: compile {t_compile:.2f} s; {reps} calls "
          f"of {nb} folded batches of {LANES} lanes x K={K} x {NLAMBDA} "
          f"wavelengths = {packets} packets in {seconds:.4f} s = "
          f"{packets / seconds:.1f} packets/s; {iters} event iterations, "
          f"{seconds / max(iters, 1) * 1e3:.4f} ms per iteration",
          flush=True)


# ---------------------------------------------------------------------------
# four-card phases

def phase_packet_sharded():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    packets = LANES * 4 * 2
    with tempfile.TemporaryDirectory() as tmp:
        sim4 = simulation(True, packets, tmp, use_mesh=True)
        check(sim4.mesh is not None, "no mesh was built")
        devs = {d.id for d in sim4.mesh.devices.flat}
        probe = jax.device_put(np.arange(4 * 8.0),
                               NamedSharding(sim4.mesh,
                                             P(sim4.mesh.axis_names[0])))
        shard_devs = {s.device.id for s in probe.addressable_shards}
        check(len(devs) == 4 and shard_devs == devs,
              f"shards not on four distinct cards: {devs} / {shard_devs}")
        acc4 = sim4.run()
        acc1 = simulation(True, packets, tmp, use_mesh=False).run()
    f4, l4 = totals(acc4)
    f1, l1 = totals(acc1)
    print(f"four cards, packet-sharded flagship on devices {sorted(devs)}: "
          f"detected {f4:.6e} W vs one card {f1:.6e} W (rel "
          f"{rel(f4, f1):.3e}, limit 2e-2); absorbed {l4:.6e} W vs "
          f"{l1:.6e} W (rel {rel(l4, l1):.3e}, limit 5e-2)", flush=True)
    check(rel(f4, f1) <= 2e-2 and rel(l4, l1) <= 5e-2,
          "packet-sharded run differs from the one-card run")


def phase_slab_fused():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from skirt_tpu import rng
    from skirt_tpu.engine.lifecycle import LifecycleOptions, make_lifecycle
    from skirt_tpu.instruments import SEDInstrument
    from skirt_tpu.parallel import make_slab_lifecycle
    from skirt_tpu.parallel.slab import SLAB_AXIS
    from __graft_entry__ import _torus_model

    tds, ss, _ = _torus_model(nlambda=2, min_level=3, max_level=5)
    mesh = Mesh(np.asarray(jax.devices()), (SLAB_AXIS,))
    opts = LifecycleOptions(store_absorption=True, deposition="sampled",
                            quadrature_panels=32, peel_panels=32,
                            max_scatt_events=64, fused=True,
                            table_peel="exact", refill_batches=4)
    sed = SEDInstrument("sed", 3.08e23, 2, inclination=1.2)
    n = 1 << 16
    ell = jnp.asarray(np.arange(n, dtype=np.int32) % 2)
    L0 = jnp.full((n,), 1e36 / (n * 4), jnp.float32)
    run4 = make_slab_lifecycle(mesh, tds.grid, tds, ss, [sed], opts, 2,
                               exchange="fused")
    out4 = jax.block_until_ready(run4(rng.root_key(3), ell, L0))
    labs_devs = {s.device.id for s in out4["labs"].addressable_shards}
    check(len(labs_devs) == 4, f"labs not sharded over four cards: "
          f"{labs_devs}")
    run1 = jax.jit(make_lifecycle(tds.grid, tds, ss, [sed], opts, 2))
    out1 = run1(rng.root_key(3), ell, L0, {
        "instruments": [sed.zero_tallies()],
        "labs": jnp.zeros((tds.grid.ncells * 2,), jnp.float32)})
    f4, l4 = totals(out4)
    f1, l1 = totals(out1)
    print(f"four cards, slab-fused octree torus ({tds.grid.nx}^3 voxels, "
          f"labs on devices {sorted(labs_devs)}): detected {f4:.6e} W vs "
          f"one card {f1:.6e} W (rel {rel(f4, f1):.3e}, limit 5e-2); "
          f"absorbed {l4:.6e} W vs {l1:.6e} W (rel {rel(l4, l1):.3e}, "
          "limit 5e-2)", flush=True)
    check(rel(f4, f1) <= 5e-2 and rel(l4, l1) <= 5e-2,
          "slab-fused run differs from the one-card fused table engine")


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded checks")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        from skirt_tpu.cache import enable_compile_cache
    except ImportError as e:
        fail(f"the skirt_tpu package is not next to this script ({e})")
    cache = enable_compile_cache()
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        fail(f"JAX found no accelerator ({e})")
    dev = devices[0]
    check(dev.platform == "gpu", f"platform is {dev.platform!r}, not 'gpu'")
    want = 4 if args.four_cards else 1
    check(len(devices) >= want, f"need {want} cards, JAX sees "
          f"{len(devices)}")
    card = card_line()
    print(f"(i) device: {card}; jax {jax.__version__}: {devices}; "
          f"compile cache {cache}", flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        check(len(devices) == 4, f"--four-cards needs exactly 4 cards, "
              f"JAX sees {len(devices)}")
        phase_packet_sharded()
        phase_slab_fused()
    else:
        phase_end_to_end()
        phase_no_dust()
        phase_kernels()
        phase_timing(card)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
