"""The photon-packet lifecycle megakernel.

ref: SKIRTcore/MonteCarloSimulation.cpp — dostellaremissionchunk (:265-301),
peeloffemission (:305-315), peeloffscattering (:319-363),
simulateescapeandabsorption (:438-515), simulatepropagation (:519-537),
simulatescattering (:541-549); polarization per DustMix.cpp:537-671.

Batched re-design: instead of a scalar per-photon loop, a whole batch of
packets advances in lockstep through launch -> [traverse+absorb ->
propagate -> peel-off -> scatter]* with masked lanes, streaming traversal
sweeps (no path records), scatter-add tallies (replacing LockFree::add),
and counter-based RNG.  The entire cycle is one jit-compiled function.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .. import rng
from ..ops import binned_add, drop_add
from . import traversal
from . import vector_traversal as vt


@dataclass(frozen=True)
class LifecycleOptions:
    """ref: MonteCarloSimulation.hpp property defaults (:41-65)."""
    min_weight_reduction: float = 1e4
    min_scatt_events: int = 0
    scatt_bias: float = 0.5          # the composite biasing factor xi
    max_scatt_events: int = 256      # lockstep-loop bound (ref loops freely;
                                     # with minWeightReduction=1e4 packets die
                                     # far earlier except for albedo ~ 1)
    store_absorption: bool = False   # tally Labs per (cell, wavelength)
    continuous_scattering: bool = False  # peel-off from every path cell
                                     # (ref: continuouspeeloffscattering;
                                     # requires fast_peeloff maps)
    fast_peeloff: bool = False       # cell-center tau maps for distant
                                     # instruments (gather replaces a
                                     # traversal per peel-off; cell-scale
                                     # approximation, exact by default)
    refill_batches: int = 0          # persistent-lane relaunch: each lane
                                     # launches this many packets over the
                                     # dispatch, relaunching when its
                                     # packet dies (budget per lane is
                                     # fixed, so normalization is exact).
                                     # Avoids the mostly-dead tail of the
                                     # lockstep event loop.
                                     # 0/1 = off.  Requires the vector
                                     # path, isotropic stellar launch, no
                                     # polarization/io_state/launch_fn.
    refill_every: int = 2            # inverse idle-fraction threshold:
                                     # relaunch when >= 1/refill_every of
                                     # the lanes are idle (2 = 50%); 1
                                     # degenerates to relaunch-only-
                                     # when-all-dead
    polychromatic: bool = False      # fused TABLE mode: each lane carries
                                     # ALL nlambda wavelengths on one
                                     # geometric path (defensive-mixture
                                     # importance sampling; weights
                                     # bounded by nlambda) — the rho panel
                                     # gathers and the exact-peel column
                                     # rows are lambda-independent, so the
                                     # descriptor budget per packet
                                     # divides by nlambda.  Requires the
                                     # fused table path, single dust
                                     # component, single isotropic stellar
                                     # component, nlambda <= 8.  See
                                     # engine/fused_table_poly.py.
    peel_panels: int | None = None   # panels for peel-off extinction
                                     # integrals (None = quadrature_panels);
                                     # peel tau only weights detected flux,
                                     # so a coarser quadrature is usually
                                     # fine
    quadrature_panels: int | None = None  # analytic-mode panels per ray
                                     # (None = the grid's wall-crossing
                                     # count, i.e. finer than the grid's
                                     # own resolution; fewer panels trade
                                     # O((panel/scale-height)^2) tau error
                                     # for throughput)
    deposition: str = "path"         # absorption-tally estimator:
                                     # 'path' = per-segment deposit (the
                                     # reference's analytic path estimator,
                                     # simulateescapeandabsorption) —
                                     # scatter-bound ((N,S) random
                                     # updates); 'sampled' = unbiased
                                     # single-segment deposit per event
                                     # (segment drawn proportional to its
                                     # absorbed energy, whole-path energy
                                     # deposited there) — (N,) updates,
                                     # ~S times cheaper, higher per-cell
                                     # variance
    fused: bool = False              # run the whole scattering event as
                                     # one per-lane event body
                                     # (engine/fused*.py): panel
                                     # quadrature, deposit, propagation,
                                     # peel and scatter in one fused pass
                                     # over the (N,) packet state.
                                     # Requires the analytic or table
                                     # single-mix panel path with distant
                                     # instruments; raises otherwise.
    table_peel: str = "exact"        # fused TABLE mode peel-off extinction:
                                     # 'exact' = per-leader column-DDA (one
                                     # row gather per lateral column
                                     # crossed) — exact for the voxel
                                     # field, the accuracy-validated
                                     # default (0.06% flux vs the exact
                                     # walk, experiments/accuracy_table.py);
                                     # 'staged' = P_peel-panel quadrature —
                                     # its variance sits inside e^-tau and
                                     # becomes a convexity BIAS (25% flux
                                     # at 8 panels, 0.7% at 32);
                                     # 'taumap' = per-leader density-path
                                     # maps (two gathers/packet but a
                                     # cell-scale lateral approximation:
                                     # ~5% SED error at 16^3 voxels).
                                     # 'exact' needs a uniform Cartesian
                                     # (voxel) grid; other grids downgrade
                                     # to 'staged' with a warning.
    voxelize: bool | None = None     # trace tree grids through their exact
                                     # uniform-voxel view (Cartesian DDA)
                                     # instead of the per-step re-descent
                                     # walk; tallies fold voxel -> leaf at
                                     # phase end.  None = auto (on for
                                     # OligoSimulation when the grid
                                     # voxelizes within budget); False =
                                     # always the leaf walk
    path_record: bool | None = None  # record each event's path into (S, N)
                                     # buffers (ref: DustGridPath) so
                                     # absorption + propagation inversion
                                     # are vectorized over segments and the
                                     # second traversal disappears; None =
                                     # auto (on for grids with small
                                     # max_steps, off otherwise — memory is
                                     # 3*S*N words)
    count_events: bool = False       # fused table paths: accumulate the
                                     # total scattering-event count into
                                     # tallies["nevents"] (one scalar sum
                                     # of live lanes per iteration) — the
                                     # per-event accounting for
                                     # throughput per scattering event;
                                     # off by default


def propagate_tau_sample(taupath, u1, u2, xi, n):
    """Forced-scattering optical-depth sample + bias weight.

    ref: MonteCarloSimulation::simulatepropagation (:519-537) — composite
    bias xi between the uniform and truncated-exponential tau densities,
    weight = p/q.  Shared by the single-device and slab-decomposed
    lifecycles so the two stay identical event for event.
    """
    tau_exp = rng.expon_cutoff(u2, taupath)
    if xi == 0.0:
        return tau_exp, jnp.ones(n, jnp.float32)
    tau_uni = u2 * taupath
    tau = jnp.where(u1 < xi, tau_uni, tau_exp)
    p = -jnp.exp(-tau) / jnp.expm1(-jnp.maximum(taupath, 1e-30))
    qq = (1.0 - xi) * p + xi / jnp.maximum(taupath, 1e-30)
    return tau, p / jnp.maximum(qq, 1e-37)


def hg_costheta(g, u):
    """Henyey-Greenstein deflection cosine from one uniform deviate.

    ref: MonteCarloSimulation::simulatescattering + DustMix HG sampling;
    the |g| < 1e-6 branch is the isotropic limit.
    """
    f = (1.0 - g) * (1.0 + g) / (1.0 - g + 2.0 * g * u)
    cos_hg = (1.0 + g * g - f * f) / (2.0 * jnp.where(
        jnp.abs(g) < 1e-6, 1.0, g))
    return jnp.where(jnp.abs(g) < 1e-6, 2.0 * u - 1.0,
                     jnp.clip(cos_hg, -1.0, 1.0))


def terminate_alive(alive, L, taupath, Lthreshold, nscatt, min_scatt):
    """Packet termination rule (ref: dostellaremissionchunk :289)."""
    alive = alive & (L > 0) & jnp.logical_not(
        (L <= Lthreshold) & (nscatt >= min_scatt))
    return alive & (taupath > 0)


def make_lifecycle_with_fallback(grid, dust_system, stellar_system,
                                 instruments, options, nlambda, log=None,
                                 **kwargs):
    """make_lifecycle, retrying without the fused fast path on ValueError.

    The fused engines gate narrow configurations (analytic/table density,
    distant instruments, ...) by raising; driver code that enables
    `options.fused` opportunistically (ski --fast) uses this wrapper so
    an ineligible model falls back to the general path instead of
    crashing.  Returns (run_batch, options used): after a fallback the
    options carry no fused path and no refill, and the caller must count
    its batches by them (without refill every lane launches one packet).
    """
    try:
        return make_lifecycle(grid, dust_system, stellar_system,
                              instruments, options, nlambda,
                              **kwargs), options
    except ValueError as e:
        if not getattr(options, "fused", False):
            raise
        if log is not None:
            log.info(f"fused fast path unavailable ({e}); using the "
                     "general estimators")
        from dataclasses import replace
        slow = replace(options, fused=False, refill_batches=0,
                       polychromatic=False)
        return make_lifecycle(grid, dust_system, stellar_system,
                              instruments, slow, nlambda, **kwargs), slow


def make_multibatch(run_batch, nbatches: int, key_fn=None):
    """Fold `nbatches` lifecycle batches into ONE jittable dispatch.

    Dispatch latency is a fixed cost per jit call; folding batches
    amortizes it.  This wrapper runs `nbatches` consecutive batches in a
    single `lax.fori_loop`, re-deriving each batch's RNG key with
    `key_fn(key, b)` (default: `jax.random.fold_in`) and accumulating the
    tallies functionally — the per-batch results are identical to
    `nbatches` separate dispatches with the same keys, up to float32
    accumulation order.

    Returns run_many(key, ell, L0, tallies) -> tallies.
    """
    import jax as _jax

    kf = key_fn if key_fn is not None else _jax.random.fold_in

    def run_many(key, ell, L0, tallies):
        def body(b, t):
            return run_batch(kf(key, b), ell, L0, t)
        return _jax.lax.fori_loop(0, nbatches, body, tallies)

    return run_many


def begin_traversal(grid, pos, direction):
    """Traversal state from an arbitrary position: inside -> start, outside
    -> advance to the domain entry (ref: DustGridPath::moveInside)."""
    s_in = grid.start(pos)
    inside = grid.cell_of(s_in) >= 0
    _, s_enter = grid.enter(pos, direction)
    state = jax.tree.map(
        lambda a, b: jnp.where(inside, a, b), s_in, s_enter)
    return state


def make_peel_off(grid, dust_system, instrument, rho_path_map=None):
    """Returns fn(tallies, pos, ell, contribution, tags) applying extinction
    along the observer direction and detecting.

    rho_path_map: optional (Ncomp, Ncells) density-path integrals from cell
    centers to the boundary along the instrument direction; when given,
    peel-off extinction is tau = sum_h map[h, cell] * kappaext_h(ell) — a
    gather instead of a traversal (LifecycleOptions.fast_peeloff).
    """

    # hoisted out of the traced function (lazily caching inside a trace
    # would leak tracers under shard_map)
    centers = _centers_cache(grid) if (rho_path_map is not None
                                       and grid is not None) else None

    def peel(tallies, pos, ell, contribution, tags, active=None, cell=None,
             tau=None, kapparho=None):
        kobs = instrument.observer_direction(pos)
        max_s = instrument.observer_distance(pos) \
            if hasattr(instrument, "observer_distance") else None
        if tau is not None:
            # shared extinction: computed once for all instruments with
            # the same observer direction
            pass
        elif dust_system is None:
            tau = jnp.zeros(contribution.shape, contribution.dtype)
        elif rho_path_map is not None and max_s is None:
            c = grid.cell_of(grid.start(pos)) if cell is None else cell
            safe = jnp.clip(c, 0)
            tau = 0.0
            kr_local = 0.0
            kext_t = jnp.asarray(dust_system.kappaext)
            rho_t = jnp.asarray(dust_system.rho)
            rmap = jnp.asarray(rho_path_map)
            for h in range(dust_system.ncomp):
                kh = kext_t[h, ell]
                tau = tau + rmap[h, safe] * kh
                kr_local = kr_local + rho_t[h, safe] * kh
            # first-order in-cell correction: the map holds tau from the
            # cell center; shift by the projected offset times local kappa*rho
            delta = jnp.sum((jnp.asarray(centers)[safe] - pos) * kobs,
                            axis=-1)
            tau = jnp.maximum(tau + kr_local * delta, 0.0)
            tau = jnp.where(c >= 0, tau, 0.0)
        else:
            state0 = begin_traversal(grid, pos, kobs)
            if kapparho is None:
                # fallback; callers pass the hoisted per-packet closure
                # (per-wavelength kappa gathers inside the sweep double the
                # per-step gather count otherwise)
                kapparho = dust_system.kapparho_ext_fn(ell)
            tau = traversal.optical_depth(grid, kapparho, pos, kobs,
                                          state0=state0, max_s=max_s,
                                          active=active)
        extincted = contribution * jnp.exp(-tau)
        if tags is not None:
            tags = dict(tags, transparent=contribution)
        return instrument.detect(tallies, pos, ell, extincted, tags)

    return peel


def _centers_cache(grid):
    """Cell centers cached on the grid object (numpy: traced consumers
    wrap with jnp.asarray so the constant inlines as an HLO literal)."""
    if not hasattr(grid, "_centers_np"):
        import numpy as np
        grid._centers_np = np.asarray(grid.cell_centers(), np.float32)
    return grid._centers_np


def compute_rho_path_maps(grid, dust_system, instrument, chunk: int = 65536):
    """Per-cell density-path integrals toward a distant instrument.

    One traversal sweep from every cell center along the constant observer
    direction; tau(cell, ell) then factorizes as map[h, cell] *
    kappaext_h(ell).  Computed once per (instrument, phase) at setup.
    """
    import numpy as np
    centers = grid.cell_centers()
    ncells = centers.shape[0]
    out = np.empty((dust_system.ncomp, ncells), np.float32)
    for h in range(dust_system.ncomp):
        rho_h = dust_system.rho[h]

        def kr(cell, rho_h=rho_h):
            return jnp.where(cell >= 0, jnp.asarray(rho_h)[jnp.clip(cell, 0)],
                             0.0)

        vals = []
        for i in range(0, ncells, chunk):
            pos = jnp.asarray(centers[i:i + chunk], jnp.float32)
            kobs = instrument.observer_direction(pos)
            p = traversal.optical_depth(grid, kr, pos, kobs)
            vals.append(np.asarray(p))
        out[h] = np.concatenate(vals)
    return out


def make_lifecycle(grid, dust_system, stellar_system, instruments,
                   options: LifecycleOptions, nlambda: int,
                   launch_fn=None, emission_peeloff: bool = True,
                   scattering_peeloff: bool = True, is_dust_emission=False,
                   mueller=None, io_state: bool = False,
                   max_iterations: int | None = None):
    """Build the jittable per-batch lifecycle function.

    Returns run_batch(key, ell, L0, tallies[, launch_ctx]) -> tallies where
    - ell: (N,) int32 wavelength bin per packet,
    - L0:  (N,) float32 launch luminosity per packet [W] (Lv[ell]/Npp),
    - tallies: dict with "instruments" (list of per-instrument dicts) and
      optionally "labs" (flat (Ncells*Nlambda,) absorption tally).

    launch_fn(key, ell, L0, ctx) -> (pos, dir, L) overrides the stellar
    launch (used by the dust-emission phases, ref: dodustemissionchunk).
    emission_peeloff/scattering_peeloff=False reproduces the reference's
    self-absorption cycles (dodustselfabsorptionchunk: absorb only).
    mueller: a media.polarization.MuellerTables enables polarized
    scattering (ref: DustMix polarization branch); packets then carry
    normalized Stokes ratios and a reference normal.
    io_state=True enables survivor compaction: the cycle runs at most
    max_iterations scattering events and run_batch returns
    (tallies, packet_state); passing state_in resumes packets mid-flight
    (the north-star sorted-compaction divergence control).
    """
    ds = dust_system
    if (options.fused and options.polychromatic and ds is not None
            and getattr(ds, "table", False)):
        from . import fused_table_poly as _ftp
        return _ftp.make_fused_table_poly_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission, mueller=mueller,
            io_state=io_state, max_iterations=max_iterations)
    if (options.fused and options.polychromatic and ds is not None
            and getattr(ds, "analytic", False)):
        from . import fused_poly as _fp
        return _fp.make_fused_poly_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission, mueller=mueller,
            io_state=io_state, max_iterations=max_iterations)
    if options.fused and ds is not None and getattr(ds, "table", False):
        from . import fused_table as _ft
        return _ft.make_fused_table_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission, mueller=mueller,
            io_state=io_state, max_iterations=max_iterations)
    if options.fused:
        from . import fused as _fused
        return _fused.make_fused_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission, mueller=mueller,
            io_state=io_state, max_iterations=max_iterations)
    if options.continuous_scattering and not options.fast_peeloff:
        raise ValueError("continuous_scattering requires fast_peeloff "
                         "(per-segment peel-off needs the tau maps)")
    maps = [None] * len(instruments)
    if options.fast_peeloff and ds is not None:
        maps = [compute_rho_path_maps(grid, ds, ins)
                if not hasattr(ins, "observer_distance") else None
                for ins in instruments]
    peels = [make_peel_off(grid, ds, ins, rho_path_map=m)
             for ins, m in zip(instruments, maps)]
    muellers = None
    if mueller is not None:
        from ..media import polarization as pol
        # normalize to a per-component list (ref: the reference keeps
        # per-mix Mueller matrices; peel blends them with the wv weights
        # and scattering selects one via randomMixForPosition)
        muellers = (list(mueller) if isinstance(mueller, (list, tuple))
                    else [mueller])
        if ds is not None and len(muellers) != ds.ncomp:
            raise ValueError("mueller list must have one entry per dust "
                             "component (None for unpolarized mixes)")

    # fully-batched all-crossings traversal (vector_traversal.py): no
    # sequential stepping at all — the default whenever the grid can
    # enumerate its surface crossings in closed form
    # analytic-density fast path: rho evaluated at segment midpoints with
    # elementwise math instead of per-cell table gathers.  Panel quadrature only needs the grid's
    # in-domain ray span + batched point location, so grids without a
    # closed-form crossing set (curved grids) still qualify.
    analytic = bool(ds is not None and getattr(ds, "analytic", False))
    can_panels = (grid is not None and hasattr(grid, "ray_span")
                  and hasattr(grid, "locate_batched"))
    use_vector = (grid is not None and ds is not None
                  and not options.continuous_scattering
                  and ((hasattr(grid, "crossings")
                        and hasattr(grid, "locate_batched"))
                       or (analytic and can_panels)))
    if analytic and not use_vector:
        raise ValueError("density_mode='analytic' requires a grid with "
                         "batched crossings or ray_span+locate_batched "
                         "(vector traversal) and no continuous_scattering")
    # panel count for the analytic quadrature: same per-direction
    # resolution as the wall-crossing segmentation
    npanels = None
    if analytic and can_panels:
        npanels = int(options.quadrature_panels
                      or getattr(grid, "max_steps", 96))
    if options.deposition not in ("path", "sampled"):
        raise ValueError("deposition must be 'path' or 'sampled'")

    use_refill = options.refill_batches > 1
    if use_refill and (launch_fn is not None or mueller is not None
                       or io_state or not use_vector
                       or stellar_system is None
                       or not stellar_system.is_isotropic):
        raise ValueError(
            "refill_batches requires the vector traversal path with an "
            "isotropic stellar launch and no polarization/io_state/"
            "launch_fn")

    # path-record mode (ref: DustGridPath): vectorize per-segment physics
    # over an (S, N) buffer and drop the second (propagation) traversal;
    # auto-enabled for grids with bounded small step counts
    use_path_record = (options.path_record if options.path_record is not None
                       else (grid is not None
                             and getattr(grid, "max_steps", 1 << 30) <= 160))
    use_path_record = bool(use_path_record) and grid is not None \
        and not options.continuous_scattering and not use_vector

    # exact-mode distant instruments with the same observer direction share
    # one peel-off traversal (common case: SED + frame of the same view).
    # In vector mode EVERY exact distant instrument joins a group (its tau
    # comes from a batched record-paths pass instead of a streaming sweep).
    import numpy as _np
    _shared_leader = {}
    _dir_groups = {}
    for _i, (_ins, _m) in enumerate(zip(instruments, maps)):
        if _m is None and not hasattr(_ins, "observer_distance") \
                and hasattr(_ins, "kobs"):
            key = tuple(_np.round(_np.asarray(_ins.kobs, _np.float64), 12))
            _dir_groups.setdefault(key, []).append(_i)
    for _g in _dir_groups.values():
        if len(_g) > 1 or use_vector:
            for _i in _g:
                _shared_leader[_i] = _g[0]

    def rows_kappas(cells, ksca_pk, kext_pk, want_sca=True):
        """Batched per-segment (kappasca*rho, kappaext*rho) over (N, S) rows.

        ref: DustSystem::ksca_kext — same sum over components, but the
        cell-id rows come from a recorded path so every rho gather is
        independent and batchable.
        """
        safe = jnp.clip(cells, 0)
        ksca = 0.0
        kext = 0.0
        for h in range(ds.ncomp):
            rho_r = ds.rho_at(h, safe)
            if want_sca:
                ksca = ksca + ksca_pk[h][:, None] * rho_r
            kext = kext + kext_pk[h][:, None] * rho_r
        valid = cells >= 0
        kext = jnp.where(valid, kext, 0.0)
        if not want_sca:
            return kext
        return jnp.where(valid, ksca, 0.0), kext

    def vector_taus(pos, kext_pk):
        """Peel-off optical depths toward every leader instrument, batched."""
        taus = {}
        for lead in sorted(set(_shared_leader.values())):
            kobs = instruments[lead].observer_direction(pos)
            if analytic and npanels is not None:
                np_peel = int(options.peel_panels or npanels)
                ds_seg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
                kext_rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                             want_sca=False)
            elif analytic:
                _, ds_seg, _, mid = vt.record_paths(
                    grid, pos, kobs, want_cells=False, want_mid=True)
                kext_rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                             want_sca=False)
            else:
                cells, ds_seg, _ = vt.record_paths(grid, pos, kobs)
                kext_rows = rows_kappas(cells, None, kext_pk, want_sca=False)
            taus[lead] = jnp.sum(kext_rows * ds_seg, axis=1)
        return taus

    def shared_taus(pos, kapparho, active):
        """tau per group leader, computed once per event."""
        taus = {}
        for lead in set(_shared_leader.values()):
            kobs = instruments[lead].observer_direction(pos)
            taus[lead] = traversal.optical_depth(
                grid, kapparho, pos, kobs,
                state0=begin_traversal(grid, pos, kobs), active=active)
        return taus

    def run_batch(key, ell, L0, tallies, launch_ctx=None, state_in=None):
        n = ell.shape[0]
        k_launch, k_cycle = jax.random.split(rng.event_key(key, 1))

        if state_in is not None:
            # resume mid-flight packets (compaction continuation)
            ell = state_in["ell"]
            L0 = state_in["L0"]
            pos = state_in["pos"]
            direction = state_in["dir"]
            L = state_in["L"]
            alive = state_in["alive"]
            comp = None
        else:
            # --- launch (ref: StellarSystem::launch) ----------------------
            comp = None
            if launch_fn is not None:
                pos, direction, L = launch_fn(k_launch, ell, L0, launch_ctx)
            else:
                pos, direction, L, comp = stellar_system.launch(k_launch, ell,
                                                                L0)
            alive = L > 0

        # hoist per-wavelength property gathers out of the traversal loops
        if ds is not None:
            ksca_pk, kext_pk = ds.packet_kappas(ell)
            kapparho_pk = ds.kapparho_ext_from(kext_pk)
        else:
            kapparho_pk = None

        # --- emission peel-off (ref: peeloffemission) ---------------------
        dust_flags = jnp.full(n, bool(is_dust_emission))
        tags = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
        anisotropic = (comp is not None and stellar_system is not None
                       and not stellar_system.is_isotropic)
        if emission_peeloff and state_in is None:
            if _shared_leader and ds is not None:
                taus0 = vector_taus(pos, kext_pk) if use_vector \
                    else shared_taus(pos, kapparho_pk, alive)
            else:
                taus0 = {}
            for i, peel in enumerate(peels):
                contribution = jnp.where(alive, L, 0.0)
                if anisotropic:
                    # ref: launchEmissionPeelOff direction-bias weight
                    kobs = instruments[i].observer_direction(pos)
                    contribution = contribution * \
                        stellar_system.direction_probability(ell, pos, kobs,
                                                             comp)
                tallies["instruments"][i] = peel(
                    tallies["instruments"][i], pos, ell, contribution, tags,
                    tau=taus0.get(_shared_leader.get(i)),
                    kapparho=kapparho_pk)

        if ds is None:
            return (tallies, None) if io_state else tallies

        Lthreshold = L0 / options.min_weight_reduction
        labs = tallies.get("labs")

        def refill_emission_peel(ins_list, pos_p, L_p, mask):
            """Emission peel-off for relaunched lanes (isotropic launch)."""
            t = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
            t0 = vector_taus(pos_p, kext_pk) if _shared_leader else {}
            out = list(ins_list)
            for i, peel in enumerate(peels):
                out[i] = peel(out[i], pos_p, ell,
                              jnp.where(mask, L_p, 0.0), t,
                              tau=t0.get(_shared_leader.get(i)),
                              kapparho=kapparho_pk)
            return out

        state = dict(
            it=jnp.int32(0), pos=pos, dir=direction, L=L,
            nscatt=state_in["nscatt"] if state_in is not None
            else jnp.zeros(n, jnp.int32),
            alive=alive,
            labs=labs if labs is not None else jnp.zeros((1,), jnp.float32),
            ins=tallies["instruments"],
        )
        if use_refill:
            state["bcount"] = jnp.ones(n, jnp.int32)
        if mueller is not None:
            if state_in is not None:
                state.update(q=state_in["q"], u=state_in["u"],
                             v=state_in["v"], normal=state_in["normal"])
            else:
                state.update(q=jnp.zeros(n), u=jnp.zeros(n), v=jnp.zeros(n),
                             normal=jnp.zeros((n, 3)))

        def cycle_body(st):
            it = st["it"]
            pos, direction, L = st["pos"], st["dir"], st["L"]
            nscatt, alive = st["nscatt"], st["alive"]
            labs_c, ins_tallies = st["labs"], st["ins"]
            kit = rng.event_key(k_cycle, it)
            k1, k2, k3 = jax.random.split(kit, 3)

            if use_refill:
                # relaunch dead lanes that still have packet budget
                # (ref: none — the reference's thread pool keeps cores busy
                # by pulling fresh chunks; this is the SPMD-lane analog)
                K = options.refill_batches
                eligible = jnp.logical_not(alive) & (st["bcount"] < K)

                def _refill(op):
                    pos, direction, L, nscatt, alive, bcount, ins = op
                    kr = jax.random.fold_in(kit, 987654)
                    npos, ndir, nL, _ = stellar_system.launch(kr, ell, L0)
                    take = eligible & (nL > 0)
                    pos = jnp.where(take[:, None], npos, pos)
                    direction = jnp.where(take[:, None], ndir, direction)
                    L = jnp.where(take, nL, L)
                    nscatt = jnp.where(take, 0, nscatt)
                    alive = alive | take
                    bcount = bcount + eligible.astype(jnp.int32)
                    if emission_peeloff:
                        ins = refill_emission_peel(ins, pos, L, take)
                    return (pos, direction, L, nscatt, alive, bcount, ins)

                # refill when enough lanes are idle to amortize the
                # relaunch cost (launch sampling + emission peel), or when
                # nothing is alive at all (end-of-dispatch drain)
                frac = jnp.mean(eligible.astype(jnp.float32))
                trigger = jnp.any(eligible) & (
                    (frac >= 1.0 / max(options.refill_every, 1))
                    | jnp.logical_not(jnp.any(alive)))
                op = (pos, direction, L, nscatt, alive, st["bcount"],
                      ins_tallies)
                op = jax.lax.cond(trigger, _refill, lambda o: o, op)
                (pos, direction, L, nscatt, alive, st["bcount"],
                 ins_tallies) = op

            # -- traverse + absorb (ref: simulateescapeandabsorption) ------
            continuous = options.continuous_scattering and scattering_peeloff
            if use_vector:
                # batched all-crossings pass: record, then vectorized
                # per-segment physics (zero sequential steps).  Cell-id
                # rows (a large gather downstream) are only materialized
                # when the path-deposition tally needs them.
                want_cells = (not analytic) or (
                    labs is not None and options.deposition == "path")
                if analytic and npanels is not None:
                    # sortless equal-panel quadrature of the continuous rho
                    ds_r, te_r, mid_r = vt.panel_paths(grid, pos, direction,
                                                       npanels)
                    cells_r = None
                    if want_cells:
                        pmid = pos[:, None, :] + mid_r[..., None] \
                            * direction[:, None, :]
                        cells_r = grid.locate_batched(pmid)
                        cells_r = jnp.where(ds_r > 0, cells_r, -1)
                else:
                    cells_r, ds_r, te_r, mid_r = vt.record_paths(
                        grid, pos, direction, want_cells=want_cells,
                        want_mid=True)
                # single-mix media have a spatially uniform albedo(lambda):
                # the scattered/absorbed path totals and the deposit-point
                # distribution then close over cum_r alone — no ksca rows,
                # no second cumsum, no row reduces
                uniform_albedo = analytic and ds.ncomp == 1
                if uniform_albedo:
                    kext_rows = ds.analytic_rows(
                        pos, direction, mid_r, None, kext_pk, want_sca=False)
                    kext_rows = jnp.where(ds_r > 0, kext_rows, 0.0)
                    ksca_rows = albedo_rows = None
                elif analytic:
                    ksca_rows, kext_rows = ds.analytic_rows(
                        pos, direction, mid_r, ksca_pk, kext_pk)
                    ksca_rows = jnp.where(ds_r > 0, ksca_rows, 0.0)
                    kext_rows = jnp.where(ds_r > 0, kext_rows, 0.0)
                else:
                    ksca_rows, kext_rows = rows_kappas(cells_r, ksca_pk,
                                                       kext_pk)
                dtau_r = kext_rows * ds_r
                cum_r = vt.row_cumsum(dtau_r)
                taupath = cum_r[:, -1]
                if analytic and npanels is not None:
                    # equal panels: hit-segment geometry is arithmetic in
                    # the hit index (invert_tau_panels / panel_pick_mid)
                    delta_p = ds_r[:, 0]
                    t0_p = te_r[:, 0] - delta_p
                if not uniform_albedo:
                    cum_prev_r = cum_r - dtau_r
                    albedo_rows = jnp.where(
                        kext_rows > 0,
                        ksca_rows / jnp.maximum(kext_rows, 1e-37), 0.0)
                    expfac_r = jnp.exp(-cum_prev_r) * (-jnp.expm1(-dtau_r))
                    Lint_r = jnp.where(alive, L, 0.0)[:, None] * expfac_r
                else:
                    albedo_l = ksca_pk[0] / jnp.maximum(kext_pk[0], 1e-37)
                    one_m_e = -jnp.expm1(-taupath)
                if labs is not None and options.deposition == "path":
                    idx_r = jnp.where(cells_r >= 0,
                                      cells_r * nlambda + ell[:, None], -1)
                    if uniform_albedo:
                        cum_prev_r = cum_r - dtau_r
                        expfac_r = jnp.exp(-cum_prev_r) * (-jnp.expm1(-dtau_r))
                        dep_rows = (1.0 - albedo_l[:, None]) \
                            * jnp.where(alive, L, 0.0)[:, None] * expfac_r
                    else:
                        dep_rows = (1.0 - albedo_rows) * Lint_r
                    labs_c = binned_add(labs_c, idx_r, dep_rows)
                elif labs is not None:
                    # sampled deposition: draw one segment with probability
                    # proportional to its absorbed energy, deposit the
                    # whole-path absorbed energy there (unbiased; (N,)
                    # scatter instead of (N,S))
                    ud = rng.uniform_open(jax.random.fold_in(k1, 2), (n,))
                    if uniform_albedo:
                        # absorbed-energy density ~ kapparho e^-tau: the
                        # deposit point is an expon_cutoff sample in cum_r
                        D = (1.0 - albedo_l) * L * one_m_e
                        tau_dep = rng.expon_cutoff(ud, taupath)
                        i_dep = jnp.clip(
                            jnp.sum((cum_r < tau_dep[:, None])
                                    .astype(jnp.int32), axis=1),
                            0, cum_r.shape[1] - 1)
                    else:
                        w_r = (1.0 - albedo_rows) * Lint_r
                        cw = vt.row_cumsum(w_r)
                        D = cw[:, -1]
                        target = ud * D
                        i_dep = jnp.clip(
                            jnp.sum((cw < target[:, None]).astype(jnp.int32),
                                    axis=1), 0, cw.shape[1] - 1)
                    if analytic and npanels is not None:
                        mid_dep = vt.panel_pick_mid(t0_p, delta_p, i_dep)
                    else:
                        mid_dep = vt.masked_row_pick(mid_r, i_dep)
                    cell_dep = grid.locate(pos + mid_dep[:, None] * direction)
                    idx_dep = jnp.where((cell_dep >= 0) & (D > 0),
                                        cell_dep * nlambda + ell, -1)
                    labs_c = binned_add(labs_c, idx_dep,
                                        jnp.where(alive, D, 0.0))
                if uniform_albedo:
                    L = jnp.where(alive, albedo_l * L * one_m_e, L)
                else:
                    L = jnp.where(alive,
                                  jnp.sum(albedo_rows * Lint_r, axis=1), L)

                # termination + forced propagation (shared helpers)
                alive = terminate_alive(alive, L, taupath, Lthreshold,
                                        nscatt, options.min_scatt_events)
                u1 = rng.uniform_open(jax.random.fold_in(k1, 0), (n,))
                u2 = rng.uniform_open(jax.random.fold_in(k1, 1), (n,))
                tau, weight = propagate_tau_sample(taupath, u1, u2,
                                                   options.scatt_bias, n)
                L = jnp.where(alive, L * weight, L)

                if analytic and npanels is not None:
                    s, mid_h = vt.invert_tau_panels(cum_r, t0_p, delta_p,
                                                    tau)
                    cell_at = None
                else:
                    s, cell_at, mid_h = vt.invert_tau(cum_r, ds_r, te_r,
                                                      cells_r, tau)
                if cell_at is None:
                    # analytic mode: locate the hit segment's midpoint
                    # (arithmetic for uniform grids, (N,)-sized)
                    cell_at = grid.locate(pos + mid_h[:, None] * direction)
                new_pos = pos + s[:, None] * direction
                pos = jnp.where(alive[:, None], new_pos, pos)
            else:
                state0 = begin_traversal(grid, pos, direction)
                path = None
                carry0 = dict(tau=jnp.zeros(n, jnp.float32),
                              Lsca=jnp.zeros(n, jnp.float32), labs=labs_c)
                if continuous:
                    carry0["ins"] = ins_tallies
                    carry0["segi"] = jnp.int32(0)

                def seg(carry, cell, ds_len, t_exit):
                    ksca, kext = ds.ksca_kext_from(cell, ksca_pk, kext_pk)
                    dtau = kext * ds_len
                    albedo = jnp.where(kext > 0,
                                       ksca / jnp.maximum(kext, 1e-37), 0.0)
                    expfac = jnp.exp(-carry["tau"]) * (-jnp.expm1(-dtau))
                    Lint = jnp.where(alive, L, 0.0) * expfac
                    new = dict(carry)
                    new["Lsca"] = carry["Lsca"] + albedo * Lint
                    if labs is not None:
                        idx = jnp.where(cell >= 0, cell * nlambda + ell, -1)
                        new["labs"] = drop_add(carry["labs"], idx,
                                               (1.0 - albedo) * Lint)
                    new["tau"] = carry["tau"] + dtau
                    if continuous:
                        # ref: continuouspeeloffscattering — peel-off from
                        # this path segment with weight
                        # albedo*exp(-tau0)*(1-e^-dtau), at a RANDOM
                        # in-segment position (s = s0 + uniform()*ds,
                        # MonteCarloSimulation.cpp:408)
                        segi = carry["segi"]
                        u_seg = rng.uniform_open(
                            jax.random.fold_in(
                                jax.random.fold_in(k1, 3), segi), (n,))
                        s_rand = t_exit - u_seg * ds_len
                        seg_pos = pos + s_rand[:, None] * direction
                        new["segi"] = segi + 1
                        t2 = {"nscatt": nscatt + 1, "is_dust": dust_flags}
                        for i, peel in enumerate(peels):
                            kobs_i = instruments[i].observer_direction(
                                seg_pos)
                            cosalpha = jnp.sum(direction * kobs_i, axis=-1)
                            w = ds.phase_value(cell, ell, cosalpha)
                            # ref: albedo * exp(-tau0) * (1 - e^-dtau)
                            contribution = jnp.where(
                                alive & (cell >= 0),
                                L * albedo * expfac * w, 0.0)
                            new["ins"][i] = peel(new["ins"][i], seg_pos, ell,
                                                 contribution, t2, cell=cell)
                    return new, jnp.ones(n, bool)

                if use_path_record:
                    # same streaming absorption sweep, but record per-step
                    # (cumtau, ds, t_exit) rows so propagation inverts from
                    # the recording instead of re-traversing (ref:
                    # DustGridPath record-and-replay; this halves the
                    # per-event gather-sweep count)
                    def seg_rec(carry, cell, ds_len, t_exit):
                        new, cont = seg(carry, cell, ds_len, t_exit)
                        return new, cont, new["tau"]

                    carry, path = traversal.sweep_tau_recorded(
                        grid, pos, direction, seg_rec, carry0, state0=state0,
                        active=alive)
                else:
                    carry, _ = traversal.sweep(grid, pos, direction, seg,
                                               carry0, state0=state0,
                                               active=alive)
                taupath = carry["tau"]
                labs_c = carry["labs"]
                if continuous:
                    ins_tallies = carry["ins"]
                L = jnp.where(alive, carry["Lsca"], L)

                # -- termination + forced propagation (shared helpers) -----
                alive = terminate_alive(alive, L, taupath, Lthreshold,
                                        nscatt, options.min_scatt_events)
                u1 = rng.uniform_open(jax.random.fold_in(k1, 0), (n,))
                u2 = rng.uniform_open(jax.random.fold_in(k1, 1), (n,))
                tau, weight = propagate_tau_sample(taupath, u1, u2,
                                                   options.scatt_bias, n)
                L = jnp.where(alive, L * weight, L)

                if use_path_record:
                    # vectorized inverse lookup in the recorded rows
                    # (ref: DustGridPath::pathlength)
                    cum_b, ds_b, te_b = path
                    i_hit = jnp.clip(
                        jnp.sum((cum_b < tau[None, :]).astype(jnp.int32),
                                axis=0), 0, cum_b.shape[0] - 1)

                    def _pick(a, idx):
                        # masked sum instead of a per-lane
                        # take_along_axis gather
                        sel = jax.lax.broadcasted_iota(
                            jnp.int32, a.shape, 0) == idx[None, :]
                        return jnp.sum(jnp.where(sel, a, 0), axis=0)

                    cum_h = _pick(cum_b, i_hit)
                    cum_prev = jnp.where(
                        i_hit > 0,
                        _pick(cum_b, jnp.maximum(i_hit - 1, 0)), 0.0)
                    dtau_h = cum_h - cum_prev
                    frac = jnp.where(dtau_h > 0,
                                     (tau - cum_prev)
                                     / jnp.maximum(dtau_h, 1e-30), 0.0)
                    te_h = _pick(te_b, i_hit)
                    ds_h = _pick(ds_b, i_hit)
                    s = (te_h - ds_h) + jnp.clip(frac, 0.0, 1.0) * ds_h
                    # the cell is constant across the hit segment: locate at
                    # the segment midpoint (robust against border landing)
                    mid = te_h - 0.5 * ds_h
                    cell_at = grid.locate(pos + mid[:, None] * direction)
                else:
                    s, cell_at = traversal.propagate_to_tau(
                        grid, kapparho_pk, pos, direction, tau,
                        state0=begin_traversal(grid, pos, direction),
                        active=alive)
                new_pos = pos + s[:, None] * direction
                pos = jnp.where(alive[:, None], new_pos, pos)

            # -- scattering peel-off (ref: peeloffscattering) --------------
            if scattering_peeloff and not continuous:
                tags2 = {"nscatt": nscatt + 1, "is_dust": dust_flags}
                if not _shared_leader:
                    taus_s = {}
                elif use_vector:
                    taus_s = vector_taus(pos, kext_pk)
                else:
                    taus_s = shared_taus(pos, kapparho_pk, alive)
                for i, peel in enumerate(peels):
                    kobs = instruments[i].observer_direction(pos)
                    cosalpha = jnp.sum(direction * kobs, axis=-1)
                    if mueller is None:
                        w = ds.phase_value(cell_at, ell, cosalpha)
                        tg = tags2
                    else:
                        # polarized peel-off (ref: peeloffscattering):
                        # each component h weighted by kappasca_h*rho_h;
                        # I/Q/U/V blend over components, unpolarized
                        # mixes contribute their HG phase with zero
                        # Q/U/V (the default StokesVector)
                        theta = jnp.arccos(jnp.clip(cosalpha, -1.0, 1.0))
                        phi = pol.angle_between_planes(st["normal"],
                                                       direction, kobs)
                        pdeg = jnp.sqrt(st["q"] ** 2 + st["u"] ** 2)
                        pang = 0.5 * jnp.arctan2(st["u"], st["q"])
                        qr, ur = pol.rotate_stokes(st["q"], st["u"], phi)
                        if ds.ncomp == 1:
                            wv_n = [1.0]
                        else:
                            wv = ds._component_weights(cell_at, ell)
                            tot = sum(wv)
                            wv_n = [jnp.where(tot > 0,
                                              wh / jnp.maximum(tot, 1e-30),
                                              0.0) for wh in wv]
                        w = 0.0
                        Qb = 0.0
                        Ub = 0.0
                        Vb = 0.0
                        for h, mt in enumerate(muellers):
                            if mt is None:
                                w_h = ds.components[h].mix.phase_function(
                                    ell, cosalpha)
                                w = w + wv_n[h] * w_h
                                continue
                            S11, S12, S33, S34 = mt.lookup(ell, theta)
                            w_h = jnp.asarray(mt.pfnorm)[ell] * (
                                S11 + pdeg * S12
                                * jnp.cos(2.0 * (phi - pang)))
                            _, qh, uh, vh = pol.apply_mueller(
                                qr, ur, st["v"], S11, S12, S33, S34)
                            w = w + wv_n[h] * w_h
                            Qb = Qb + wv_n[h] * w_h * qh
                            Ub = Ub + wv_n[h] * w_h * uh
                            Vb = Vb + wv_n[h] * w_h * vh
                        winv = 1.0 / jnp.maximum(w, 1e-30)
                        q2 = Qb * winv
                        u2_ = Ub * winv
                        v2 = Vb * winv
                        # rotate into the instrument frame (ref: angle
                        # BetweenScatteringAndInstrumentReference)
                        nrm = jnp.cross(direction, kobs)
                        nn = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
                        nrm = jnp.where(nn > 1e-20, nrm / jnp.maximum(nn, 1e-30),
                                        st["normal"])
                        ky = jnp.broadcast_to(
                            jnp.asarray(instruments[i].ky, jnp.float32),
                            pos.shape) if hasattr(instruments[i], "ky") else nrm
                        cosal = jnp.sum(nrm * ky, axis=-1)
                        sinal = jnp.sum(jnp.cross(nrm, ky) * kobs, axis=-1)
                        alpha = jnp.arctan2(sinal, cosal)
                        q3, u3 = pol.rotate_stokes(q2, u2_, alpha)
                        tg = dict(tags2, stokes=(q3, u3, v2))
                    contribution = jnp.where(alive, L * w, 0.0)
                    ins_tallies[i] = peel(ins_tallies[i], pos, ell,
                                          contribution, tg, active=alive,
                                          cell=cell_at,
                                          tau=taus_s.get(
                                              _shared_leader.get(i)),
                                          kapparho=kapparho_pk)

            # -- scatter (ref: simulatescattering) -------------------------
            if mueller is None:
                g = ds.sample_scatter_g(jax.random.fold_in(k2, 0), cell_at, ell)
                u = rng.uniform_open(jax.random.fold_in(k2, 1), (n,))
                costheta = hg_costheta(g, u)
                new_dir = rng.direction_about_axis(k3, direction, costheta)
            else:
                # ref: MonteCarloSimulation::simulatescattering — one mix
                # selected per event with probability ~ kappasca_h*rho_h
                # (DustSystem::randomMixForPosition), then that mix's
                # scatteringDirectionAndPolarization
                pdeg = jnp.sqrt(st["q"] ** 2 + st["u"] ** 2)
                pang = 0.5 * jnp.arctan2(st["u"], st["q"])
                # unpolarized packets need a well-defined reference normal
                have_n = jnp.linalg.norm(st["normal"], axis=-1) > 1e-6
                default_n = rng.isotropic_direction(
                    jax.random.fold_in(k2, 2), (n,))
                default_n = default_n - direction * jnp.sum(
                    default_n * direction, axis=-1, keepdims=True)
                default_n = default_n / jnp.maximum(
                    jnp.linalg.norm(default_n, axis=-1, keepdims=True), 1e-30)
                normal0 = jnp.where(have_n[:, None], st["normal"], default_n)
                if ds.ncomp == 1:
                    hsel = jnp.zeros(n, jnp.int32)
                else:
                    wv = ds._component_weights(cell_at, ell)
                    tot = sum(wv)
                    u_h = rng.uniform_open(jax.random.fold_in(k2, 3),
                                           (n,)) * jnp.maximum(tot, 1e-30)
                    acc = wv[0]
                    hsel = jnp.zeros(n, jnp.int32)
                    for h in range(1, ds.ncomp):
                        hsel = jnp.where(u_h > acc, h, hsel)
                        acc = acc + wv[h]
                new_dir = direction
                q2c = st["q"]
                u2c = st["u"]
                v2c = st["v"]
                n2c = normal0
                for h, mt in enumerate(muellers):
                    sel = hsel == h
                    if mt is None:
                        # HG scatter off an unpolarized mix: the Stokes
                        # state rides along (ref: the unpolarized branch
                        # of scatteringDirectionAndPolarization leaves
                        # the packet's StokesVector untouched); the
                        # reference normal re-projects onto the new
                        # direction's perpendicular plane
                        g_h = jnp.asarray(
                            ds.components[h].mix.g)[ell]
                        u_c = rng.uniform_open(jax.random.fold_in(k2, 1),
                                               (n,))
                        costheta = hg_costheta(g_h, u_c)
                        nd = rng.direction_about_axis(k3, direction,
                                                      costheta)
                        npr = normal0 - nd * jnp.sum(
                            normal0 * nd, axis=-1, keepdims=True)
                        nn = jnp.linalg.norm(npr, axis=-1, keepdims=True)
                        npr = jnp.where(nn > 1e-20,
                                        npr / jnp.maximum(nn, 1e-30),
                                        default_n)
                        qh, uh, vh, nh = st["q"], st["u"], st["v"], npr
                    else:
                        # ref: DustMix::scatteringDirectionAndPolarization
                        theta = mt.sample_theta(jax.random.fold_in(k2, 0),
                                                ell)
                        phi = mt.sample_phi(jax.random.fold_in(k2, 1), ell,
                                            theta, pdeg, pang)
                        qr, ur = pol.rotate_stokes(st["q"], st["u"], phi)
                        normal = pol.rotate_normal(normal0, direction, phi)
                        S11, S12, S33, S34 = mt.lookup(ell, theta)
                        _, qh, uh, vh = pol.apply_mueller(qr, ur, st["v"],
                                                          S11, S12, S33,
                                                          S34)
                        newdir = (direction * jnp.cos(theta)[:, None]
                                  + jnp.cross(normal, direction)
                                  * jnp.sin(theta)[:, None])
                        nd = newdir / jnp.maximum(
                            jnp.linalg.norm(newdir, axis=-1, keepdims=True),
                            1e-30)
                        nh = normal
                    new_dir = jnp.where(sel[:, None], nd, new_dir)
                    q2c = jnp.where(sel, qh, q2c)
                    u2c = jnp.where(sel, uh, u2c)
                    v2c = jnp.where(sel, vh, v2c)
                    n2c = jnp.where(sel[:, None], nh, n2c)
                st["q"] = jnp.where(alive, q2c, st["q"])
                st["u"] = jnp.where(alive, u2c, st["u"])
                st["v"] = jnp.where(alive, v2c, st["v"])
                st["normal"] = jnp.where(alive[:, None], n2c, st["normal"])

            direction = jnp.where(alive[:, None], new_dir, direction)
            nscatt = jnp.where(alive, nscatt + 1, nscatt)

            out = dict(st)
            out.update(it=it + 1, pos=pos, dir=direction, L=L, nscatt=nscatt,
                       alive=alive, labs=labs_c, ins=ins_tallies)
            return out

        iter_cap = max_iterations if max_iterations is not None \
            else options.max_scatt_events
        if use_refill:
            iter_cap = iter_cap * options.refill_batches

        def cycle_cond(st):
            go = (st["it"] < iter_cap) & jnp.any(st["alive"])
            if use_refill:
                go = (st["it"] < iter_cap) & (
                    jnp.any(st["alive"])
                    | jnp.any(st["bcount"] < options.refill_batches))
            return go

        final = jax.lax.while_loop(cycle_cond, cycle_body, state)

        out = dict(tallies)
        out["instruments"] = final["ins"]
        if labs is not None:
            out["labs"] = final["labs"]
        if io_state:
            pstate = {"pos": final["pos"], "dir": final["dir"],
                      "L": final["L"], "ell": ell, "L0": L0,
                      "nscatt": final["nscatt"], "alive": final["alive"]}
            if mueller is not None:
                pstate.update(q=final["q"], u=final["u"], v=final["v"],
                              normal=final["normal"])
            return out, pstate
        return out

    return run_batch
