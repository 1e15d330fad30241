"""Domain-decomposed (slab-sharded) photon lifecycle.

ref: the reference has NO spatial domain decomposition — every MPI rank
replicates the entire grid and the (Ncells x Nlambda) absorption table and
only the photon work is split (SURVEY.md §5; PanDustSystem.cpp:394-404
Allreduces the full Labs table).  The north star replaces that with
spatial decomposition so per-device memory for the density and tally
tables scales DOWN with the device count.

Design — replicated packets over sharded cells
----------------------------------------------
The classic MPI formulation migrates packets between subdomain owners
(all-to-all) as rays cross slab boundaries.  On a lockstep SPMD machine
that formulation buys nothing: with D slabs a migrating packet makes up
to D hops per phase, so each device still processes every packet once per
slab it crosses — exactly the same total work as having every device
sweep ALL packets through ITS OWN slab only.  The replicated-packet
formulation therefore does identical work with no migration latency, no
ragged all-to-all, and no load imbalance when packets bunch in dense
slabs; what moves between devices per event is only (N,)-sized path
integrals:

  * the domain is cut into D x-slabs (grid planes), one per device in a
    1-D mesh; the (Ncomp, Ncells) density table and the (Ncells*Nlambda)
    absorption tally are sharded by slab (cells are x-major, so a slab is
    a contiguous flat-cell range);
  * every device holds the full (replicated) packet state and advances it
    with identical RNG streams;
  * per event, each device records only the ray segments inside its slab
    (slab-local wall crossings: nx/D + ny + nz candidates instead of
    nx + ny + nz) and gathers only its local density shard;
  * per-slab optical depths are all-gathered — a (D, N) exchange — and a
    ray-ordered cumulative sum (computed identically on every device)
    yields the total path tau, each slab's entry offset, and the unique
    owner of any interaction point;
  * the owner inverts the interaction point in its local path record and
    one psum publishes (s, cell) to everyone; absorption deposits stay
    entirely local to the owning slab's tally shard (zero communication —
    the reference Allreduces the full table instead);
  * instrument peel-off extinction is the same per-slab sweep + psum; the
    detection arithmetic is replicated, so instrument tallies need no
    collective at all.

Per-device memory: density + tallies ~1/D (the point of domain
decomposition); packet state is replicated (N x ~10 words — small next to
cell tables for import-scale grids).  Per-event collective payload:
one (D, N) all-gather + a few (N,) psums, independent of grid size.

Supported envelope (first cut): gridded-density mode on a Cartesian grid
whose nx is divisible by the device count, unpolarized, exact peel-off,
path or sampled absorption deposition.  The analytic-density fast path
needs no decomposition (its memory does not scale with cells).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import rng
from ..engine import lifecycle as lc
from ..engine import vector_traversal as vt
from ..ops import binned_add

SLAB_AXIS = "slabs"

_BIG = 3.4e38


def make_slab_lifecycle(mesh: Mesh, grid, dust_system, stellar_system,
                        instruments, options, nlambda: int,
                        emission_peeloff: bool = True,
                        scattering_peeloff: bool = True,
                        is_dust_emission: bool = False,
                        exchange: str = "allgather", launch_fn=None):
    """Build the domain-decomposed lifecycle over a 1-D slab mesh.

    exchange='migrate' swaps the per-event (D, N) all-gather for the
    sharded-packet ppermute ring engine (parallel/migrate.py
    make_migrating_lifecycle): packets live N/D per device, their ray
    descriptors hop neighbour-to-neighbour, and deposits land in the
    owning slab's local tally shard.  Narrower envelope (single
    component, sampled deposition, isotropic source); per-device RNG
    streams differ from the replicated engine's.

    Returns run(key, ell, L0) -> {"instruments": [per-instrument tallies,
    replicated], "labs": (Ncells*Nlambda,) absorption tally SHARDED over
    the slab axis (present when options.store_absorption)}.  Because slabs
    are contiguous flat-cell ranges, the sharded labs array IS the global
    tally in global cell order — no reordering needed on fetch.

    Physics and RNG discipline mirror engine.lifecycle.make_lifecycle's
    vector gridded path event for event, so results match the
    single-device engine to float32 reduction-order tolerance.
    """
    if exchange == "migrate":
        from .migrate import make_migrating_lifecycle
        return make_migrating_lifecycle(
            mesh, grid, dust_system, stellar_system, instruments,
            options, nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission)
    if exchange == "fused":
        # sharded packets + slab-sharded tables with the per-event
        # physics in the fused table event per device
        # (panel rows assembled by a ppermute ring sweep) — see
        # parallel/slab_fused.py
        from .slab_fused import (make_slab_fused_lifecycle,
                                 make_slab_fused_poly_lifecycle)
        if not (emission_peeloff and scattering_peeloff) \
                or is_dust_emission or launch_fn is not None:
            raise NotImplementedError("exchange='fused' supports the "
                                      "full stellar phase only")
        if getattr(options, "polychromatic", False):
            return make_slab_fused_poly_lifecycle(
                mesh, grid, dust_system, stellar_system, instruments,
                options, nlambda)
        return make_slab_fused_lifecycle(mesh, grid, dust_system,
                                         stellar_system, instruments,
                                         options, nlambda)
    if exchange != "allgather":
        raise ValueError("exchange must be 'allgather', 'migrate' or "
                         "'fused'")
    if launch_fn is not None:
        raise NotImplementedError("launch_fn (dust-emission launch) is "
                                  "supported by exchange='migrate' only")
    ds = dust_system
    D = int(mesh.devices.size)
    if ds is None:
        raise ValueError("slab decomposition requires a dust system "
                         "(nothing to shard without one)")
    # analytic mode composes too: densities are closed-form (no rho shard
    # to gather) but the (Ncells*Nlambda) absorption tally still shards by
    # slab, and each device runs the panel quadrature over the ray's slab
    # x-interval only (arithmetic, no structural blocker — VERDICT r1 #4)
    analytic = bool(getattr(ds, "analytic", False))
    # table mode composes as well: the panel structure is the analytic
    # one, but densities gather from MY slab's rho shard at the panel
    # midpoints (local cell ids are already computed for the deposits),
    # so the table still shards ~1/D per device
    table = bool(getattr(ds, "table", False))
    if not hasattr(grid, "nx"):
        raise ValueError("slab decomposition requires a Cartesian grid")
    if grid.nx % D != 0:
        raise ValueError(f"grid.nx ({grid.nx}) must be divisible by the "
                         f"device count ({D})")
    if options.continuous_scattering or options.fast_peeloff \
            or options.refill_batches > 1 or options.fused:
        raise ValueError("slab decomposition supports the exact vector "
                         "path only (no continuous/fast_peeloff/refill/"
                         "fused)")
    if ds is not None and ds.mueller is not None:
        raise NotImplementedError("polarization not yet supported in the "
                                  "slab-decomposed lifecycle")
    for ins in instruments:
        if hasattr(ins, "observer_distance"):
            raise NotImplementedError("slab decomposition supports distant "
                                      "instruments only")
    if options.deposition not in ("path", "sampled"):
        raise ValueError("deposition must be 'path' or 'sampled'")

    nxl = grid.nx // D
    cells_per_slab = nxl * grid.ny * grid.nz
    ncomp = ds.ncomp
    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 64)) if analytic else None

    # shared-direction peel groups (same rule as make_lifecycle: every
    # exact distant instrument joins a group keyed by its direction)
    _shared_leader = {}
    _dir_groups = {}
    for i, ins in enumerate(instruments):
        if hasattr(ins, "kobs"):
            k = tuple(np.round(np.asarray(ins.kobs, np.float64), 12))
            _dir_groups.setdefault(k, []).append(i)
    for g in _dir_groups.values():
        for i in g:
            _shared_leader[i] = g[0]

    store_labs = bool(options.store_absorption)
    xb_full = np.asarray(grid.xb, np.float32)

    def per_device(key, ell, L0, rho_loc):
        n = ell.shape[0]
        idx = jax.lax.axis_index(SLAB_AXIS)
        cell_offset = idx * cells_per_slab
        xb_l = jax.lax.dynamic_slice(jnp.asarray(xb_full), (idx * nxl,),
                                     (nxl + 1,))

        def slab_rows_analytic(pos, direction, kpk_list):
            """Analytic-mode per-slab panel record, same contract as
            slab_rows: equal-panel quadrature over the ray's global span
            clipped to MY slab's x-interval (pure arithmetic; the only
            per-cell object left is the deposit target)."""
            t0g, t1g = grid.ray_span(pos, direction)
            dx = direction[:, 0]
            x0 = pos[:, 0]
            moving = jnp.abs(dx) > 1e-30
            inv = 1.0 / jnp.where(moving, dx, 1.0)
            ta = (xb_l[0] - x0) * inv
            tb = (xb_l[-1] - x0) * inv
            in_x = (x0 >= xb_l[0]) & (x0 <= xb_l[-1])
            near = jnp.where(moving, jnp.minimum(ta, tb),
                             jnp.where(in_x, -_BIG, _BIG))
            far = jnp.where(moving, jnp.maximum(ta, tb),
                            jnp.where(in_x, _BIG, -_BIG))
            t_lo = jnp.maximum(t0g, near)
            t_hi = jnp.minimum(t1g, far)
            delta = jnp.maximum(t_hi - t_lo, 0.0) / npanels
            k = jnp.arange(1, npanels + 1, dtype=pos.dtype)[None, :]
            te_r = t_lo[:, None] + k * delta[:, None]
            mid = te_r - 0.5 * delta[:, None]
            ds_r = jnp.broadcast_to(delta[:, None], te_r.shape)
            pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
            gcell = grid.locate_batched(pmid)
            lcell = gcell - cell_offset
            valid = (ds_r > 0) & (lcell >= 0) & (lcell < cells_per_slab)
            if table:
                # gather the slab-local density shard at the panel cells
                safe = jnp.clip(lcell, 0, cells_per_slab - 1)
                outs = []
                for kpk in kpk_list:
                    rows = 0.0
                    for h in range(ncomp):
                        rows = rows + kpk[h][:, None] * rho_loc[h][safe]
                    outs.append(jnp.where(valid, rows, 0.0))
            elif len(kpk_list) == 2:
                ksca_rows, kext_rows = ds.analytic_rows(
                    pos, direction, mid, kpk_list[0], kpk_list[1])
                outs = [jnp.where(ds_r > 0, ksca_rows, 0.0),
                        jnp.where(ds_r > 0, kext_rows, 0.0)]
            else:
                kext_rows = ds.analytic_rows(pos, direction, mid, None,
                                             kpk_list[0], want_sca=False)
                outs = [jnp.where(ds_r > 0, kext_rows, 0.0)]
            lcell = jnp.where(valid, lcell, -1)
            gcell = jnp.where(valid, gcell, -1)
            return outs, ds_r, te_r, lcell, gcell

        def slab_rows(pos, direction, kpk_list):
            """Per-slab path record: (rows per kappa list entry, ds, te,
            local cells).  kpk_list: list of per-packet kappa lists (one
            row set per entry, e.g. [kext_pk] or [ksca_pk, kext_pk]).
            Cell ids are always materialized — the density gathers need
            them (unlike vt.record_paths' analytic want_cells=False)."""
            if analytic:
                return slab_rows_analytic(pos, direction, kpk_list)
            t_all, t_start, t_stop = grid.crossings_with_x(
                xb_l, pos, direction)
            t = jnp.clip(t_all, t_start[:, None], t_stop[:, None])
            ts = jnp.sort(t, axis=-1)
            ds_r = ts[:, 1:] - ts[:, :-1]
            te_r = ts[:, 1:]
            mid = te_r - 0.5 * ds_r
            pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
            gcell = grid.locate_batched(pmid)
            lcell = gcell - cell_offset
            valid = (ds_r > 0) & (lcell >= 0) & (lcell < cells_per_slab)
            safe = jnp.clip(lcell, 0, cells_per_slab - 1)
            outs = []
            for kpk in kpk_list:
                rows = 0.0
                for h in range(ncomp):
                    rows = rows + kpk[h][:, None] * rho_loc[h][safe]
                outs.append(jnp.where(valid, rows, 0.0))
            lcell = jnp.where(valid, lcell, -1)
            gcell = jnp.where(valid, gcell, -1)
            return outs, ds_r, te_r, lcell, gcell

        def slab_tau(pos, direction, kext_pk):
            (kext_rows,), ds_r, _, _, _ = slab_rows(pos, direction,
                                                    [kext_pk])
            return jnp.sum(kext_rows * ds_r, axis=1)

        def ray_ordered(tau_slab, dirx):
            """All-gather per-slab taus and build the ray-ordered cumsum.

            Returns (cum_slabs (D, N) in ray order — bit-identical on every
            device, the basis for consistent ownership claims —, offset
            (N,) = tau accumulated before MY slab, taupath (N,)).
            """
            taus = jax.lax.all_gather(tau_slab, SLAB_AXIS)      # (D, N)
            dirpos = dirx >= 0
            ordered = jnp.where(dirpos[None, :], taus, taus[::-1])
            cum_slabs = jnp.cumsum(ordered, axis=0)
            iota = jnp.arange(D, dtype=jnp.int32)[:, None]
            before = jnp.where(dirpos[None, :], iota < idx, iota > idx)
            offset = jnp.sum(jnp.where(before, taus, 0.0), axis=0)
            return cum_slabs, offset, cum_slabs[-1], dirpos

        def owner_of(cum_slabs, dirpos, tau):
            """Slab index owning global path depth `tau` (consistent on
            every device: derived from the shared cum_slabs alone)."""
            r = jnp.clip(jnp.sum((cum_slabs < tau[None, :]).astype(jnp.int32),
                                 axis=0), 0, D - 1)
            return jnp.where(dirpos, r, D - 1 - r)

        def peel_taus(pos, kext_pk):
            """Peel-off tau toward every leader instrument: slab sweep +
            psum (ref-equivalent of the per-instrument extinction
            traversal, SimpleInstrument.cpp:34-49)."""
            taus = {}
            for lead in sorted(set(_shared_leader.values())):
                kobs = instruments[lead].observer_direction(pos)
                taus[lead] = jax.lax.psum(slab_tau(pos, kobs, kext_pk),
                                          SLAB_AXIS)
            return taus

        # --- launch (replicated: identical RNG on every device) ----------
        k_launch, k_cycle = jax.random.split(rng.event_key(key, 1))
        pos, direction, L, comp = stellar_system.launch(k_launch, ell, L0)
        alive = L > 0

        ksca_pk, kext_pk = ds.packet_kappas(ell)
        albedo_l = None
        if ncomp == 1:
            albedo_l = ksca_pk[0] / jnp.maximum(kext_pk[0], 1e-37)

        ins_tallies = [ins.zero_tallies() for ins in instruments]
        labs_loc = jnp.zeros((cells_per_slab * nlambda,), jnp.float32) \
            if store_labs else jnp.zeros((1,), jnp.float32)

        dust_flags = jnp.full(n, bool(is_dust_emission))
        tags = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
        anisotropic = not stellar_system.is_isotropic
        if emission_peeloff:
            taus0 = peel_taus(pos, kext_pk)
            for i, ins in enumerate(instruments):
                contribution = jnp.where(alive, L, 0.0)
                if anisotropic:
                    kobs = ins.observer_direction(pos)
                    contribution = contribution * \
                        stellar_system.direction_probability(ell, pos, kobs,
                                                             comp)
                extincted = contribution * jnp.exp(-taus0[_shared_leader[i]])
                tg = dict(tags, transparent=contribution)
                ins_tallies[i] = ins.detect(ins_tallies[i], pos, ell,
                                            extincted, tg)

        Lthreshold = L0 / options.min_weight_reduction

        def rho_at_cell(gcell, pos=None):
            """Per-component rho at the interaction point.  Gridded: the
            owner gathers from its shard, ONE stacked psum publishes all
            components.  Analytic: replicated closed-form evaluation at
            the position — no collective at all."""
            if analytic and not table:
                invL = jnp.float32(1.0 / ds.lscale)
                mL3 = jnp.asarray(ds._mass_over_L3)
                pos_s = (pos * invL)[:, None, :]
                return [mL3[h] * ds.components[h].geometry.density_scaled(
                    pos_s, ds.lscale)[:, 0] for h in range(ncomp)]
            mine = (gcell >= cell_offset) \
                & (gcell < cell_offset + cells_per_slab)
            safe = jnp.clip(gcell - cell_offset, 0, cells_per_slab - 1)
            stacked = jnp.stack([jnp.where(mine, rho_loc[h][safe], 0.0)
                                 for h in range(ncomp)])
            out = jax.lax.psum(stacked, SLAB_AXIS)
            return [out[h] for h in range(ncomp)]

        state = dict(it=jnp.int32(0), pos=pos, dir=direction, L=L,
                     nscatt=jnp.zeros(n, jnp.int32), alive=alive,
                     labs=labs_loc, ins=ins_tallies)

        def cycle_body(st):
            it = st["it"]
            pos, direction, L = st["pos"], st["dir"], st["L"]
            nscatt, alive = st["nscatt"], st["alive"]
            labs_c, ins_t = st["labs"], st["ins"]
            kit = rng.event_key(k_cycle, it)
            k1, k2, k3 = jax.random.split(kit, 3)

            # -- slab traversal + absorb (ref: simulateescapeandabsorption)
            want_sca = ncomp > 1
            kpks = [ksca_pk, kext_pk] if want_sca else [kext_pk]
            rows, ds_r, te_r, lcell_r, gcell_r = slab_rows(pos, direction,
                                                           kpks)
            kext_rows = rows[-1]
            dtau_r = kext_rows * ds_r
            cum_r = vt.row_cumsum(dtau_r)
            tau_slab = cum_r[:, -1]
            cum_slabs, offset, taupath, dirpos = ray_ordered(
                tau_slab, direction[:, 0])

            if want_sca:
                ksca_rows = rows[0]
                albedo_rows = jnp.where(
                    kext_rows > 0,
                    ksca_rows / jnp.maximum(kext_rows, 1e-37), 0.0)
                cum_prev_r = cum_r - dtau_r
                expfac_r = jnp.exp(-(offset[:, None] + cum_prev_r)) \
                    * (-jnp.expm1(-dtau_r))
                Lint_r = jnp.where(alive, L, 0.0)[:, None] * expfac_r
                Lsca = jax.lax.psum(jnp.sum(albedo_rows * Lint_r, axis=1),
                                    SLAB_AXIS)
            else:
                one_m_e = -jnp.expm1(-taupath)

            if store_labs and options.deposition == "path":
                idx_r = jnp.where(lcell_r >= 0,
                                  lcell_r * nlambda + ell[:, None], -1)
                if want_sca:
                    dep_rows = (1.0 - albedo_rows) * Lint_r
                else:
                    cum_prev_r = cum_r - dtau_r
                    expfac_r = jnp.exp(-(offset[:, None] + cum_prev_r)) \
                        * (-jnp.expm1(-dtau_r))
                    dep_rows = (1.0 - albedo_l[:, None]) \
                        * jnp.where(alive, L, 0.0)[:, None] * expfac_r
                labs_c = binned_add(labs_c, idx_r, dep_rows)
            elif store_labs:
                # sampled deposition: one segment per event, drawn by
                # absorbed energy; the OWNER slab deposits locally
                ud = rng.uniform_open(jax.random.fold_in(k1, 2), (n,))
                if not want_sca:
                    D_abs = (1.0 - albedo_l) * L * one_m_e
                    tau_dep = rng.expon_cutoff(ud, taupath)
                    own_dep = owner_of(cum_slabs, dirpos, tau_dep)
                    tloc = jnp.clip(tau_dep - offset, 0.0, tau_slab)
                    i_dep = jnp.clip(jnp.sum((cum_r < tloc[:, None])
                                             .astype(jnp.int32), axis=1),
                                     0, cum_r.shape[1] - 1)
                else:
                    # Lint_r already carries the cross-slab offset
                    # attenuation, so these rows are the packet's GLOBAL
                    # absorbed-energy profile restricted to this slab
                    w_r = (1.0 - albedo_rows) * Lint_r
                    cw = vt.row_cumsum(w_r)
                    W_slab = cw[:, -1]
                    cumW, offW, Wtot, _ = ray_ordered(W_slab,
                                                      direction[:, 0])
                    D_abs = Wtot
                    target = ud * Wtot
                    own_dep = owner_of(cumW, dirpos, target)
                    tgt_loc = jnp.clip(target - offW, 0.0, W_slab)
                    i_dep = jnp.clip(jnp.sum((cw < tgt_loc[:, None])
                                             .astype(jnp.int32), axis=1),
                                     0, cw.shape[1] - 1)
                cell_dep = vt.masked_row_pick_int(lcell_r, i_dep)
                mine = own_dep == idx
                idx_dep = jnp.where(mine & (cell_dep >= 0) & (D_abs > 0)
                                    & alive,
                                    cell_dep * nlambda + ell, -1)
                labs_c = binned_add(labs_c, idx_dep,
                                    jnp.where(alive, D_abs, 0.0))

            if want_sca:
                L = jnp.where(alive, Lsca, L)
            else:
                L = jnp.where(alive, albedo_l * L * one_m_e, L)

            # -- termination + forced propagation (shared helpers, so the
            # slab engine stays identical to lifecycle.py event for event)
            alive = lc.terminate_alive(alive, L, taupath, Lthreshold,
                                       nscatt, options.min_scatt_events)
            u1 = rng.uniform_open(jax.random.fold_in(k1, 0), (n,))
            u2 = rng.uniform_open(jax.random.fold_in(k1, 1), (n,))
            tau, weight = lc.propagate_tau_sample(taupath, u1, u2,
                                                  options.scatt_bias, n)
            L = jnp.where(alive, L * weight, L)

            # ownership + local inversion + psum publication
            owner = owner_of(cum_slabs, dirpos, tau)
            am_owner = (owner == idx) & alive
            tau_loc = jnp.clip(tau - offset, 0.0, tau_slab)
            s_inv, gcell_at, _ = vt.invert_tau(cum_r, ds_r, te_r, gcell_r,
                                               tau_loc)
            s = jax.lax.psum(jnp.where(am_owner, s_inv, 0.0), SLAB_AXIS)
            cell_at = jax.lax.psum(
                jnp.where(am_owner, gcell_at + 1, 0), SLAB_AXIS) - 1
            new_pos = pos + s[:, None] * direction
            pos = jnp.where(alive[:, None], new_pos, pos)

            # -- scattering peel-off (ref: peeloffscattering) --------------
            if scattering_peeloff:
                rho_at = rho_at_cell(cell_at, pos) if ncomp > 1 else None
                taus_s = peel_taus(pos, kext_pk)
                tags2 = {"nscatt": nscatt + 1, "is_dust": dust_flags}
                for i, ins in enumerate(instruments):
                    kobs = ins.observer_direction(pos)
                    cosalpha = jnp.sum(direction * kobs, axis=-1)
                    if ncomp == 1:
                        w = ds.components[0].mix.phase_function(ell, cosalpha)
                    else:
                        wv = [ksca_pk[h] * rho_at[h] for h in range(ncomp)]
                        total = sum(wv)
                        w = 0.0
                        for h in range(ncomp):
                            w = w + wv[h] * ds.components[h].mix \
                                .phase_function(ell, cosalpha)
                        w = jnp.where(total > 0,
                                      w / jnp.maximum(total, 1e-30), 0.0)
                    contribution = jnp.where(alive, L * w, 0.0)
                    extincted = contribution \
                        * jnp.exp(-taus_s[_shared_leader[i]])
                    tg = dict(tags2, transparent=contribution)
                    ins_t[i] = ins.detect(ins_t[i], pos, ell, extincted, tg)
            elif ncomp > 1:
                rho_at = rho_at_cell(cell_at, pos)

            # -- scatter (ref: simulatescattering) -------------------------
            if ncomp == 1:
                g = jnp.asarray(ds.g)[0, ell]
            else:
                wv = [ksca_pk[h] * rho_at[h] for h in range(ncomp)]
                total = sum(wv)
                u = jax.random.uniform(jax.random.fold_in(k2, 0), ell.shape) \
                    * jnp.maximum(total, 1e-30)
                g = jnp.asarray(ds.g)[0, ell]
                acc = wv[0]
                for h in range(1, ncomp):
                    g = jnp.where(u > acc, jnp.asarray(ds.g)[h, ell], g)
                    acc = acc + wv[h]
            u = rng.uniform_open(jax.random.fold_in(k2, 1), (n,))
            costheta = lc.hg_costheta(g, u)
            new_dir = rng.direction_about_axis(k3, direction, costheta)
            direction = jnp.where(alive[:, None], new_dir, direction)
            nscatt = jnp.where(alive, nscatt + 1, nscatt)

            out = dict(st)
            out.update(it=it + 1, pos=pos, dir=direction, L=L,
                       nscatt=nscatt, alive=alive, labs=labs_c, ins=ins_t)
            return out

        def cycle_cond(st):
            return (st["it"] < options.max_scatt_events) \
                & jnp.any(st["alive"])

        final = jax.lax.while_loop(cycle_cond, cycle_body, state)
        out = {"instruments": final["ins"]}
        if store_labs:
            out["labs"] = final["labs"]
        return out

    # structural specs: instruments replicate (identical arithmetic on
    # every device), labs stays slab-sharded — contiguous x-major slabs
    # make the sharded array the global tally in global cell order
    out_specs = {"instruments": [jax.tree.map(lambda _: P(),
                                              ins.zero_tallies())
                                 for ins in instruments]}
    if store_labs:
        out_specs["labs"] = P(SLAB_AXIS)
    sharded = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(None, SLAB_AXIS)),
        out_specs=out_specs,
        check_vma=False)

    from jax.sharding import NamedSharding
    # device_put straight from host numpy: going through jnp.asarray first
    # would materialize the FULL table on the default device before
    # resharding — an OOM at exactly the import-scale grids slab
    # decomposition exists for
    # analytic mode never touches the table — ship a (ncomp, D) dummy so
    # nothing cell-sized is materialized
    rho_host = (np.zeros((ncomp, D), np.float32) if analytic and not table
                else np.asarray(ds.rho, np.float32))
    rho_dev = jax.device_put(rho_host,
                             NamedSharding(mesh, P(None, SLAB_AXIS)))
    jitted = jax.jit(sharded)

    def run(key, ell, L0):
        return jitted(key, ell, L0, rho_dev)

    return run
