"""The fused table event composed with slab sharding.

ref: the reference composes its two parallelism axes everywhere — every
thread-pool loop runs under MPI (SKIRTcore/Parallel.cpp:76-177 +
ProcessAssigner.hpp:25-97).  Here packets are SHARDED (N/D lanes per
device), the (Ncells) density table and the (Ncells*Nlambda) absorption
tally are SHARDED by x-slab, and the per-event physics runs in the same
table event as the single-device engine (engine/fused_table.make_event,
engine/fused_table_poly.make_event) on each device's resident lanes.

The composition trick: the fused kernel consumes a COMPLETE per-lane
(P,) panel record of kappa*rho along the global ray — but the density
shard on each device covers only its slab.  So each event does a
PANEL-FILL RING SWEEP first: every lane's ray descriptor (position,
direction, kext, a (P,) row buffer) makes one lap of the slab ring via
`jax.lax.ppermute`; each visited device fills the panels whose midpoints
fall inside ITS slab from ITS local density shard.  After D hops the
descriptor is home with the full rows and the kernel runs exactly as on
a single device — same panel grid, same inversion, same RNG stream
shape.  Per-link payload per sweep: (P + 7) * N/D words, independent of
D (the allgather engine's per-device volume grows with D).

After the event, a second ring sweep carries (new position, deposit
bin/value, per-leader peel accumulators): each visited device adds its
slab-clipped panel quadrature toward every leader direction and CLAIMS
deposits whose global bins land in its labs shard — absorption writes
are entirely local to the owning shard (zero tally collective; the
reference Allreduces the full table instead,
doc/Part 2/Parallelization/MPI SKIRT.txt:11-17).

Envelope (first cut, mirrors the migrating engine): single dust
component, uniform Cartesian (voxel) table grid with nx divisible by D,
sampled deposition, distant instruments, isotropic stellar source,
unpolarized.  Supports persistent-lane refill (XLA-side relaunch, the
fused_table pattern) — the migrating engine does not, which is the main
reason this engine is faster at equal lane counts.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .slab import SLAB_AXIS, _BIG
from ..engine import fused_table, fused_table_poly
from ..engine.fused import _group_leaders
from ..ops import binned_add


def make_slab_fused_lifecycle(mesh: Mesh, grid, dust_system,
                              stellar_system, instruments, options,
                              nlambda: int):
    """Build run(key, ell, L0) -> {"instruments": [replicated tallies],
    "labs": (Ncells*Nlambda,) sharded over the slab axis}.

    ell/L0 are sharded along the packet axis (N/D lanes per device).
    """
    from jax.sharding import NamedSharding

    from .. import rng

    ds = dust_system
    D = int(mesh.devices.size)
    if ds is None or not getattr(ds, "table", False):
        raise ValueError("slab-fused lifecycle requires a table dust "
                         "system (voxelized().as_table())")
    if not (hasattr(grid, "nx") and hasattr(grid, "_uniform")
            and all(grid._uniform)):
        raise ValueError("slab-fused lifecycle requires a uniform "
                         "Cartesian (voxel) grid")
    if grid.nx % D:
        raise ValueError(f"grid.nx ({grid.nx}) must divide by D={D}")
    if options.store_absorption and options.deposition != "sampled":
        raise NotImplementedError("sampled deposition only")
    if ds.mueller is not None:
        raise NotImplementedError("polarization not supported")
    if not stellar_system.is_isotropic:
        raise NotImplementedError("isotropic stellar emission only")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            raise NotImplementedError("distant instruments only")

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    nlead = len(leaders)
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    mix = ds.components[0].mix
    iter_cap = int(options.max_scatt_events) * K

    nx, ny, nz = grid.nx, grid.ny, grid.nz
    nxl = nx // D
    cells_per_slab = nxl * ny * nz
    lo = np.asarray(grid._lo, np.float64)
    dxv = np.asarray(grid._dx, np.float64)

    # the event is built against the GLOBAL grid: its arithmetic locate
    # yields GLOBAL deposit bins (cell*nlambda + ell), which the deposit
    # ring sweep routes to the owning slab shard
    multi = ds.ncomp > 1
    H = ds.ncomp
    # multi: staged (kext*rho, ksca*rho) row pairs -> per-panel albedo
    # blending in the event; component selection + blended peel move
    # XLA-side after a ring lap that fetches the interaction cell's
    # per-component densities from the owning shard
    event = fused_table.make_event(grid, options, nlambda, npanels,
                                   want_labs, True, multi)
    n_uniform = 3 if multi else 5

    fwd = [(i, (i + 1) % D) for i in range(D)]

    def per_device(key, ell, L0, rho_loc):
        n = ell.shape[0]
        d = jax.lax.axis_index(SLAB_AXIS)
        kdev = jax.random.fold_in(key, d)
        kext_t = jnp.asarray(np.asarray(ds.kappaext, np.float32))
        x0_my = np.float32(lo[0]) + d.astype(jnp.float32) \
            * np.float32(nxl * dxv[0])

        # ---- ring sweep primitives --------------------------------------
        def hopf(arrs):
            return [jax.lax.ppermute(a, SLAB_AXIS, fwd) for a in arrs]

        def fill_rows(pos, direction, kpk_mat, want_sca=False):
            """One lap of the ring: every lane's (P,) blended kappa*rho
            panel rows filled from each slab's local shard.  kpk_mat is
            (n, H) per-component kext (columns H..2H-1 carry ksca when
            want_sca — the multi-component kernel consumes both row
            sets).  Returns (rows_kext[, rows_ksca], t0, delta) —
            t0/delta recomputed from the (ring-invariant) descriptor so
            they equal the home values bit for bit."""
            rows_r = jnp.zeros((n, npanels), jnp.float32)
            st = [pos, direction, kpk_mat, rows_r]                 + ([jnp.zeros((n, npanels), jnp.float32)]
                   if want_sca else [])
            for _ in range(D):
                p_c, d_c, k_c, rows = st[0], st[1], st[2], st[3]
                rows_s = st[4] if want_sca else None
                t0g, t1g = grid.ray_span(p_c, d_c)
                delta = jnp.maximum(t1g - t0g, 0.0) / npanels
                kk = jnp.arange(npanels, dtype=jnp.float32)[None, :]
                tmid = t0g[:, None] + (kk + 0.5) * delta[:, None]
                px = p_c[:, 0:1] + tmid * d_c[:, 0:1]
                py = p_c[:, 1:2] + tmid * d_c[:, 1:2]
                pz = p_c[:, 2:3] + tmid * d_c[:, 2:3]
                ixl = jnp.floor((px - x0_my)
                                * np.float32(1.0 / dxv[0])).astype(
                    jnp.int32)
                iy = jnp.floor((py - np.float32(lo[1]))
                               * np.float32(1.0 / dxv[1])).astype(
                    jnp.int32)
                iz = jnp.floor((pz - np.float32(lo[2]))
                               * np.float32(1.0 / dxv[2])).astype(
                    jnp.int32)
                ok = ((ixl >= 0) & (ixl < nxl) & (iy >= 0) & (iy < ny)
                      & (iz >= 0) & (iz < nz) & (delta[:, None] > 0))
                safe = jnp.clip((ixl * ny + iy) * nz + iz, 0,
                                cells_per_slab - 1)
                acc_r = 0.0
                acc_s = 0.0
                for h in range(H):
                    rho_h = rho_loc[h][safe]
                    acc_r = acc_r + k_c[:, h:h + 1] * rho_h
                    if want_sca:
                        acc_s = acc_s + k_c[:, H + h:H + h + 1] * rho_h
                rows = rows + jnp.where(ok, acc_r, 0.0)
                nxt = [p_c, d_c, k_c, rows]
                if want_sca:
                    rows_s = rows_s + jnp.where(ok, acc_s, 0.0)
                    nxt.append(rows_s)
                st = hopf(nxt)
            p_c, d_c = st[0], st[1]
            t0g, t1g = grid.ray_span(p_c, d_c)
            delta = jnp.maximum(t1g - t0g, 0.0) / npanels
            if want_sca:
                return st[3], st[4], t0g, delta
            return st[3], t0g, delta

        def slab_peel_tau(pos, kobs_np, kpk_mat):
            """My slab's clipped P_peel-panel kext*rho quadrature toward
            a fixed leader direction (the per-slab share of the peel
            optical depth)."""
            kx, ky, kz = [np.float32(v) for v in kobs_np]
            t0 = jnp.zeros(pos.shape[0], jnp.float32)
            t1 = jnp.full(pos.shape[0], np.float32(_BIG))
            spans = [(x0_my, x0_my + np.float32(nxl * dxv[0]), kx, 0),
                     (np.float32(lo[1]),
                      np.float32(lo[1] + ny * dxv[1]), ky, 1),
                     (np.float32(lo[2]),
                      np.float32(lo[2] + nz * dxv[2]), kz, 2)]
            for (a, b, dd, ax) in spans:
                o = pos[:, ax]
                if abs(float(dd)) > 1e-12:
                    i2 = np.float32(1.0 / float(dd))
                    aa = (a - o) * i2
                    bb = (b - o) * i2
                    t0 = jnp.maximum(t0, jnp.minimum(aa, bb))
                    t1 = jnp.minimum(t1, jnp.maximum(aa, bb))
                else:
                    inside = (o >= a) & (o <= b)
                    t1 = jnp.where(inside, t1, np.float32(-_BIG))
            t0 = jnp.maximum(t0, 0.0)
            hit = t1 > t0
            delta = jnp.where(hit, (t1 - t0) / np_peel, 0.0)
            tau = jnp.zeros_like(delta)
            for k in range(np_peel):
                tm = t0 + np.float32(k + 0.5) * delta
                ixl = jnp.floor((pos[:, 0] + tm * kx - x0_my)
                                * np.float32(1.0 / dxv[0])).astype(
                    jnp.int32)
                iy = jnp.floor((pos[:, 1] + tm * ky - np.float32(lo[1]))
                               * np.float32(1.0 / dxv[1])).astype(
                    jnp.int32)
                iz = jnp.floor((pos[:, 2] + tm * kz - np.float32(lo[2]))
                               * np.float32(1.0 / dxv[2])).astype(
                    jnp.int32)
                ok = ((ixl >= 0) & (ixl < nxl) & (iy >= 0) & (iy < ny)
                      & (iz >= 0) & (iz < nz) & hit)
                safe = jnp.clip((ixl * ny + iy) * nz + iz, 0,
                                cells_per_slab - 1)
                acc = 0.0
                for h in range(H):
                    acc = acc + kpk_mat[:, h] * rho_loc[h][safe]
                tau = tau + jnp.where(ok, acc, 0.0) * delta
            return tau

        bin_lo = d * (cells_per_slab * nlambda)

        def peel_deposit_sweep(pos, kext_pk, dep_bin, dep_val, labs_c):
            """One lap carrying (pos, kext, deposit bin/value, per-leader
            accumulators): peel taus accumulate; each visited device
            claims the deposits whose global bins land in its shard."""
            accs = [jnp.zeros(n, jnp.float32) for _ in range(nlead)]
            st = [pos, kext_pk, dep_bin, dep_val] + accs
            for _ in range(D):
                p_c, k_c, db_c, dv_c = st[:4]
                acc_c = st[4:]
                if want_labs:
                    mine = (db_c >= bin_lo) \
                        & (db_c < bin_lo + cells_per_slab * nlambda)
                    labs_c = binned_add(
                        labs_c, jnp.where(mine, db_c - bin_lo, -1), dv_c)
                new_accs = [acc_c[li]
                            + slab_peel_tau(p_c, leaders[li], k_c)
                            for li in range(nlead)]
                st = hopf([p_c, k_c, db_c, dv_c] + new_accs)
            return st[4:], labs_c

        # ---- launch (per-device shard, device-folded RNG) ---------------
        k_launch, k_cycle = jax.random.split(rng.event_key(kdev, 1))
        pos, direction, L, _comp = stellar_system.launch(k_launch, ell,
                                                         L0)
        alive = L > 0
        ksca_l, kext_l = ds.packet_kappas(ell)
        kpk_ext = jnp.stack(list(kext_l), axis=1)          # (n, H)
        kpk_mat = (jnp.concatenate(
            [kpk_ext, jnp.stack(list(ksca_l), axis=1)], axis=1)
            if multi else kpk_ext)                         # (n, 2H)|(n, H)
        kext_pk = kext_l[0]
        albedo_pk = ksca_l[0] / jnp.maximum(kext_pk, 1e-37)
        g_pk = jnp.asarray(np.asarray(mix.g, np.float32))[ell]

        ins_t = [ins.zero_tallies() for ins in instruments]
        labs_loc = jnp.zeros((cells_per_slab * nlambda,), jnp.float32) \
            if want_labs else jnp.zeros((1,), jnp.float32)

        dust_flags = jnp.full(n, False)
        no_dep = jnp.full(n, -1, jnp.int32)
        taus0, labs_loc = peel_deposit_sweep(
            pos, kpk_ext, no_dep, jnp.zeros(n, jnp.float32), labs_loc)
        tags0 = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
        for i, ins in enumerate(instruments):
            contribution = jnp.where(alive, L, 0.0)
            extincted = contribution * jnp.exp(-taus0[lead_of[i]])
            ins_t[i] = ins.detect(ins_t[i], pos, ell, extincted,
                                  dict(tags0, transparent=contribution))

        go0 = jax.lax.psum(jnp.any(alive).astype(jnp.int32), SLAB_AXIS)
        state = dict(it=jnp.int32(0), pos=pos, dir=direction, L=L,
                     ns=jnp.zeros(n, jnp.int32), alive=alive,
                     bc=jnp.ones(n, jnp.int32), labs=labs_loc,
                     ins=ins_t, go=go0)

        def body(st):
            s_pos, s_dir, s_L = st["pos"], st["dir"], st["L"]
            s_ns, s_alive = st["ns"], st["alive"]
            labs_c, ins_c = st["labs"], st["ins"]
            kit = rng.event_key(k_cycle, st["it"])
            us = list(jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                                  jnp.float32),
                               1e-7, 1.0 - 1e-7))

            # -- sweep F: assemble the full panel rows over the ring ------
            def panels(rows):                      # (n, P) -> P x (n,)
                return list(jnp.moveaxis(rows, 1, 0))

            wv_h = None
            if multi:
                kr_rows, ks_rows, t0g, delta = fill_rows(
                    s_pos, s_dir, kpk_mat, want_sca=True)
                kstate = (s_pos[:, 0], s_pos[:, 1], s_pos[:, 2],
                          s_dir[:, 0], s_dir[:, 1], s_dir[:, 2],
                          s_L, s_alive.astype(jnp.int32), s_ns, ell, L0,
                          t0g, delta)
                outs = event(us, panels(kr_rows), kstate,
                             ks=panels(ks_rows))
                pos_new = jnp.stack(outs[0:3], axis=-1)
                L_new = outs[3]
                alive_new = outs[4] != 0
                cell_at = outs[5]
                dep_bin = outs[6] if want_labs else no_dep
                dep_val = outs[7] if want_labs \
                    else jnp.zeros(n, jnp.float32)

                # per-component densities at the interaction cell:
                # lanes are SHARDED (a psum would sum misaligned
                # lanes), so the (cell,) descriptor makes one ring lap
                # and each visited shard fills the cells it owns
                cell_lo = d * cells_per_slab

                def rho_ring(cells):
                    st2 = [cells, jnp.zeros((n, H), jnp.float32)]
                    for _ in range(D):
                        c_c, a_c = st2
                        minec = (c_c >= cell_lo) \
                            & (c_c < cell_lo + cells_per_slab)
                        safec = jnp.clip(c_c - cell_lo, 0,
                                         cells_per_slab - 1)
                        vals = jnp.stack(
                            [jnp.where(minec, rho_loc[h][safec], 0.0)
                             for h in range(H)], axis=1)
                        st2 = hopf([c_c, a_c + vals])
                    return st2[1]                        # (n, H)

                rho_at_mat = rho_ring(cell_at)
                wv_h = [ksca_l[h] * rho_at_mat[:, h] for h in range(H)]
                total_wv = sum(wv_h)

                # XLA-side component selection + HG scatter (ref: the
                # unfused multi-component branch; fused_table.py body)
                from ..engine.lifecycle import hg_costheta
                ksc = rng.event_key(k_cycle, st["it"], 11)
                usel = jax.random.uniform(jax.random.fold_in(ksc, 0),
                                          (n,)) \
                    * jnp.maximum(total_wv, 1e-30)
                g_tab = jnp.asarray(np.asarray(ds.g, np.float32))
                g_sel = g_tab[0, ell]
                acc = wv_h[0]
                for h in range(1, H):
                    g_sel = jnp.where(usel > acc, g_tab[h, ell], g_sel)
                    acc = acc + wv_h[h]
                ug = rng.uniform_open(jax.random.fold_in(ksc, 1), (n,))
                costh = hg_costheta(g_sel, ug)
                dir_new = rng.direction_about_axis(
                    jax.random.fold_in(ksc, 2), s_dir, costh)
                dir_new = jnp.where(alive_new[:, None], dir_new, s_dir)
                ns_new = jnp.where(alive_new, s_ns + 1, s_ns)
            else:
                rows, t0g, delta = fill_rows(s_pos, s_dir, kpk_ext)
                kstate = (s_pos[:, 0], s_pos[:, 1], s_pos[:, 2],
                          s_dir[:, 0], s_dir[:, 1], s_dir[:, 2],
                          s_L, s_alive.astype(jnp.int32), s_ns, ell, L0,
                          t0g, delta, albedo_pk, g_pk)
                outs = event(us, panels(rows), kstate)

                pos_new = jnp.stack(outs[0:3], axis=-1)
                dir_new = jnp.stack(outs[3:6], axis=-1)
                L_new = outs[6]
                alive_new = outs[7] != 0
                ns_new = outs[8]
                dep_bin = outs[9] if want_labs else no_dep
                dep_val = outs[10] if want_labs \
                    else jnp.zeros(n, jnp.float32)

            # -- XLA-side relaunch (refill) -------------------------------
            bc = st["bc"]
            fresh = jnp.zeros(n, bool)
            if refill:
                eligible = jnp.logical_not(alive_new) & (bc < K)
                kre = rng.event_key(k_cycle, st["it"], 7)
                pos_l, dir_l, L_l, _ = stellar_system.launch(kre, ell, L0)
                pos_new = jnp.where(eligible[:, None], pos_l, pos_new)
                dir_new = jnp.where(eligible[:, None], dir_l, dir_new)
                L_new = jnp.where(eligible, L_l, L_new)
                ns_new = jnp.where(eligible, 0, ns_new)
                bc = bc + eligible.astype(jnp.int32)
                fresh = eligible
                alive_new = alive_new | eligible

            # -- sweep C: peel taus + deposit routing ---------------------
            taus_s, labs_c = peel_deposit_sweep(pos_new, kpk_ext, dep_bin,
                                                dep_val, labs_c)
            tags2 = {"nscatt": ns_new, "is_dust": dust_flags}
            for i, ins in enumerate(instruments):
                kvec = leaders[lead_of[i]]
                cosj = (s_dir[:, 0] * np.float32(kvec[0])
                        + s_dir[:, 1] * np.float32(kvec[1])
                        + s_dir[:, 2] * np.float32(kvec[2]))
                if multi:
                    # blended phase weight by ksca_h*rho_h at the
                    # interaction cell (ref: peeloffscattering's
                    # per-component wv mix)
                    total_w = sum(wv_h)
                    w = 0.0
                    for h in range(H):
                        w = w + wv_h[h] * ds.components[h].mix \
                            .phase_function(ell, cosj)
                    w = jnp.where(total_w > 0,
                                  w / jnp.maximum(total_w, 1e-30), 0.0)
                else:
                    w = mix.phase_function(ell, cosj)
                if refill:
                    w = jnp.where(fresh, 1.0, w)
                contribution = jnp.where(alive_new, L_new * w, 0.0)
                extincted = contribution * jnp.exp(-taus_s[lead_of[i]])
                ins_c[i] = ins.detect(ins_c[i], pos_new, ell, extincted,
                                      dict(tags2,
                                           transparent=contribution))

            go = jax.lax.psum(jnp.any(alive_new).astype(jnp.int32)
                              | jnp.any(bc < K).astype(jnp.int32),
                              SLAB_AXIS)
            out = dict(st)
            out.update(it=st["it"] + 1, pos=pos_new, dir=dir_new,
                       L=L_new, ns=ns_new, alive=alive_new, bc=bc,
                       labs=labs_c, ins=ins_c, go=go)
            return out

        def cond(st):
            return (st["it"] < iter_cap) & (st["go"] > 0)

        final = jax.lax.while_loop(cond, body, state)
        ins_out = [jax.tree.map(lambda x: jax.lax.psum(x, SLAB_AXIS), t)
                   for t in final["ins"]]
        out = {"instruments": ins_out}
        if want_labs:
            out["labs"] = final["labs"]
        return out

    out_specs = {"instruments": [jax.tree.map(lambda _: P(),
                                              ins.zero_tallies())
                                 for ins in instruments]}
    if want_labs:
        out_specs["labs"] = P(SLAB_AXIS)
    sharded = jax.shard_map(per_device, mesh=mesh,
                            in_specs=(P(), P(SLAB_AXIS), P(SLAB_AXIS),
                                      P(None, SLAB_AXIS)),
                            out_specs=out_specs, check_vma=False)
    rho_host = np.asarray(ds.rho, np.float32)
    rho_dev = jax.device_put(rho_host,
                             NamedSharding(mesh, P(None, SLAB_AXIS)))
    jitted = jax.jit(sharded)

    def run(key, ell, L0):
        return jitted(key, ell, L0, rho_dev)

    return run


def make_slab_fused_poly_lifecycle(mesh: Mesh, grid, dust_system,
                                   stellar_system, instruments, options,
                                   nlambda: int):
    """POLYCHROMATIC lanes composed with slab sharding.

    The production-width estimator (engine/fused_table_poly.py) runs
    per device on sharded lanes: the ring sweep fills RAW rho panel rows
    (wavelength-independent — no per-lane kext in the descriptor), the
    unchanged poly kernel consumes them, and the peel sweep accumulates
    raw per-leader rho integrals that serve every wavelength at once.
    Deposit bins (cell*nlambda + sampled wavelength) route to the owning
    labs shard exactly like the monochromatic engine.

    ell is ignored (poly contract); L0 is (N, nlambda) nominal rows,
    sharded along the lane axis.
    """
    from jax.sharding import NamedSharding

    from .. import rng

    ds = dust_system
    D = int(mesh.devices.size)
    W = int(nlambda)
    if ds is None or not getattr(ds, "table", False):
        raise ValueError("slab-fused poly lifecycle requires a table "
                         "dust system")
    if ds.ncomp != 1:
        raise NotImplementedError("single dust component only")
    if not (hasattr(grid, "nx") and hasattr(grid, "_uniform")
            and all(grid._uniform)):
        raise ValueError("requires a uniform Cartesian (voxel) grid")
    if grid.nx % D:
        raise ValueError(f"grid.nx ({grid.nx}) must divide by D={D}")
    if options.store_absorption and options.deposition != "sampled":
        raise NotImplementedError("sampled deposition only")
    if ds.mueller is not None:
        raise NotImplementedError("polarization not supported")
    if not stellar_system.is_isotropic:
        raise NotImplementedError("isotropic stellar emission only")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            raise NotImplementedError("distant instruments only")
    if W > 128:
        raise ValueError("nlambda <= 128")

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    nlead = len(leaders)
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    mix = ds.components[0].mix
    iter_cap = int(options.max_scatt_events) * K

    nx, ny, nz = grid.nx, grid.ny, grid.nz
    nxl = nx // D
    cells_per_slab = nxl * ny * nz
    lo = np.asarray(grid._lo, np.float64)
    dxv = np.asarray(grid._dx, np.float64)

    kext_w = [float(np.asarray(ds.kappaext)[0, w]) for w in range(W)]
    albedo_w = [float(np.asarray(mix.albedo)[w]) for w in range(W)]
    g_w = [float(np.asarray(mix.g)[w]) for w in range(W)]
    event, n_uniform = fused_table_poly.make_event(
        grid, options, W, npanels, want_labs,
        [np.asarray(v, np.float32) for v in (kext_w, albedo_w, g_w)],
        arith_locate=True)

    fwd = [(i, (i + 1) % D) for i in range(D)]

    def per_device(key, ell, L0, rho_loc):
        n = L0.shape[0]
        d = jax.lax.axis_index(SLAB_AXIS)
        kdev = jax.random.fold_in(key, d)
        x0_my = np.float32(lo[0]) + d.astype(jnp.float32) \
            * np.float32(nxl * dxv[0])

        def hopf(arrs):
            return [jax.lax.ppermute(a, SLAB_AXIS, fwd) for a in arrs]

        def fill_rows(pos, direction):
            """One ring lap filling RAW rho panel rows (lambda-free)."""
            st = [pos, direction, jnp.zeros((n, npanels), jnp.float32)]
            for _ in range(D):
                p_c, d_c, rows = st
                t0g, t1g = grid.ray_span(p_c, d_c)
                delta = jnp.maximum(t1g - t0g, 0.0) / npanels
                kk = jnp.arange(npanels, dtype=jnp.float32)[None, :]
                tmid = t0g[:, None] + (kk + 0.5) * delta[:, None]
                px = p_c[:, 0:1] + tmid * d_c[:, 0:1]
                py = p_c[:, 1:2] + tmid * d_c[:, 1:2]
                pz = p_c[:, 2:3] + tmid * d_c[:, 2:3]
                ixl = jnp.floor((px - x0_my)
                                * np.float32(1.0 / dxv[0])).astype(
                    jnp.int32)
                iy = jnp.floor((py - np.float32(lo[1]))
                               * np.float32(1.0 / dxv[1])).astype(
                    jnp.int32)
                iz = jnp.floor((pz - np.float32(lo[2]))
                               * np.float32(1.0 / dxv[2])).astype(
                    jnp.int32)
                ok = ((ixl >= 0) & (ixl < nxl) & (iy >= 0) & (iy < ny)
                      & (iz >= 0) & (iz < nz) & (delta[:, None] > 0))
                safe = jnp.clip((ixl * ny + iy) * nz + iz, 0,
                                cells_per_slab - 1)
                rows = rows + jnp.where(ok, rho_loc[0][safe], 0.0)
                st = hopf([p_c, d_c, rows])
            p_c, d_c, rows = st
            t0g, t1g = grid.ray_span(p_c, d_c)
            delta = jnp.maximum(t1g - t0g, 0.0) / npanels
            return rows, t0g, delta

        def slab_peel_I(pos, kobs_np):
            """My slab's raw rho quadrature toward a leader direction."""
            kx, ky, kz = [np.float32(v) for v in kobs_np]
            t0 = jnp.zeros(pos.shape[0], jnp.float32)
            t1 = jnp.full(pos.shape[0], np.float32(_BIG))
            spans = [(x0_my, x0_my + np.float32(nxl * dxv[0]), kx, 0),
                     (np.float32(lo[1]),
                      np.float32(lo[1] + ny * dxv[1]), ky, 1),
                     (np.float32(lo[2]),
                      np.float32(lo[2] + nz * dxv[2]), kz, 2)]
            for (a, b, dd, ax) in spans:
                o = pos[:, ax]
                if abs(float(dd)) > 1e-12:
                    i2 = np.float32(1.0 / float(dd))
                    aa = (a - o) * i2
                    bb = (b - o) * i2
                    t0 = jnp.maximum(t0, jnp.minimum(aa, bb))
                    t1 = jnp.minimum(t1, jnp.maximum(aa, bb))
                else:
                    inside = (o >= a) & (o <= b)
                    t1 = jnp.where(inside, t1, np.float32(-_BIG))
            t0 = jnp.maximum(t0, 0.0)
            hit = t1 > t0
            delta = jnp.where(hit, (t1 - t0) / np_peel, 0.0)
            acc = jnp.zeros_like(delta)
            for k in range(np_peel):
                tm = t0 + np.float32(k + 0.5) * delta
                ixl = jnp.floor((pos[:, 0] + tm * kx - x0_my)
                                * np.float32(1.0 / dxv[0])).astype(
                    jnp.int32)
                iy = jnp.floor((pos[:, 1] + tm * ky - np.float32(lo[1]))
                               * np.float32(1.0 / dxv[1])).astype(
                    jnp.int32)
                iz = jnp.floor((pos[:, 2] + tm * kz - np.float32(lo[2]))
                               * np.float32(1.0 / dxv[2])).astype(
                    jnp.int32)
                ok = ((ixl >= 0) & (ixl < nxl) & (iy >= 0) & (iy < ny)
                      & (iz >= 0) & (iz < nz) & hit)
                safe = jnp.clip((ixl * ny + iy) * nz + iz, 0,
                                cells_per_slab - 1)
                acc = acc + jnp.where(ok, rho_loc[0][safe], 0.0) * delta
            return acc

        bin_lo = d * (cells_per_slab * W)

        def peel_deposit_sweep(pos, dep_bin, dep_val, labs_c):
            accs = [jnp.zeros(n, jnp.float32) for _ in range(nlead)]
            st = [pos, dep_bin, dep_val] + accs
            for _ in range(D):
                p_c, db_c, dv_c = st[:3]
                acc_c = st[3:]
                if want_labs:
                    mine = (db_c >= bin_lo) \
                        & (db_c < bin_lo + cells_per_slab * W)
                    labs_c = binned_add(
                        labs_c, jnp.where(mine, db_c - bin_lo, -1), dv_c)
                new_accs = [acc_c[li] + slab_peel_I(p_c, leaders[li])
                            for li in range(nlead)]
                st = hopf([p_c, db_c, dv_c] + new_accs)
            return st[3:], labs_c

        # ---- launch -----------------------------------------------------
        k_launch, k_cycle = jax.random.split(rng.event_key(kdev, 1))
        ell0 = jnp.zeros(n, jnp.int32)
        pos, direction, _, _ = stellar_system.launch(
            k_launch, ell0, jnp.ones(n, jnp.float32))
        L = L0.T                                     # (W, N/D)
        alive = jnp.any(L > 0, axis=0)
        l0_w = L0.T
        wls = np.arange(W, dtype=np.int32)
        kext_col = jnp.asarray(np.asarray(kext_w, np.float32))[:, None]
        g_col = np.asarray(g_w, np.float32)[:, None]

        ins_t = [ins.zero_tallies() for ins in instruments]
        labs_loc = jnp.zeros((cells_per_slab * W,), jnp.float32) \
            if want_labs else jnp.zeros((1,), jnp.float32)
        dust_flags = jnp.full(n, False)
        no_dep = jnp.full(n, -1, jnp.int32)

        Ipeel0, labs_loc = peel_deposit_sweep(
            pos, no_dep, jnp.zeros(n, jnp.float32), labs_loc)
        tags0 = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
        for i, ins in enumerate(instruments):
            cw = jnp.where(alive[None], L, 0.0)
            ext = cw * jnp.exp(-kext_col * Ipeel0[lead_of[i]][None])
            ins_t[i] = ins.detect_poly(ins_t[i], pos, wls, ext,
                                       dict(tags0, transparent=cw))

        go0 = jax.lax.psum(jnp.any(alive).astype(jnp.int32), SLAB_AXIS)
        state = dict(it=jnp.int32(0), pos=pos, dir=direction, L=L,
                     ns=jnp.zeros(n, jnp.int32), alive=alive,
                     bc=jnp.ones(n, jnp.int32), labs=labs_loc,
                     ins=ins_t, go=go0)

        def body(st):
            s_pos, s_dir = st["pos"], st["dir"]
            kit = rng.event_key(k_cycle, st["it"])
            u = jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                            jnp.float32),
                         1e-7, 1.0 - 1e-7)
            rows, t0g, delta = fill_rows(s_pos, s_dir)
            kstate = (s_pos[:, 0], s_pos[:, 1], s_pos[:, 2],
                      s_dir[:, 0], s_dir[:, 1], s_dir[:, 2],
                      st["alive"].astype(jnp.int32), st["ns"], t0g, delta)
            outs = event(list(u), list(jnp.moveaxis(rows, 1, 0)), st["L"],
                         l0_w, kstate)

            pos_new = jnp.stack(outs[0:3], axis=-1)
            dir_new = jnp.stack(outs[3:6], axis=-1)
            alive_new = outs[6] != 0
            ns_new = outs[7]
            Ln = outs[8]
            Lp = outs[9]
            dep_bin = outs[10] if want_labs else no_dep
            dep_val = outs[11] if want_labs \
                else jnp.zeros(n, jnp.float32)

            bc = st["bc"]
            fresh = jnp.zeros(n, bool)
            if refill:
                eligible = jnp.logical_not(alive_new) & (bc < K)
                kre = rng.event_key(k_cycle, st["it"], 7)
                pos_l, dir_l, _, _ = stellar_system.launch(
                    kre, ell0, jnp.ones(n, jnp.float32))
                pos_new = jnp.where(eligible[:, None], pos_l, pos_new)
                dir_new = jnp.where(eligible[:, None], dir_l, dir_new)
                Ln = jnp.where(eligible[None], L0.T, Ln)
                ns_new = jnp.where(eligible, 0, ns_new)
                bc = bc + eligible.astype(jnp.int32)
                fresh = eligible
                alive_new = alive_new | eligible

            Ipeel, labs_c = peel_deposit_sweep(pos_new, dep_bin, dep_val,
                                               st["labs"])
            ins_c = list(st["ins"])
            tags2 = {"nscatt": ns_new, "is_dust": dust_flags}
            for i, ins in enumerate(instruments):
                kvec = leaders[lead_of[i]]
                cosj = (s_dir[:, 0] * np.float32(kvec[0])
                        + s_dir[:, 1] * np.float32(kvec[1])
                        + s_dir[:, 2] * np.float32(kvec[2]))
                tq = 1.0 + g_col * g_col - 2.0 * g_col * cosj[None]
                pw = ((1.0 - g_col) * (1.0 + g_col)
                      / jnp.sqrt(tq * tq * tq))
                cw = jnp.where(fresh[None], Ln, Lp * pw)
                cw = jnp.where(alive_new[None], cw, 0.0)
                ext = cw * jnp.exp(-kext_col * Ipeel[lead_of[i]][None])
                ins_c[i] = ins.detect_poly(ins_c[i], pos_new, wls, ext,
                                           dict(tags2, transparent=cw))

            go = jax.lax.psum(jnp.any(alive_new).astype(jnp.int32)
                              | jnp.any(bc < K).astype(jnp.int32),
                              SLAB_AXIS)
            out = dict(st)
            out.update(it=st["it"] + 1, pos=pos_new, dir=dir_new, L=Ln,
                       ns=ns_new, alive=alive_new, bc=bc, labs=labs_c,
                       ins=ins_c, go=go)
            return out

        def cond(st):
            return (st["it"] < iter_cap) & (st["go"] > 0)

        final = jax.lax.while_loop(cond, body, state)
        ins_out = [jax.tree.map(lambda x: jax.lax.psum(x, SLAB_AXIS), t)
                   for t in final["ins"]]
        out = {"instruments": ins_out}
        if want_labs:
            out["labs"] = final["labs"]
        return out

    out_specs = {"instruments": [jax.tree.map(lambda _: P(),
                                              ins.zero_tallies())
                                 for ins in instruments]}
    if want_labs:
        out_specs["labs"] = P(SLAB_AXIS)
    sharded = jax.shard_map(per_device, mesh=mesh,
                            in_specs=(P(), P(SLAB_AXIS),
                                      P(SLAB_AXIS, None),
                                      P(None, SLAB_AXIS)),
                            out_specs=out_specs, check_vma=False)
    rho_host = np.asarray(ds.rho, np.float32)
    rho_dev = jax.device_put(rho_host,
                             NamedSharding(mesh, P(None, SLAB_AXIS)))
    jitted = jax.jit(sharded)

    def run(key, ell, L0):
        return jitted(key, ell, L0, rho_dev)

    return run
