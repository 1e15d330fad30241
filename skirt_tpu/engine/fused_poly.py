"""Polychromatic fused ANALYTIC event kernel: W wavelengths per lane.

The mono analytic event (engine/fused.py) spends its arithmetic on the
per-panel closed-form density evaluations, and those are
wavelength-independent, exactly like the table path's rho gathers.  This
kernel puts the full oligo wavelength vector on every lane: ONE set of
panel density evaluations (propagation + per-leader peel quadrature)
serves W wavelengths, dividing the per-packet density and tally work by
W.

The estimator is the defensive-mixture importance sampling of
engine/fused_table_poly.py (see its module docstring for the math):
the interaction point and scattering angle are drawn from the uniform
mixture over the lane's wavelengths; per-wavelength weights are
arithmetic in the lambda-independent cumulative column density and
bounded by W.  Absorption deposits sample one wavelength per event
(unbiased, one deposit stream).

The event body is a pure function over per-lane arrays, compiled by XLA
(a Pallas Triton kernel of the same body was slower on the card, PERF.md).
Persistent-lane refill from closed-form samplers and the per-leader peel
quadrature run inside the body; detects run after it.

ref: SKIRTcore/MonteCarloSimulation.cpp:438-549 event chain; the
polychromatic packet is an estimator redesign with no reference
counterpart.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..ops import binned_add
from ..ops.backend import require_supported_platform
from .fused import (_expon_cutoff, _group_leaders, _make_locate,
                    _make_span, _pick_wavelength)


def _validate(grid, ds, stellar_system, instruments, options, nlambda,
              mueller, io_state, launch_fn):
    def bail(msg):
        raise ValueError(f"polychromatic fused lifecycle: {msg}")

    if ds is None or not getattr(ds, "analytic", False) \
            or getattr(ds, "table", False):
        bail("requires density_mode='analytic' (closed-form densities)")
    if ds.ncomp != 1:
        bail("single dust component only")
    if mueller is not None:
        bail("polarization not supported (vector/fused-mono paths carry "
             "the Stokes machinery)")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    if options.store_absorption and not (hasattr(grid, "_uniform")
                                         and all(grid._uniform)):
        bail("absorption tallies require a uniform Cartesian grid "
             "(in-body arithmetic locate)")
    if nlambda > 128:
        bail("nlambda <= 128 (the widest lane vector validated; split "
             "wider grids into blocks of <= 128 wavelengths)")
    if launch_fn is not None:
        # poly launch_fn contract: (key, ell0, L0 (N, W), ctx) ->
        # (pos, dir, L (W, N)); emission must be isotropic.  Refill for
        # launch_fn lanes runs between events, outside the body (the
        # in-body relauncher samples closed-form device geometries only)
        pass
    elif stellar_system.ncomp != 1 or not stellar_system.is_isotropic:
        bail("requires a single isotropic stellar component")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if options.refill_batches > 1 and launch_fn is None:
        geom = stellar_system.components[0].geometry
        if geom.device_sampler_xyz() is None:
            bail(f"refill: {type(geom).__name__} has no closed-form "
                 "device sampler")


def _build_kernel(grid, ds, leaders, npanels, np_peel, options, W,
                  want_labs, scattering_peeloff, sampler):
    geom = ds.components[0].geometry
    lscale = ds.lscale
    invL = np.float32(1.0 / lscale)
    mL3 = float(np.asarray(ds._mass_over_L3).ravel()[0])
    kextm_w = [np.float32(float(v) * mL3) for v in ds.kappaext[0][:W]]
    albedo_w = [np.float32(float(s) / max(float(e), 1e-37))
                for s, e in zip(ds.kappasca[0][:W], ds.kappaext[0][:W])]
    g_w = [np.float32(float(v)) for v in ds.g[0][:W]]
    span = _make_span(grid.bounding_box())
    locate = _make_locate(grid) if want_labs else None
    xi = float(options.scatt_bias)
    min_scatt = int(options.min_scatt_events)
    inv_np = np.float32(1.0 / npanels)
    inv_pp = np.float32(1.0 / np_peel)
    inv_minred = np.float32(1.0 / options.min_weight_reduction)
    refill = sampler is not None
    K = int(options.refill_batches) if refill else 1
    nu_pos, pos_fn = sampler if refill else (0, None)
    nlead = len(leaders)
    tiny = np.float32(1e-30)
    # uniforms: u1, u2, u_dep, u_g, u_phi, u_c, u_pick (+ refill draws)
    n_uniform = 7 + (nu_pos + 2 if refill else 0)
    # per-wavelength optical constants (kext*m/L3, albedo, g): three (W,)
    # vectors passed as inputs, so every per-wavelength quantity below is
    # ONE (W, lanes) vector op and nlambda needs no unrolling
    oc_np = tuple(np.asarray(v, np.float32)
                  for v in (kextm_w, albedo_w, g_w))

    def rho_s(X, Y, Z):
        return geom.density_scaled_xyz(X * invL, Y * invL, Z * invL,
                                       lscale)

    def hg(g, cosa):
        t = 1.0 + g * g - 2.0 * g * cosa
        return (1.0 - g) * (1.0 + g) / jnp.sqrt(t * t * t)

    def body(oc, lanes):
        """One event for a block of lanes: pure function over arrays.

        oc: (kext, albedo, g), each (W, 1); lanes: per-lane arrays with
        the lane axis last.
        """
        kext, alb, gw = oc
        us = lanes["u"]
        X, Y, Z, DX, DY, DZ, alive_i, nscatt = lanes["s"]
        alive = alive_i != 0
        l0 = lanes["l0"]

        def uget(i):
            return us[i]

        # -- panel quadrature of the lambda-independent column density ----
        t0, t1 = span(X, Y, Z, DX, DY, DZ)
        delta = (t1 - t0) * inv_np
        cum = jnp.zeros_like(delta)
        cums = []
        for kk in range(npanels):
            midk = t0 + np.float32(kk + 0.5) * delta
            rho = rho_s(X + midk * DX, Y + midk * DY, Z + midk * DZ)
            cum = cum + rho * delta
            cums.append(cum)
        I_tot = cum

        wi = jax.lax.broadcasted_iota(jnp.int32, kext.shape, 0)
        tau = kext * I_tot[None]                         # (W, lanes)
        ome = 1.0 - jnp.exp(-tau)
        Lm = jnp.where(alive[None], lanes["L"], 0.0)

        # -- absorption deposit: one sampled wavelength per event ---------
        if want_labs:
            D = (1.0 - alb) * Lm * ome
            Dsum = jnp.sum(D, axis=0)
            target = uget(6) * Dsum
            wsel = _pick_wavelength(D, target, W)
            ohw = wi == wsel[None]
            tau_sel = jnp.sum(jnp.where(ohw, tau, 0.0), axis=0)
            kinv_sel = 1.0 / jnp.sum(jnp.where(ohw, kext, 0.0), axis=0)
            tau_dep = _expon_cutoff(uget(2), tau_sel)
            I_dep = tau_dep * kinv_sel
            i_dep = jnp.zeros(X.shape, jnp.int32)
            for kk in range(npanels - 1):
                i_dep = i_dep + (cums[kk] < I_dep).astype(jnp.int32)
            mid_dep = t0 + (i_dep.astype(jnp.float32) + 0.5) * delta
            okd = (Dsum > 0) & alive
            cell = locate(X + mid_dep * DX, Y + mid_dep * DY,
                          Z + mid_dep * DZ)
            okd = okd & (cell >= 0)
            dep = (jnp.where(okd, cell * W + wsel, -1),
                   jnp.where(okd, Dsum, 0.0))

        Lab = alb * Lm * ome

        # -- mixture-driver forced propagation ----------------------------
        c = jnp.minimum((uget(5) * np.float32(W)).astype(jnp.int32), W - 1)
        ohc = wi == c[None]
        tau_c = jnp.sum(jnp.where(ohc, tau, 0.0), axis=0)
        kinv_cc = 1.0 / jnp.sum(jnp.where(ohc, kext, 0.0), axis=0)
        g_cc = jnp.sum(jnp.where(ohc, gw, 0.0), axis=0)
        u1 = uget(0)
        u2 = uget(1)
        tau_exp = _expon_cutoff(u2, tau_c)
        if xi == 0.0:
            tau_smp = tau_exp
        else:
            tau_smp = jnp.where(u1 < xi, u2 * tau_c, tau_exp)
        I_s = tau_smp * kinv_cc

        i_hit = jnp.zeros(X.shape, jnp.int32)
        for kk in range(npanels - 1):
            i_hit = i_hit + (cums[kk] < I_s).astype(jnp.int32)
        cum_h = jnp.zeros_like(I_tot)
        cum_prev = jnp.zeros_like(I_tot)
        for kk in range(npanels):
            sel = i_hit == kk
            cum_h = jnp.where(sel, cums[kk], cum_h)
            if kk > 0:
                cum_prev = jnp.where(sel, cums[kk - 1], cum_prev)
        dI_h = cum_h - cum_prev
        frac = jnp.clip(jnp.where(dI_h > 0,
                                  (I_s - cum_prev)
                                  / jnp.maximum(dI_h, tiny), 0.0),
                        0.0, 1.0)
        s = t0 + (i_hit.astype(jnp.float32) + frac) * delta
        X = jnp.where(alive, X + s * DX, X)
        Y = jnp.where(alive, Y + s * DY, Y)
        Z = jnp.where(alive, Z + s * DZ, Z)

        # -- per-wavelength mixture ratios --------------------------------
        F = kext * jnp.exp(-kext * I_s[None]) / jnp.maximum(ome, tiny)
        if xi == 0.0:
            Q = F
        else:
            Q = ((1.0 - xi) * F
                 + np.float32(xi) * kext / jnp.maximum(tau, tiny))
        Qmix = jnp.sum(Q, axis=0) * np.float32(1.0 / W)

        u_g = uget(3)
        u_phi = uget(4)
        f = (1.0 - g_cc) * (1.0 + g_cc) / (1.0 - g_cc + 2.0 * g_cc * u_g)
        small_g = jnp.abs(g_cc) < 1e-6
        cos_hg = (1.0 + g_cc * g_cc - f * f) / (2.0
                                                * jnp.where(small_g, 1.0,
                                                            g_cc))
        costheta = jnp.where(small_g, 2.0 * u_g - 1.0,
                             jnp.clip(cos_hg, -1.0, 1.0))
        HG = hg(gw, costheta[None])                      # (W, lanes)
        QHmix = jnp.sum(Q * HG, axis=0) * np.float32(1.0 / W)

        Lp = Lab * F / jnp.maximum(Qmix[None], tiny)
        Ln = Lab * F * HG / jnp.maximum(QHmix[None], tiny)

        past_min = nscatt >= min_scatt
        kill = (Ln <= l0 * inv_minred) & past_min[None]
        Lp = jnp.where(kill, 0.0, Lp)
        Ln = jnp.where(kill, 0.0, Ln)
        alive = alive & (jnp.max(Ln, axis=0) > 0) & (I_tot > tiny)

        # -- persistent-lane relaunch (in the body, fused.py pattern) ----
        fresh = jnp.zeros(X.shape, bool)
        if refill:
            bcount = lanes["bc"]
            eligible = jnp.logical_not(alive) & (bcount < K)
            xs, ys, zs = pos_fn([uget(7 + j) for j in range(nu_pos)])
            ct = 2.0 * uget(7 + nu_pos) - 1.0
            st_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
            ph2 = np.float32(2.0 * np.pi) * uget(8 + nu_pos)
            X = jnp.where(eligible, xs, X)
            Y = jnp.where(eligible, ys, Y)
            Z = jnp.where(eligible, zs, Z)
            DX = jnp.where(eligible, st_ * jnp.cos(ph2), DX)
            DY = jnp.where(eligible, st_ * jnp.sin(ph2), DY)
            DZ = jnp.where(eligible, ct, DZ)
            Ln = jnp.where(eligible[None], l0, Ln)
            Lp = jnp.where(eligible[None], 0.0, Lp)
            nscatt = jnp.where(eligible, 0, nscatt)
            bcount = bcount + eligible.astype(jnp.int32)
            fresh = eligible
            alive = alive | eligible

        # -- peel quadrature toward each leader (lambda-independent) ------
        Ips, coss = [], []
        for j, (kx, ky, kz) in enumerate(leaders):
            if not scattering_peeloff:
                coss.append(jnp.zeros_like(I_tot))
                Ips.append(jnp.zeros_like(I_tot))
                continue
            cosj = (DX * np.float32(kx) + DY * np.float32(ky)
                    + DZ * np.float32(kz))
            coss.append(cosj)
            pt0, pt1 = span(X, Y, Z, kx, ky, kz, const_d=True)
            pd = (pt1 - pt0) * inv_pp
            rsum = jnp.zeros_like(I_tot)
            for kk in range(np_peel):
                mx = X + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(kx)
                my = Y + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(ky)
                mz = Z + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(kz)
                rsum = rsum + rho_s(mx, my, mz)
            Ips.append(rsum * pd)

        # -- HG scatter about the old direction (driver g) ----------------
        phi = np.float32(2.0 * np.pi) * u_phi
        sintheta = jnp.sqrt(jnp.maximum(0.0, 1.0 - costheta * costheta))
        cosphi = jnp.cos(phi)
        sinphi = jnp.sin(phi)
        sign = jnp.where(DZ >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + DZ)
        b = DX * DY * a
        ux = 1.0 + sign * DX * DX * a
        uy = sign * b
        uz = -sign * DX
        vx = b
        vy = sign + DY * DY * a
        vz = -DY
        nxd = sintheta * (cosphi * ux + sinphi * vx) + costheta * DX
        nyd = sintheta * (cosphi * uy + sinphi * vy) + costheta * DY
        nzd = sintheta * (cosphi * uz + sinphi * vz) + costheta * DZ
        inv_n = jax.lax.rsqrt(jnp.maximum(
            nxd * nxd + nyd * nyd + nzd * nzd, tiny))
        scat = alive & jnp.logical_not(fresh)
        DX = jnp.where(scat, nxd * inv_n, DX)
        DY = jnp.where(scat, nyd * inv_n, DY)
        DZ = jnp.where(scat, nzd * inv_n, DZ)
        nscatt = jnp.where(scat, nscatt + 1, nscatt)

        outs = [X, Y, Z, DX, DY, DZ, alive.astype(jnp.int32), nscatt,
                jnp.where(alive[None], Ln, 0.0),
                jnp.where(alive[None], Lp, 0.0)]
        if want_labs:
            outs += list(dep)
        outs += Ips + coss
        if refill:
            outs += [bcount, fresh.astype(jnp.int32)]
        return tuple(outs)

    return body, n_uniform, oc_np, [float(k) for k in kextm_w], \
        [float(g) for g in g_w]


def make_fused_poly_lifecycle(grid, dust_system, stellar_system,
                              instruments, options, nlambda: int,
                              launch_fn=None, emission_peeloff: bool = True,
                              scattering_peeloff: bool = True,
                              is_dust_emission=False, mueller=None,
                              io_state: bool = False,
                              max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) — polychromatic analytic.

    Contract: `L0` must be (N, nlambda) per-lane launch luminosities;
    `ell` is ignored.  A dispatch covers N * refill_batches * nlambda
    packets.  Labs bins are cell * nlambda + w.
    """
    ds = dust_system
    W = int(nlambda)
    _validate(grid, ds, stellar_system, instruments, options, W,
              mueller, io_state, launch_fn)

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    nlead = len(leaders)
    refill = options.refill_batches > 1
    # in-body relaunch for the stellar (closed-form sampler) launch;
    # relaunch between events, outside the body, for launch_fn lanes
    # (dust-emission phases sample per-cycle alias tables)
    refill_kernel = refill and launch_fn is None
    refill_xla = refill and launch_fn is not None
    K = int(options.refill_batches) if refill else 1
    sampler = (stellar_system.components[0].geometry.device_sampler_xyz()
               if refill_kernel else None)

    body, n_uniform, oc_np, kextm_w, g_w = _build_kernel(
        grid, ds, leaders, npanels, np_peel, options, W, want_labs,
        scattering_peeloff, sampler)
    oc_col = tuple(c[:, None] for c in oc_np)
    require_supported_platform()

    def call_kernel(us, Lw, l0w, state):
        lanes = {"u": us, "L": Lw, "l0": l0w, "s": tuple(state[:8])}
        if refill_kernel:
            lanes["bc"] = state[8]
        return body(tuple(jnp.asarray(c) for c in oc_col), lanes)

    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K

    def run_batch(key, ell, L0, tallies, launch_ctx=None):
        del ell
        if L0.ndim != 2 or L0.shape[1] != W:
            raise ValueError("polychromatic run_batch needs L0 of shape "
                             f"(N, {W})")
        n = L0.shape[0]
        k_launch, k_cycle = jax.random.split(rng.event_key(key, 1))

        ell0 = jnp.zeros(n, jnp.int32)
        if launch_fn is not None:
            # dust-emission launch (ref: dodustemissionchunk): the lane's
            # wavelength vector carries the launch cell's spectrum
            pos, direction, L = launch_fn(k_launch, ell0, L0, launch_ctx)
        else:
            pos, direction, _, _ = stellar_system.launch(
                k_launch, ell0, jnp.ones(n, jnp.float32))
            L = L0.T
        alive = jnp.any(L > 0, axis=0)
        dust_flags = jnp.full(n, bool(is_dust_emission))
        wls = np.arange(W, dtype=np.int32)
        kext_col = jnp.asarray(np.asarray(kextm_w, np.float32))[:, None]
        g_col = np.asarray(g_w, np.float32)[:, None]

        labs = tallies.get("labs")
        l0_w = L0.T

        kext_t_col = jnp.asarray(
            np.asarray(ds.kappaext, np.float32)[0, :W])[:, None]

        def detect_emission(ins_list, pos_p, Lw, ns_p):
            # emission peel: XLA quadrature toward each leader once;
            # Lw is (W, N), one vectorized detect per instrument
            from . import vector_traversal as vt
            tags = {"nscatt": ns_p, "is_dust": dust_flags}
            Ipe = []
            for kvec in leaders:
                kobs = jnp.broadcast_to(
                    jnp.asarray(np.asarray(kvec, np.float32)), pos_p.shape)
                dsg, _, midp = vt.panel_paths(grid, pos_p, kobs, np_peel)
                ones = [jnp.ones(n, jnp.float32)]
                # with unit weights analytic_rows returns the kg/m^3
                # density rows -> tau_w = kappaext_w * integral
                rows = ds.analytic_rows(pos_p, kobs, midp, None, ones,
                                        want_sca=False)
                Ipe.append(jnp.sum(rows * dsg, axis=1))
            out = list(ins_list)
            for i, ins in enumerate(instruments):
                ext = Lw * jnp.exp(-kext_t_col * Ipe[lead_of[i]][None])
                out[i] = ins.detect_poly(out[i], pos_p, wls, ext,
                                         dict(tags, transparent=Lw))
            return out

        ins0 = tallies["instruments"]
        if emission_peeloff:
            ins0 = detect_emission(list(ins0), pos,
                                   jnp.where(alive[None], L, 0.0),
                                   jnp.zeros(n, jnp.int32))

        state0 = {"pos": pos, "dir": direction, "L": L, "alive": alive,
                  "ns": jnp.zeros(n, jnp.int32)}
        if refill:
            state0["bc"] = jnp.ones(n, jnp.int32)
        carry = {"it": jnp.int32(0), "s": state0, "ins": ins0,
                 "labs": labs if labs is not None
                 else jnp.zeros((1,), jnp.float32)}

        def body(st):
            s = st["s"]
            kit = rng.event_key(k_cycle, st["it"])
            u = jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                            jnp.float32),
                         1e-7, 1.0 - 1e-7)
            state = (s["pos"][:, 0], s["pos"][:, 1], s["pos"][:, 2],
                     s["dir"][:, 0], s["dir"][:, 1], s["dir"][:, 2],
                     s["alive"].astype(jnp.int32), s["ns"])
            if refill_kernel:
                state = state + (s["bc"],)
            outs = call_kernel(list(u), s["L"], l0_w, state)

            pos_new = jnp.stack(outs[0:3], axis=-1)
            dir_new = jnp.stack(outs[3:6], axis=-1)
            alive_new = outs[6] != 0
            ns_new = outs[7]
            Ln = outs[8]
            Lp = outs[9]
            k = 10
            labs_c = st["labs"]
            if want_labs:
                labs_c = binned_add(labs_c, outs[k], outs[k + 1])
                k += 2
            Ips = outs[k:k + nlead]
            coss = outs[k + nlead:k + 2 * nlead]
            k += 2 * nlead
            fresh = None
            bc = None
            if refill_kernel:
                bc = outs[k]
                fresh = outs[k + 1] != 0
            elif refill_xla:
                # relaunch exhausted lanes between events: the
                # launch_fn samples host-built alias tables the in-body
                # relauncher cannot reproduce
                bc = s["bc"]
                eligible = jnp.logical_not(alive_new) & (bc < K)
                kre = rng.event_key(k_cycle, st["it"], 7)
                pos_l, dir_l, L_l = launch_fn(kre, ell0, L0, launch_ctx)
                pos_new = jnp.where(eligible[:, None], pos_l, pos_new)
                dir_new = jnp.where(eligible[:, None], dir_l, dir_new)
                Ln = jnp.where(eligible[None], L_l, Ln)
                ns_new = jnp.where(eligible, 0, ns_new)
                bc = bc + eligible.astype(jnp.int32)
                fresh = eligible
                alive_new = alive_new | eligible

            s_new = {"pos": pos_new, "dir": dir_new, "L": Ln,
                     "alive": alive_new, "ns": ns_new}
            if bc is not None:
                s_new["bc"] = bc

            ins = list(st["ins"])
            if scattering_peeloff:
                tags2 = {"nscatt": ns_new, "is_dust": dust_flags}
                for i, ins_obj in enumerate(instruments):
                    Ii = Ips[lead_of[i]]
                    cosj = coss[lead_of[i]]
                    # HG phase weights for all wavelengths at once
                    tq = 1.0 + g_col * g_col - 2.0 * g_col * cosj[None]
                    pw = ((1.0 - g_col) * (1.0 + g_col)
                          / jnp.sqrt(tq * tq * tq))
                    cw = Lp * pw
                    if refill_kernel:
                        # in-body relaunch happens BEFORE the peel
                        # quadrature, so Ii/cosj are at the fresh position
                        cw = jnp.where(fresh[None], Ln, cw)
                    elif refill_xla:
                        # fresh lanes relaunched AFTER the body: their
                        # emission peel needs the launch position's
                        # quadrature (detect_emission below), not Ii
                        cw = jnp.where(fresh[None], 0.0, cw)
                    cw = jnp.where(alive_new[None], cw, 0.0)
                    ext = cw * jnp.exp(-kext_col * Ii[None])
                    ins[i] = ins_obj.detect_poly(
                        ins[i], pos_new, wls, ext,
                        dict(tags2, transparent=cw))
            if refill_xla and emission_peeloff:
                ins = detect_emission(ins, pos_new,
                                      jnp.where(fresh[None], Ln, 0.0),
                                      ns_new)
            return {"it": st["it"] + 1, "s": s_new, "ins": ins,
                    "labs": labs_c}

        def cond(st):
            go = jnp.any(st["s"]["alive"])
            if refill:
                go = go | jnp.any(st["s"]["bc"] < K)
            return (st["it"] < iter_cap) & go

        final = jax.lax.while_loop(cond, body, carry)
        out = dict(tallies)
        out["instruments"] = final["ins"]
        if labs is not None:
            out["labs"] = final["labs"]
        if "iterations" in tallies:
            # opt-in count of event iterations (per-iteration timing)
            out["iterations"] = tallies["iterations"] + final["it"]
        return out

    return run_batch
