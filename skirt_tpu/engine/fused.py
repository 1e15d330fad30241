"""Fused single-event body (analytic panel quadrature), monochromatic.

ref: SKIRTcore/MonteCarloSimulation.cpp — the per-event physics chain
simulateescapeandabsorption (:438-515), simulatepropagation (:519-537),
peeloffscattering (:319-363), simulatescattering (:541-549).

The event is ONE pure function over the (N,) packet state: propagation
quadrature, absorption-deposit sampling, forced-scattering inversion,
per-instrument peel-off quadrature and the Henyey-Greenstein scatter all
run per lane, with no cross-lane work.  It runs under jit as plain XLA,
which fuses the whole elementwise graph; the tallies (XLA scatter-add)
and the per-event threefry uniforms stay outside it.

Supported configuration (the flagship fast path; anything else raises and
the caller falls back to the XLA lifecycle):
  - analytic single-component dust system (uniform albedo per wavelength),
  - uniform-spacing Cartesian grid (locate is pure arithmetic),
  - equal-panel quadrature (LifecycleOptions.quadrature_panels),
  - distant instruments (constant observer direction),
  - sampled absorption deposition, no continuous scattering, no io_state.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..ops import binned_add
from ..ops.backend import require_supported_platform
from . import vector_traversal as vt

_BIG = 3.4e38
_MAX_CHAIN_AUTO = 16   # wavelength tables are compile-time where-chains up
                       # to this nlambda (free for oligo runs); beyond it
                       # they become per-lane (N,) inputs gathered once
                       # per batch (no ceiling)


def _chain_table(ell, values):
    """Per-lane table lookup as a select chain over compile-time floats."""
    out = jnp.full(ell.shape, np.float32(values[0]), jnp.float32)
    for l in range(1, len(values)):
        out = jnp.where(ell == l, np.float32(values[l]), out)
    return out


def _expon_cutoff(u, taumax):
    """Truncated-exponential optical-depth sample (rng.expon_cutoff).

    The plain exp/log forms lose relative precision only for
    taumax ~< 1e-3, where the dedicated small branch (uniform*taumax, same
    as the reference's limit) takes over anyway."""
    tau = -jnp.log(jnp.maximum(1.0 - u * (1.0 - jnp.exp(-taumax)), 1e-37))
    return jnp.where(taumax < 1e-4, u * taumax, jnp.minimum(tau, taumax))


def _pick_wavelength(D, target, W):
    """Index of the wavelength whose prefix interval of D (over axis 0)
    holds target: the count of inclusive prefix sums <= target, clamped
    to W - 1 (covers sum(D) = 0 and rounding at the top)."""
    cumD = jnp.cumsum(D, axis=0)
    return jnp.minimum(
        jnp.sum((cumD <= target[None]).astype(jnp.int32), axis=0), W - 1)


def _axis_span(o, d, lo, hi, tn, tf, const_d):
    """Slab-test update for one axis; const_d means d is a python float."""
    if const_d:
        if abs(d) > 1e-30:
            inv = 1.0 / d
            ta = (np.float32(lo) - o) * inv
            tb = (np.float32(hi) - o) * inv
            near = jnp.minimum(ta, tb)
            far = jnp.maximum(ta, tb)
        else:
            in_slab = (o >= lo) & (o <= hi)
            near = jnp.where(in_slab, -_BIG, _BIG)
            far = jnp.where(in_slab, _BIG, -_BIG)
    else:
        moving = jnp.abs(d) > 1e-30
        inv = 1.0 / jnp.where(moving, d, 1.0)
        ta = (np.float32(lo) - o) * inv
        tb = (np.float32(hi) - o) * inv
        in_slab = (o >= lo) & (o <= hi)
        near = jnp.where(moving, jnp.minimum(ta, tb),
                         jnp.where(in_slab, -_BIG, _BIG))
        far = jnp.where(moving, jnp.maximum(ta, tb),
                        jnp.where(in_slab, _BIG, -_BIG))
    return jnp.maximum(tn, near), jnp.minimum(tf, far)


def _make_span(box):
    """Elementwise in-domain ray span (mirrors CartesianGrid.ray_span)."""
    lo = (box[0], box[1], box[2])
    hi = (box[3], box[4], box[5])

    def span(X, Y, Z, DX, DY, DZ, const_d=False):
        tn = jnp.full(X.shape, -_BIG, jnp.float32)
        tf = jnp.full(X.shape, _BIG, jnp.float32)
        for o, d, l, h in ((X, DX, lo[0], hi[0]), (Y, DY, lo[1], hi[1]),
                           (Z, DZ, lo[2], hi[2])):
            tn, tf = _axis_span(o, d, l, h, tn, tf, const_d)
        t0 = jnp.maximum(tn, 0.0)
        hit = (t0 <= tf) & (tf > 0)
        t0 = jnp.where(hit, t0, 0.0)
        return t0, jnp.where(hit, tf, t0)

    return span


def _make_locate(grid):
    """Arithmetic point location for uniform-spacing Cartesian grids."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    lo = grid._lo
    inv = (1.0 / grid._dx[0], 1.0 / grid._dx[1], 1.0 / grid._dx[2])

    def locate(X, Y, Z):
        ix = jnp.floor((X - np.float32(lo[0]))
                       * np.float32(inv[0])).astype(jnp.int32)
        iy = jnp.floor((Y - np.float32(lo[1]))
                       * np.float32(inv[1])).astype(jnp.int32)
        iz = jnp.floor((Z - np.float32(lo[2]))
                       * np.float32(inv[2])).astype(jnp.int32)
        ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
              & (iz >= 0) & (iz < nz))
        return jnp.where(ok, (ix * ny + iy) * nz + iz, -1)

    return locate


def _group_leaders(instruments):
    """Group instruments by observer direction; returns (leaders, lead_of)
    where leaders is a list of unit-direction tuples and lead_of[i] indexes
    into it (same sharing rule as lifecycle._shared_leader)."""
    groups = {}
    lead_of = []
    leaders = []
    for ins in instruments:
        key = tuple(np.round(np.asarray(ins.kobs, np.float64), 12))
        if key not in groups:
            groups[key] = len(leaders)
            leaders.append(tuple(float(v) for v in
                                 np.asarray(ins.kobs, np.float64)))
        lead_of.append(groups[key])
    return leaders, lead_of


def _validate(grid, ds, instruments, options, nlambda, mueller, io_state,
              stellar_system, launch_fn):
    def bail(msg):
        raise ValueError(f"fused lifecycle: {msg}")

    if ds is None or not getattr(ds, "analytic", False):
        bail("requires density_mode='analytic'")
    if getattr(ds, "table", False):
        bail("table (gathered) densities are not supported in the "
             "analytic body; "
             "use the XLA panel path (fused=False)")
    if mueller is not None:
        ms = (list(mueller) if isinstance(mueller, (list, tuple))
              else [mueller])
        if ds is not None and ds.ncomp != 1:
            bail("polarized fused path supports a single dust component "
                 "(multi-component polarization runs the vector path)")
        if ms[0] is None:
            bail("polarized fused path needs a Mueller table")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    if options.store_absorption:
        # deposits need an in-body (arithmetic) cell id; otherwise the
        # single-mix event is cell-independent and any analytic grid's
        # bounding-box span suffices (rho is zero outside its support)
        if not (hasattr(grid, "_uniform") and all(grid._uniform)):
            bail("absorption tallies require a uniform-spacing Cartesian "
                 "grid (in-body arithmetic locate); disable "
                 "store_absorption for other grids")
    elif not hasattr(grid, "bounding_box"):
        bail("grid must expose bounding_box()")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if options.refill_batches > 1:
        # in-body persistent-lane relaunch: needs a closed-form sampler
        if launch_fn is not None:
            bail("refill requires the stellar launch (no launch_fn)")
        if (stellar_system is None or stellar_system.ncomp != 1
                or not stellar_system.is_isotropic):
            bail("refill requires a single isotropic stellar component")
        geom = stellar_system.components[0].geometry
        if geom.device_sampler_xyz() is None:
            bail(f"refill: {type(geom).__name__} has no closed-form "
                 "device sampler (device_sampler_xyz)")


def _build_kernel(grid, ds, leaders, npanels, np_peel, options, nlambda,
                  want_labs, scattering_peeloff, sampler=None,
                  lam_inputs=False):
    H = ds.ncomp
    multi = H > 1
    geoms = [c.geometry for c in ds.components]
    lscale = ds.lscale
    invL = np.float32(1.0 / lscale)
    mL3s = [float(v) for v in np.asarray(ds._mass_over_L3).ravel()]
    # fold the mass prefactor into the extinction table: one multiply per
    # panel saved (kext_rows = kextm * density_scaled)
    kextm_t = [[float(v) * mL3s[h] for v in ds.kappaext[h]]
               for h in range(H)]
    kscam_t = [[float(v) * mL3s[h] for v in ds.kappasca[h]]
               for h in range(H)]
    alb_t = [float(s) / max(float(e), 1e-37)
             for s, e in zip(ds.kappasca[0], ds.kappaext[0])]
    g_t = [[float(v) for v in ds.g[h]] for h in range(H)]
    span = _make_span(grid.bounding_box())
    # locate is needed only for the absorption-deposit cell id: single-mix
    # physics (scatter g, phase value, albedo) is cell-independent, so
    # tally-free runs work on ANY analytic grid through the box span
    locate = _make_locate(grid) if want_labs else None
    xi = float(options.scatt_bias)
    min_scatt = int(options.min_scatt_events)
    inv_np = np.float32(1.0 / npanels)
    inv_pp = np.float32(1.0 / np_peel)
    inv_minred = np.float32(1.0 / options.min_weight_reduction)
    refill = sampler is not None
    K = int(options.refill_batches) if refill else 1
    nu_pos, pos_fn = sampler if refill else (0, None)
    u_comp = 5 + (nu_pos + 2 if refill else 0)   # mix-selection slot

    def rho_s(h, X, Y, Z):
        # density_scaled units (rho * L^3); the mass/L^3 factor lives in
        # kextm_t.  ref: DustSystem.analytic_rows
        return geoms[h].density_scaled_xyz(X * invL, Y * invL, Z * invL,
                                           lscale)

    nlead = len(leaders)

    def body(lanes):
        """One event for a block of lanes: pure function over arrays."""
        us = lanes["u"]
        X, Y, Z, DX, DY, DZ, L, alive_i, nscatt, ell, L0 = lanes["s"]
        alive = alive_i != 0
        Lth = L0 * inv_minred

        def uget(i):
            return us[i]

        if lam_inputs:
            # per-lane wavelength properties gathered once per batch in
            # XLA (ell is loop-invariant: relaunched lanes keep their ell)
            # instead of select chains whose cost grows with nlambda
            lam = lanes["lam"]
            if multi:
                kextm_l = list(lam[:H])
                kscam_l = list(lam[H:2 * H])
                g_l = list(lam[2 * H:3 * H])
                g = g_l[0]
            else:
                kextm_l = [lam[0]]
                albedo = lam[1]
                g = lam[2]
        else:
            kextm_l = [_chain_table(ell, kextm_t[h]) for h in range(H)]
            if multi:
                kscam_l = [_chain_table(ell, kscam_t[h]) for h in range(H)]
                g_l = [_chain_table(ell, g_t[h]) for h in range(H)]
                g = g_l[0]
            else:
                albedo = _chain_table(ell, alb_t)
                g = _chain_table(ell, g_t[0])
        kextm = kextm_l[0]

        # -- traverse: equal-panel quadrature of the analytic density ------
        # (ref: simulateescapeandabsorption's per-segment tau accumulation;
        # the continuous-density panel form is vt.panel_paths)
        t0, t1 = span(X, Y, Z, DX, DY, DZ)
        delta = (t1 - t0) * inv_np
        cum = jnp.zeros_like(L)
        cums = []
        albs = []                      # per-panel local albedo (multi only)
        for kk in range(npanels):
            midk = t0 + np.float32(kk + 0.5) * delta
            mx, my, mz = X + midk * DX, Y + midk * DY, Z + midk * DZ
            if multi:
                dke = jnp.zeros_like(L)
                dks = jnp.zeros_like(L)
                for h in range(H):
                    rho = rho_s(h, mx, my, mz)
                    dke = dke + kextm_l[h] * rho
                    dks = dks + kscam_l[h] * rho
                albs.append(jnp.where(dke > 0,
                                      dks / jnp.maximum(dke, 1e-37), 0.0))
                cum = cum + dke * delta
            else:
                rho = rho_s(0, mx, my, mz)
                cum = cum + kextm * rho * delta
            cums.append(cum)
        taupath = cum
        one_m_e = 1.0 - jnp.exp(-taupath)
        Lm = jnp.where(alive, L, 0.0)

        if multi:
            # per-panel absorbed/scattered split: the local albedo varies
            # along the path (ref: lifecycle.py multi-component branch —
            # Lsca = sum_k albedo_k * e^{-tau_{k-1}}(1-e^{-dtau_k}) L)
            e_prev = jnp.ones_like(L)
            Lsca_f = jnp.zeros_like(L)
            cab = jnp.zeros_like(L)
            cumabs = []
            for kk in range(npanels):
                e_k = jnp.exp(-cums[kk])
                seg = e_prev - e_k
                Lsca_f = Lsca_f + albs[kk] * seg
                cab = cab + (1.0 - albs[kk]) * seg
                cumabs.append(cab)
                e_prev = e_k

        # -- sampled absorption deposit (ref: the path estimator's energy,
        # deposited at one sampled segment; lifecycle.py 'sampled'
        # deposition) -----------------------------------------------------
        if want_labs:
            u_dep = uget(2)
            if multi:
                # segment ~ its absorbed energy (w_k = (1-alb_k) seg_k)
                D = cab * Lm
                target = u_dep * cab
                i_dep = jnp.zeros(X.shape, jnp.int32)
                for kk in range(npanels - 1):
                    i_dep = i_dep + (cumabs[kk] < target).astype(jnp.int32)
            else:
                D = (1.0 - albedo) * Lm * one_m_e
                tau_dep = _expon_cutoff(u_dep, taupath)
                i_dep = jnp.zeros(X.shape, jnp.int32)
                for kk in range(npanels - 1):
                    i_dep = i_dep + (cums[kk] < tau_dep).astype(jnp.int32)
            mid_dep = t0 + (i_dep.astype(jnp.float32) + 0.5) * delta
            cell = locate(X + mid_dep * DX, Y + mid_dep * DY,
                          Z + mid_dep * DZ)
            okd = (cell >= 0) & (D > 0) & alive
            dep = [jnp.where(okd, cell * nlambda + ell, -1),
                   jnp.where(okd, D, 0.0)]

        # -- scattered-luminosity update + termination ---------------------
        # (ref: dostellaremissionchunk :284-293)
        if multi:
            L = jnp.where(alive, Lsca_f * Lm, L)
        else:
            L = jnp.where(alive, albedo * Lm * one_m_e, L)
        alive = alive & (L > 0) & jnp.logical_not(
            (L <= Lth) & (nscatt >= min_scatt)) & (taupath > 0)

        # -- forced propagation (ref: simulatepropagation) -----------------
        u1 = uget(0)
        u2 = uget(1)
        tau_exp = _expon_cutoff(u2, taupath)
        if xi == 0.0:
            tau = tau_exp
        else:
            tau = jnp.where(u1 < xi, u2 * taupath, tau_exp)
            p = jnp.exp(-tau) / jnp.maximum(one_m_e, 1e-30)
            qq = (1.0 - xi) * p + xi / jnp.maximum(taupath, 1e-30)
            L = jnp.where(alive, L * (p / jnp.maximum(qq, 1e-37)), L)
        i_hit = jnp.zeros(X.shape, jnp.int32)
        for kk in range(npanels - 1):
            i_hit = i_hit + (cums[kk] < tau).astype(jnp.int32)
        cum_h = jnp.zeros_like(L)
        cum_prev = jnp.zeros_like(L)
        for kk in range(npanels):
            sel = i_hit == kk
            cum_h = jnp.where(sel, cums[kk], cum_h)
            if kk > 0:
                cum_prev = jnp.where(sel, cums[kk - 1], cum_prev)
        dtau_h = cum_h - cum_prev
        frac = jnp.clip(jnp.where(dtau_h > 0,
                                  (tau - cum_prev)
                                  / jnp.maximum(dtau_h, 1e-30), 0.0),
                        0.0, 1.0)
        s = t0 + (i_hit.astype(jnp.float32) + frac) * delta
        X = jnp.where(alive, X + s * DX, X)
        Y = jnp.where(alive, Y + s * DY, Y)
        Z = jnp.where(alive, Z + s * DZ, Z)

        # -- persistent-lane relaunch (refill) ------------------------------
        # Lockstep occupancy decays to ~20% as packets die; dead lanes with
        # packet budget left relaunch IN-KERNEL (closed-form sampler) and
        # get their emission peel-off from this iteration's shared peel
        # quadrature — the SPMD analog of the reference thread pool pulling
        # fresh chunks (Parallel.cpp:160).
        fresh = jnp.zeros(X.shape, bool)
        if refill:
            bcount = lanes["bc"]
            eligible = jnp.logical_not(alive) & (bcount < K)
            xs, ys, zs = pos_fn([uget(5 + j) for j in range(nu_pos)])
            ct = 2.0 * uget(5 + nu_pos) - 1.0
            st_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
            ph2 = np.float32(2.0 * np.pi) * uget(6 + nu_pos)
            X = jnp.where(eligible, xs, X)
            Y = jnp.where(eligible, ys, Y)
            Z = jnp.where(eligible, zs, Z)
            DX = jnp.where(eligible, st_ * jnp.cos(ph2), DX)
            DY = jnp.where(eligible, st_ * jnp.sin(ph2), DY)
            DZ = jnp.where(eligible, ct, DZ)
            L = jnp.where(eligible, L0, L)
            nscatt = jnp.where(eligible, 0, nscatt)
            bcount = bcount + eligible.astype(jnp.int32)
            fresh = eligible
            alive = alive | eligible

        # -- local mixture at the interaction point (multi-component) ------
        # (ref: DustSystem::randomMixForPosition — component h selected
        # with probability ~ kappasca_h * rho_h; DustSystem::phase_value —
        # the peel phase is the kappasca*rho-weighted blend)
        if multi:
            w_h = [kscam_l[h] * rho_s(h, X, Y, Z) for h in range(H)]
            w_tot = w_h[0]
            for h in range(1, H):
                w_tot = w_tot + w_h[h]
            u_c = uget(u_comp) * jnp.maximum(w_tot, 1e-37)
            g = g_l[0]
            w_acc = w_h[0]
            for h in range(1, H):
                g = jnp.where(u_c > w_acc, g_l[h], g)
                w_acc = w_acc + w_h[h]

        # -- peel-off extinction toward each observer direction ------------
        # (ref: peeloffscattering; tau by the same panel quadrature along
        # the constant kobs — lifecycle.vector_taus)
        taus, coss, phs = [], [], []
        for j, (kx, ky, kz) in enumerate(leaders):
            if not scattering_peeloff:
                coss.append(jnp.zeros_like(L))
                taus.append(jnp.zeros_like(L))
                phs.append(jnp.zeros_like(L))
                continue
            cosj = (DX * np.float32(kx) + DY * np.float32(ky)
                    + DZ * np.float32(kz))
            coss.append(cosj)
            if multi:
                ph = jnp.zeros_like(L)
                for h in range(H):
                    gh = g_l[h]
                    t_ = 1.0 + gh * gh - 2.0 * gh * cosj
                    ph = ph + w_h[h] * ((1.0 - gh) * (1.0 + gh)
                                        * jax.lax.rsqrt(t_ * t_ * t_))
                phs.append(jnp.where(w_tot > 0,
                                     ph / jnp.maximum(w_tot, 1e-30), 0.0))
            pt0, pt1 = span(X, Y, Z, kx, ky, kz, const_d=True)
            pd = (pt1 - pt0) * inv_pp
            rsum = jnp.zeros_like(L)
            for kk in range(np_peel):
                mx = X + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(kx)
                my = Y + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(ky)
                mz = Z + (pt0 + np.float32(kk + 0.5) * pd) * np.float32(kz)
                if multi:
                    for h in range(H):
                        rsum = rsum + kextm_l[h] * rho_s(h, mx, my, mz)
                else:
                    rsum = rsum + rho_s(0, mx, my, mz)
            taus.append((rsum if multi else kextm * rsum) * pd)

        # -- Henyey-Greenstein scatter (ref: simulatescattering +
        # Random::direction(bfk, costheta)) --------------------------------
        u_g = uget(3)
        u_phi = uget(4)
        f = (1.0 - g) * (1.0 + g) / (1.0 - g + 2.0 * g * u_g)
        small_g = jnp.abs(g) < 1e-6
        cos_hg = (1.0 + g * g - f * f) / (2.0 * jnp.where(small_g, 1.0, g))
        costheta = jnp.where(small_g, 2.0 * u_g - 1.0,
                             jnp.clip(cos_hg, -1.0, 1.0))
        phi = np.float32(2.0 * np.pi) * u_phi
        sintheta = jnp.sqrt(jnp.maximum(0.0, 1.0 - costheta * costheta))
        cosphi = jnp.cos(phi)
        sinphi = jnp.sin(phi)
        # branchless Frisvad frame about the old direction (rng.py)
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
            nxd * nxd + nyd * nyd + nzd * nzd, 1e-30))
        scat = alive & jnp.logical_not(fresh)   # fresh lanes keep launch dir
        DX = jnp.where(scat, nxd * inv_n, DX)
        DY = jnp.where(scat, nyd * inv_n, DY)
        DZ = jnp.where(scat, nzd * inv_n, DZ)
        nscatt = jnp.where(scat, nscatt + 1, nscatt)

        outs = [X, Y, Z, DX, DY, DZ, L, alive.astype(jnp.int32), nscatt]
        if want_labs:
            outs += dep
        outs += taus + coss
        if multi:
            # blended peel phase weights (ref: DustSystem::phase_value)
            outs += phs
        if refill:
            outs += [bcount, fresh.astype(jnp.int32)]
        return tuple(outs)

    return body


def make_fused_lifecycle(grid, dust_system, stellar_system, instruments,
                         options, nlambda: int, launch_fn=None,
                         emission_peeloff: bool = True,
                         scattering_peeloff: bool = True,
                         is_dust_emission=False, mueller=None,
                         io_state: bool = False,
                         max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies[, launch_ctx]) -> tallies with
    the whole scattering event fused into one per-lane event body.

    Same contract as lifecycle.make_lifecycle; raises ValueError for
    configurations outside the fused fast path (see module docstring).
    """
    ds = dust_system
    _validate(grid, ds, instruments, options, nlambda, mueller, io_state,
              stellar_system, launch_fn)
    from .lifecycle import make_peel_off

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    sampler = (stellar_system.components[0].geometry.device_sampler_xyz()
               if refill else None)
    multi = ds.ncomp > 1
    n_uniform = 5 + (sampler[0] + 2 if refill else 0) + (1 if multi else 0)
    # per-lane lambda properties: below the threshold the compile-time
    # select chains are free; beyond it they grow linearly in nlambda, so
    # the tables are gathered once per batch instead (ell is loop-invariant
    # even under refill) — this removed the old 64-wavelength ceiling
    lam_inputs = nlambda > _MAX_CHAIN_AUTO
    body = _build_kernel(grid, ds, leaders, npanels, np_peel, options,
                         nlambda, want_labs, scattering_peeloff,
                         sampler=sampler, lam_inputs=lam_inputs)
    require_supported_platform()
    peels = [make_peel_off(grid, ds, ins) for ins in instruments]
    mix = ds.components[0].mix
    nlead = len(leaders)
    # polarized mode: the kernel is UNCHANGED — its per-leader (cos, tau)
    # outputs feed an XLA-side Mueller peel, and the scattering direction
    # it wrote is overridden by the XLA-side Mueller sample (the Stokes
    # ratios + reference normal ride as XLA loop state).  The kernel's
    # expensive part (3 x panels analytic density evaluations per event)
    # is shared; the Mueller table lookups are (lambda, theta) gathers
    # that stay XLA-side like every other gather in this engine.
    # ref: DustMix.cpp:584-620 scatteringDirectionAndPolarization +
    # peeloffscattering's polarized branch (lifecycle.py mirrors it).
    mt0 = (mueller[0] if isinstance(mueller, (list, tuple)) else mueller)
    pol_mode = mt0 is not None
    if pol_mode:
        from ..media import polarization as pol
    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K
    minred = float(options.min_weight_reduction)
    anisotropic = (stellar_system is not None
                   and not stellar_system.is_isotropic)

    def leader_taus(pos, kext_pk):
        """XLA panel quadrature toward each leader (launch peel-off)."""
        taus = []
        for kvec in leaders:
            kobs = jnp.broadcast_to(
                jnp.asarray(np.asarray(kvec, np.float32)), pos.shape)
            dsg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
            rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                    want_sca=False)
            taus.append(jnp.sum(rows * dsg, axis=1))
        return taus

    n_lam = (3 * ds.ncomp if multi else 3) if lam_inputs else 0
    if lam_inputs:
        mL3s = [float(v) for v in np.asarray(ds._mass_over_L3).ravel()]
        kextm_tab = jnp.asarray(np.asarray(ds.kappaext, np.float32)
                                * np.asarray(mL3s, np.float32)[:, None])
        kscam_tab = jnp.asarray(np.asarray(ds.kappasca, np.float32)
                                * np.asarray(mL3s, np.float32)[:, None])
        g_tab = jnp.asarray(np.asarray(ds.g, np.float32))
        alb_tab = jnp.asarray(
            np.asarray(ds.kappasca[0], np.float32)
            / np.maximum(np.asarray(ds.kappaext[0], np.float32), 1e-37))

    def call_kernel(us, state):
        lanes = {"u": us, "s": state[:11]}
        if lam_inputs:
            lanes["lam"] = state[11:11 + n_lam]
        if refill:
            lanes["bc"] = state[11 + n_lam]
        return body(lanes)

    def run_batch(key, ell, L0, tallies, launch_ctx=None):
        n = ell.shape[0]
        k_launch, k_cycle = jax.random.split(rng.event_key(key, 1))

        comp = None
        if launch_fn is not None:
            pos, direction, L = launch_fn(k_launch, ell, L0, launch_ctx)
        else:
            pos, direction, L, comp = stellar_system.launch(k_launch, ell,
                                                            L0)
        alive = L > 0
        _, kext_pk = ds.packet_kappas(ell)

        dust_flags = jnp.full(n, bool(is_dust_emission))
        if emission_peeloff:
            # ref: peeloffemission — same XLA path as the vector lifecycle
            taus0 = leader_taus(pos, kext_pk)
            tags = {"nscatt": jnp.zeros(n, jnp.int32), "is_dust": dust_flags}
            for i, peel in enumerate(peels):
                contribution = jnp.where(alive, L, 0.0)
                if anisotropic and comp is not None:
                    kobs = instruments[i].observer_direction(pos)
                    contribution = contribution * \
                        stellar_system.direction_probability(ell, pos, kobs,
                                                             comp)
                tallies["instruments"][i] = peel(
                    tallies["instruments"][i], pos, ell, contribution, tags,
                    tau=taus0[lead_of[i]])

        state = (pos[:, 0], pos[:, 1], pos[:, 2],
                 direction[:, 0], direction[:, 1], direction[:, 2],
                 L, alive.astype(jnp.int32), jnp.zeros(n, jnp.int32), ell,
                 L0)
        if lam_inputs:
            # loop-invariant per-lane wavelength properties (one gather
            # per batch instead of select chains)
            if multi:
                lam = tuple(kextm_tab[h, ell] for h in range(ds.ncomp)) \
                    + tuple(kscam_tab[h, ell] for h in range(ds.ncomp)) \
                    + tuple(g_tab[h, ell] for h in range(ds.ncomp))
            else:
                lam = (kextm_tab[0, ell], alb_tab[ell], g_tab[0, ell])
            state = state + lam
        if refill:
            state = state + (jnp.ones(n, jnp.int32),)   # packet budget
        labs = tallies.get("labs")

        carry = {"it": jnp.int32(0), "state": state,
                 "ins": tallies["instruments"],
                 "labs": labs if labs is not None
                 else jnp.zeros((1,), jnp.float32)}
        if pol_mode:
            # normalized Stokes ratios + reference normal (packets launch
            # unpolarized; a zero normal means "no reference yet")
            carry["stq"] = jnp.zeros(n, jnp.float32)
            carry["stu"] = jnp.zeros(n, jnp.float32)
            carry["stv"] = jnp.zeros(n, jnp.float32)
            carry["stn"] = jnp.zeros((n, 3), jnp.float32)

        def body(st):
            kit = rng.event_key(k_cycle, st["it"])
            u = jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                            jnp.float32),
                         1e-7, 1.0 - 1e-7)
            outs = call_kernel(list(u), st["state"])
            k = 9
            labs_c = st["labs"]
            if want_labs:
                labs_c = binned_add(labs_c, outs[k], outs[k + 1])
                k += 2
            taus = outs[k:k + nlead]
            coss = outs[k + nlead:k + 2 * nlead]
            k += 2 * nlead
            ows = None
            if multi:
                ows = outs[k:k + nlead]
                k += nlead
            new_state = tuple(outs[:9]) \
                + tuple(st["state"][9:11 + n_lam])
            fresh = None
            if refill:
                new_state = new_state + (outs[k],)
                fresh = outs[k + 1]

            pol_upd = {}
            if pol_mode:
                # ---- XLA-side Mueller scatter + polarized peel ----------
                # pre-event state (the peel uses the PRE-scatter Stokes
                # and direction, exactly like the vector path)
                dir_old = jnp.stack(st["state"][3:6], axis=-1)
                alive_new = outs[7] != 0
                fresh_f = (fresh != 0 if fresh is not None
                           else jnp.zeros(n, bool))
                q0, u0, v0 = st["stq"], st["stu"], st["stv"]
                nrm0_raw = st["stn"]
                pdeg = jnp.sqrt(q0 ** 2 + u0 ** 2)
                pang = 0.5 * jnp.arctan2(u0, q0)
                kpol = rng.event_key(k_cycle, st["it"], 13)
                have_n = jnp.linalg.norm(nrm0_raw, axis=-1) > 1e-6
                default_n = rng.isotropic_direction(
                    jax.random.fold_in(kpol, 2), (n,))
                default_n = default_n - dir_old * jnp.sum(
                    default_n * dir_old, axis=-1, keepdims=True)
                default_n = default_n / jnp.maximum(
                    jnp.linalg.norm(default_n, axis=-1, keepdims=True),
                    1e-30)
                nrm0 = jnp.where(have_n[:, None], nrm0_raw, default_n)

                # scatter (ref: scatteringDirectionAndPolarization)
                theta_s = mt0.sample_theta(jax.random.fold_in(kpol, 0),
                                           ell)
                phi_s = mt0.sample_phi(jax.random.fold_in(kpol, 1), ell,
                                       theta_s, pdeg, pang)
                qr_s, ur_s = pol.rotate_stokes(q0, u0, phi_s)
                nrm_s = pol.rotate_normal(nrm0, dir_old, phi_s)
                S11, S12, S33, S34 = mt0.lookup(ell, theta_s)
                _, qn, un, vn = pol.apply_mueller(qr_s, ur_s, v0,
                                                  S11, S12, S33, S34)
                nd = (dir_old * jnp.cos(theta_s)[:, None]
                      + jnp.cross(nrm_s, dir_old)
                      * jnp.sin(theta_s)[:, None])
                nd = nd / jnp.maximum(
                    jnp.linalg.norm(nd, axis=-1, keepdims=True), 1e-30)
                scat = alive_new & jnp.logical_not(fresh_f)
                dir_out = jnp.stack(outs[3:6], axis=-1)
                dir_fin = jnp.where(scat[:, None], nd, dir_out)
                # the overridden direction goes back into the lane state
                ns_list = list(new_state)
                ns_list[3:6] = [dir_fin[:, 0], dir_fin[:, 1], dir_fin[:, 2]]
                new_state = tuple(ns_list)
                pol_upd = {
                    "stq": jnp.where(scat, qn,
                                     jnp.where(fresh_f, 0.0, q0)),
                    "stu": jnp.where(scat, un,
                                     jnp.where(fresh_f, 0.0, u0)),
                    "stv": jnp.where(scat, vn,
                                     jnp.where(fresh_f, 0.0, v0)),
                    "stn": jnp.where(scat[:, None], nrm_s,
                                     jnp.where(fresh_f[:, None], 0.0,
                                               nrm0_raw)),
                }

            ins = list(st["ins"])
            if scattering_peeloff:
                pos_new = jnp.stack(outs[0:3], axis=-1)
                L_new = outs[6]
                alive_new = outs[7] != 0
                ns_new = outs[8]
                tags = {"nscatt": ns_new, "is_dust": dust_flags}
                pol_lead = {}
                if pol_mode:
                    # per-LEADER Mueller peel, shared by every instrument
                    # with that observer direction (ref:
                    # peeloffscattering's polarized branch)
                    for j in sorted(set(lead_of)):
                        cosa = coss[j]
                        theta_p = jnp.arccos(jnp.clip(cosa, -1.0, 1.0))
                        kobs = jnp.broadcast_to(jnp.asarray(
                            np.asarray(leaders[j], np.float32)),
                            (n, 3))
                        phi_p = pol.angle_between_planes(nrm0, dir_old,
                                                         kobs)
                        qr_p, ur_p = pol.rotate_stokes(q0, u0, phi_p)
                        S11p, S12p, S33p, S34p = mt0.lookup(ell, theta_p)
                        w = jnp.asarray(mt0.pfnorm)[ell] * (
                            S11p + pdeg * S12p
                            * jnp.cos(2.0 * (phi_p - pang)))
                        _, qh, uh, vh = pol.apply_mueller(
                            qr_p, ur_p, v0, S11p, S12p, S33p, S34p)
                        nrm_i = jnp.cross(dir_old, kobs)
                        nn_i = jnp.linalg.norm(nrm_i, axis=-1,
                                               keepdims=True)
                        nrm_i = jnp.where(nn_i > 1e-20,
                                          nrm_i / jnp.maximum(nn_i, 1e-30),
                                          nrm0)
                        pol_lead[j] = (w, qh, uh, vh, nrm_i, kobs)
                for i, peel in enumerate(peels):
                    tg = tags
                    if pol_mode:
                        w, qh, uh, vh, nrm_i, kobs = pol_lead[lead_of[i]]
                        # rotate into THIS instrument's frame
                        ky = (jnp.broadcast_to(
                            jnp.asarray(instruments[i].ky, jnp.float32),
                            (n, 3))
                            if hasattr(instruments[i], "ky") else nrm_i)
                        cosal = jnp.sum(nrm_i * ky, axis=-1)
                        sinal = jnp.sum(jnp.cross(nrm_i, ky) * kobs,
                                        axis=-1)
                        alpha = jnp.arctan2(sinal, cosal)
                        q3, u3 = pol.rotate_stokes(qh, uh, alpha)
                        v3 = vh
                        if fresh is not None:
                            w = jnp.where(fresh_f, 1.0, w)
                            q3 = jnp.where(fresh_f, 0.0, q3)
                            u3 = jnp.where(fresh_f, 0.0, u3)
                            v3 = jnp.where(fresh_f, 0.0, v3)
                        tg = dict(tags, stokes=(q3, u3, v3))
                    elif multi:
                        # blended in the body (DustSystem.phase_value form)
                        w = ows[lead_of[i]]
                    else:
                        w = mix.phase_function(ell, coss[lead_of[i]])
                    if fresh is not None and not pol_mode:
                        # relaunched lanes: emission peel-off (isotropic —
                        # unit direction weight), same quadrature
                        w = jnp.where(fresh != 0, 1.0, w)
                    ins[i] = peel(ins[i], pos_new, ell,
                                  jnp.where(alive_new, L_new * w, 0.0), tg,
                                  tau=taus[lead_of[i]])

            out_c = {"it": st["it"] + 1, "state": new_state,
                     "ins": ins, "labs": labs_c}
            if pol_mode:
                out_c.update(pol_upd)
            return out_c

        def cond(st):
            go = jnp.any(st["state"][7] != 0)
            if refill:
                go = go | jnp.any(st["state"][11 + n_lam] < K)
            return (st["it"] < iter_cap) & go

        final = jax.lax.while_loop(cond, body, carry)
        out = dict(tallies)
        out["instruments"] = final["ins"]
        if labs is not None:
            out["labs"] = final["labs"]
        return out

    return run_batch
