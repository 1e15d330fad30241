"""Polychromatic fused table-mode lifecycle: W wavelengths per lane.

The table path is gather-bound (~8.6 ns/descriptor on the serial gather
unit, BASELINE.md roofline): the (N, P) rho panel gathers and the exact
peel column-DDA rows are the per-event cost — and BOTH are
lambda-independent.  So in this mode each lane carries the FULL oligo
wavelength vector: one geometric path serves W wavelengths and the
descriptor budget per photon packet divides by W.

Estimator (unbiased defensive-mixture importance sampling):

 - The interaction point s and the scattering angle are sampled from the
   uniform-mixture proposal q(s, cos) = (1/W) sum_c q_c(s) HG_c(cos),
   where q_c is wavelength c's composite-biased forced-scattering pdf
   (the same xi-mixture as the monochromatic kernel) and HG_c its
   Henyey-Greenstein phase function: draw a driver wavelength c
   uniformly, then sample both from that wavelength's distributions.
 - Every per-wavelength pdf shares the same rho(s) factor, so the
   importance ratios are pure arithmetic in the lambda-independent
   cumulative column density I(s) = int rho ds — no extra gathers:
       F_w(I) = kext_w e^{-kext_w I} / (1 - e^{-tau_w})
       Q_w(I) = (1-xi) F_w(I) + xi kext_w / tau_w
   peel luminosity   L^peel_w = L_w albedo_w (1-e^{-tau_w})
                                * F_w / ((1/W) sum_c Q_c)
   onward luminosity L^next_w = L_w albedo_w (1-e^{-tau_w})
                                * F_w HG_w / ((1/W) sum_c Q_c HG_c)
   The peel weight uses the s-marginal of the proposal; the outgoing leg
   carries the joint weight.  Both are defensive-mixture ratios bounded
   by W — no weight blow-up, unlike naive path reweighting.
 - The peel-off for ALL wavelengths shares ONE exact column-DDA
   rho-integral per leader direction; per-wavelength extinction is
   exp(-kext_w I_peel).
 - Absorption deposits sample ONE wavelength per event with probability
   D_w / sum(D) and deposit sum(D) at that wavelength's bin (unbiased;
   one deposit stream regardless of W).

ref: SKIRTcore/MonteCarloSimulation.cpp:438-549 — the same event chain
(simulateescapeandabsorption / simulatepropagation / peeloffscattering /
simulatescattering) as engine/fused_table.py; the polychromatic packet
is a estimator redesign with no reference counterpart (the
reference is strictly monochromatic per packet).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..ops import binned_add
from ..ops.backend import require_supported_platform
from . import vector_traversal as vt
from .fused import _expon_cutoff, _group_leaders, _pick_wavelength
from .fused_table import make_exact_peel


def _validate(grid, ds, stellar_system, instruments, options, nlambda,
              mueller, io_state, launch_fn, is_dust_emission):
    def bail(msg):
        raise ValueError(f"polychromatic table lifecycle: {msg}")

    if ds is None or not getattr(ds, "table", False):
        bail("requires density_mode='table' (voxelized().as_table())")
    if ds.ncomp != 1 and not (hasattr(grid, "_uniform")
                              and all(grid._uniform)):
        bail("multi-component mode needs the uniform Cartesian voxel "
             "view (per-component raw rows + in-body blending)")
    if mueller is not None:
        mt = (mueller[0] if isinstance(mueller, (list, tuple))
              else mueller)
        if mt is not None and ds.ncomp != 1:
            bail("polarization supports a single dust component")
        if mt is not None and launch_fn is not None:
            bail("polarization with launch_fn (dust phases) not "
                 "supported (dust re-emission launches unpolarized; "
                 "use the monochromatic kernel)")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    if nlambda > 128:
        bail("nlambda <= 128 (the widest lane vector validated; split "
             "wider grids into blocks of <= 128 wavelengths)")
    if launch_fn is not None:
        # dust-emission phases: the lane's wavelength vector carries the
        # launch cell's emission spectrum (poly launch_fn contract:
        # (key, ell0, L0 (N, W), ctx) -> (pos, dir, L (W, N)))
        if not is_dust_emission:
            bail("launch_fn requires isotropic emission (dust phases)")
    elif stellar_system.ncomp != 1:
        bail("requires a single stellar component (multi-component "
             "selection is wavelength-biased, which a polychromatic "
             "lane cannot carry)")
    if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
        bail("requires a grid with ray_span + locate_batched (uniform "
             "Cartesian voxel view, or a direct-table grid such as the "
             "exact Voronoi tessellation)")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")


def _build_kernel(grid, options, W, npanels, want_labs, arith_locate=True,
                  want_pol=False):
    """The polychromatic event body (single dust mix).

    arith_locate=False (direct-table grids, e.g. the
    exact Voronoi tessellation): the deposit bin cannot be computed
    in the body, so the body emits (wavelength, value, distance) and the
    caller locates pos + mid_dep*dir with grid.locate_batched.
    """
    if arith_locate:
        nx, ny, nz = grid.nx, grid.ny, grid.nz
        lo = grid._lo
        inv = (1.0 / grid._dx[0], 1.0 / grid._dx[1], 1.0 / grid._dx[2])
    xi = float(options.scatt_bias)
    min_scatt = int(options.min_scatt_events)
    inv_minred = np.float32(1.0 / options.min_weight_reduction)
    # per-wavelength optical constants ride in as (W, 1) inputs: every
    # per-wavelength quantity is ONE (W, lanes) vector op, so nlambda
    # scales to production panchromatic widths (24-128) without unrolling
    tiny = np.float32(1e-30)

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

    def hg(g, cosa):
        t = 1.0 + g * g - 2.0 * g * cosa
        return (1.0 - g) * (1.0 + g) / jnp.sqrt(t * t * t)

    n_uniform = 7

    def body(oc, lanes):
        """One event for a block of lanes: pure function over arrays.

        oc: (kext, albedo, g), each (W, 1); lanes["r"]: per-panel raw
        rho; lanes["L"], lanes["l0"]: (W, lanes).
        """
        kext, alb, gw = oc
        us, r = lanes["u"], lanes["r"]
        X, Y, Z, DX, DY, DZ, alive_i, nscatt, t0, delta = lanes["s"]
        alive = alive_i != 0
        l0 = lanes["l0"]

        def uget(i):
            return us[i]

        # -- cumulative column density I_k (lambda-independent) -----------
        cum = jnp.zeros_like(delta)
        cums = []
        for kk in range(npanels):
            cum = cum + r[kk] * delta
            cums.append(cum)
        I_tot = cum

        wi = jax.lax.broadcasted_iota(jnp.int32, kext.shape, 0)
        tau = kext * I_tot[None]                         # (W, lanes)
        ome = 1.0 - jnp.exp(-tau)
        Lm = jnp.where(alive[None], lanes["L"], 0.0)
        dep = []

        # -- absorption deposit: one sampled wavelength per event ---------
        if want_labs:
            D = (1.0 - alb) * Lm * ome                   # (W, lanes)
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
            if arith_locate:
                cell = locate(X + mid_dep * DX, Y + mid_dep * DY,
                              Z + mid_dep * DZ)
                okd = okd & (cell >= 0)
                dep = [jnp.where(okd, cell * W + wsel, -1),
                       jnp.where(okd, Dsum, 0.0)]
            else:
                # bin = cell*W + wsel is finished XLA-side after a
                # locate_batched of pos + mid_dep*dir
                dep = [jnp.where(okd, wsel, -1),
                       jnp.where(okd, Dsum, 0.0),
                       jnp.where(okd, mid_dep, -1.0)]

        # -- scattered luminosity (absorption split) ----------------------
        Lab = alb * Lm * ome

        # -- mixture-driver forced propagation ----------------------------
        # driver wavelength c uniform in [0, W)
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
        I_s = tau_smp * kinv_cc         # I(s) at the interaction point

        # panel inversion in I space (cums are lambda-independent)
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

        # -- per-wavelength mixture ratios (arithmetic in I_s) ------------
        F = kext * jnp.exp(-kext * I_s[None]) / jnp.maximum(ome, tiny)
        if xi == 0.0:
            Q = F
        else:
            Q = ((1.0 - xi) * F
                 + np.float32(xi) * kext / jnp.maximum(tau, tiny))
        Qmix = jnp.sum(Q, axis=0) * np.float32(1.0 / W)

        # -- Henyey-Greenstein scatter with the driver's g ----------------
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

        # peel luminosity: s-marginal weight; onward: joint weight
        Lp = Lab * F / jnp.maximum(Qmix[None], tiny)
        Ln = Lab * F * HG / jnp.maximum(QHmix[None], tiny)

        # per-wavelength termination (weight-reduction cutoff,
        # ref: MonteCarloSimulation.cpp:44-50)
        past_min = nscatt >= min_scatt
        kill = (Ln <= l0 * inv_minred) & past_min[None]
        Lp = jnp.where(kill, 0.0, Lp)
        Ln = jnp.where(kill, 0.0, Ln)
        alive = alive & (jnp.max(Ln, axis=0) > 0) & (I_tot > tiny)

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
        DX = jnp.where(alive, nxd * inv_n, DX)
        DY = jnp.where(alive, nyd * inv_n, DY)
        DZ = jnp.where(alive, nzd * inv_n, DZ)
        nscatt = jnp.where(alive, nscatt + 1, nscatt)

        outs = [X, Y, Z, DX, DY, DZ, alive.astype(jnp.int32), nscatt,
                jnp.where(alive[None], Ln, 0.0),
                jnp.where(alive[None], Lp, 0.0)] + dep
        if want_pol:
            # polarized mode recomputes the per-lambda ratios XLA-side
            # from the two raw column densities (BEFORE the position
            # update: I at the interaction point + the whole-path total)
            outs += [I_s, I_tot]
        return tuple(outs)

    return body, n_uniform


def _build_kernel_multi(grid, options, W, H, npanels, want_labs):
    """Multi-component polychromatic event kernel (round 5).

    Inputs: H raw rho panel row sets (no per-lane kappa folding — the
    per-(component, wavelength) kappas ride in the oc input as 3H
    (W, 1) columns: kext, then ksca, then g).  All per-wavelength
    quantities are (W, lanes) vector ops; the
    per-panel loop keeps only running accumulators.

    Estimator: the interaction point s is drawn from the uniform-driver
    mixture over wavelengths of the composite-biased forced pdf in PATH
    LENGTH, f_c(s) = kmix_c(s) e^{-cum_c(s)} / (1 - e^{-tau_c}) with
    kmix_w(s) = sum_h kext_{h,w} rho_h(s); the scattering direction from
    the driver wavelength's component-blended HG.  Per-wavelength
    contributions are measure-consistent densities in s:

      peel    Lp_w = L_w kscamix_w(s) e^{-cum_w(s)} / Qmix(s)
      onward  Ln_w = L_w [sum_h ksca_hw rho_h(s) HG_hw(cos)]
                       e^{-cum_w(s)} / QHmix(s, cos)
      Qmix  = (1/W) sum_c [(1-xi) f_c + xi kmix_c / tau_c] (1-e^{-tau_c})
              ... expressed below as Q_w = (1-xi) F_w + xi kmix_w/tau_w
              with F_w = kmix_w e^{-cum_w}/(1-e^{-tau_w})
      QHmix = (1/W) sum_c Q_c p_c(cos),  p_c = blended phase at c

    (for a single component this reduces exactly to the single-mix
    kernel's ratios).  Deposits: a SECOND point s_dep from the driver's
    pure forced pdf estimates the per-wavelength absorbed power
    D_w = L_w kabsmix_w(s_dep) e^{-cum_w(s_dep)} / mean_c f_c(s_dep);
    one wavelength is sampled by D_w/sum(D) and sum(D) deposited at
    cell(s_dep) (unbiased, one stream).

    ref: MonteCarloSimulation.cpp:438-549 event chain +
    PanDustSystem.cpp:304-316 per-component tallies; the polychromatic
    multi-component estimator is a redesign.
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    lo = grid._lo
    inv = (1.0 / grid._dx[0], 1.0 / grid._dx[1], 1.0 / grid._dx[2])
    xi = float(options.scatt_bias)
    min_scatt = int(options.min_scatt_events)
    inv_minred = np.float32(1.0 / options.min_weight_reduction)
    tiny = np.float32(1e-30)

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

    def hg(g, cosa):
        t = 1.0 + g * g - 2.0 * g * cosa
        return (1.0 - g) * (1.0 + g) / jnp.sqrt(t * t * t)

    n_uniform = 8     # u1, u2, u_dep, u_g, u_phi, u_c, u_pick, u_comp

    def body(oc, lanes):
        """One event for a block of lanes: pure function over arrays.
        oc: 3H (W, 1) constants (kext rows, ksca rows, g rows);
        lanes["r"]: H*P raw rho panels, h-major."""
        us, r = lanes["u"], lanes["r"]
        X, Y, Z, DX, DY, DZ, alive_i, nscatt, t0, delta = lanes["s"]
        alive = alive_i != 0
        l0 = lanes["l0"]

        def uget(i):
            return us[i]

        kext_h = list(oc[:H])                                   # (W, 1)
        ksca_h = list(oc[H:2 * H])
        g_h = list(oc[2 * H:3 * H])
        wi = jax.lax.broadcasted_iota(jnp.int32, kext_h[0].shape, 0)

        Lm = jnp.where(alive[None], lanes["L"], 0.0)

        # -- driver wavelength + per-lane driver kappas -------------------
        c = jnp.minimum((uget(5) * np.float32(W)).astype(jnp.int32), W - 1)
        ohc = wi == c[None]
        kextc_h = [jnp.sum(jnp.where(ohc, kext_h[h], 0.0), axis=0)
                   for h in range(H)]                            # (lanes,)
        kscac_h = [jnp.sum(jnp.where(ohc, ksca_h[h], 0.0), axis=0)
                   for h in range(H)]

        # -- pass A: driver cums + per-component raw integrals ------------
        cumc = jnp.zeros_like(delta)
        cums_c = []
        I_h = [jnp.zeros_like(delta) for _ in range(H)]
        for kk in range(npanels):
            dk = 0.0
            for h in range(H):
                rho_hk = r[h * npanels + kk]
                dk = dk + kextc_h[h] * rho_hk
                I_h[h] = I_h[h] + rho_hk * delta
            cumc = cumc + dk * delta
            cums_c.append(cumc)
        tau_c = cumc

        # per-wavelength total optical depths (kappas constant per cell
        # row set: tau_w = sum_h kext_hw * integral rho_h)
        tau = kext_h[0] * I_h[0][None]
        for h in range(1, H):
            tau = tau + kext_h[h] * I_h[h][None]
        ome = 1.0 - jnp.exp(-tau)

        # -- interaction + deposit samples in driver-tau space ------------
        u1 = uget(0)
        u2 = uget(1)
        tau_exp = _expon_cutoff(u2, tau_c)
        if xi == 0.0:
            tau_smp = tau_exp
        else:
            tau_smp = jnp.where(u1 < xi, u2 * tau_c, tau_exp)
        tau_dep = _expon_cutoff(uget(2), tau_c)

        def invert(target):
            i_hit = jnp.zeros(X.shape, jnp.int32)
            for kk in range(npanels - 1):
                i_hit = i_hit + (cums_c[kk] < target).astype(jnp.int32)
            cum_hi = jnp.zeros_like(tau_c)
            cum_prev = jnp.zeros_like(tau_c)
            for kk in range(npanels):
                sel = i_hit == kk
                cum_hi = jnp.where(sel, cums_c[kk], cum_hi)
                if kk > 0:
                    cum_prev = jnp.where(sel, cums_c[kk - 1], cum_prev)
            dtau_hi = cum_hi - cum_prev
            frac = jnp.clip(jnp.where(dtau_hi > 0,
                                      (target - cum_prev)
                                      / jnp.maximum(dtau_hi, tiny), 0.0),
                            0.0, 1.0)
            return i_hit, frac

        ks_i, ks_f = invert(tau_smp)
        kd_i, kd_f = invert(tau_dep)
        s = t0 + (ks_i.astype(jnp.float32) + ks_f) * delta
        s_dep = t0 + (kd_i.astype(jnp.float32) + kd_f) * delta

        # -- pass B: per-wavelength prefixes + point kappas ---------------
        zW = jnp.zeros_like(Lm)
        cum_w_s = zW
        cum_w_d = zW
        kmix_s = zW          # sum_h kext_hw rho_h at the interaction panel
        kscam_s = zW
        kmix_d = zW
        kscam_d = zW
        rho_s_h = [jnp.zeros_like(delta) for _ in range(H)]
        for kk in range(npanels):
            rho_k = [r[h * npanels + kk] for h in range(H)]
            dtau_wk = kext_h[0] * rho_k[0][None]
            ksca_wk = ksca_h[0] * rho_k[0][None]
            for h in range(1, H):
                dtau_wk = dtau_wk + kext_h[h] * rho_k[h][None]
                ksca_wk = ksca_wk + ksca_h[h] * rho_k[h][None]
            m_s = jnp.where(ks_i > kk, 1.0,
                            jnp.where(ks_i == kk, ks_f, 0.0)) * delta
            m_d = jnp.where(kd_i > kk, 1.0,
                            jnp.where(kd_i == kk, kd_f, 0.0)) * delta
            cum_w_s = cum_w_s + dtau_wk * m_s[None]
            cum_w_d = cum_w_d + dtau_wk * m_d[None]
            sel_s = (ks_i == kk)
            sel_d = (kd_i == kk)
            kmix_s = jnp.where(sel_s[None], dtau_wk, kmix_s)
            kscam_s = jnp.where(sel_s[None], ksca_wk, kscam_s)
            kmix_d = jnp.where(sel_d[None], dtau_wk, kmix_d)
            kscam_d = jnp.where(sel_d[None], ksca_wk, kscam_d)
            for h in range(H):
                rho_s_h[h] = jnp.where(sel_s, rho_k[h], rho_s_h[h])

        # -- deposit: per-wavelength absorbed estimate at s_dep -----------
        dep = []
        if want_labs:
            Fd = kmix_d * jnp.exp(-cum_w_d) / jnp.maximum(ome, tiny)
            qd = jnp.sum(Fd, axis=0) * np.float32(1.0 / W)
            D = (Lm * (kmix_d - kscam_d) * jnp.exp(-cum_w_d)
                 / jnp.maximum(qd[None], tiny))
            D = jnp.where((tau_c > tiny)[None] & alive[None], D, 0.0)
            Dsum = jnp.sum(D, axis=0)
            target = uget(6) * Dsum
            wsel = _pick_wavelength(D, target, W)
            okd = (Dsum > 0) & alive
            cell = locate(X + s_dep * DX, Y + s_dep * DY, Z + s_dep * DZ)
            okd = okd & (cell >= 0)
            dep = [jnp.where(okd, cell * W + wsel, -1),
                   jnp.where(okd, Dsum, 0.0)]

        # -- per-wavelength mixture ratios at s ---------------------------
        F = kmix_s * jnp.exp(-cum_w_s) / jnp.maximum(ome, tiny)
        if xi == 0.0:
            Q = F
        else:
            Q = ((1.0 - xi) * F
                 + np.float32(xi) * kmix_s / jnp.maximum(tau, tiny))
        Qmix = jnp.sum(Q, axis=0) * np.float32(1.0 / W)

        # -- scatter: component selection at the driver wavelength --------
        wv_h = [kscac_h[h] * rho_s_h[h] for h in range(H)]
        total_wv = wv_h[0]
        for h in range(1, H):
            total_wv = total_wv + wv_h[h]
        u_comp = uget(7) * jnp.maximum(total_wv, tiny)
        gc_h = [jnp.sum(jnp.where(ohc, g_h[h], 0.0), axis=0)
                for h in range(H)]
        g_sel = gc_h[0]
        acc = wv_h[0]
        for h in range(1, H):
            g_sel = jnp.where(u_comp > acc, gc_h[h], g_sel)
            acc = acc + wv_h[h]

        u_g = uget(3)
        u_phi = uget(4)
        f = (1.0 - g_sel) * (1.0 + g_sel) \
            / (1.0 - g_sel + 2.0 * g_sel * u_g)
        small_g = jnp.abs(g_sel) < 1e-6
        cos_hg = (1.0 + g_sel * g_sel - f * f) \
            / (2.0 * jnp.where(small_g, 1.0, g_sel))
        costheta = jnp.where(small_g, 2.0 * u_g - 1.0,
                             jnp.clip(cos_hg, -1.0, 1.0))

        # blended phase numerators per wavelength at the sampled cos
        num = ksca_h[0] * rho_s_h[0][None] * hg(g_h[0], costheta[None])
        for h in range(1, H):
            num = num + ksca_h[h] * rho_s_h[h][None] \
                * hg(g_h[h], costheta[None])
        p_w = num / jnp.maximum(kscam_s, tiny)
        QHmix = jnp.sum(Q * p_w, axis=0) * np.float32(1.0 / W)

        Lp = Lm * kscam_s * jnp.exp(-cum_w_s) / jnp.maximum(Qmix[None],
                                                            tiny)
        Ln = Lm * num * jnp.exp(-cum_w_s) / jnp.maximum(QHmix[None],
                                                        tiny)

        past_min = nscatt >= min_scatt
        kill = (Ln <= l0 * inv_minred) & past_min[None]
        Lp = jnp.where(kill, 0.0, Lp)
        Ln = jnp.where(kill, 0.0, Ln)
        alive = alive & (jnp.max(Ln, axis=0) > 0) & (tau_c > tiny)

        X = jnp.where(alive, X + s * DX, X)
        Y = jnp.where(alive, Y + s * DY, Y)
        Z = jnp.where(alive, Z + s * DZ, Z)

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
        DX = jnp.where(alive, nxd * inv_n, DX)
        DY = jnp.where(alive, nyd * inv_n, DY)
        DZ = jnp.where(alive, nzd * inv_n, DZ)
        nscatt = jnp.where(alive, nscatt + 1, nscatt)

        return (X, Y, Z, DX, DY, DZ, alive.astype(jnp.int32), nscatt,
                jnp.where(alive[None], Ln, 0.0),
                jnp.where(alive[None], Lp, 0.0), *dep)

    return body, n_uniform


def make_event(grid, options, W, npanels, want_labs, oc_np,
               arith_locate=True, want_pol=False, H=1):
    """The polychromatic table event as event(us, r, Lw, l0w, state) ->
    outputs.

    oc_np: per-wavelength constants, a sequence of (W,) float32 vectors
    (kext, albedo, g for one component; kext rows, ksca rows, g rows for
    H > 1).  us / r are lists of (N,) arrays (uniforms, raw rho panels);
    Lw / l0w are (W, N); state is the tuple of (N,) lane arrays.  Shared
    by the single-device engine and the slab-sharded one
    (parallel/slab_fused.py).  Returns (event, n_uniform).
    """
    if H > 1:
        body, n_uniform = _build_kernel_multi(grid, options, W, H, npanels,
                                              want_labs)
    else:
        body, n_uniform = _build_kernel(grid, options, W, npanels,
                                        want_labs, arith_locate, want_pol)
    oc_col = tuple(np.asarray(c, np.float32)[:, None] for c in oc_np)
    require_supported_platform()

    def event(us, r, Lw, l0w, state):
        oc = tuple(jnp.asarray(c) for c in oc_col)
        lanes = {"u": us, "r": r, "L": Lw, "l0": l0w, "s": tuple(state)}
        return body(oc, lanes)

    return event, n_uniform


def make_fused_table_poly_lifecycle(grid, dust_system, stellar_system,
                                    instruments, options, nlambda: int,
                                    launch_fn=None,
                                    emission_peeloff: bool = True,
                                    scattering_peeloff: bool = True,
                                    is_dust_emission=False, mueller=None,
                                    io_state: bool = False,
                                    max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies) for polychromatic lanes.

    Contract difference from make_lifecycle: each lane carries ALL
    nlambda wavelengths.  `L0` must be (N, nlambda) per-lane launch
    luminosities (Lv[w] / total launches of the dispatch); `ell` is
    ignored (kept for signature compatibility — pass zeros).  A
    dispatch's packet count is N * refill_batches * nlambda.
    """
    ds = dust_system
    W = int(nlambda)
    _validate(grid, ds, stellar_system, instruments, options, W,
              mueller, io_state, launch_fn, is_dust_emission)

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    nlead = len(leaders)
    peel_mode = getattr(options, "table_peel", "exact")
    if peel_mode == "taumap":
        raise ValueError("polychromatic table lifecycle: table_peel="
                         "'taumap' is per-wavelength; use 'exact'")
    arith_locate = bool(hasattr(grid, "_uniform") and all(grid._uniform))
    if peel_mode == "exact" and not arith_locate:
        import warnings
        warnings.warn(
            "table_peel='exact' needs a uniform Cartesian (voxel) grid; "
            f"downgrading to 'staged' on {type(grid).__name__} — peel "
            "flux carries a panel quadrature bias (use >=32 panels)",
            stacklevel=2)
        peel_mode = "staged"
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1

    mix = ds.components[0].mix
    multi = ds.ncomp > 1
    H = ds.ncomp
    # per-(component, wavelength) constants (host floats, compiled in)
    kext_w = [float(np.asarray(ds.kappaext)[0, w]) for w in range(W)]
    albedo_w = [float(np.asarray(mix.albedo)[w]) for w in range(W)]
    g_w = [float(np.asarray(mix.g)[w]) for w in range(W)]
    kext_hw = np.asarray(ds.kappaext, np.float32)[:, :W]       # (H, W)
    ksca_hw = np.asarray(ds.kappasca, np.float32)[:, :W]
    g_hw = np.stack([np.asarray(c.mix.g, np.float32)[:W]
                     for c in ds.components])

    mt0 = (mueller[0] if isinstance(mueller, (list, tuple)) else mueller)
    pol_mode = mt0 is not None
    if pol_mode:
        from ..media import polarization as pol

    if multi:
        peel_mode = "exact"       # uniform grid guaranteed by _validate
        oc_np = list(kext_hw) + list(ksca_hw) + list(g_hw)
    else:
        oc_np = [np.asarray(v, np.float32) for v in (kext_w, albedo_w, g_w)]
    event, n_uniform = make_event(grid, options, W, npanels, want_labs,
                                  oc_np, arith_locate, want_pol=pol_mode,
                                  H=H)

    # lambda-independent peel rho-integrals: ONE column-DDA (or staged
    # quadrature) per leader serves every wavelength
    np_peel = int(options.peel_panels or npanels)
    exact_peel = (make_exact_peel(grid, ds, leaders)
                  if peel_mode == "exact" else None)

    def peel_Ih(pos):
        """Multi-component peel: per-leader (H, N) per-component RAW
        rho integrals (the per-(h, w) extinction folds XLA-side)."""
        n_p = pos.shape[0]
        per_h = []
        for h in range(H):
            unit = [jnp.ones(n_p, jnp.float32) if hh == h
                    else jnp.zeros(n_p, jnp.float32) for hh in range(H)]
            per_h.append(exact_peel(pos, unit))
        return [jnp.stack([per_h[h][li] for h in range(H)])
                for li in range(nlead)]

    def peel_I(pos):
        ones = [jnp.ones(pos.shape[:1], jnp.float32)]
        if exact_peel is not None:
            return exact_peel(pos, ones)
        out = []
        for kvec in leaders:
            kobs = jnp.broadcast_to(
                jnp.asarray(np.asarray(kvec, np.float32)), pos.shape)
            dsg, _, midp = vt.panel_paths(grid, pos, kobs, np_peel)
            rows = ds.analytic_rows(pos, kobs, midp, None, ones,
                                    want_sca=False)
            out.append(jnp.sum(rows * dsg, axis=1))
        return out

    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K
    count_events = bool(getattr(options, "count_events", False))

    def run_batch(key, ell, L0, tallies, launch_ctx=None):
        del ell
        if L0.ndim != 2 or L0.shape[1] != W:
            raise ValueError("polychromatic run_batch needs L0 of shape "
                             f"(N, {W})")
        n = L0.shape[0]
        k_launch, k_cycle = jax.random.split(rng.event_key(key, 1))

        ell0 = jnp.zeros(n, jnp.int32)
        comp0 = None
        if launch_fn is not None:
            # dust-emission launch: per-lane wavelength vector carries
            # the launch cell's emission spectrum (ref:
            # dodustemissionchunk, PanMonteCarloSimulation.cpp:269-342)
            pos, direction, L = launch_fn(k_launch, ell0, L0, launch_ctx)
        else:
            pos, direction, _, comp0 = stellar_system.launch(
                k_launch, ell0, jnp.ones(n, jnp.float32))
            L = L0.T                                 # (W, N)
        alive = jnp.any(L > 0, axis=0)
        anisotropic = (launch_fn is None
                       and not stellar_system.is_isotropic)
        if pol_mode and anisotropic:
            raise ValueError("polychromatic table lifecycle: polarized "
                             "mode with anisotropic stellar emission is "
                             "not supported")

        dust_flags = jnp.full(n, bool(is_dust_emission))
        wls = np.arange(W, dtype=np.int32)
        kext_col = jnp.asarray(np.asarray(kext_w, np.float32))[:, None]
        g_col = np.asarray(g_w, np.float32)[:, None]
        peel_fn = peel_Ih if multi else peel_I

        def peel_tau_w(Ii):
            """Per-wavelength peel optical depths from the raw
            integrals: (W, N) = kext_hw^T @ I_h for multi, kext_w * I
            for single."""
            if multi:
                return jnp.tensordot(jnp.asarray(kext_hw).T, Ii, axes=1,
                                     precision=jax.lax.Precision.HIGHEST)
            return kext_col * Ii[None]

        def detect_all(ins_list, pos_p, contrib, nscatt_p, Ipeel,
                       comp_p=None):
            # contrib (W, N); one shared I per leader, per-lambda
            # extinction + ONE vectorized detect per instrument
            tags = {"nscatt": nscatt_p, "is_dust": dust_flags}
            out = list(ins_list)
            for i, ins in enumerate(instruments):
                cwi = contrib
                if anisotropic:
                    # emission peel weight for anisotropic components
                    # (ref: PhotonPackage::launchEmissionPeelOff).  Every
                    # catalog angular distribution ignores ell — matching
                    # the reference's concrete classes — so ONE
                    # probability evaluation serves all W lanes
                    kobs = ins.observer_direction(pos_p)
                    dp = stellar_system.direction_probability(
                        ell0, pos_p, kobs, comp_p)
                    cwi = contrib * dp[None]
                ext = cwi * jnp.exp(-peel_tau_w(Ipeel[lead_of[i]]))
                out[i] = ins.detect_poly(out[i], pos_p, wls, ext,
                                         dict(tags, transparent=cwi))
            return out

        ins0 = tallies["instruments"]
        if emission_peeloff:
            Ipeel0 = peel_fn(pos)
            ins0 = detect_all(list(ins0), pos,
                              jnp.where(alive[None], L, 0.0),
                              jnp.zeros(n, jnp.int32), Ipeel0, comp0)

        labs = tallies.get("labs")
        l0_w = L0.T

        state0 = {"pos": pos, "dir": direction, "L": L, "alive": alive,
                  "ns": jnp.zeros(n, jnp.int32), "bc": jnp.ones(n, jnp.int32)}
        if pol_mode:
            # per-WAVELENGTH normalized Stokes ratios (each wavelength's
            # Mueller chain differs) + ONE shared geometric reference
            # normal (rotations are wavelength-free); packets launch
            # unpolarized, zero normal = "no reference yet"
            state0["stq"] = jnp.zeros((W, n), jnp.float32)
            state0["stu"] = jnp.zeros((W, n), jnp.float32)
            state0["stv"] = jnp.zeros((W, n), jnp.float32)
            state0["stn"] = jnp.zeros((n, 3), jnp.float32)
        carry = {"it": jnp.int32(0), "s": state0, "ins": ins0,
                 "labs": labs if labs is not None
                 else jnp.zeros((1,), jnp.float32)}
        if count_events:
            carry["nev"] = jnp.float32(0.0)

        def body(st):
            s = st["s"]
            kit = rng.event_key(k_cycle, st["it"])
            u = jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                            jnp.float32),
                         1e-7, 1.0 - 1e-7)

            # -- stage the rho panel rows (the gather-bound op) -----------
            dsg, _, midp = vt.panel_paths(grid, s["pos"], s["dir"], npanels)
            if multi:
                # per-component RAW rows: one locate + H row gathers,
                # h-major for the kernel's (H*P) layout
                pmid = s["pos"][:, None, :] \
                    + midp[..., None] * s["dir"][:, None, :]
                cells_p = grid.locate_batched(pmid)
                safe_p = jnp.clip(cells_p, 0)
                valid_p = cells_p >= 0
                r_rows = jnp.concatenate(
                    [jnp.where(valid_p, ds.rho_at(h, safe_p), 0.0)
                     for h in range(H)], axis=1)         # (N, H*P)
            else:
                ones = [jnp.ones(n, jnp.float32)]
                r_rows = ds.analytic_rows(s["pos"], s["dir"], midp, None,
                                          ones, want_sca=False)
            t0 = midp[:, 0] - 0.5 * dsg[:, 0]

            state = (s["pos"][:, 0], s["pos"][:, 1], s["pos"][:, 2],
                     s["dir"][:, 0], s["dir"][:, 1], s["dir"][:, 2],
                     s["alive"].astype(jnp.int32), s["ns"], t0, dsg[:, 0])
            outs = event(list(u), list(jnp.moveaxis(r_rows, 1, 0)),
                         s["L"], l0_w, state)

            labs_c = st["labs"]
            if want_labs and arith_locate:
                labs_c = binned_add(labs_c, outs[10], outs[11])
            elif want_labs:
                # direct-table grid: locate the sampled deposit point
                # (one locate_batched per iteration, lambda-independent)
                wsel = outs[10]
                dval = outs[11]
                mid_dep = outs[12]
                pos_dep = s["pos"] + mid_dep[:, None] * s["dir"]
                cell_dep = grid.locate_batched(pos_dep[:, None, :])[:, 0]
                okd = (mid_dep >= 0) & (wsel >= 0) & (cell_dep >= 0)
                bins = jnp.where(okd, cell_dep * W + wsel, -1)
                labs_c = binned_add(labs_c, bins,
                                    jnp.where(okd, dval, 0.0))

            pos_new = jnp.stack(outs[0:3], axis=-1)
            dir_new = jnp.stack(outs[3:6], axis=-1)
            alive_new = outs[6] != 0
            ns_new = outs[7]
            Ln = outs[8]                             # onward
            Lp = outs[9]                             # peel

            pol_ctx = None
            if pol_mode:
                # ---- XLA-side Mueller scatter + polarized reweighting
                # around the unchanged kernel.  The per-lambda mixture
                # ratios are recomputed from the kernel's raw column
                # densities; the HG-sampled direction (and its HG
                # importance weights in Ln) are REPLACED by the driver
                # wavelength's polarized phase sample and its
                # defensive-mixture weights (ref: DustMix.cpp:584-620).
                I_s = outs[-2]
                I_tot = outs[-1]
                xi_v = float(options.scatt_bias)
                alb_col = jnp.asarray(np.asarray(albedo_w,
                                                 np.float32))[:, None]
                tau_wv = kext_col * I_tot[None]                 # (W, n)
                ome_v = 1.0 - jnp.exp(-tau_wv)
                Lin = jnp.where(s["alive"][None], s["L"], 0.0)
                Lab_v = alb_col * Lin * ome_v
                F_v = kext_col * jnp.exp(-kext_col * I_s[None]) \
                    / jnp.maximum(ome_v, 1e-30)
                if xi_v == 0.0:
                    Q_v = F_v
                else:
                    Q_v = ((1.0 - xi_v) * F_v + np.float32(xi_v)
                           * kext_col / jnp.maximum(tau_wv, 1e-30))
                Qmix_v = jnp.sum(Q_v, axis=0) * np.float32(1.0 / W)

                # the kernel's driver-lambda draw, reproduced exactly
                u5 = u[5]
                c_drv = jnp.minimum((u5 * np.float32(W))
                                    .astype(jnp.int32), W - 1)
                ohc = (jnp.arange(W, dtype=jnp.int32)[:, None]
                       == c_drv[None])
                dir_old = s["dir"]
                q0, u0, v0 = s["stq"], s["stu"], s["stv"]
                nrm0_raw = s["stn"]
                pdeg_w = jnp.sqrt(q0 ** 2 + u0 ** 2)            # (W, n)
                pang_w = 0.5 * jnp.arctan2(u0, q0)
                pdeg_c = jnp.sum(jnp.where(ohc, pdeg_w, 0.0), axis=0)
                pang_c = jnp.sum(jnp.where(ohc, pang_w, 0.0), axis=0)
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

                theta_s = mt0.sample_theta(jax.random.fold_in(kpol, 0),
                                           c_drv)
                phi_s = mt0.sample_phi(jax.random.fold_in(kpol, 1),
                                       c_drv, theta_s, pdeg_c, pang_c)
                S11a, S12a, S33a, S34a = mt0.lookup_all(theta_s)
                pf_col = jnp.asarray(mt0.pfnorm)[:, None]       # (W, 1)
                wpol = pf_col * (S11a + pdeg_w * S12a
                                 * jnp.cos(2.0 * (phi_s[None] - pang_w)))
                QHpol = jnp.sum(Q_v * wpol, axis=0) * np.float32(1.0 / W)
                Lp = Lab_v * F_v / jnp.maximum(Qmix_v[None], 1e-30)
                Ln = Lab_v * F_v * wpol / jnp.maximum(QHpol[None], 1e-30)
                # per-lambda termination with the polarized weights
                # (the kernel's alive_new stays the lane-level decision)
                past_min = s["ns"] >= int(options.min_scatt_events)
                kill = (Ln <= l0_w
                        * np.float32(1.0 / options.min_weight_reduction)) \
                    & past_min[None]
                Lp = jnp.where(kill | ~alive_new[None], 0.0, Lp)
                Ln = jnp.where(kill | ~alive_new[None], 0.0, Ln)

                # Mueller-rotated Stokes + overridden direction
                qr_s, ur_s = pol.rotate_stokes(q0, u0, phi_s[None])
                nrm_s = pol.rotate_normal(nrm0, dir_old, phi_s)
                _, qn, un, vn = pol.apply_mueller(qr_s, ur_s, v0,
                                                  S11a, S12a, S33a, S34a)
                nd = (dir_old * jnp.cos(theta_s)[:, None]
                      + jnp.cross(nrm_s, dir_old)
                      * jnp.sin(theta_s)[:, None])
                nd = nd / jnp.maximum(
                    jnp.linalg.norm(nd, axis=-1, keepdims=True), 1e-30)
                dir_new = jnp.where(alive_new[:, None], nd, dir_new)
                pol_ctx = dict(q0=q0, u0=u0, v0=v0, nrm0=nrm0,
                               dir_old=dir_old, pdeg_w=pdeg_w,
                               pang_w=pang_w, pf_col=pf_col,
                               scat=alive_new, qn=qn, un=un, vn=vn,
                               nrm_s=nrm_s)

            # -- XLA-side relaunch (refill) -------------------------------
            bc = s["bc"]
            fresh = jnp.zeros(n, bool)
            comp_l = None
            if refill:
                eligible = jnp.logical_not(alive_new) & (bc < K)
                kre = rng.event_key(k_cycle, st["it"], 7)
                if launch_fn is not None:
                    pos_l, dir_l, L_l = launch_fn(kre, ell0, L0,
                                                  launch_ctx)
                else:
                    pos_l, dir_l, _, comp_l = stellar_system.launch(
                        kre, ell0, jnp.ones(n, jnp.float32))
                    L_l = L0.T
                pos_new = jnp.where(eligible[:, None], pos_l, pos_new)
                dir_new = jnp.where(eligible[:, None], dir_l, dir_new)
                Ln = jnp.where(eligible[None, :], L_l, Ln)
                ns_new = jnp.where(eligible, 0, ns_new)
                bc = bc + eligible.astype(jnp.int32)
                fresh = eligible
                alive_new = alive_new | eligible

            # -- merged peel-off: scattered lanes use the peel
            # luminosities + per-lambda phase weights; fresh lanes the
            # isotropic emission weight ----------------------------------
            ins = list(st["ins"])
            if scattering_peeloff:
                Ipeel = peel_fn(pos_new)
                tags2 = {"nscatt": ns_new, "is_dust": dust_flags}
                if multi:
                    # per-component densities at the interaction cell
                    # (one locate + H gathers, shared by all leaders)
                    cell_n = grid.locate_batched(
                        pos_new[:, None, :])[:, 0]
                    safe_n = jnp.clip(cell_n, 0)
                    rho_n_h = [jnp.where(cell_n >= 0,
                                         ds.rho_at(h, safe_n), 0.0)
                               for h in range(H)]
                for i, ins_obj in enumerate(instruments):
                    kvec = leaders[lead_of[i]]
                    cosj = (s["dir"][:, 0] * np.float32(kvec[0])
                            + s["dir"][:, 1] * np.float32(kvec[1])
                            + s["dir"][:, 2] * np.float32(kvec[2]))
                    stk = None
                    if pol_mode:
                        # polarized peel: per-lambda Mueller phase
                        # weights + Stokes rotated into THIS
                        # instrument's frame (one theta-major row gather
                        # serves every wavelength)
                        pc = pol_ctx
                        kobs = jnp.broadcast_to(jnp.asarray(
                            np.asarray(kvec, np.float32)), (n, 3))
                        theta_p = jnp.arccos(jnp.clip(cosj, -1.0, 1.0))
                        phi_p = pol.angle_between_planes(
                            pc["nrm0"], pc["dir_old"], kobs)
                        S11p, S12p, S33p, S34p = mt0.lookup_all(theta_p)
                        pw = pc["pf_col"] * (
                            S11p + pc["pdeg_w"] * S12p
                            * jnp.cos(2.0 * (phi_p[None]
                                             - pc["pang_w"])))
                        qr_p, ur_p = pol.rotate_stokes(pc["q0"],
                                                       pc["u0"],
                                                       phi_p[None])
                        _, qh, uh, vh = pol.apply_mueller(
                            qr_p, ur_p, pc["v0"],
                            S11p, S12p, S33p, S34p)
                        nrm_i = jnp.cross(pc["dir_old"], kobs)
                        nn_i = jnp.linalg.norm(nrm_i, axis=-1,
                                               keepdims=True)
                        nrm_i = jnp.where(nn_i > 1e-20,
                                          nrm_i / jnp.maximum(nn_i,
                                                              1e-30),
                                          pc["nrm0"])
                        ky = (jnp.broadcast_to(
                            jnp.asarray(ins_obj.ky, jnp.float32),
                            (n, 3))
                            if hasattr(ins_obj, "ky") else nrm_i)
                        cosal = jnp.sum(nrm_i * ky, axis=-1)
                        sinal = jnp.sum(jnp.cross(nrm_i, ky) * kobs,
                                        axis=-1)
                        alpha = jnp.arctan2(sinal, cosal)
                        q3, u3 = pol.rotate_stokes(qh, uh, alpha[None])
                        v3 = vh
                        if refill:
                            q3 = jnp.where(fresh[None], 0.0, q3)
                            u3 = jnp.where(fresh[None], 0.0, u3)
                            v3 = jnp.where(fresh[None], 0.0, v3)
                        stk = (q3, u3, v3)
                    elif multi:
                        # component-blended phase at the interaction
                        # cell, per wavelength (ref: peeloffscattering's
                        # per-component wv mix, DustMix.cpp:648-671)
                        num = 0.0
                        den = 0.0
                        for h in range(H):
                            gh = jnp.asarray(g_hw[h])[:, None]
                            tq = 1.0 + gh * gh - 2.0 * gh * cosj[None]
                            HGh = ((1.0 - gh) * (1.0 + gh)
                                   / jnp.sqrt(tq * tq * tq))
                            kr = jnp.asarray(ksca_hw[h])[:, None] \
                                * rho_n_h[h][None]
                            num = num + kr * HGh
                            den = den + kr
                        pw = num / jnp.maximum(den, 1e-30)
                    else:
                        # HG phase weights for all wavelengths at once
                        # (ref: DustMix.cpp:648-671 phaseFunctionValue)
                        tq = 1.0 + g_col * g_col - 2.0 * g_col * cosj[None]
                        pw = ((1.0 - g_col) * (1.0 + g_col)
                              / jnp.sqrt(tq * tq * tq))
                    fresh_w = Ln
                    if anisotropic and refill:
                        # fresh lanes re-emit anisotropically: one
                        # lambda-free probability call (see detect_all)
                        kobs = ins_obj.observer_direction(pos_new)
                        dp = stellar_system.direction_probability(
                            ell0, pos_new, kobs, comp_l)
                        fresh_w = Ln * dp[None]
                    cw = jnp.where(fresh[None], fresh_w, Lp * pw)
                    cw = jnp.where(alive_new[None], cw, 0.0)
                    ext = cw * jnp.exp(-peel_tau_w(Ipeel[lead_of[i]]))
                    tg2 = dict(tags2, transparent=cw)
                    if stk is not None:
                        tg2["stokes"] = stk
                    ins[i] = ins_obj.detect_poly(
                        ins[i], pos_new, wls, ext, tg2)
            elif refill and emission_peeloff:
                Ipeel = peel_fn(pos_new)
                ins = detect_all(ins, pos_new,
                                 jnp.where(fresh[None], Ln, 0.0),
                                 ns_new, Ipeel, comp_l)

            s_new = {"pos": pos_new, "dir": dir_new, "L": Ln,
                     "alive": alive_new, "ns": ns_new, "bc": bc}
            if pol_mode:
                pc = pol_ctx
                scat = pc["scat"] & jnp.logical_not(fresh)
                s_new["stq"] = jnp.where(scat[None], pc["qn"],
                                         jnp.where(fresh[None], 0.0,
                                                   pc["q0"]))
                s_new["stu"] = jnp.where(scat[None], pc["un"],
                                         jnp.where(fresh[None], 0.0,
                                                   pc["u0"]))
                s_new["stv"] = jnp.where(scat[None], pc["vn"],
                                         jnp.where(fresh[None], 0.0,
                                                   pc["v0"]))
                s_new["stn"] = jnp.where(
                    scat[:, None], pc["nrm_s"],
                    jnp.where(fresh[:, None], 0.0, s["stn"]))
            out_st = {"it": st["it"] + 1, "s": s_new, "ins": ins,
                      "labs": labs_c}
            if count_events:
                # events processed this iteration = lanes alive at entry
                out_st["nev"] = st["nev"] + jnp.sum(
                    s["alive"].astype(jnp.float32))
            return out_st

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
        if count_events:
            out["nevents"] = final["nev"] + out.get("nevents", 0.0)
        return out

    return run_batch
