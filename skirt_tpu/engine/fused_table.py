"""Fused single-event kernel for TABLE (gridded panel-quadrature) densities.

ref: SKIRTcore/MonteCarloSimulation.cpp — the same per-event chain as
engine/fused.py (simulateescapeandabsorption :438-515, simulatepropagation
:519-537, peeloffscattering :319-363, simulatescattering :541-549), but for
models WITHOUT closed-form densities: imports and clumpy decorators traced
through a uniform voxel table (DustSystem.voxelized().as_table()).

The event splits at the density lookup:

  - XLA stages the (N, P) panel-midpoint kappaext*rho rows each iteration
    (vt.panel_paths + DustSystem.analytic_rows),
  - the event body (make_event) consumes the staged panels and runs the
    rest of the event per lane: cumulative-tau profile, sampled
    absorption deposit, forced-scattering inversion, position update,
    Henyey-Greenstein scatter.  As plain XLA the row gather fuses into
    its consumers,
  - peel-off extinction uses per-leader exact column DDAs
    (make_exact_peel), or per-leader density-path maps
    (compute_rho_path_maps, table_peel='taumap'), or a P_peel-panel
    staged quadrature (table_peel='staged'),
  - relaunch (refill) runs in XLA after the event: dead lanes with
    packet budget left relaunch through the FULL stellar launch machinery
    (any source, not just closed-form samplers) and get their emission
    peel-off from the same merged peel pass.

Per-lane wavelengths are loop-invariant (relaunched lanes keep their ell),
so per-lambda optical properties (albedo, g) are gathered ONCE per batch
and passed as (N,) inputs — no select chains, no nlambda ceiling.

Supported configuration (else ValueError and the caller falls back):
  - table-mode single-component dust system (uniform albedo per lambda),
  - uniform-spacing Cartesian grid (the voxelized view),
  - distant instruments, sampled deposition, no polarization,
    no continuous scattering, no io_state.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..ops import binned_add
from ..ops.backend import require_supported_platform
from . import vector_traversal as vt
from .fused import _expon_cutoff, _group_leaders


def _validate(grid, ds, instruments, options, mueller, io_state):
    def bail(msg):
        raise ValueError(f"fused table lifecycle: {msg}")

    if ds is None or not getattr(ds, "table", False):
        bail("requires density_mode='table' (voxelized().as_table())")
    if mueller is not None and ds.ncomp > 1:
        bail("polarization supports a single dust component (the "
             "multi-component kernel moves the scatter XLA-side "
             "differently)")
    if io_state:
        bail("io_state not supported")
    if options.continuous_scattering:
        bail("continuous_scattering not supported")
    if options.store_absorption and options.deposition != "sampled":
        bail("absorption tallies require deposition='sampled'")
    if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
        bail("requires a grid with ray_span + locate_batched (uniform "
             "Cartesian voxel view, or Voronoi with device point location)")
    for ins in instruments:
        if hasattr(ins, "observer_distance") or not hasattr(ins, "kobs"):
            bail("requires distant (constant-direction) instruments")
    if options.refill_batches > 1:
        pass   # XLA-side relaunch: any stellar system works


def _build_kernel(grid, options, nlambda, npanels, want_labs, arith_locate):
    """The table event body: staged kr panels -> event physics.

    arith_locate: uniform Cartesian grids locate the deposit cell
    in the body (pure arithmetic); other grids (Voronoi direct-table mode)
    get the deposit ray parameter as an output and the caller locates it
    (one locate_batched per iteration).
    """
    if arith_locate:
        nx, ny, nz = grid.nx, grid.ny, grid.nz
        lo = grid._lo
        inv = (1.0 / grid._dx[0], 1.0 / grid._dx[1], 1.0 / grid._dx[2])
    xi = float(options.scatt_bias)
    min_scatt = int(options.min_scatt_events)
    inv_minred = np.float32(1.0 / options.min_weight_reduction)

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

    def body(lanes):
        """One event for a block of lanes: pure function over arrays."""
        us, kr = lanes["u"], lanes["kr"]
        (X, Y, Z, DX, DY, DZ, L, alive_i, nscatt, ell, L0, t0, delta,
         albedo, g) = lanes["s"]
        alive = alive_i != 0
        Lth = L0 * inv_minred

        def uget(i):
            return us[i]

        # -- cumulative-tau profile from the staged panels ----------------
        # (ref: simulateescapeandabsorption's per-segment accumulation;
        # kr panels are kappaext*rho at the panel midpoints)
        cum = jnp.zeros_like(L)
        cums = []
        for kk in range(npanels):
            cum = cum + kr[kk] * delta
            cums.append(cum)
        taupath = cum
        one_m_e = 1.0 - jnp.exp(-taupath)
        Lm = jnp.where(alive, L, 0.0)
        dep = []

        # -- sampled absorption deposit (lifecycle.py 'sampled') ----------
        if want_labs:
            u_dep = uget(2)
            D = (1.0 - albedo) * Lm * one_m_e
            tau_dep = _expon_cutoff(u_dep, taupath)
            i_dep = jnp.zeros(X.shape, jnp.int32)
            for kk in range(npanels - 1):
                i_dep = i_dep + (cums[kk] < tau_dep).astype(jnp.int32)
            mid_dep = t0 + (i_dep.astype(jnp.float32) + 0.5) * delta
            okd = (D > 0) & alive
            if arith_locate:
                cell = locate(X + mid_dep * DX, Y + mid_dep * DY,
                              Z + mid_dep * DZ)
                okd = okd & (cell >= 0)
                dep = [jnp.where(okd, cell * nlambda + ell, -1)]
            else:
                # caller locates pos + mid_dep*dir (locate_batched)
                dep = [jnp.where(okd, mid_dep, -1.0)]
            dep.append(jnp.where(okd, D, 0.0))

        # -- scattered-luminosity update + termination --------------------
        L = jnp.where(alive, albedo * Lm * one_m_e, L)
        alive = alive & (L > 0) & jnp.logical_not(
            (L <= Lth) & (nscatt >= min_scatt)) & (taupath > 0)

        # -- forced propagation (ref: simulatepropagation) ----------------
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

        # -- Henyey-Greenstein scatter (ref: simulatescattering) ----------
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
        DX = jnp.where(alive, nxd * inv_n, DX)
        DY = jnp.where(alive, nyd * inv_n, DY)
        DZ = jnp.where(alive, nzd * inv_n, DZ)
        nscatt = jnp.where(alive, nscatt + 1, nscatt)

        return (X, Y, Z, DX, DY, DZ, L, alive.astype(jnp.int32),
                nscatt, *dep)

    return body


def _build_kernel_multi(grid, options, nlambda, npanels, want_labs):
    """Multi-component event body: staged (ksca*rho, kext*rho)
    panel SUMS -> per-panel albedo blending (ref: the unfused
    non-uniform-albedo branch, lifecycle.py; PanDustSystem.cpp:304-316
    tallies per-component).

    The per-event chain through forced propagation runs in the body; the
    scattering DIRECTION (component selection by ksca_h*rho_h at the
    interaction cell + HG) and the blended peel phase weight move
    XLA-side — they need per-component densities at one cell (H small
    gathers) and are (N,)-sized elementwise work.  Outputs the
    interaction cell for those gathers.
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

    def body(lanes):
        """One event for a block of lanes: pure function over arrays.
        kr / ks: per-panel kext*rho and ksca*rho sums."""
        us, kr, ks = lanes["u"], lanes["kr"], lanes["ks"]
        (X, Y, Z, DX, DY, DZ, L, alive_i, nscatt, ell, L0, t0,
         delta) = lanes["s"]
        X0, Y0, Z0 = X, Y, Z
        alive = alive_i != 0
        Lth = L0 * inv_minred

        def uget(i):
            return us[i]

        # cumulative tau + per-panel absorbed-energy profile
        cum = jnp.zeros_like(L)
        e_prev = jnp.ones_like(L)
        cums = []
        Lm = jnp.where(alive, L, 0.0)
        Lsca = jnp.zeros_like(L)
        wdep = []                       # per-panel absorbed energy
        cw = jnp.zeros_like(L)
        cws = []
        for kk in range(npanels):
            dtau = kr[kk] * delta
            cum = cum + dtau
            cums.append(cum)
            e_cur = jnp.exp(-cum)
            dE = Lm * (e_prev - e_cur)          # energy interacting here
            alb = ks[kk] / jnp.maximum(kr[kk], tiny)
            Lsca = Lsca + alb * dE
            w = (1.0 - alb) * dE
            cw = cw + w
            cws.append(cw)
            wdep.append(w)
            e_prev = e_cur
        taupath = cum

        # -- sampled absorption deposit: panel drawn by absorbed energy --
        dep = []
        if want_labs:
            D = cw
            target = uget(2) * D
            i_dep = jnp.zeros(X.shape, jnp.int32)
            for kk in range(npanels - 1):
                i_dep = i_dep + (cws[kk] < target).astype(jnp.int32)
            mid_dep = t0 + (i_dep.astype(jnp.float32) + 0.5) * delta
            okd = (D > 0) & alive
            cell = locate(X + mid_dep * DX, Y + mid_dep * DY,
                          Z + mid_dep * DZ)
            okd = okd & (cell >= 0)
            dep = [jnp.where(okd, cell * nlambda + ell, -1),
                   jnp.where(okd, D, 0.0)]

        # -- scattered-luminosity update + termination --------------------
        L = jnp.where(alive, Lsca, L)
        alive = alive & (L > 0) & jnp.logical_not(
            (L <= Lth) & (nscatt >= min_scatt)) & (taupath > 0)

        # -- forced propagation -------------------------------------------
        one_m_e = 1.0 - jnp.exp(-taupath)
        u1 = uget(0)
        u2 = uget(1)
        tau_exp = _expon_cutoff(u2, taupath)
        if xi == 0.0:
            tau = tau_exp
        else:
            tau = jnp.where(u1 < xi, u2 * taupath, tau_exp)
            p = jnp.exp(-tau) / jnp.maximum(one_m_e, tiny)
            qq = (1.0 - xi) * p + xi / jnp.maximum(taupath, tiny)
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
                                  / jnp.maximum(dtau_h, tiny), 0.0),
                        0.0, 1.0)
        s = t0 + (i_hit.astype(jnp.float32) + frac) * delta
        X = jnp.where(alive, X + s * DX, X)
        Y = jnp.where(alive, Y + s * DY, Y)
        Z = jnp.where(alive, Z + s * DZ, Z)
        mid_h = t0 + (i_hit.astype(jnp.float32) + 0.5) * delta

        # interaction cell (hit-panel midpoint) for the XLA-side
        # component selection + blended peel
        cell_at = jnp.where(alive, locate(X0 + mid_h * DX, Y0 + mid_h * DY,
                                          Z0 + mid_h * DZ), -1)
        return (X, Y, Z, L, alive.astype(jnp.int32), cell_at, *dep)

    return body


def make_event(grid, options, nlambda, npanels, want_labs, arith_locate,
               multi):
    """The table event as event(us, kr, state[, ks]) -> outputs.
    us / kr / ks are lists of (N,) arrays (the
    uniforms and the per-panel kappa*rho sums); state is the tuple of (N,)
    lane arrays the body unpacks.  Shared by the single-device engine and
    the slab-sharded one (parallel/slab_fused.py)."""
    if multi:
        body = _build_kernel_multi(grid, options, nlambda, npanels,
                                   want_labs)
    else:
        body = _build_kernel(grid, options, nlambda, npanels, want_labs,
                             arith_locate)
    require_supported_platform()

    def event(us, kr, state, ks=None):
        lanes = {"u": us, "kr": kr, "s": tuple(state)}
        if ks is not None:
            lanes["ks"] = ks
        return body(lanes)

    return event


def make_exact_peel(grid, ds, leaders):
    """EXACT peel-off optical depths toward static leader directions.

    The leader direction is constant, so the row axis is chosen per
    leader (the dominant component): one row gather per lateral COLUMN
    the peel ray crosses returns the full 1D density profile along the
    dominant axis, and the in-column integral is exact arithmetic.  The
    static column bound Kp ~ n_perp * |k_perp| / |k_par| (typically
    ~n/2) replaces a P-panel quadrature whose tau bias multiplies the
    detected flux as e^-tau (measured 25% flux error at 8 panels,
    0.7% at 32 — experiments/accuracy_table.py); this is exact for the
    piecewise-constant voxel field at ~half the descriptors.

    ref: the reference peel-off traversal (PeelOffInstrument tau via
    DustGridPath) is exact per-crossing; this reproduces it with
    row-granular gathers.
    """
    import numpy as np

    nxyz = (grid.nx, grid.ny, grid.nz)
    lo = np.asarray(grid._lo, np.float64)
    dx = np.asarray(grid._dx, np.float64)
    hi = lo + np.asarray(nxyz) * dx
    D = float(np.linalg.norm(hi - lo))       # max in-domain ray length
    H = ds.ncomp
    rho3 = [np.asarray(ds.rho[h], np.float32).reshape(nxyz)
            for h in range(H)]

    per_leader = []
    for kvec in leaders:
        k = np.asarray(kvec, np.float64)
        a = int(np.argmax(np.abs(k)))
        b, c = [i for i in range(3) if i != a]
        # rows along axis a, indexed by (ib, ic)
        rows = [jnp.asarray(np.moveaxis(r, a, 2).reshape(-1, nxyz[a]))
                for r in rho3]
        # max in-domain ray length along k: bounded per axis, not by the
        # diagonal (an axis-dominant leader exits through that axis)
        ext = hi - lo
        Dk = min(float(ext[i] / abs(k[i])) for i in range(3)
                 if abs(k[i]) > 1e-12)
        cb = int(np.floor(Dk * abs(k[b]) / dx[b])) + 1
        cc = int(np.floor(Dk * abs(k[c]) / dx[c])) + 1
        Kp = min(cb + cc + 1, nxyz[b] + nxyz[c] + 1)
        per_leader.append((k, a, b, c, rows, Kp))

    def taus(pos, kext_pk):
        out = []
        for (k, a, b, c, rows, Kp) in per_leader:
            ka, kb, kc = float(k[a]), float(k[b]), float(k[c])
            pa = pos[:, a]
            pb = pos[:, b]
            pc = pos[:, c]
            kdir = jnp.broadcast_to(
                jnp.asarray(np.asarray(k, np.float32)), pos.shape)
            _, t_exit = grid.ray_span(pos, kdir)

            def cross_seq(p0, kk, loi, dxi, ni, count):
                # boundary-crossing ray parameters along one lateral axis
                if abs(kk) < 1e-12:
                    return jnp.full(pos.shape[:1] + (count,), np.inf,
                                    jnp.float32)
                i0 = (p0 - np.float32(loi)) * np.float32(1.0 / dxi)
                step = np.float32(abs(dxi / kk))
                first = jnp.where(
                    kk > 0,
                    (jnp.ceil(i0) - i0) * np.float32(dxi / kk),
                    (i0 - jnp.floor(i0)) * np.float32(-dxi / kk))
                first = jnp.where(first <= 1e-6 * step, first + step, first)
                m = jnp.arange(count, dtype=jnp.float32)[None, :]
                return first[:, None] + m * step

            nb_, nc_ = \
                (grid.nx, grid.ny, grid.nz)[b], (grid.nx, grid.ny,
                                                 grid.nz)[c]
            tb = cross_seq(pb, kb, lo[b], dx[b], nb_, Kp)
            tc = cross_seq(pc, kc, lo[c], dx[c], nc_, Kp)
            tb = jnp.where(tb < t_exit[:, None], tb, np.inf)
            tc = jnp.where(tc < t_exit[:, None], tc, np.inf)
            if abs(kb) < 1e-12 or abs(kc) < 1e-12:
                # one lateral axis is inactive (e.g. azimuth-0 leaders):
                # the crossing sequence is already sorted
                tall = (tc if abs(kb) < 1e-12 else tb)[:, :Kp - 1]
            else:
                # two-pointer merge of the two sorted arithmetic
                # sequences — a per-slot unrolled scan instead of a sort
                iota_b = jax.lax.broadcasted_iota(jnp.int32, tb.shape, 1)
                iota_c = jax.lax.broadcasted_iota(jnp.int32, tc.shape, 1)

                def take(seq, iota, ptr):
                    return jnp.sum(
                        jnp.where(iota == ptr[:, None], seq, 0.0), axis=1)

                pA = jnp.zeros(pos.shape[:1], jnp.int32)
                pB = jnp.zeros(pos.shape[:1], jnp.int32)
                merged = []
                for _ in range(Kp - 1):
                    vA = take(tb, iota_b, jnp.minimum(pA, Kp - 1))
                    vA = jnp.where(pA < Kp, vA, np.inf)
                    vB = take(tc, iota_c, jnp.minimum(pB, Kp - 1))
                    vB = jnp.where(pB < Kp, vB, np.inf)
                    lead_a = vA <= vB
                    merged.append(jnp.where(lead_a, vA, vB))
                    pA = pA + lead_a.astype(jnp.int32)
                    pB = pB + (1 - lead_a.astype(jnp.int32))
                tall = jnp.stack(merged, axis=1)
            zeros = jnp.zeros_like(t_exit)[:, None]
            tbnd = jnp.concatenate(
                [zeros, jnp.minimum(tall, t_exit[:, None]),
                 t_exit[:, None]], axis=1)              # (N, Kp+1)
            t_in = tbnd[:, :-1]
            t_out = tbnd[:, 1:]
            valid = t_out > t_in
            tmid = 0.5 * (t_in + t_out)
            ib = jnp.floor((pb[:, None] + tmid * np.float32(kb)
                            - np.float32(lo[b]))
                           * np.float32(1.0 / dx[b])).astype(jnp.int32)
            ic = jnp.floor((pc[:, None] + tmid * np.float32(kc)
                            - np.float32(lo[c]))
                           * np.float32(1.0 / dx[c])).astype(jnp.int32)
            okc = valid & (ib >= 0) & (ib < nb_) & (ic >= 0) & (ic < nc_)
            col = jnp.where(okc, ib * nc_ + ic, 0)
            na = (grid.nx, grid.ny, grid.nz)[a]
            # exact in-column integral over the a-profile
            a_in = pa[:, None] + t_in * np.float32(ka)
            a_out = pa[:, None] + t_out * np.float32(ka)
            a_nearc = jnp.minimum(a_in, a_out)
            a_farc = jnp.maximum(a_in, a_out)
            edges = (np.float32(lo[a])
                     + np.float32(dx[a]) * jnp.arange(na + 1,
                                                      dtype=jnp.float32))
            ov = jnp.clip(
                jnp.minimum(a_farc[..., None], edges[None, None, 1:])
                - jnp.maximum(a_nearc[..., None], edges[None, None, :-1]),
                0.0, None)                               # (N, Kp, na)
            tau = 0.0
            for h in range(H):
                rws = rows[h][col]                       # (N, Kp, na)
                colsum = jnp.sum(rws * ov, axis=2)       # (N, Kp)
                tau = tau + kext_pk[h] * jnp.sum(
                    jnp.where(okc, colsum, 0.0), axis=1)
            out.append(tau * np.float32(1.0 / max(abs(ka), 1e-12)))
        return out

    return taus


def make_fused_table_lifecycle(grid, dust_system, stellar_system,
                               instruments, options, nlambda: int,
                               launch_fn=None, emission_peeloff: bool = True,
                               scattering_peeloff: bool = True,
                               is_dust_emission=False, mueller=None,
                               io_state: bool = False,
                               max_iterations: int | None = None):
    """Build run_batch(key, ell, L0, tallies[, launch_ctx]) -> tallies
    for table densities with the event physics fused into one kernel.

    Same contract as lifecycle.make_lifecycle.
    """
    ds = dust_system
    _validate(grid, ds, instruments, options, mueller, io_state)
    from .lifecycle import (compute_rho_path_maps, make_peel_off)

    npanels = int(options.quadrature_panels
                  or getattr(grid, "max_steps", 96))
    np_peel = int(options.peel_panels or npanels)
    want_labs = bool(options.store_absorption)
    leaders, lead_of = _group_leaders(instruments)
    nlead = len(leaders)
    peel_mode = getattr(options, "table_peel", "exact")
    if peel_mode not in ("taumap", "staged", "exact"):
        raise ValueError("table_peel must be 'exact', 'taumap' or "
                         "'staged'")
    if peel_mode == "exact" and not (hasattr(grid, "_uniform")
                                     and all(grid._uniform)):
        # non-uniform direct-table mode has no column-DDA formulation;
        # say so out loud — staged peel carries a panel-count-dependent
        # convexity bias (see LifecycleOptions.table_peel)
        import warnings
        warnings.warn(
            "table_peel='exact' needs a uniform Cartesian (voxel) grid; "
            f"downgrading to 'staged' ({np_peel} panels) on "
            f"{type(grid).__name__} — peel flux carries a panel "
            "quadrature bias (use >=32 panels)", stacklevel=2)
        peel_mode = "staged"
    refill = options.refill_batches > 1
    K = int(options.refill_batches) if refill else 1
    # refill relaunches run XLA-side through the full launch machinery,
    # so a custom launch_fn refills too — but only when its emission is
    # isotropic (the merged peel gives fresh lanes unit weight): the
    # dust-emission launch qualifies (ref: dodustemissionchunk samples
    # an isotropic direction)
    if refill and launch_fn is not None and not is_dust_emission:
        raise ValueError("fused table lifecycle: refill with launch_fn "
                         "requires isotropic emission (dust phases)")
    if refill and launch_fn is None and not stellar_system.is_isotropic:
        raise ValueError("fused table lifecycle: refill requires an "
                         "isotropic stellar system (emission peel weight)")
    arith_locate = bool(hasattr(grid, "_uniform") and all(grid._uniform))

    multi = ds.ncomp > 1
    if multi and not arith_locate:
        raise ValueError("fused table lifecycle: multi-component mode "
                         "needs the uniform Cartesian voxel view")
    event = make_event(grid, options, nlambda, npanels, want_labs,
                       arith_locate, multi)

    # per-leader density-path maps: peel tau = map[cell] * kext(ell) with a
    # first-order in-cell correction (make_peel_off) — two gathers/packet
    maps = None
    if peel_mode == "taumap":
        maps = [compute_rho_path_maps(grid, ds, ins) for ins in instruments]
        peels = [make_peel_off(grid, ds, ins, rho_path_map=m)
                 for ins, m in zip(instruments, maps)]
    else:
        peels = [make_peel_off(grid, ds, ins) for ins in instruments]
    mix = ds.components[0].mix
    iter_cap = int(max_iterations if max_iterations is not None
                   else options.max_scatt_events) * K
    count_events = bool(getattr(options, "count_events", False))
    n_uniform = 3 if multi else 5
    # polarized mode: the kernel is UNCHANGED — the XLA-side Mueller
    # sample overrides the direction it wrote, and the per-leader peel
    # reuses the staged/exact tau with Mueller phase weights + Stokes
    # tags (the round-4 fused-analytic recipe, transplanted; ref:
    # DustMix.cpp:584-620 scatteringDirectionAndPolarization +
    # peeloffscattering's polarized branch)
    mt0 = (mueller[0] if isinstance(mueller, (list, tuple)) else mueller)
    pol_mode = mt0 is not None
    if pol_mode:
        from ..media import polarization as pol
        if multi:
            raise ValueError("fused table lifecycle: polarized mode is "
                             "single-component only")

    exact_taus = (make_exact_peel(grid, ds, leaders)
                  if peel_mode == "exact" else None)

    def staged_taus(pos, kext_pk):
        """Peel tau toward each leader: exact per-column DDA rows, or the
        P_peel panel quadrature."""
        if exact_taus is not None:
            return exact_taus(pos, kext_pk)
        taus = []
        for kvec in leaders:
            kobs = jnp.broadcast_to(
                jnp.asarray(np.asarray(kvec, np.float32)), pos.shape)
            dsg, _, mid = vt.panel_paths(grid, pos, kobs, np_peel)
            rows = ds.analytic_rows(pos, kobs, mid, None, kext_pk,
                                    want_sca=False)
            taus.append(jnp.sum(rows * dsg, axis=1))
        return taus

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
        ksca_pk, kext_pk = ds.packet_kappas(ell)
        albedo_pk = ksca_pk[0] / jnp.maximum(kext_pk[0], 1e-37)
        g_pk = jnp.asarray(mix.g)[ell]

        dust_flags = jnp.full(n, bool(is_dust_emission))

        def emission_peel(ins_list, pos_p, ell_p, contribution, nscatt_p):
            # ref: peeloffemission; tau via the maps or the staged
            # quadrature depending on table_peel
            tags = {"nscatt": nscatt_p, "is_dust": dust_flags}
            taus0 = (None if peel_mode == "taumap"
                     else staged_taus(pos_p, kext_pk))
            out = []
            for i, peel in enumerate(peels):
                c = contribution
                if (comp is not None and stellar_system is not None
                        and not stellar_system.is_isotropic):
                    kobs = instruments[i].observer_direction(pos_p)
                    c = c * stellar_system.direction_probability(
                        ell_p, pos_p, kobs, comp)
                out.append(peel(ins_list[i], pos_p, ell_p, c, tags,
                                tau=(taus0[lead_of[i]] if taus0 is not None
                                     else None)))
            return out

        ins0 = tallies["instruments"]
        if emission_peeloff:
            ins0 = emission_peel(list(ins0), pos, ell,
                                 jnp.where(alive, L, 0.0),
                                 jnp.zeros(n, jnp.int32))

        labs = tallies.get("labs")
        state0 = {
            "pos": pos, "dir": direction, "L": L,
            "alive": alive, "ns": jnp.zeros(n, jnp.int32),
            "bc": jnp.ones(n, jnp.int32),
        }
        carry = {"it": jnp.int32(0), "s": state0, "ins": ins0,
                 "labs": labs if labs is not None
                 else jnp.zeros((1,), jnp.float32)}
        if count_events:
            carry["nev"] = jnp.float32(0.0)
        if pol_mode:
            # normalized Stokes ratios + reference normal (packets launch
            # unpolarized; zero normal = "no reference yet")
            state0["stq"] = jnp.zeros(n, jnp.float32)
            state0["stu"] = jnp.zeros(n, jnp.float32)
            state0["stv"] = jnp.zeros(n, jnp.float32)
            state0["stn"] = jnp.zeros((n, 3), jnp.float32)


        def body(st):
            s = st["s"]
            kit = rng.event_key(k_cycle, st["it"])
            us = list(jnp.clip(jax.random.uniform(kit, (n_uniform, n),
                                                  jnp.float32),
                               1e-7, 1.0 - 1e-7))

            # -- stage the kappa*rho panel rows (the gather-bound op) -----
            dsg, _, mid = vt.panel_paths(grid, s["pos"], s["dir"], npanels)
            t0 = mid[:, 0] - 0.5 * dsg[:, 0]

            def panels(rows):                      # (N, P) -> P x (N,)
                return list(jnp.moveaxis(rows, 1, 0))

            labs_c = st["labs"]
            wv_h = None
            if multi:
                ks_rows, kr_rows = ds.analytic_rows(
                    s["pos"], s["dir"], mid, ksca_pk, kext_pk)
                state = (s["pos"][:, 0], s["pos"][:, 1], s["pos"][:, 2],
                         s["dir"][:, 0], s["dir"][:, 1], s["dir"][:, 2],
                         s["L"], s["alive"].astype(jnp.int32), s["ns"],
                         ell, L0, t0, dsg[:, 0])
                outs = event(us, panels(kr_rows), state,
                             ks=panels(ks_rows))
                if want_labs:
                    labs_c = binned_add(labs_c, outs[6], outs[7])
                pos_new = jnp.stack(outs[0:3], axis=-1)
                L_new = outs[3]
                alive_new = outs[4] != 0
                cell_at = outs[5]

                # XLA-side component selection + HG scatter (ref: the
                # unfused multi-component branch; per-component densities
                # at ONE cell — H small gathers per event)
                safe_c = jnp.clip(cell_at, 0)
                rho_h = [ds.rho_at(h, safe_c) for h in range(ds.ncomp)]
                wv_h = [ksca_pk[h] * rho_h[h] for h in range(ds.ncomp)]
                total_wv = sum(wv_h)
                ksc = rng.event_key(k_cycle, st["it"], 11)
                usel = jax.random.uniform(jax.random.fold_in(ksc, 0),
                                          (n,)) \
                    * jnp.maximum(total_wv, 1e-30)
                g_sel = jnp.asarray(ds.g)[0, ell]
                acc = wv_h[0]
                for h in range(1, ds.ncomp):
                    g_sel = jnp.where(usel > acc,
                                      jnp.asarray(ds.g)[h, ell], g_sel)
                    acc = acc + wv_h[h]
                from .lifecycle import hg_costheta
                ug = rng.uniform_open(jax.random.fold_in(ksc, 1), (n,))
                costh = hg_costheta(g_sel, ug)
                dir_new = rng.direction_about_axis(
                    jax.random.fold_in(ksc, 2), s["dir"], costh)
                dir_new = jnp.where(alive_new[:, None], dir_new, s["dir"])
                ns_new = jnp.where(alive_new, s["ns"] + 1, s["ns"])
            else:
                kr_rows = ds.analytic_rows(s["pos"], s["dir"], mid, None,
                                           kext_pk, want_sca=False)
                state = (s["pos"][:, 0], s["pos"][:, 1], s["pos"][:, 2],
                         s["dir"][:, 0], s["dir"][:, 1], s["dir"][:, 2],
                         s["L"], s["alive"].astype(jnp.int32), s["ns"],
                         ell, L0, t0, dsg[:, 0], albedo_pk, g_pk)
                outs = event(us, panels(kr_rows), state)

                if want_labs and arith_locate:
                    labs_c = binned_add(labs_c, outs[9], outs[10])
                elif want_labs:
                    # locate the sampled deposit point on the
                    # (non-Cartesian) grid: one locate_batched/iteration
                    mid_dep = outs[9]
                    dval = outs[10]
                    pos_dep = s["pos"] + mid_dep[:, None] * s["dir"]
                    cell_dep = grid.locate_batched(pos_dep[:, None, :])[:, 0]
                    okd = (mid_dep >= 0) & (cell_dep >= 0)
                    bins = jnp.where(okd,
                                     cell_dep * nlambda + ell, -1)
                    labs_c = binned_add(labs_c, bins,
                                        jnp.where(okd, dval, 0.0))

                pos_new = jnp.stack(outs[0:3], axis=-1)
                dir_new = jnp.stack(outs[3:6], axis=-1)
                L_new = outs[6]
                alive_new = outs[7] != 0
                ns_new = outs[8]

            pol_ctx = None
            if pol_mode:
                # ---- XLA-side Mueller scatter overriding the kernel's
                # HG direction (pre-event Stokes + direction feed both
                # the scatter and the peel, like the vector path) -------
                dir_old = s["dir"]
                q0, u0, v0 = s["stq"], s["stu"], s["stv"]
                nrm0_raw = s["stn"]
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
                theta_s = mt0.sample_theta(jax.random.fold_in(kpol, 0),
                                           ell)
                phi_s = mt0.sample_phi(jax.random.fold_in(kpol, 1), ell,
                                       theta_s, pdeg, pang)
                from ..media import polarization as pol
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
                scat = alive_new
                dir_new = jnp.where(scat[:, None], nd, dir_new)
                pol_ctx = dict(q0=q0, u0=u0, v0=v0, nrm0=nrm0,
                               dir_old=dir_old, pdeg=pdeg, pang=pang,
                               scat=scat, qn=qn, un=un, vn=vn,
                               nrm_s=nrm_s)

            # -- XLA-side relaunch (refill) -------------------------------
            bc = s["bc"]
            fresh = jnp.zeros(n, bool)
            if refill:
                eligible = jnp.logical_not(alive_new) & (bc < K)
                kre = rng.event_key(k_cycle, st["it"], 7)
                if launch_fn is not None:
                    pos_l, dir_l, L_l = launch_fn(kre, ell, L0,
                                                  launch_ctx)
                else:
                    pos_l, dir_l, L_l, _ = stellar_system.launch(kre, ell,
                                                                 L0)
                pos_new = jnp.where(eligible[:, None], pos_l, pos_new)
                dir_new = jnp.where(eligible[:, None], dir_l, dir_new)
                L_new = jnp.where(eligible, L_l, L_new)
                ns_new = jnp.where(eligible, 0, ns_new)
                bc = bc + eligible.astype(jnp.int32)
                fresh = eligible
                alive_new = alive_new | eligible

            # -- merged peel-off: scattered lanes get the phase weight,
            # fresh lanes the (isotropic) emission weight ------------------
            ins = list(st["ins"])
            if scattering_peeloff:
                taus0 = ([None] * nlead if peel_mode == "taumap"
                         else staged_taus(pos_new, kext_pk))
                tags2 = {"nscatt": ns_new, "is_dust": dust_flags}
                pol_lead = {}
                if pol_mode:
                    # per-LEADER Mueller peel, shared by every instrument
                    # with that observer direction (ref:
                    # peeloffscattering's polarized branch)
                    pc = pol_ctx
                    for j in sorted(set(lead_of)):
                        kobs = jnp.broadcast_to(jnp.asarray(
                            np.asarray(leaders[j], np.float32)), (n, 3))
                        cosa = jnp.sum(pc["dir_old"] * kobs, axis=-1)
                        theta_p = jnp.arccos(jnp.clip(cosa, -1.0, 1.0))
                        phi_p = pol.angle_between_planes(
                            pc["nrm0"], pc["dir_old"], kobs)
                        qr_p, ur_p = pol.rotate_stokes(pc["q0"],
                                                       pc["u0"], phi_p)
                        S11p, S12p, S33p, S34p = mt0.lookup(ell, theta_p)
                        wj = jnp.asarray(mt0.pfnorm)[ell] * (
                            S11p + pc["pdeg"] * S12p
                            * jnp.cos(2.0 * (phi_p - pc["pang"])))
                        _, qh, uh, vh = pol.apply_mueller(
                            qr_p, ur_p, pc["v0"], S11p, S12p, S33p, S34p)
                        nrm_i = jnp.cross(pc["dir_old"], kobs)
                        nn_i = jnp.linalg.norm(nrm_i, axis=-1,
                                               keepdims=True)
                        nrm_i = jnp.where(nn_i > 1e-20,
                                          nrm_i / jnp.maximum(nn_i,
                                                              1e-30),
                                          pc["nrm0"])
                        pol_lead[j] = (wj, qh, uh, vh, nrm_i, kobs)
                for i, peel in enumerate(peels):
                    kvec = leaders[lead_of[i]]
                    cosj = (s["dir"][:, 0] * np.float32(kvec[0])
                            + s["dir"][:, 1] * np.float32(kvec[1])
                            + s["dir"][:, 2] * np.float32(kvec[2]))
                    tg = tags2
                    if pol_mode:
                        wj, qh, uh, vh, nrm_i, kobs = pol_lead[lead_of[i]]
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
                        w = wj
                        if refill:
                            w = jnp.where(fresh, 1.0, w)
                            q3 = jnp.where(fresh, 0.0, q3)
                            u3 = jnp.where(fresh, 0.0, u3)
                            v3 = jnp.where(fresh, 0.0, v3)
                        tg = dict(tags2, stokes=(q3, u3, v3))
                    elif multi:
                        # blended phase weight by ksca_h*rho_h at the
                        # interaction cell (ref: peeloffscattering's
                        # per-component wv mix)
                        total_w = sum(wv_h)
                        w = 0.0
                        for h in range(ds.ncomp):
                            w = w + wv_h[h] * ds.components[h].mix \
                                .phase_function(ell, cosj)
                        w = jnp.where(total_w > 0,
                                      w / jnp.maximum(total_w, 1e-30),
                                      0.0)
                    else:
                        w = mix.phase_function(ell, cosj)
                    if refill and not pol_mode:
                        w = jnp.where(fresh, 1.0, w)
                    contribution = jnp.where(alive_new, L_new * w, 0.0)
                    ins[i] = peel(ins[i], pos_new, ell, contribution,
                                  tg, tau=taus0[lead_of[i]])
            elif refill and emission_peeloff:
                ins = emission_peel(ins, pos_new, ell,
                                    jnp.where(fresh, L_new, 0.0), ns_new)

            s_new = {"pos": pos_new, "dir": dir_new, "L": L_new,
                     "alive": alive_new, "ns": ns_new, "bc": bc}
            if count_events:
                # events processed this iteration = lanes alive at entry
                out_nev = st["nev"] + jnp.sum(
                    s["alive"].astype(jnp.float32))
            if pol_mode:
                pc = pol_ctx
                scat = pc["scat"] & jnp.logical_not(fresh)
                s_new["stq"] = jnp.where(scat, pc["qn"],
                                         jnp.where(fresh, 0.0, pc["q0"]))
                s_new["stu"] = jnp.where(scat, pc["un"],
                                         jnp.where(fresh, 0.0, pc["u0"]))
                s_new["stv"] = jnp.where(scat, pc["vn"],
                                         jnp.where(fresh, 0.0, pc["v0"]))
                s_new["stn"] = jnp.where(
                    scat[:, None], pc["nrm_s"],
                    jnp.where(fresh[:, None], 0.0, s["stn"]))
            out_st = {"it": st["it"] + 1, "s": s_new, "ins": ins,
                      "labs": labs_c}
            if count_events:
                out_st["nev"] = out_nev
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
