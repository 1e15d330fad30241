"""Dust-system diagnostic outputs.

ref: SKIRTcore/DustSystem.cpp — writeConvergence (:195-316), density cuts
(:320-458); PanDustSystem.cpp — ISRF text output and mean-temperature FITS
cuts (:415-707).  File naming follows the reference's
`prefix_ds_*.fits/dat` convention.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.fits import write_fits
from ..units import Units


def _midplane_points(box, axis1, axis2, n, fixed_axis, fixed_value=0.0):
    lo = [box[0], box[1], box[2]]
    hi = [box[3], box[4], box[5]]
    a = np.linspace(lo[axis1], hi[axis1], n)
    b = np.linspace(lo[axis2], hi[axis2], n)
    A, B = np.meshgrid(a, b, indexing="xy")
    pts = np.zeros((n * n, 3))
    pts[:, axis1] = A.ravel()
    pts[:, axis2] = B.ravel()
    pts[:, fixed_axis] = fixed_value
    return pts, a, b


def write_convergence(dust_system, units: Units, out_dir: str, prefix: str,
                      log=None):
    """Compare gridded vs theoretical mass and optical depths.

    ref: DustSystem::writeconvergence (DustSystem.cpp:195-316).
    """
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{prefix}_ds_convergence.dat")
    wg = dust_system.wavelength_grid
    ell = 0
    lines = ["# dust grid convergence check",
             f"# expected total dust mass ({units.unit('mass')}): "
             f"{units.out('mass', dust_system.expected_mass()):.6e}",
             f"# gridded  total dust mass ({units.unit('mass')}): "
             f"{units.out('mass', dust_system.gridded_mass()):.6e}"]
    for axis in ("x", "y", "z"):
        try:
            tau = dust_system.gridded_optical_depth(axis, ell)
            lines.append(f"# gridded optical depth along {axis} at "
                         f"{wg.lambdav[ell]*1e6:.3f} micron: {tau:.6e}")
        except Exception:  # axis may be degenerate for 1D/2D grids
            pass
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if log:
        log.info(f"Wrote convergence check to {path}")
    return path


def write_density_cuts(dust_system, units: Units, out_dir: str, prefix: str,
                       npix: int = 256):
    """Theoretical vs gridded density cuts through the coordinate planes.

    ref: DustSystem::writedensity (DustSystem.cpp:320-458) — xy, xz, yz
    midplane FITS frames for both the input distribution and the gridded
    representation.
    """
    os.makedirs(out_dir, exist_ok=True)
    box = dust_system.grid.bounding_box()
    import jax.numpy as jnp
    rho_grid = np.asarray(dust_system.rho64.sum(axis=0))
    written = []
    for name, (a1, a2, fixed) in {"xy": (0, 1, 2), "xz": (0, 2, 1),
                                  "yz": (1, 2, 0)}.items():
        pts, av, bv = _midplane_points(box, a1, a2, npix, fixed)
        # theoretical
        rho_t = np.zeros(pts.shape[0])
        for comp in dust_system.components:
            rho_t += comp.mass() * np.asarray(comp.geometry.density(pts))
        # gridded
        cells = np.asarray(dust_system.grid.locate(
            jnp.asarray(pts, jnp.float32)))
        rho_g = np.where(cells >= 0, rho_grid[np.clip(cells, 0, None)], 0.0)
        unit = units.unit("massvolumedensity")
        for tag, rho in (("trho", rho_t), ("grho", rho_g)):
            p = os.path.join(out_dir, f"{prefix}_ds_{tag}{name}.fits")
            write_fits(p, units.out("massvolumedensity",
                                    rho.reshape(npix, npix)),
                       incx=units.out("length", av[1] - av[0]),
                       incy=units.out("length", bv[1] - bv[0]), units=unit)
            written.append(p)
    return written


def write_tau_map(dust_system, units: Units, out_dir: str, prefix: str,
                  npx: int = 1600, npy: int = 800, ell: int | None = None,
                  batch: int = 1 << 16, log=None):
    """All-sky optical-depth map viewed from the model center.

    ref: DustSystem::writedepthmap (DustSystem.cpp:497-590) — inverse
    Mollweide projection of the (theta, phi) sphere onto an Npx x Npy
    image, optical depth integrated from the origin to the domain edge at
    the wavelength nearest to the V band.  The per-pixel scalar ray walk
    becomes a batched device sweep over all pixels at once.
    """
    import jax.numpy as jnp
    from ..engine import traversal
    os.makedirs(out_dir, exist_ok=True)
    wg = dust_system.wavelength_grid
    if ell is None:
        ell = max(0, int(np.argmin(np.abs(wg.lambdav - 0.55e-6))))

    # inverse Mollweide projection (ref: WriteDepthMap::body)
    j, i = np.meshgrid(np.arange(npy), np.arange(npx), indexing="ij")
    x = (i + 0.5) / npx
    y = (j + 0.5) / npy
    alpha = np.arcsin(2.0 * y - 1.0)
    theta = np.arccos(np.clip((2.0 * alpha + np.sin(2.0 * alpha)) / np.pi,
                              -1.0, 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = np.pi * (2.0 * x - 1.0) / np.cos(alpha)
    valid = (phi > -np.pi) & (phi < np.pi)
    st = np.sin(theta)
    dirs = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                    axis=-1).reshape(-1, 3).astype(np.float32)
    dirs = np.where(np.isfinite(dirs), dirs, 0.0)

    kr = dust_system.kapparho_ext_fn(jnp.asarray([ell]))
    tau = np.zeros(npx * npy, np.float64)
    flat_valid = valid.reshape(-1)
    idx = np.nonzero(flat_valid)[0]
    for start in range(0, idx.size, batch):
        sel = idx[start:start + batch]
        d = jnp.asarray(dirs[sel])
        pos = jnp.zeros_like(d)
        tau[sel] = np.asarray(traversal.optical_depth(
            dust_system.grid, kr, pos, d))
    path = os.path.join(out_dir, f"{prefix}_ds_tau.fits")
    write_fits(path, tau.reshape(npy, npx),
               incx=np.degrees(2.0 * np.pi / npx),
               incy=np.degrees(np.pi / npy), units="dimensionless")
    if log:
        log.info(f"Wrote optical depth map to {path}")
    return path


def write_temperature_cuts(pan_sim, acc, units: Units, out_dir: str,
                           prefix: str, npix: int = 256):
    """Equilibrium dust temperature cuts through the coordinate planes.

    ref: PanDustSystem.cpp WriteTempCut (:615-707).
    """
    os.makedirs(out_dir, exist_ok=True)
    import jax.numpy as jnp
    T_cells = pan_sim.cell_temperatures(acc)
    box = pan_sim.grid.bounding_box()
    written = []
    for name, (a1, a2, fixed) in {"xy": (0, 1, 2), "xz": (0, 2, 1),
                                  "yz": (1, 2, 0)}.items():
        pts, av, bv = _midplane_points(box, a1, a2, npix, fixed)
        cells = np.asarray(pan_sim.grid.locate(jnp.asarray(pts, jnp.float32)))
        T = np.where(cells >= 0, T_cells[np.clip(cells, 0, None)], 0.0)
        p = os.path.join(out_dir, f"{prefix}_ds_temp{name}.fits")
        write_fits(p, T.reshape(npix, npix),
                   incx=units.out("length", av[1] - av[0]),
                   incy=units.out("length", bv[1] - bv[0]), units="K")
        written.append(p)
    return written


def write_isrf(pan_sim, acc, units: Units, out_dir: str, prefix: str):
    """Mean interstellar radiation field per cell.

    ref: PanDustSystem.cpp writeISRF (:415+) — J_lambda per cell computed
    as Labs/(4 pi V kappa rho dlambda) (DustSystem::meanintensityv).
    """
    os.makedirs(out_dir, exist_ok=True)
    ds = pan_sim.dust_system
    wg = pan_sim.wavelength_grid
    labs = acc["labs_stellar"] + acc["labs_dust"]  # (Ncells, Nl)
    rho = ds.rho64.sum(axis=0)
    V = ds.volumes
    kabs = np.asarray(ds.components[0].mix.kappaabs64)
    with np.errstate(divide="ignore", invalid="ignore"):
        J = labs / (4.0 * np.pi * V[:, None] * rho[:, None] * kabs[None, :]
                    * wg.dlambdav[None, :])
    J = np.where(np.isfinite(J), J, 0.0)
    path = os.path.join(out_dir, f"{prefix}_ds_isrf.dat")
    centers = ds.grid.cell_centers()
    header = ("ISRF mean intensity J_lambda [W/m3/sr] per cell\n"
              "columns: cell index, x, y, z (" + units.unit("length") + "), "
              + ", ".join(f"J({l*1e6:.4g}um)" for l in wg.lambdav))
    cols = np.column_stack([np.arange(ds.grid.ncells),
                            units.out("length", centers), J])
    np.savetxt(path, cols, header=header)
    return path


def _emissivities_for_field(pan_sim, J):
    """Per-component emissivity j_lambda [W/m/kg/sr] for an embedding field.

    ref: DustEmissivity::emissivity(mix, Jv).  For each component the
    absorbed power per unit dust mass is int kappaabs J dlambda; the grey
    -body solution is kappaabs * B(T_eq) with T_eq from the precomputed
    planck-absorption table, and the transient solver (when active)
    redistributes the same absorbed power over its per-bin emission
    fractions (energy balance: int j dlambda = int kappaabs J dlambda,
    both per steradian).
    """
    wg = pan_sim.wavelength_grid
    dlam = wg.dlambdav
    out = []
    for h, comp in enumerate(pan_sim.dust_system.components):
        kabs = np.asarray(comp.mix.kappaabs64)
        absorbed = float(np.sum(kabs * J * dlam))
        if pan_sim.transient is not None:
            import jax.numpy as jnp
            Jrow = np.asarray(J, np.float32)[None, :]
            frac = np.asarray(pan_sim.transient.fractions_from_J(
                jnp.asarray(Jrow)))[0].astype(np.float64)
            with np.errstate(divide="ignore"):
                j = frac * absorbed / dlam
        else:
            em = pan_sim.emissivities[h]
            logabs = np.log(max(absorbed, 1e-300))
            logtab = np.log(np.maximum(em.planckabs64, 1e-300))
            T = float(np.interp(logabs, logtab, em.Tv64))
            from ..sources.sed import PlanckFunction
            j = kabs * PlanckFunction(T)(wg.lambdav)
        out.append(j)
    return out


def write_emissivities(pan_sim, units: Units, out_dir: str, prefix: str,
                       log=None):
    """Emissivity tables for standard embedding fields.

    ref: PanDustSystem::setupSelfAfter writeEmissivity branch
    (PanDustSystem.cpp:131-155) + writeEmissivitiesForField (:73-107):
    scaled Mathis fields U = 1e-4..1e6 and six diluted blackbodies.
    Columns per file: lambda, J_lambda (W/m3/sr), then per dust component
    mu * lambda * j_lambda (W/sr/H) — mixes without a known mu (mu = 1)
    report lambda * j_lambda per unit dust mass instead.
    """
    from .isrf import mathis, blackbody
    os.makedirs(out_dir, exist_ok=True)
    wg = pan_sim.wavelength_grid
    written = []

    def write_one(filebody, title, J):
        path = os.path.join(out_dir, f"{prefix}_ds_{filebody}.dat")
        jvv = _emissivities_for_field(pan_sim, J)
        cols = [units.out("wavelength", wg.lambdav), J]
        for comp, j in zip(pan_sim.dust_system.components, jvv):
            mu = getattr(comp.mix, "mu", 1.0) or 1.0
            cols.append(mu * wg.lambdav * j)
        header = (f"dust emissivities for {title}\n"
                  f"columns: lambda ({units.unit('wavelength')}), "
                  "J_lambda (W/m3/sr), then per component "
                  "mu*lambda*j_lambda (W/sr/H)")
        np.savetxt(path, np.column_stack(cols), header=header)
        written.append(path)

    Jmathis = mathis(wg)
    for i in range(-4, 7):
        U = 10.0 ** i
        write_one(f"Mathis_U_{U:.0e}", f"{U:g} * Mathis ISRF", U * Jmathis)
    # ref: PanDustSystem.cpp:144-146 — dilution factors for T = 3000..18000 K
    Tv = (3000, 6000, 9000, 12000, 15000, 18000)
    Dv = (8.28e-12, 2.23e-13, 2.99e-14, 7.23e-15, 2.36e-15, 9.42e-16)
    for T, D in zip(Tv, Dv):
        write_one(f"BlackBody_T_{T:05d}", f"{D:.2e} * B({T}K)",
                  blackbody(wg, T, D))
    if log:
        log.info(f"Wrote {len(written)} emissivity tables to {out_dir}")
    return written


# ---------------------------------------------------------------------------
# grid-outline plot files
# ---------------------------------------------------------------------------

def _cell_boxes(grid):
    """(lo (N,3), hi (N,3)) leaf boxes for box-structured grids, or None."""
    if hasattr(grid, "leaf_nodes"):            # tree grids
        return grid.lo64[grid.leaf_nodes], grid.hi64[grid.leaf_nodes]
    if hasattr(grid, "xb64"):                  # Cartesian
        lo = np.stack(np.meshgrid(grid.xb64[:-1], grid.yb64[:-1],
                                  grid.zb64[:-1], indexing="ij"),
                      axis=-1).reshape(-1, 3)
        hi = np.stack(np.meshgrid(grid.xb64[1:], grid.yb64[1:],
                                  grid.zb64[1:], indexing="ij"),
                      axis=-1).reshape(-1, 3)
        return lo, hi
    if hasattr(grid, "leaf_lo"):               # adaptive-mesh imports
        return np.asarray(grid.leaf_lo), np.asarray(grid.leaf_hi)
    return None


def write_grid_plots(grid, units: Units, out_dir: str, prefix: str,
                     log=None, max_cells_3d: int = 5000):
    """Grid-outline data for gnuplot, matching the reference's layout.

    ref: SKIRTcore/DustGridPlotFile.cpp + DustGrid::writegrid
    (DustGrid.cpp:53-74) — four text files: _ds_gridxy/xz/yz.dat hold
    2-D outlines of the cells crossing the z=0/y=0/x=0 planes (blocks of
    vertex rows separated by blank lines), _ds_gridxyz.dat holds 3-D cell
    outlines (capped at max_cells_3d cells for tree-scale grids).
    """
    os.makedirs(out_dir, exist_ok=True)
    conv = 1.0 / _UNIT_TO_SI_LENGTH(units)
    written = []

    def rect(f, a0, b0, a1, b1):
        f.write(f"{a0 * conv:.8g}\t{b0 * conv:.8g}\n"
                f"{a0 * conv:.8g}\t{b1 * conv:.8g}\n"
                f"{a1 * conv:.8g}\t{b1 * conv:.8g}\n"
                f"{a1 * conv:.8g}\t{b0 * conv:.8g}\n"
                f"{a0 * conv:.8g}\t{b0 * conv:.8g}\n\n")

    def circle(f, r):
        # ref: DustGridPlotFile::writeCircle — 360 one-degree segments
        th = np.linspace(0.0, 2.0 * np.pi, 361)
        for x, y in zip(r * np.cos(th), r * np.sin(th)):
            f.write(f"{x * conv:.8g}\t{y * conv:.8g}\n")
        f.write("\n")

    def path_for(body):
        p = os.path.join(out_dir, f"{prefix}_ds_{body}.dat")
        written.append(p)
        return p

    boxes = _cell_boxes(grid)
    if boxes is not None:
        lo, hi = boxes
        for body, (ia, ib, ic) in (("gridxy", (0, 1, 2)),
                                   ("gridxz", (0, 2, 1)),
                                   ("gridyz", (1, 2, 0))):
            sel = (lo[:, ic] <= 0.0) & (hi[:, ic] >= 0.0)
            with open(path_for(body), "w") as f:
                f.write(f"# {body} dust grid outline, length unit "
                        f"{units.unit('length')}\n\n")
                for l, h in zip(lo[sel], hi[sel]):
                    rect(f, l[ia], l[ib], h[ia], h[ib])
        with open(path_for("gridxyz"), "w") as f:
            f.write(f"# 3-D dust grid outline, length unit "
                    f"{units.unit('length')}\n\n")
            step = max(1, lo.shape[0] // max_cells_3d)
            for l, h in zip(lo[::step], hi[::step]):
                # ref: DustGridPlotFile::writeCube — 12 edges as 2 loops
                # + 4 pillars
                for z in (l[2], h[2]):
                    f.write(f"{l[0]*conv:.8g}\t{l[1]*conv:.8g}\t{z*conv:.8g}\n"
                            f"{l[0]*conv:.8g}\t{h[1]*conv:.8g}\t{z*conv:.8g}\n"
                            f"{h[0]*conv:.8g}\t{h[1]*conv:.8g}\t{z*conv:.8g}\n"
                            f"{h[0]*conv:.8g}\t{l[1]*conv:.8g}\t{z*conv:.8g}\n"
                            f"{l[0]*conv:.8g}\t{l[1]*conv:.8g}\t{z*conv:.8g}\n\n")
                for cx in (l[0], h[0]):
                    for cy in (l[1], h[1]):
                        f.write(f"{cx*conv:.8g}\t{cy*conv:.8g}\t{l[2]*conv:.8g}\n"
                                f"{cx*conv:.8g}\t{cy*conv:.8g}\t{h[2]*conv:.8g}\n\n")
    elif hasattr(grid, "rb64") and not hasattr(grid, "zb64"):
        # spherical grids: concentric circles in every cut
        tb = getattr(grid, "tb64", None)
        for body in ("gridxy", "gridxz", "gridyz"):
            with open(path_for(body), "w") as f:
                f.write(f"# {body} dust grid outline, length unit "
                        f"{units.unit('length')}\n\n")
                for r in grid.rb64[1:]:
                    circle(f, r)
                if tb is not None and body in ("gridxz", "gridyz"):
                    # ref: Sphere2DDustGrid::write_xz — cone lines
                    R = grid.rb64[-1]
                    for t in tb:
                        f.write(f"0\t0\n{R*np.sin(t)*conv:.8g}\t"
                                f"{R*np.cos(t)*conv:.8g}\n\n")
    elif hasattr(grid, "rb64") and hasattr(grid, "zb64"):
        # cylindrical: circles in xy; rectangles (R, z) mirrored in xz/yz
        with open(path_for("gridxy"), "w") as f:
            f.write(f"# gridxy dust grid outline, length unit "
                    f"{units.unit('length')}\n\n")
            for r in grid.rb64[1:]:
                circle(f, r)
        for body in ("gridxz", "gridyz"):
            with open(path_for(body), "w") as f:
                f.write(f"# {body} dust grid outline, length unit "
                        f"{units.unit('length')}\n\n")
                for i in range(grid.rb64.size - 1):
                    for j in range(grid.zb64.size - 1):
                        rect(f, grid.rb64[i], grid.zb64[j],
                             grid.rb64[i + 1], grid.zb64[j + 1])
                        rect(f, -grid.rb64[i + 1], grid.zb64[j],
                             -grid.rb64[i], grid.zb64[j + 1])
    else:
        # Voronoi and friends: plot sites + bounding box outline
        with open(path_for("gridxyz"), "w") as f:
            f.write(f"# grid sites, length unit {units.unit('length')}\n")
            pts = getattr(grid, "sites", None)
            if pts is not None:
                for p in np.asarray(pts):
                    f.write(f"{p[0]*conv:.8g}\t{p[1]*conv:.8g}\t"
                            f"{p[2]*conv:.8g}\n")
    if log:
        log.info(f"Wrote {len(written)} grid plot files to {out_dir}")
    return written


def _UNIT_TO_SI_LENGTH(units: Units) -> float:
    from ..units import _UNIT_TO_SI
    return _UNIT_TO_SI["length"][units.unit("length")]


def write_cells_crossed(grid, dust_system, stellar_system, out_dir: str,
                        prefix: str, n_samples: int = 20000, seed: int = 71,
                        log=None):
    """Histogram of cells crossed per photon path -> _ds_crossed.dat.

    ref: DustSystem.cpp:965-971 + :1010-1021 — the reference counts the
    path length (pp->size()) of every fillOpticalDepth call and writes a
    two-column histogram.  Batched re-design: a per-event host-side counter
    would serialize the SPMD lockstep loop, so the histogram is sampled
    POST-HOC over n_samples launch-distributed rays traced through the
    same grid (statistically the same first-flight distribution; the
    scattered-flight distribution is geometry-dominated and matches to
    sampling noise).
    """
    import jax
    import jax.numpy as jnp

    from .. import rng as _rng
    from ..engine import vector_traversal as vt

    os.makedirs(out_dir, exist_ok=True)
    key = _rng.root_key(seed)
    n = int(n_samples)
    ell = jnp.zeros((n,), jnp.int32)
    L0 = jnp.ones((n,), jnp.float32)
    pos, direction, _L, _c = stellar_system.launch(key, ell, L0)
    if hasattr(grid, "crossings"):
        cells, dsg, _ = vt.record_paths(grid, pos, direction)
        counts = np.asarray(jnp.sum((cells >= 0) & (dsg > 0), axis=1))
    else:
        # panel fallback: count distinct located cells at panel midpoints
        dsg, _, mid = vt.panel_paths(grid, pos, direction,
                                     int(getattr(grid, "max_steps", 64)))
        pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
        cells = grid.locate_batched(pmid)
        change = jnp.concatenate(
            [(cells[:, :1] >= 0).astype(jnp.int32),
             ((cells[:, 1:] != cells[:, :-1])
              & (cells[:, 1:] >= 0)).astype(jnp.int32)], axis=1)
        counts = np.asarray(change.sum(axis=1))
    hist = np.bincount(counts)
    path = os.path.join(out_dir, f"{prefix}_ds_crossed.dat")
    with open(path, "w") as f:
        f.write("# Number of cells crossed per path (sampled)\n")
        f.write("# column 1: number of cells crossed\n")
        f.write("# column 2: number of paths that crossed this number "
                "of cells\n")
        for i, c in enumerate(hist):
            f.write(f"{i} {int(c)}\n")
    if log is not None:
        log.info(f"Wrote cells-crossed histogram to {path}")
    return hist
