"""Dust system: discretized density field over a grid + optical properties.

ref: SKIRTcore/DustSystem.cpp:63-192 (per-cell volume + density sampling,
MPI assemble), DustComp/CompDustDistribution, and the normalization family
(SKIRTcore/*DustCompNormalization.*).

Setup (host, float64): each component's geometry density is MC-averaged
over each cell (default 100 samples/cell as in the reference, DustSystem.cpp:41)
or evaluated at cell centers; normalizations convert unit-mass geometry
density to physical kg/m^3.  The result is frozen into float32 device
arrays rho (Ncomp, Ncells); the engine computes kappa*rho per packet with
two gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry.base import Geometry
from .mix import DustMix


@dataclass
class DustMassNormalization:
    """Total dust mass in kg (ref: DustMassDustCompNormalization)."""
    mass: float

    def mass_for(self, geometry: Geometry, mix: DustMix) -> float:
        return float(self.mass)


@dataclass
class OpticalDepthNormalization:
    """Normalize to an optical depth along a coordinate axis.

    axis: 'x' | 'y' | 'z' (full-axis optical depth, ref: X/Y/ZDustComp
    Normalization) or 'radial' (half-axis, ref: RadialDustCompNormalization).
    wavelength: reference wavelength [m]; tau: target optical depth.
    """
    axis: str
    wavelength: float
    tau: float

    def mass_for(self, geometry: Geometry, mix: DustMix) -> float:
        ell = mix.wavelength_grid.nearest(self.wavelength)
        if ell < 0:
            raise ValueError("normalization wavelength outside the grid")
        kappa = float(mix.kappaext64[ell])
        if self.axis == "x":
            sigma = geometry.sigma_x()
        elif self.axis == "y":
            sigma = geometry.sigma_y()
        elif self.axis == "z":
            sigma = geometry.sigma_z()
        elif self.axis == "radial":
            sigma = 0.5 * geometry.sigma_x()
        else:
            raise ValueError(f"unknown axis '{self.axis}'")
        if sigma <= 0 or kappa <= 0:
            raise ValueError("cannot normalize: zero surface density or opacity")
        return self.tau / (sigma * kappa)


@dataclass
class DustComponent:
    """geometry (unit total mass) + mix + normalization.

    ref: SKIRTcore/DustComp.cpp.
    """
    geometry: Geometry
    mix: DustMix
    normalization: DustMassNormalization | OpticalDepthNormalization

    def mass(self) -> float:
        return self.normalization.mass_for(self.geometry, self.mix)


class DustSystem:
    """Density field of one or more dust components over a spatial grid.

    ref: SKIRTcore/DustSystem.cpp (OligoDustSystem/PanDustSystem split is
    handled by the simulation drivers; the density machinery is shared).
    """

    def __init__(self, grid, components, samples_per_cell: int = 100,
                 seed: int = 8672, density_mode: str = "gridded"):
        if not components:
            raise ValueError("need at least one dust component")
        self.grid = grid
        self.components = list(components)
        self.ncomp = len(self.components)
        wg = self.components[0].mix.wavelength_grid
        for c in self.components:
            if c.mix.wavelength_grid is not wg:
                raise ValueError("all mixes must share the wavelength grid")
        self.wavelength_grid = wg

        # --- discretize densities (host, float64) -------------------------
        ncells = grid.ncells
        self.volumes = grid.cell_volumes()             # (Ncells,)
        rho = np.zeros((self.ncomp, ncells))
        rng_np = np.random.default_rng(seed)
        cells = np.arange(ncells)
        for h, comp in enumerate(self.components):
            m = comp.mass()
            if hasattr(grid, "sample_cell_densities"):
                # unstructured grids provide a one-pass stratified estimate
                rho[h] = m * grid.sample_cell_densities(comp.geometry.density)
            elif samples_per_cell <= 1:
                pos = grid.cell_centers()
                rho[h] = m * np.asarray(comp.geometry.density(pos))
            else:
                acc = np.zeros(ncells)
                for _ in range(samples_per_cell):
                    pos = grid.random_positions_in_cells(rng_np, cells)
                    acc += np.asarray(comp.geometry.density(pos))
                rho[h] = m * acc / samples_per_cell
        # two-phase (clumpy) media scale each cell's density by the grid's
        # random phase weight (ref: DustSystem.cpp:159-170, grid->weight(m))
        w = getattr(grid, "cell_weights", None)
        if w is not None:
            rho *= np.asarray(w)[None, :]
        self.rho64 = rho                               # (Ncomp, Ncells) kg/m^3
        self.masses = np.array([c.mass() for c in self.components])

        # host (numpy) tables: traced code wraps them with jnp.asarray
        self.rho = np.asarray(rho, np.float32)
        self.kappaext = np.stack([np.asarray(c.mix.kappaext, np.float32)
                                  for c in self.components])
        self.kappasca = np.stack([np.asarray(c.mix.kappasca, np.float32)
                                  for c in self.components])
        self.kappaabs = np.stack([np.asarray(c.mix.kappaabs, np.float32)
                                  for c in self.components])
        self.g = np.stack([np.asarray(c.mix.g, np.float32)
                           for c in self.components])

        # -- analytic-density traversal mode (fast path) ---------------
        # 'gridded' (default) reproduces the reference exactly: per-cell
        # constant densities, per-segment table gathers.  'analytic'
        # evaluates each component's closed-form density at segment
        # midpoints with pure elementwise math — no gathers, the costliest
        # op of the gridded lifecycle.
        # tau integrals then use the CONTINUOUS density (2nd-order-accurate
        # in cell size vs the reference's piecewise-constant gridding);
        # tallies remain per-cell.
        # 'table' rides the same panel-quadrature path as 'analytic' but
        # samples the GRIDDED per-cell densities (one gather per panel
        # midpoint) — for media without closed forms (imports, clumpy
        # decorators) on uniform Cartesian/voxelized grids.  ~P panel
        # gathers replace ~S crossing gathers and the single-mix event
        # closes over the cumulative tau alone (uniform albedo), at the
        # cost of a voxel-scale quadrature approximation of tau.
        if density_mode not in ("gridded", "analytic", "table"):
            raise ValueError(
                "density_mode must be 'gridded', 'analytic' or 'table'")
        self.analytic = density_mode in ("analytic", "table")
        self.table = density_mode == "table"
        if self.table:
            self._check_table_grid(grid)
        box = grid.bounding_box()
        self.lscale = float(max(box[3] - box[0], box[4] - box[1],
                                box[5] - box[2]))
        if self.analytic and not self.table:
            for c in self.components:
                if not c.geometry.supports_analytic:
                    raise ValueError(
                        f"{type(c.geometry).__name__} has no analytic device "
                        "density (density_scaled); use density_mode='gridded'")
        # m_h / L^3: converts density_scaled output (rho_unit * L^3) to
        # physical kg/m^3 (float64 host product; ~1e-26, float32-safe)
        self._mass_over_L3 = np.asarray(
            self.masses / self.lscale ** 3, np.float32)

    @staticmethod
    def _check_table_grid(grid):
        if not (hasattr(grid, "ray_span") and hasattr(grid, "locate_batched")):
            raise ValueError(
                "density_mode='table' needs a grid with ray_span + "
                "locate_batched (uniform Cartesian / voxelized view)")

    def as_table(self) -> "DustSystem":
        """Copy of this system in 'table' mode (panel-sampled gridded rho).

        The panel quadrature samples the per-cell density table at panel
        midpoints (one gather each) instead of walking every wall crossing
        (~S gathers + a second kappa row in the gridded branch).  tau picks
        up a voxel-scale quadrature error — the same class of trade as the
        analytic fast path and the approximate Voronoi voxelization; the
        reference's own cell densities are already MC-sampled
        (ref: DustSystem.cpp:41 _Nrandom=100).
        """
        import copy

        self._check_table_grid(self.grid)
        t = copy.copy(self)
        t.analytic = True
        t.table = True
        return t

    @property
    def muellers(self):
        """Per-component Mueller tables (None entries for unpolarized
        mixes), or None when no component is polarized.

        ref: DustMix polarization tables; the reference keeps per-mix
        matrices and blends/selects per event (peeloffscattering wv,
        randomMixForPosition).
        """
        tables = [getattr(c.mix, "mueller", None) for c in self.components]
        if not any(t is not None for t in tables):
            return None
        return tables

    @property
    def mueller(self):
        """Single-component Mueller table (back-compat accessor): the
        per-component list collapses when there is one component."""
        tables = self.muellers
        if tables is None:
            return None
        if self.ncomp == 1:
            return tables[0]
        return tables

    # -- voxelized view (tree grids) --------------------------------------

    def voxelized(self, max_voxels: int = 1 << 24,
                  max_field_error: float | None = None, log=None):
        """Uniform-voxel view of this system for tree grids.

        The gridded density field is piecewise constant on leaf cells and
        leaves are unions of finest-level voxels, so the voxel view traces
        the IDENTICAL field through the fast Cartesian DDA (no per-step
        tree re-descent).  Returns (voxel_dust_system, fold_labs) where
        fold_labs maps a flat (nvox*nlambda,) absorption tally back onto
        (ncells*nlambda,) leaf cells; None when the grid has no exact
        voxelization or it would be too large.

        For APPROXIMATE voxelizations (Voronoi nearest-site
        rasterization: grid.voxelize_exact is False) the mass-weighted
        field error is MEASURED by sampling (stored as
        `voxelization_error` on the returned system and logged); when
        `max_field_error` is given and the estimate exceeds it the
        voxelization is REFUSED (returns None) so callers fall back to
        the exact walk.  ref: VoronoiMesh.cpp:512-543 is exact; the
        rasterization trades wall-resolution for the Cartesian DDA.
        """
        import copy

        if self.analytic or not hasattr(self.grid, "voxelize"):
            return None
        v = self.grid.voxelize(max_voxels=max_voxels)
        if v is None:
            return None
        cart, cell_of = v
        field_error = None
        if not getattr(self.grid, "voxelize_exact", True):
            field_error = self._voxel_field_error(cart, cell_of)
            if log is not None:
                log.info(f"approximate voxelization: mass-weighted field "
                         f"error {field_error * 100:.2f}%")
            if max_field_error is not None \
                    and field_error > max_field_error:
                if log is not None:
                    log.warning(
                        f"voxelization refused: field error "
                        f"{field_error * 100:.2f}% exceeds the "
                        f"{max_field_error * 100:.2f}% tolerance — "
                        f"falling back to the exact walk")
                return None
        vds = copy.copy(self)
        vds.grid = cart
        vds.rho64 = np.ascontiguousarray(self.rho64[:, cell_of])
        vds.rho = np.asarray(vds.rho64, np.float32)
        vds.volumes = cart.cell_volumes()
        vds.voxelization_error = field_error
        nl = self.wavelength_grid.nlambda
        ncells = self.grid.ncells

        def fold_labs(labs_vox):
            lv = np.asarray(labs_vox, np.float64).reshape(-1, nl)
            out = np.zeros((ncells, nl))
            np.add.at(out, cell_of, lv)
            return out.reshape(-1)

        return vds, fold_labs

    def _voxel_field_error(self, cart, cell_of, n_samples: int = 200000,
                           seed: int = 31):
        """Mass-weighted relative field error of an approximate
        rasterization: E = sum |rho_vox - rho_exact| dV / sum rho dV,
        MC-sampled.  rho_exact uses the grid's own point location (the
        exact tessellation); rho_vox the voxel assignment."""
        import jax.numpy as _jnp

        rs = np.random.default_rng(seed)
        lo = np.asarray([cart._lo[a] for a in range(3)])
        dxv = np.asarray([cart._dx[a] for a in range(3)])
        nv = np.asarray([cart.nx, cart.ny, cart.nz])
        pts = lo + rs.uniform(size=(n_samples, 3)) * (nv * dxv)
        exact_cells = np.asarray(
            self.grid.locate(_jnp.asarray(pts, _jnp.float32)))
        iv = np.clip(((pts - lo) / dxv).astype(np.int64), 0, nv - 1)
        vox_flat = (iv[:, 0] * nv[1] + iv[:, 1]) * nv[2] + iv[:, 2]
        vox_cells = np.asarray(cell_of)[vox_flat]
        rho = self.rho64.sum(axis=0)
        ok = exact_cells >= 0
        re_ = rho[exact_cells[ok]]
        rv = rho[vox_cells[ok]]
        denom = re_.sum()
        if denom <= 0:
            return 0.0
        return float(np.abs(rv - re_).sum() / denom)

    # -- diagnostics (host) -----------------------------------------------

    def gridded_mass(self) -> float:
        """Total dust mass as represented on the grid (convergence check).

        ref: DustSystem.cpp:195-316 writeConvergence.
        """
        return float((self.rho64.sum(axis=0) * self.volumes).sum())

    def expected_mass(self) -> float:
        return float(self.masses.sum())

    def gridded_optical_depth(self, axis: str, ell: int, n: int = 10000) -> float:
        """Optical depth through the gridded medium along a coordinate axis."""
        from ..engine import traversal
        unit = {"x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]}[axis]
        box = self.grid.bounding_box()
        span = max(box[3] - box[0], box[4] - box[1], box[5] - box[2])
        pos = jnp.asarray([[(-2.0 * span) * unit[i] for i in range(3)]], jnp.float32)
        d = jnp.asarray([unit], jnp.float32)
        s0, state = self.grid.enter(pos, d)
        kr = self.kapparho_ext_fn(jnp.asarray([ell]))
        tau = traversal.optical_depth(self.grid, kr, pos, d, state0=state)
        return float(tau[0])

    # -- device-side property accessors -----------------------------------

    def rho_at(self, h, cells_safe):
        """rho_h gathered at (clipped) flat cell ids — the gridded-mode
        hot op.

        Two-level row gather on Cartesian grids (cells are z-minor): one
        gather of the nz-wide z-row per element + a one-hot select over
        nz.  Row gathers move nz contiguous floats per descriptor where
        the scalar gather moves one.  Chunked via lax.map so the
        (chunk, nz) row tensor stays bounded.
        """
        import os
        g = self.grid
        nz = int(getattr(g, "nz", 0) or 0)
        if not (2 <= nz <= 64) or (self.grid.ncells % nz) != 0 \
                or os.environ.get("SKIRT_TPU_ROW_GATHER", "1") == "0":
            return jnp.asarray(self.rho)[h, cells_safe]
        rho3 = jnp.asarray(self.rho[h].reshape(-1, nz))
        flat = cells_safe.reshape(-1)
        M = flat.shape[0]

        def one(c):
            ixy = c // nz
            iz = c % nz
            rows = rho3[ixy]                              # (CH, nz)
            sel = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1) \
                == iz[:, None]
            return jnp.sum(jnp.where(sel, rows, 0.0), axis=1)

        CH = 1 << 18        # (CH, 64) rows <= 64 MB
        if M <= CH:
            out = one(flat)
        else:
            pad = (-M) % CH
            fp = jnp.pad(flat, (0, pad))
            out = jax.lax.map(one, fp.reshape(-1, CH)).reshape(-1)[:M]
        return out.reshape(cells_safe.shape)

    def kapparho_ext_fn(self, ell):
        """Returns a function cell -> sum_h kappaext_h(ell) * rho_h(cell)."""
        def fn(cell):
            safe = jnp.clip(cell, 0)
            kr = 0.0
            for h in range(self.ncomp):
                kr = kr + jnp.asarray(self.kappaext)[h, ell] \
                * jnp.asarray(self.rho)[h, safe]
            return jnp.where(cell >= 0, kr, 0.0)
        return fn

    def packet_kappas(self, ell):
        """Per-packet kappa lookups hoisted out of traversal loops.

        Returns (ksca_pk, kext_pk): lists over components of (N,) arrays.
        The per-wavelength gathers are loop-invariant (ell is fixed per
        packet), so they leave the traversal loops.
        """
        ksca = jnp.asarray(self.kappasca)
        kext = jnp.asarray(self.kappaext)
        return ([ksca[h, ell] for h in range(self.ncomp)],
                [kext[h, ell] for h in range(self.ncomp)])

    def analytic_rows(self, pos, direction, mid, ksca_pk, kext_pk,
                      want_sca=True):
        """Per-segment (kappasca*rho, kappaext*rho) via analytic densities.

        pos (N,3), direction (N,3) in SI; mid (N,S) segment-midpoint ray
        parameters.  Evaluates each component's density_scaled at the
        midpoints — pure elementwise math, no gathers.  Returns (N, S)
        rows like rows_kappas, zero outside each geometry's support.

        Table mode: gathers the gridded per-cell densities at the midpoint
        cells instead (one rho_at row gather per component).
        """
        if getattr(self, "table", False):
            pmid = pos[:, None, :] + mid[..., None] * direction[:, None, :]
            cells = self.grid.locate_batched(pmid)
            safe = jnp.clip(cells, 0)
            valid = cells >= 0
            ksca = 0.0
            kext = 0.0
            for h in range(self.ncomp):
                rho_h = self.rho_at(h, safe)
                if want_sca:
                    ksca = ksca + ksca_pk[h][:, None] * rho_h
                kext = kext + kext_pk[h][:, None] * rho_h
            kext = jnp.where(valid, kext, 0.0)
            if not want_sca:
                return kext
            return jnp.where(valid, ksca, 0.0), kext
        invL = jnp.float32(1.0 / self.lscale)
        pos_s = pos * invL
        pmid_s = pos_s[:, None, :] + (mid * invL)[..., None] \
            * direction[:, None, :]
        mL3 = jnp.asarray(self._mass_over_L3)
        ksca = 0.0
        kext = 0.0
        for h, comp in enumerate(self.components):
            rho_p = comp.geometry.density_scaled(pmid_s, self.lscale)
            rho_h = mL3[h] * rho_p                      # kg/m^3
            if want_sca:
                ksca = ksca + ksca_pk[h][:, None] * rho_h
            kext = kext + kext_pk[h][:, None] * rho_h
        if not want_sca:
            return kext
        return ksca, kext

    def ksca_kext_from(self, cell, ksca_pk, kext_pk):
        """Like ksca_kext but with prefetched per-packet kappas."""
        safe = jnp.clip(cell, 0)
        ksca = 0.0
        kext = 0.0
        for h in range(self.ncomp):
            rho_h = self.rho_at(h, safe)
            ksca = ksca + ksca_pk[h] * rho_h
            kext = kext + kext_pk[h] * rho_h
        valid = cell >= 0
        return jnp.where(valid, ksca, 0.0), jnp.where(valid, kext, 0.0)

    def kapparho_ext_from(self, kext_pk):
        """kapparho closure with prefetched per-packet kappas."""
        def fn(cell):
            safe = jnp.clip(cell, 0)
            kr = 0.0
            for h in range(self.ncomp):
                kr = kr + kext_pk[h] * self.rho_at(h, safe)
            return jnp.where(cell >= 0, kr, 0.0)
        return fn

    def ksca_kext(self, cell, ell):
        """Per-packet (kappasca*rho, kappaext*rho) summed over components."""
        safe = jnp.clip(cell, 0)
        rho = jnp.asarray(self.rho)
        ksca_t = jnp.asarray(self.kappasca)
        kext_t = jnp.asarray(self.kappaext)
        ksca = 0.0
        kext = 0.0
        for h in range(self.ncomp):
            rho_h = rho[h, safe]
            ksca = ksca + ksca_t[h, ell] * rho_h
            kext = kext + kext_t[h, ell] * rho_h
        valid = cell >= 0
        return jnp.where(valid, ksca, 0.0), jnp.where(valid, kext, 0.0)

    def local_albedo(self, cell, ell):
        """Scattering albedo of the local dust mixture.

        ref: MonteCarloSimulation.cpp:497-515 ('difficult case'):
        albedo = sum_h ksca_h rho_h / sum_h kext_h rho_h.
        """
        ksca, kext = self.ksca_kext(cell, ell)
        return jnp.where(kext > 0, ksca / jnp.maximum(kext, 1e-30), 0.0)

    def _component_weights(self, cell, ell):
        """Per-component scattering weights kappasca_h * rho_h (list of arrays)."""
        safe = jnp.clip(cell, 0)
        ksca_t = jnp.asarray(self.kappasca)
        rho = jnp.asarray(self.rho)
        return [ksca_t[h, ell] * rho[h, safe]
                for h in range(self.ncomp)]

    def phase_value(self, cell, ell, cosalpha):
        """Density-weighted phase-function value of the local mixture.

        ref: MonteCarloSimulation.cpp:319-363 peeloffscattering — each
        component h is weighted by kappasca_h * rho_h.
        """
        if self.ncomp == 1:
            return self.components[0].mix.phase_function(ell, cosalpha)
        wv = self._component_weights(cell, ell)
        total = sum(wv)
        val = 0.0
        for h, w in enumerate(wv):
            val = val + w * self.components[h].mix.phase_function(ell, cosalpha)
        return jnp.where(total > 0, val / jnp.maximum(total, 1e-30), 0.0)

    def sample_scatter_g(self, key, cell, ell):
        """Asymmetry parameter of a randomly selected local component.

        ref: DustSystem::randomMixForPosition (DustSystem.cpp:879) +
        MonteCarloSimulation::simulatescattering — component h selected with
        probability ∝ kappasca_h * rho_h.
        """
        if self.ncomp == 1:
            return jnp.asarray(self.g)[0, ell]
        import jax
        wv = self._component_weights(cell, ell)
        total = sum(wv)
        u = jax.random.uniform(key, ell.shape) * jnp.maximum(total, 1e-30)
        g = jnp.asarray(self.g)[0, ell]
        acc = wv[0]
        for h in range(1, self.ncomp):
            g = jnp.where(u > acc, jnp.asarray(self.g)[h, ell], g)
            acc = acc + wv[h]
        return g
