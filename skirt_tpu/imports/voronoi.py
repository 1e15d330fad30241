"""Voronoi mesh import: cell-constant fields over an imported tessellation.

ref: SKIRTcore/VoronoiDustDistribution.hpp (BoxDustDistribution +
MeshDustComponent entries with densityIndex/densityFraction),
VoronoiMeshFile.hpp:20-80 (particle records = site coordinates + field
values, constant per Voronoi cell), VoronoiMeshAsciiFile.cpp (text rows,
coordinateUnits default 1 pc).

Batched re-design: the tessellation is built once (native exact clipping via
skirt_tpu.native, the Voro++ role) as a VoronoiGrid; imported fields become
cell-constant densities evaluated host-side with the grid's nearest-site
kd-tree, and photon launch positions are sampled by cell-mass CDF + in-cell
rejection — no per-photon mesh walks at setup.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import PC
from ..geometry.base import Geometry, array_namespace


def load_voronoi_mesh(path: str, coordinate_units: float = PC):
    """Read an ASCII Voronoi mesh file: rows `x y z field0 field1 ...`.

    Returns (sites [m], fields (N, Nfields) in file units).
    ref: VoronoiMeshAsciiFile.cpp.
    """
    data = np.loadtxt(path, comments="#", ndmin=2)
    if data.shape[1] < 3:
        raise ValueError("Voronoi mesh file needs at least x y z columns")
    sites = data[:, :3] * float(coordinate_units)
    fields = data[:, 3:]
    return sites, fields


class VoronoiMeshGeometry(Geometry):
    """Normalized cell-constant density over a prebuilt VoronoiGrid.

    `values` holds one density value per cell (file units); the geometry
    integrates to one, and `file_mass` exposes the raw integral
    (sum values*volumes, file-density x m^3) for absolute normalization.
    """

    dimension = 3

    def __init__(self, grid, values):
        vals = np.clip(np.asarray(values, np.float64).reshape(-1), 0.0, None)
        if vals.size != grid.ncells:
            raise ValueError("one field value per Voronoi cell required")
        self.grid = grid
        vols = grid.cell_volumes()
        masses = vals * vols
        total = float(masses.sum())
        if total <= 0:
            raise ValueError("imported Voronoi density field has zero mass")
        self.file_mass = total
        self._rho = vals / total                 # normalized density per cell
        self._cum = np.asarray(np.cumsum(masses) / total, np.float32)
        self._rho_dev = np.asarray(self._rho, np.float32)

    def density(self, pos):
        xp = array_namespace(pos)
        if xp is np:
            p = np.asarray(pos, np.float64).reshape(-1, 3)
            _, owner = self.grid._tree.query(p, workers=-1)
            rho = self._rho[owner]
            lo, hi = self.grid._lo, self.grid._hi
            inside = np.all((p >= lo) & (p <= hi), axis=1)
            return (rho * inside).reshape(np.shape(pos)[:-1])
        cells = self.grid.locate(pos)
        safe = jnp.maximum(cells, 0)
        return jnp.where(cells >= 0, jnp.asarray(self._rho_dev)[safe], 0.0)

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (n,), dtype=jnp.float32)
        cells = jnp.clip(jnp.searchsorted(jnp.asarray(self._cum), u,
                                          side="left"),
                         0, self.grid.ncells - 1)
        return self.grid.random_position_in_cell_dev(k2, cells)

    def _axis_sigma(self, axis: int) -> float:
        lo, hi = self.grid._lo, self.grid._hi
        t = np.linspace(lo[axis], hi[axis], 4097)
        line = np.zeros((t.size, 3))
        line[:, axis] = t
        return float(np.trapezoid(self.density(line), t))

    def sigma_x(self) -> float:
        return self._axis_sigma(0)

    def sigma_y(self) -> float:
        return self._axis_sigma(1)

    def sigma_z(self) -> float:
        return self._axis_sigma(2)


def voronoi_stellar_components(grid, fields, wavelength_grid, family,
                               density_index: int = 0,
                               metallicity_index: int = 1,
                               age_index: int = 2, nbins: int = 8):
    """Stellar components imported from a Voronoi mesh data file.

    ref: SKIRTcore/VoronoiStellarComp.cpp:40-90 — per cell m: mass
    M = rho_m [Msun/pc^3] * V_m / pc^3, SED = family(M, Z_m, age_m);
    the reference samples cells from per-wavelength luminosity CDFs.
    Batched re-design: spectral-hardness bins over cells
    (sources.stellar.mesh_stellar_components), each a cell-weighted
    VoronoiMeshGeometry component.
    """
    from ..sources.stellar import mesh_stellar_components

    f = np.asarray(fields, np.float64)
    V = grid.cell_volumes()
    M = np.clip(f[:, density_index], 0.0, None) * V / PC ** 3
    params = np.stack([M, f[:, metallicity_index], f[:, age_index]], axis=1)
    L = family.luminosities(wavelength_grid, params)

    def make_geometry(weights):
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = np.where(V > 0, weights / V, 0.0)
        return VoronoiMeshGeometry(grid, vals)

    return mesh_stellar_components(make_geometry, L, wavelength_grid,
                                   nbins=nbins)
