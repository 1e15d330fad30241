"""Adaptive-mesh (AMR) snapshot import.

ref: SKIRTcore/AdaptiveMesh.hpp:23-46 + AdaptiveMeshAsciiFile.cpp — the
ASCII format is a depth-first tree dump: a line starting with '!' declares
a non-leaf node subdividing into nx ny nz children; other lines are leaf
cells carrying field values (e.g. density).  The reference builds a
recursive linear-grid tree; here leaves are flattened to boxes + values,
with mass-CDF sampling and box-lookup density (binary search per level is
replaced by a KDTree over leaf centers + containment check).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

from .. import rng
from ..geometry.base import Geometry, array_namespace


def load_amr_ascii(path: str, extent, density_column: int | None = 0):
    """Parse the reference's AMR ASCII format into leaf boxes + values.

    extent: (xmin, ymin, zmin, xmax, ymax, zmax) of the domain.
    Returns (lo (N,3), hi (N,3), values (N,)); density_column=None keeps
    ALL value columns (N, Ncols) — e.g. for stellar imports carrying
    (density, metallicity, age).
    """
    tokens = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            tokens.append(s)

    extent = np.asarray(extent, dtype=np.float64)
    leaves_lo, leaves_hi, values = [], [], []
    it = iter(tokens)

    def parse_node(lo, hi):
        try:
            line = next(it)
        except StopIteration:
            raise ValueError("truncated AMR file")
        if line.startswith("!"):
            parts = line[1:].split()
            nx, ny, nz = int(parts[0]), int(parts[1]), int(parts[2])
            xs = np.linspace(lo[0], hi[0], nx + 1)
            ys = np.linspace(lo[1], hi[1], ny + 1)
            zs = np.linspace(lo[2], hi[2], nz + 1)
            # depth-first, x fastest (ref: AdaptiveMesh node ordering)
            for k in range(nz):
                for j in range(ny):
                    for i in range(nx):
                        parse_node(np.array([xs[i], ys[j], zs[k]]),
                                   np.array([xs[i + 1], ys[j + 1], zs[k + 1]]))
        else:
            cols = [float(c) for c in line.split()]
            leaves_lo.append(lo.copy())
            leaves_hi.append(hi.copy())
            if density_column is None:
                values.append(cols)
            else:
                values.append(cols[density_column] if cols else 0.0)

    parse_node(extent[:3], extent[3:])
    return (np.asarray(leaves_lo), np.asarray(leaves_hi),
            np.asarray(values))


def load_amr_amrvac(path: str, extent, levelone=(1, 1, 1),
                    density_column: int | None = 0):
    """Parse an MPI-AMRVAC binary snapshot into leaf boxes + values.
    density_column=None keeps all variables: values (N, nvars).

    ref: SKIRTcore/AdaptiveMeshAmrvacFile.cpp — native-endian binary:
    nleafs data blocks of (ncells*nvars) doubles (variable-major, cells
    x-fastest within a block), then the depth-first 'forest' of int32
    leaf flags (one tree per coarsest-level block, x-fastest), then a
    footer [block nx: ndims ints][eqpars: pars doubles][nleafs, levmax,
    ndim, ndir, nw, pars: ints][it: int][time: double].

    levelone: number of CELLS per axis at the coarsest level (the ski
    properties levelOneX/Y/Z); must be a multiple of the block size.
    Returns (lo (N,3), hi (N,3), values (N,)) like load_amr_ascii.
    """
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    eof = len(raw)
    nleafs, levmax, ndims, ndir, nvars, pars = struct.unpack_from(
        "<6i", raw, eof - 7 * 4 - 8)
    off = eof - 7 * 4 - 8 - ndims * 4 - pars * 8
    nx = [1, 1, 1]
    for i in range(ndims):
        nx[i] = struct.unpack_from("<i", raw, off + 4 * i)[0]
    ng = [0, 0, 0]
    for i in range(3):
        if levelone[i] % nx[i]:
            raise ValueError("number of cells at the coarsest level must "
                             "be a multiple of the block size "
                             f"(axis {i}: {levelone[i]} vs {nx[i]})")
        ng[i] = levelone[i] // nx[i]
    nr = [2 if i < ndims else 1 for i in range(3)]
    ncells = nx[0] * nx[1] * nx[2]
    blocksize = ncells * nvars * 8

    # forest flags follow the data blocks; exactly nleafs true values
    forest = []
    pos = nleafs * blocksize
    trues = 0
    while trues < nleafs:
        v = struct.unpack_from("<i", raw, pos)[0]
        pos += 4
        forest.append(bool(v))
        trues += bool(v)

    blocks = np.frombuffer(raw, "<f8", count=nleafs * ncells * nvars) \
        .reshape(nleafs, nvars, ncells)

    extent = np.asarray(extent, np.float64)
    leaves_lo, leaves_hi, values = [], [], []
    state = {"fi": 0, "bi": 0}

    def emit_block(lo, hi):
        b = state["bi"]
        state["bi"] += 1
        xs = np.linspace(lo[0], hi[0], nx[0] + 1)
        ys = np.linspace(lo[1], hi[1], nx[1] + 1)
        zs = np.linspace(lo[2], hi[2], nx[2] + 1)
        vals = (blocks[b].T if density_column is None
                else blocks[b, density_column])
        c = 0
        for k in range(nx[2]):          # cells run x-fastest (Fortran)
            for j in range(nx[1]):
                for i in range(nx[0]):
                    leaves_lo.append([xs[i], ys[j], zs[k]])
                    leaves_hi.append([xs[i + 1], ys[j + 1], zs[k + 1]])
                    values.append(vals[c])
                    c += 1

    def walk(lo, hi):
        leaf = forest[state["fi"]]
        state["fi"] += 1
        if leaf:
            emit_block(lo, hi)
            return
        xs = np.linspace(lo[0], hi[0], nr[0] + 1)
        ys = np.linspace(lo[1], hi[1], nr[1] + 1)
        zs = np.linspace(lo[2], hi[2], nr[2] + 1)
        for k in range(nr[2]):
            for j in range(nr[1]):
                for i in range(nr[0]):
                    walk(np.array([xs[i], ys[j], zs[k]]),
                         np.array([xs[i + 1], ys[j + 1], zs[k + 1]]))

    lo0, hi0 = extent[:3], extent[3:]
    gx = np.linspace(lo0[0], hi0[0], ng[0] + 1)
    gy = np.linspace(lo0[1], hi0[1], ng[1] + 1)
    gz = np.linspace(lo0[2], hi0[2], ng[2] + 1)
    for k in range(ng[2]):
        for j in range(ng[1]):
            for i in range(ng[0]):
                walk(np.array([gx[i], gy[j], gz[k]]),
                     np.array([gx[i + 1], gy[j + 1], gz[k + 1]]))
    if state["bi"] != nleafs:
        raise ValueError(f"AMRVAC walk consumed {state['bi']} blocks, "
                         f"file declares {nleafs}")
    return (np.asarray(leaves_lo), np.asarray(leaves_hi),
            np.asarray(values))


def amrvac_to_ascii_lines(path: str, levelone=(1, 1, 1)):
    """Synthesize the ASCII tree walk ('!' nodes + value rows) from an
    AMRVAC snapshot, for consumers of the line format (AdaptiveMeshGrid).

    The AMRVAC structure maps exactly: the coarsest level is a
    '! ngx ngy ngz' node, refinements are '! 2 2 2' (per refined dim),
    and a leaf block is a '! nx ny nz' node of value rows (all
    variables as columns).
    """
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    eof = len(raw)
    nleafs, levmax, ndims, ndir, nvars, pars = struct.unpack_from(
        "<6i", raw, eof - 7 * 4 - 8)
    off = eof - 7 * 4 - 8 - ndims * 4 - pars * 8
    nx = [1, 1, 1]
    for i in range(ndims):
        nx[i] = struct.unpack_from("<i", raw, off + 4 * i)[0]
    ng = [levelone[i] // nx[i] for i in range(3)]
    for i in range(3):
        if levelone[i] % nx[i]:
            raise ValueError("levelone must be a multiple of block size")
    nr = [2 if i < ndims else 1 for i in range(3)]
    ncells = nx[0] * nx[1] * nx[2]
    blocksize = ncells * nvars * 8

    forest = []
    pos = nleafs * blocksize
    trues = 0
    while trues < nleafs:
        v = struct.unpack_from("<i", raw, pos)[0]
        pos += 4
        forest.append(bool(v))
        trues += bool(v)
    blocks = np.frombuffer(raw, "<f8", count=nleafs * ncells * nvars) \
        .reshape(nleafs, nvars, ncells)

    out = [f"! {ng[0]} {ng[1]} {ng[2]}"]
    state = {"fi": 0, "bi": 0}

    def walk():
        leaf = forest[state["fi"]]
        state["fi"] += 1
        if leaf:
            b = state["bi"]
            state["bi"] += 1
            out.append(f"! {nx[0]} {nx[1]} {nx[2]}")
            for c in range(ncells):
                out.append(" ".join(repr(float(blocks[b, g, c]))
                                    for g in range(nvars)))
        else:
            out.append(f"! {nr[0]} {nr[1]} {nr[2]}")
            for _ in range(nr[0] * nr[1] * nr[2]):
                walk()

    for _ in range(ng[0] * ng[1] * ng[2]):
        walk()
    return out


class AdaptiveMeshGeometry(Geometry):
    """Normalized density geometry from AMR leaf cells.

    ref: AdaptiveMeshGeometry.cpp / AdaptiveMeshDustDistribution.cpp.
    """

    dimension = 3

    def __init__(self, lo: np.ndarray, hi: np.ndarray, values: np.ndarray):
        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)
        vals = np.clip(np.asarray(values, dtype=np.float64), 0.0, None)
        self.volumes = np.prod(self.hi - self.lo, axis=1)
        masses = vals * self.volumes
        total = masses.sum()
        if total <= 0:
            raise ValueError("AMR snapshot has zero total mass")
        self.rho = vals / total          # normalized to unit mass
        self._mass_cdf = np.concatenate([[0.0], np.cumsum(masses / total)])
        centers = 0.5 * (self.lo + self.hi)
        self._tree = cKDTree(centers)
        self._maxdiag = float(np.linalg.norm(self.hi - self.lo, axis=1).max())
        self._lo_dev = np.asarray(self.lo, np.float32)
        self._hi_dev = np.asarray(self.hi, np.float32)
        self._cdf_dev = np.asarray(self._mass_cdf, np.float32)

    @classmethod
    def from_file(cls, path: str, extent, density_column: int = 0):
        return cls(*load_amr_ascii(path, extent, density_column))

    @classmethod
    def from_amrvac(cls, path: str, extent, levelone=(1, 1, 1),
                    density_column: int = 0):
        """ref: AdaptiveMeshAmrvacFile (the second AMR import format)."""
        return cls(*load_amr_amrvac(path, extent, levelone, density_column))

    def _leaf_of(self, pts: np.ndarray) -> np.ndarray:
        """Leaf index containing each point, -1 outside (host)."""
        k = min(8, self.lo.shape[0])
        _, cand = self._tree.query(pts, k=k, workers=-1)
        cand = np.atleast_2d(cand)
        out = np.full(pts.shape[0], -1, dtype=np.int64)
        for col in range(cand.shape[1]):
            idx = cand[:, col]
            inside = np.all((pts >= self.lo[idx]) & (pts <= self.hi[idx]),
                            axis=1)
            out = np.where((out < 0) & inside, idx, out)
        return out

    def density(self, pos):
        xp = array_namespace(pos)
        if xp is not np:
            raise NotImplementedError(
                "AMR density is evaluated host-side at setup")
        pts = np.atleast_2d(np.asarray(pos, dtype=np.float64))
        leaf = self._leaf_of(pts)
        rho = np.where(leaf >= 0, self.rho[np.clip(leaf, 0, None)], 0.0)
        return rho.reshape(np.asarray(pos).shape[:-1])

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        u = rng.uniform_open(k1, (n,))
        lo_d = jnp.asarray(self._lo_dev)
        hi_d = jnp.asarray(self._hi_dev)
        i = jnp.clip(jnp.searchsorted(jnp.asarray(self._cdf_dev), u,
                                      side="right") - 1,
                     0, self.lo.shape[0] - 1)
        w = jax.random.uniform(k2, (n, 3), dtype=jnp.float32)
        return lo_d[i] + w * (hi_d[i] - lo_d[i])

    def sigma_x(self) -> float:
        span_lo = self.lo.min(axis=0)
        span_hi = self.hi.max(axis=0)
        x = np.linspace(span_lo[0], span_hi[0], 4096)
        pts = np.zeros((x.size, 3))
        pts[:, 0] = x
        return float(np.trapezoid(self.density(pts), x))

    sigma_y = sigma_x
    sigma_z = sigma_x


class SphericalAdaptiveMeshGeometry(Geometry):
    """AMR snapshot interpreted in spherical coordinates (r, theta, phi).

    ref: SKIRTcore/SphericalAdaptiveMesh.cpp — the same adaptive-mesh
    file walks a domain box (rin, 0, 0)-(rout, pi, 2 pi); leaf "boxes"
    are spherical shell sectors with volume (r2^3 - r1^3)/3 *
    (cos t1 - cos t2) * (phi2 - phi1).
    """

    dimension = 3

    def __init__(self, lo: np.ndarray, hi: np.ndarray, values: np.ndarray):
        self.lo = np.asarray(lo, np.float64)     # (r, theta, phi) corners
        self.hi = np.asarray(hi, np.float64)
        vals = np.clip(np.asarray(values, np.float64), 0.0, None)
        r1, r2 = self.lo[:, 0], self.hi[:, 0]
        t1, t2 = self.lo[:, 1], self.hi[:, 1]
        p1, p2 = self.lo[:, 2], self.hi[:, 2]
        self.volumes = ((r2 ** 3 - r1 ** 3) / 3.0
                        * (np.cos(t1) - np.cos(t2)) * (p2 - p1))
        masses = vals * self.volumes
        total = masses.sum()
        if total <= 0:
            raise ValueError("spherical AMR snapshot has zero total mass")
        self.rho = vals / total
        self._mass_cdf = np.concatenate([[0.0],
                                         np.cumsum(masses / total)])
        centers = 0.5 * (self.lo + self.hi)
        self._tree = cKDTree(centers)
        # device tables for sampling
        self._lo_dev = np.asarray(self.lo, np.float32)
        self._hi_dev = np.asarray(self.hi, np.float32)
        self._cdf_dev = np.asarray(self._mass_cdf, np.float32)

    @classmethod
    def from_file(cls, path: str, rin: float, rout: float,
                  density_column: int = 0):
        extent = (rin, 0.0, 0.0, rout, np.pi, 2.0 * np.pi)
        return cls(*load_amr_ascii(path, extent, density_column))

    @classmethod
    def from_amrvac(cls, path: str, rin: float, rout: float,
                    levelone=(1, 1, 1), density_column: int = 0):
        extent = (rin, 0.0, 0.0, rout, np.pi, 2.0 * np.pi)
        return cls(*load_amr_amrvac(path, extent, levelone, density_column))

    def _spherical(self, pts):
        r = np.linalg.norm(pts, axis=-1)
        theta = np.arccos(np.clip(
            np.divide(pts[..., 2], np.maximum(r, 1e-300)), -1.0, 1.0))
        phi = np.arctan2(pts[..., 1], pts[..., 0])
        phi = np.where(phi < 0, phi + 2.0 * np.pi, phi)
        return np.stack([r, theta, phi], axis=-1)

    def _leaf_of(self, sph):
        k = min(8, self.lo.shape[0])
        _, cand = self._tree.query(sph, k=k, workers=-1)
        cand = np.atleast_2d(cand)
        out = np.full(sph.shape[0], -1, dtype=np.int64)
        for col in range(cand.shape[1]):
            idx = cand[:, col]
            inside = np.all((sph >= self.lo[idx]) & (sph <= self.hi[idx]),
                            axis=1)
            out = np.where((out < 0) & inside, idx, out)
        return out

    def density(self, pos):
        xp = array_namespace(pos)
        if xp is not np:
            raise NotImplementedError(
                "spherical AMR density is evaluated host-side at setup")
        pts = np.atleast_2d(np.asarray(pos, np.float64))
        leaf = self._leaf_of(self._spherical(pts))
        rho = np.where(leaf >= 0, self.rho[np.clip(leaf, 0, None)], 0.0)
        return rho.reshape(np.asarray(pos).shape[:-1])

    def generate_position(self, key, n: int):
        k1, k2 = jax.random.split(key)
        u = rng.uniform_open(k1, (n,))
        i = jnp.clip(jnp.searchsorted(jnp.asarray(self._cdf_dev), u,
                                      side="right") - 1,
                     0, self.lo.shape[0] - 1)
        lo_d = jnp.asarray(self._lo_dev)[i]
        hi_d = jnp.asarray(self._hi_dev)[i]
        w = jax.random.uniform(k2, (n, 3), dtype=jnp.float32)
        # uniform density within the sector: r ~ r^2 dr, cos(theta)
        # uniform, phi uniform
        r = (lo_d[:, 0] ** 3
             + w[:, 0] * (hi_d[:, 0] ** 3 - lo_d[:, 0] ** 3)) ** (1.0 / 3.0)
        c1 = jnp.cos(lo_d[:, 1])
        c2 = jnp.cos(hi_d[:, 1])
        ct = c1 + w[:, 1] * (c2 - c1)
        st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
        phi = lo_d[:, 2] + w[:, 2] * (hi_d[:, 2] - lo_d[:, 2])
        return jnp.stack([r * st * jnp.cos(phi), r * st * jnp.sin(phi),
                          r * ct], axis=-1)

    def sigma_x(self) -> float:
        rout = float(self.hi[:, 0].max())
        x = np.linspace(-rout, rout, 4096)
        pts = np.zeros((x.size, 3))
        pts[:, 0] = x
        return float(np.trapezoid(self.density(pts), x))

    sigma_y = sigma_x
    sigma_z = sigma_x


def amr_stellar_components(lo, hi, fields, wavelength_grid, family,
                           density_index: int = 0,
                           metallicity_index: int = 1,
                           age_index: int = 2, nbins: int = 8):
    """Stellar components imported from an adaptive-mesh data file.

    ref: SKIRTcore/AdaptiveMeshStellarComp.cpp — per leaf cell: mass
    M = rho [Msun/pc^3] * V / pc^3, SED = family(M, Z, age), cells
    sampled from per-wavelength luminosity CDFs.  The batched design mirrors
    voronoi_stellar_components (spectral-hardness bins over leaf-
    weighted AdaptiveMeshGeometry components).

    fields: (Nleaves, Ncols) — all value columns of the mesh file.
    """
    from ..constants import PC
    from ..sources.stellar import mesh_stellar_components

    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    f = np.asarray(fields, np.float64)
    V = np.prod(hi - lo, axis=1)
    M = np.clip(f[:, density_index], 0.0, None) * V / PC ** 3
    params = np.stack([M, f[:, metallicity_index], f[:, age_index]], axis=1)
    L = family.luminosities(wavelength_grid, params)

    def make_geometry(weights):
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = np.where(V > 0, weights / V, 0.0)
        return AdaptiveMeshGeometry(lo, hi, vals)

    return mesh_stellar_components(make_geometry, L, wavelength_grid,
                                   nbins=nbins)
