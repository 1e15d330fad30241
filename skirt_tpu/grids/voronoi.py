"""Unstructured Voronoi dust grid.

ref: SKIRTcore/VoronoiDustGrid.cpp:37-230 and VoronoiMesh.cpp (Camps et al.
2013) — Voro++ cell construction with per-cell neighbor lists, block lists
+ kd-trees for point location (:367-393, cellIndex :512-543), and
nearest-bisector-plane traversal (:749-844).

Batched re-design: construction is host-side (scipy.spatial Voronoi/cKDTree —
the reference also builds at setup time); neighbor lists are frozen into a
*padded dense* (Ncells, K) matrix so the traversal step is a fixed-shape
gather + K-way minimum over bisector-plane crossings — no pointer chasing.
Cell volumes, bounding boxes and mean densities come from one stratified
MC pass (the reference samples 100 points/cell for densities too,
DustSystem.cpp:41).  Intersection math runs in domain-scaled units
(float32 overflow, see cylinder2d.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial import Voronoi, cKDTree


class VoronoiState(NamedTuple):
    cell: jnp.ndarray    # current cell (site) index, -1 outside
    t: jnp.ndarray       # ray parameter [m]


_BIG = 3.4e38  # float32 max-ish sentinel (plain float: no backend init at import)


class VoronoiGrid:
    dimension = 3
    voxelize_exact = False     # nearest-site rasterization approximates

    def __init__(self, sites: np.ndarray, extent, *,
                 volume_samples: int = 64, seed: int = 31337,
                 use_native: bool = True):
        """sites: (N, 3) generating points [m]; extent: domain box
        (xmin, ymin, zmin, xmax, ymax, zmax).  volume_samples: MC samples
        per cell (on average) for bboxes/density hooks.

        Cell volumes/centroids/neighbors come from the native C++ exact
        clipping builder (skirt_tpu.native, the Voro++ role) when
        available, else from scipy ridges + MC volumes.
        """
        self.extent = np.asarray(extent, dtype=np.float64)
        lo, hi = self.extent[:3], self.extent[3:]
        sites = np.asarray(sites, dtype=np.float64)
        inside = np.all((sites >= lo) & (sites <= hi), axis=1)
        if not np.all(inside):
            raise ValueError("all sites must lie inside the domain extent")
        self.sites64 = sites
        self.ncells = sites.shape[0]
        self.scale = float(np.max(hi - lo))
        self._lo = lo
        self._hi = hi

        # --- neighbor adjacency + exact volumes ---------------------------
        native_out = None
        if use_native:
            from .. import native as native_mod
            native_out = native_mod.voronoi_cells(sites, self.extent)
        self.used_native = native_out is not None
        if native_out is not None:
            volumes, centroids, nbr_data, nbr_off = native_out
            nbr_lists = [list(map(int, nbr_data[nbr_off[i]:nbr_off[i + 1]]))
                         for i in range(self.ncells)]
            self.volumes64 = volumes
            self.centroids64 = centroids
        else:
            vor = Voronoi(sites)
            nbr_lists = [[] for _ in range(self.ncells)]
            for a, b in vor.ridge_points:
                nbr_lists[a].append(int(b))
                nbr_lists[b].append(int(a))
            self.volumes64 = None  # filled by the MC pass below
            self.centroids64 = sites
        kmax = max(max(len(v) for v in nbr_lists), 1)
        nbrs = np.full((self.ncells, kmax), -1, dtype=np.int64)
        for i, v in enumerate(nbr_lists):
            uniq = sorted(set(v))[:kmax]
            nbrs[i, :len(uniq)] = uniq
        self.kmax = kmax
        self.nbrs64 = nbrs

        # --- MC pass: bounding boxes + density hooks (+ volumes fallback) -
        rng_np = np.random.default_rng(seed)
        self._tree = cKDTree(sites)
        nsamp = int(volume_samples) * self.ncells
        pts = rng_np.uniform(lo, hi, size=(nsamp, 3))
        _, owner = self._tree.query(pts, workers=-1)
        box_vol = float(np.prod(hi - lo))
        if self.volumes64 is None:
            counts = np.bincount(owner, minlength=self.ncells).astype(np.float64)
            self.volumes64 = counts / nsamp * box_vol
        self._mc_pts = pts
        self._mc_owner = owner

        # cell bounding boxes from the MC samples (padded by the mean
        # sample spacing) for in-cell position sampling
        bb_lo = np.tile(sites, 1).copy()
        bb_hi = np.tile(sites, 1).copy()
        np.minimum.at(bb_lo, owner, pts)
        np.maximum.at(bb_hi, owner, pts)
        pad = (box_vol / nsamp) ** (1.0 / 3.0)
        bb_lo = np.maximum(bb_lo - pad, lo)
        bb_hi = np.minimum(bb_hi + pad, hi)
        self.bb_lo64 = bb_lo
        self.bb_hi64 = bb_hi

        # --- numpy tables exposed via jnp-wrapping properties
        inv = 1.0 / self.scale
        self._sites_np = np.asarray(sites * inv, np.float32)
        self._nbrs_np = np.asarray(nbrs, np.int32)
        self._lo_np = np.asarray(lo * inv, np.float32)
        self._hi_np = np.asarray(hi * inv, np.float32)
        self._bb_lo_np = np.asarray(bb_lo * inv, np.float32)
        self._bb_hi_np = np.asarray(bb_hi * inv, np.float32)
        self.max_steps = 8 * int(np.ceil(self.ncells ** (1.0 / 3.0))) + 16

    @property
    def sites(self):
        return jnp.asarray(self._sites_np)

    @property
    def nbrs(self):
        return jnp.asarray(self._nbrs_np)

    @property
    def lo(self):
        return jnp.asarray(self._lo_np)

    @property
    def hi(self):
        return jnp.asarray(self._hi_np)

    @property
    def bb_lo(self):
        return jnp.asarray(self._bb_lo_np)

    @property
    def bb_hi(self):
        return jnp.asarray(self._bb_hi_np)

    # -- host metadata -----------------------------------------------------

    def voxelize(self, max_voxels: int = 1 << 24,
                 resolution: int | None = None):
        """APPROXIMATE uniform-voxel view: nearest-site rasterization.

        Unlike tree grids (exact: leaves are voxel unions), Voronoi cell
        walls cut voxels, so the voxel field differs from the exact
        tessellation at the voxel scale — an additional discretization on
        top of the MC-sampled cell densities the reference already
        accepts (DustSystem.cpp:41 _Nrandom=100).  Default resolution
        targets ~8 voxels per cell per axis, capped by max_voxels.
        Returns (CartesianGrid, cell_of_voxel).  Opt-in
        (LifecycleOptions.voxelize=True): the driver engages it only on
        request, and tallies still fold to Voronoi cells.
        """
        from scipy.spatial import cKDTree

        from .cartesian import CartesianGrid

        lo, hi = self._lo, self._hi
        if resolution is None:
            resolution = int(min(8.0 * self.ncells ** (1.0 / 3.0),
                                 np.floor(max_voxels ** (1.0 / 3.0))))
        n = max(int(resolution), 8)
        if n ** 3 > max_voxels:
            n = int(np.floor(max_voxels ** (1.0 / 3.0)))
        axes = [np.linspace(lo[a], hi[a], n + 1) for a in range(3)]
        centers = [0.5 * (b[:-1] + b[1:]) for b in axes]
        X, Y, Z = np.meshgrid(*centers, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
        tree = cKDTree(self.sites64)
        _, cell_of = tree.query(pts, workers=-1)
        return (CartesianGrid(axes[0], axes[1], axes[2]),
                cell_of.astype(np.int32))

    def bounding_box(self):
        return tuple(self.extent)

    def cell_volumes(self) -> np.ndarray:
        return self.volumes64

    def cell_centers(self) -> np.ndarray:
        return self.sites64

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        """Host-side in-cell sampling by nearest-site rejection."""
        out = np.empty((cells.size, 3))
        pending = np.arange(cells.size)
        for _ in range(200):
            if pending.size == 0:
                break
            c = cells[pending]
            u = rng_np.uniform(size=(pending.size, 3))
            p = self.bb_lo64[c] + u * (self.bb_hi64[c] - self.bb_lo64[c])
            _, owner = self._tree.query(p, workers=-1)
            ok = owner == c
            out[pending[ok]] = p[ok]
            pending = pending[~ok]
        if pending.size:
            out[pending] = self.sites64[cells[pending]]
        return out

    def sample_cell_densities(self, density_fn) -> np.ndarray:
        """Mean density per cell from the construction-time MC samples."""
        rho = np.asarray(density_fn(self._mc_pts))
        sums = np.zeros(self.ncells)
        np.add.at(sums, self._mc_owner, rho)
        counts = np.bincount(self._mc_owner, minlength=self.ncells)
        return sums / np.maximum(counts, 1)

    # -- device-side -------------------------------------------------------

    def _scaled(self, pos):
        return pos * jnp.float32(1.0 / self.scale)

    # site-count threshold between the two point-location schemes: below,
    # a matmul distance scan (zero gathers, traffic N*C*8 bytes, cost
    # linear in C); above, the row-flat block-candidate tables (ONE row
    # gather/point, independent of C).  The scan remains only for small
    # meshes where the table build isn't worth it.
    _SCAN_MAX_SITES = 2048

    def nearest_site(self, p_scaled):
        """Nearest site index for scaled points (..., 3) — exact.

        ref: VoronoiMesh::cellIndex (VoronoiMesh.cpp:512-543) — the
        reference walks nb^3 block lists with per-block kd-trees.  Device
        re-design: for small meshes a matmul distance scan (argmin of
        |s|^2 - 2 p.s over site chunks — a matmul, no gathers); for large
        meshes precomputed per-block candidate lists (block of p is
        arithmetic; candidates are the sites within dnn(center) + 2r of
        the block center, which provably contains the nearest site of
        every point in the block), so lookups cost K gathers regardless
        of the site count.
        """
        if self.ncells <= self._SCAN_MAX_SITES:
            return self._nearest_scan(p_scaled)
        self._ensure_blocks()
        if self._blk_flat_np is not None:
            return self._nearest_blocks(p_scaled)
        # block-candidate table over budget (import-scale meshes): the
        # neighbor-walk locate is exact at O(ncells * kmax) memory
        return self._nearest_walk(p_scaled)

    def _nearest_scan(self, p):
        shape = p.shape[:-1]
        p2 = p.reshape(-1, 3)
        chunk = 512
        npad = (-self.ncells) % chunk
        sites_np = np.concatenate(
            [self._sites_np, np.full((npad, 3), 1e9, np.float32)], axis=0)
        s2_np = np.sum(sites_np.astype(np.float64) ** 2,
                       axis=-1).astype(np.float32)
        nchunks = sites_np.shape[0] // chunk
        sites_c = jnp.asarray(sites_np.reshape(nchunks, chunk, 3))
        s2_c = jnp.asarray(s2_np.reshape(nchunks, chunk))
        offs = jnp.arange(nchunks, dtype=jnp.int32) * chunk

        def body(carry, inp):
            best_d, best_i = carry
            sc, s2c, off = inp
            # d + |p|^2 = |s|^2 - 2 p.s: the |p|^2 term is constant per
            # point and cancels in the argmin.  HIGHEST: a default
            # float32 product may run in TF32 on the GPU, which would
            # misassign near-bisector points.
            d = s2c[None, :] - 2.0 * jax.lax.dot_general(
                p2, sc, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            i = jnp.argmin(d, axis=1).astype(jnp.int32)
            dmin = jnp.min(d, axis=1)
            better = dmin < best_d
            return (jnp.where(better, dmin, best_d),
                    jnp.where(better, off + i, best_i)), None

        init = (jnp.full((p2.shape[0],), jnp.inf, jnp.float32),
                jnp.zeros((p2.shape[0],), jnp.int32))
        (_, best_i), _ = jax.lax.scan(body, init, (sites_c, s2_c, offs))
        return best_i.reshape(shape)

    def _ensure_blocks(self):
        """Lazy host-side build of the per-block candidate tables.

        Correctness bound: for a block with center c and half-diagonal r,
        any point p in the block has |p - c| <= r, so its nearest site is
        within dnn(c) + r of p and hence within dnn(c) + 2r of c; the
        candidate list "all sites within dnn(c) + 2r of c" therefore
        contains the true nearest site of every point in the block.
        """
        if hasattr(self, "_blk_flat_np"):
            return
        # Finer blocks than sites (ref uses nb = 3 N^(1/3) with per-block
        # kd-trees, VoronoiMesh.cpp:314): the block's candidate-ball
        # radius is dnn + O(block size) while dnn stays at the SITE
        # spacing, so smaller blocks shrink K — the width of the single
        # row gather a locate costs.  The candidate table is baked as one
        # flat f32 row per block, [X(K) | Y(K) | Z(K) | I(K)]: a locate
        # is then ONE contiguous 2D row gather + an elementwise distance
        # argmin, vs ~K dependent element gathers for an index-only
        # table.
        if self.ncells >= (1 << 24):   # f32 can't hold the site index
            # without the table every locate falls back to the
            # O(N)-per-point distance scan — a severe perf cliff on giant
            # meshes; say so out loud (ADVICE r4 fix)
            import warnings
            warnings.warn(
                f"{type(self).__name__}: {self.ncells} sites exceed the "
                "f32 index range of the block-candidate table; point "
                "location falls back to the O(N)-per-point distance "
                "scan (expect a large slowdown — split the import or "
                "use the voxelized view)")
            self._blk_flat_np = None
            return
        # the table is baked into the program as a literal, so keep it
        # well under a few hundred MB; coarser blocks trade K for row
        # count
        budget_bytes = 96 << 20
        lo, hi = self._lo, self._hi
        for mult in (3.0, 2.0, 1.5, 1.0, 0.75):
            nb = int(np.clip(round(mult * self.ncells ** (1.0 / 3.0)),
                             2, 256))
            bsize = (hi - lo) / nb
            ax = [lo[k] + (np.arange(nb) + 0.5) * bsize[k]
                  for k in range(3)]
            centers = np.stack(np.meshgrid(*ax, indexing="ij"),
                               axis=-1).reshape(-1, 3)
            r = 0.5 * float(np.linalg.norm(bsize))
            # bound: for p in the block, the nearest site is within
            # min over the block corners c of (dnn(c) + |p - c|) <=
            # min_c dnn(c) + 2r; a site can be the answer only if it
            # lies within that of p, i.e. within min_c dnn(c) + 3r of
            # the center
            offs = np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3),
                                        indexing="ij"),
                            axis=-1).reshape(-1, 3)
            corners = (centers[:, None, :]
                       + offs[None, :, :] * bsize[None, None, :])
            dcorn, _ = self._tree.query(corners.reshape(-1, 3), workers=-1)
            dnn_min = dcorn.reshape(-1, 8).min(axis=1)
            dcent, _ = self._tree.query(centers, workers=-1)
            # two valid bounds, take the tighter per block: from the
            # center c, dnn(p) <= dnn(c) + |p-c| <= dnn(c) + r, so the
            # nearest site lies within dnn(c) + 2r of c; from the
            # corners, within min_corner dnn + 3r of c
            radius = np.minimum(dcent + 2.0 * r, dnn_min + 3.0 * r)
            counts = self._tree.query_ball_point(centers, radius,
                                                 workers=-1,
                                                 return_length=True)
            # pad K so the 4K-wide row is lane-aligned (multiple of 128)
            kc = max(int(np.max(counts)), 1)
            kpad = -(-kc // 32) * 32
            if nb ** 3 * 4 * kpad * 4 <= budget_bytes:
                break
        else:
            import warnings
            warnings.warn(
                f"VoronoiGrid: block-candidate table exceeds the "
                f"{budget_bytes >> 20} MB budget at every block "
                "resolution (clustered sites); falling back to the matmul "
                "distance scan for point location")
            self._blk_flat_np = None
            return
        cand = self._tree.query_ball_point(centers, radius, workers=-1)
        flat = np.empty((nb ** 3, 4 * kpad), np.float32)
        flat[:, 0 * kpad:3 * kpad] = 1e9    # pad coords: never nearest
        flat[:, 3 * kpad:] = 0.0
        sites = self._sites_np              # scaled f32 coordinates
        for i, c in enumerate(cand):
            n = len(c)
            flat[i, 0 * kpad:0 * kpad + n] = sites[c, 0]
            flat[i, 1 * kpad:1 * kpad + n] = sites[c, 1]
            flat[i, 2 * kpad:2 * kpad + n] = sites[c, 2]
            flat[i, 3 * kpad:3 * kpad + n] = np.asarray(c, np.float32)
        self._blk_nb = nb
        self._blk_k = kpad
        # host (numpy) table, inlined as an HLO literal — hence the byte
        # budget above
        self._blk_flat_np = flat
        inv = 1.0 / self.scale
        self._blk_lo_np = np.asarray(lo * inv, np.float32)
        self._blk_inv_np = np.asarray(1.0 / (bsize * inv), np.float32)

    def _nearest_blocks(self, p):
        self._ensure_blocks()
        if self._blk_flat_np is None:   # table over budget: exact fallback
            return self._nearest_walk(p)
        shape = p.shape[:-1]
        p2 = p.reshape(-1, 3)
        nb = self._blk_nb
        K = self._blk_k
        rel = (p2 - jnp.asarray(self._blk_lo_np)) \
            * jnp.asarray(self._blk_inv_np)
        ib = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, nb - 1)
        blk = (ib[:, 0] * nb + ib[:, 1]) * nb + ib[:, 2]
        r = jnp.asarray(self._blk_flat_np)[blk]             # (M, 4K) row
        d = ((p2[:, 0:1] - r[:, :K]) ** 2
             + (p2[:, 1:2] - r[:, K:2 * K]) ** 2
             + (p2[:, 2:3] - r[:, 2 * K:3 * K]) ** 2)
        k = jnp.argmin(d, axis=1)
        sel = jnp.arange(K, dtype=jnp.int32)[None, :] == k[:, None]
        best = jnp.sum(jnp.where(sel, r[:, 3 * K:], 0.0), axis=1)
        return best.astype(jnp.int32).reshape(shape)

    def _ensure_walk(self):
        """Lazy host build of the neighbor-walk locate tables.

        A coarse voxel SEED map (voxel -> site nearest its center) plus
        per-cell [self+neighbors] rows [X|Y|Z|I](K): point location
        descends the adjacency graph from the seed, moving to the
        strictly-closest site of the current cell's row until the cell
        itself is closest.  EXACT: p is in cell(s) iff p is closer to s
        than to every neighbor of s (the walls only clip, they never
        add bisectors), and each move strictly decreases the distance so
        the walk terminates at the true cell.  Memory is
        O(ncells * kmax) — independent of the block resolution that
        capped the round-4 candidate tables at import scales
        (ref: VoronoiMesh.cpp:512-543 walks nb^3 block kd-trees).
        """
        if hasattr(self, "_walk_rows_np"):
            return
        Kp = -(-(self.nbrs64.shape[1] + 1) // 32) * 32
        budget = 96 << 20
        if self.ncells * 4 * Kp * 4 > budget or self.ncells >= (1 << 24):
            self._walk_rows_np = None
            return
        rows = np.empty((self.ncells, 4 * Kp), np.float32)
        rows[:, :3 * Kp] = 1e9      # pad coords: never nearest
        rows[:, 3 * Kp:] = 0.0
        sites = self._sites_np
        # entry 0 = the cell itself (argmin tie -> stay = converged)
        rows[:, 0] = sites[:, 0]
        rows[:, Kp] = sites[:, 1]
        rows[:, 2 * Kp] = sites[:, 2]
        rows[:, 3 * Kp] = np.arange(self.ncells, dtype=np.float32)
        nbrs = self.nbrs64
        for j in range(nbrs.shape[1]):
            col = nbrs[:, j]
            idx = np.nonzero(col >= 0)[0]
            c = col[idx]
            rows[idx, 1 + j] = sites[c, 0]
            rows[idx, Kp + 1 + j] = sites[c, 1]
            rows[idx, 2 * Kp + 1 + j] = sites[c, 2]
            rows[idx, 3 * Kp + 1 + j] = c.astype(np.float32)
        self._walk_rows_np = rows
        self._walk_k = Kp
        ns = int(np.clip(round(1.5 * self.ncells ** (1.0 / 3.0)), 8, 128))
        lo, hi = self._lo, self._hi
        bs = (hi - lo) / ns
        ax = [lo[k] + (np.arange(ns) + 0.5) * bs[k] for k in range(3)]
        centers = np.stack(np.meshgrid(*ax, indexing="ij"),
                           axis=-1).reshape(-1, 3)
        _, seed = self._tree.query(centers, workers=-1)
        self._walk_seed_np = seed.astype(np.int32)
        self._walk_ns = ns
        inv = 1.0 / self.scale
        self._walk_lo_np = np.asarray(lo * inv, np.float32)
        self._walk_inv_np = np.asarray(1.0 / (bs * inv), np.float32)

    def _nearest_walk(self, p):
        self._ensure_walk()
        if self._walk_rows_np is None:
            return self._nearest_scan(p)
        shape = p.shape[:-1]
        p2 = p.reshape(-1, 3)
        ns = self._walk_ns
        K = self._walk_k
        rel = (p2 - jnp.asarray(self._walk_lo_np)) \
            * jnp.asarray(self._walk_inv_np)
        iv = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, ns - 1)
        vox = (iv[:, 0] * ns + iv[:, 1]) * ns + iv[:, 2]
        s0 = jnp.asarray(self._walk_seed_np)[vox]
        rows_t = jnp.asarray(self._walk_rows_np)

        def step(state):
            s, _moved, it = state
            r = rows_t[s]                                 # (M, 4K) row
            d = ((p2[:, 0:1] - r[:, :K]) ** 2
                 + (p2[:, 1:2] - r[:, K:2 * K]) ** 2
                 + (p2[:, 2:3] - r[:, 2 * K:3 * K]) ** 2)
            k = jnp.argmin(d, axis=1)
            sel = jnp.arange(K, dtype=jnp.int32)[None, :] == k[:, None]
            s_new = jnp.sum(jnp.where(sel, r[:, 3 * K:], 0.0),
                            axis=1).astype(jnp.int32)
            return s_new, jnp.any(s_new != s), it + 1

        def cond(state):
            # termination is guaranteed (strictly decreasing distance);
            # the iteration cap is a safety net only
            return state[1] & (state[2] < 256)

        s_fin, _, _ = jax.lax.while_loop(
            cond, step, (s0, jnp.bool_(True), jnp.int32(0)))
        return s_fin.reshape(shape)

    def locate_batched(self, points):
        """Flat cell ids for arbitrary-shaped point batches (-1 outside).

        Vector-traversal / analytic-mode protocol (engine/
        vector_traversal.py): purely batched device point location.
        """
        p = self._scaled(points)
        inside = jnp.all((p >= self.lo) & (p <= self.hi), axis=-1)
        return jnp.where(inside, self.nearest_site(p), -1)

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the domain box, in meters.

        Analytic panel-quadrature protocol (vector_traversal.panel_paths):
        only the in-domain span is needed, not wall crossings.
        """
        p = self._scaled(pos)
        moving = jnp.abs(direction) > 1e-30
        inv = 1.0 / jnp.where(moving, direction, 1.0)
        t1 = (self.lo - p) * inv
        t2 = (self.hi - p) * inv
        in_slab = (p >= self.lo) & (p <= self.hi)
        near = jnp.where(moving, jnp.minimum(t1, t2),
                         jnp.where(in_slab, -_BIG, _BIG))
        far = jnp.where(moving, jnp.maximum(t1, t2),
                        jnp.where(in_slab, _BIG, -_BIG))
        t_near = jnp.max(near, axis=-1)
        t_far = jnp.min(far, axis=-1)
        t_start = jnp.maximum(t_near, 0.0)
        hit = (t_start <= t_far) & (t_far > 0)
        t_start = jnp.where(hit, t_start, 0.0)
        t_stop = jnp.where(hit, t_far, t_start)
        return t_start * self.scale, t_stop * self.scale

    def cell_of(self, state: VoronoiState):
        return state.cell

    def start(self, pos) -> VoronoiState:
        p = self._scaled(pos)
        inside = jnp.all((p >= self.lo) & (p <= self.hi), axis=-1)
        cell = jnp.where(inside, self.nearest_site(p), -1)
        return VoronoiState(cell.astype(jnp.int32),
                            jnp.zeros(pos.shape[:-1], jnp.float32))

    def locate(self, pos):
        return self.start(pos).cell

    def enter(self, pos, direction):
        p = self._scaled(pos)
        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (self.lo - p) * inv
        t2 = (self.hi - p) * inv
        tnear = jnp.max(jnp.where(moving, jnp.minimum(t1, t2), -_BIG), axis=-1)
        tfar = jnp.min(jnp.where(moving, jnp.maximum(t1, t2), _BIG), axis=-1)
        par_out = jnp.any(jnp.logical_not(moving)
                          & ((p < self.lo) | (p > self.hi)), axis=-1)
        hit = (tnear <= tfar) & (tfar > 0) & jnp.logical_not(par_out)
        s0 = jnp.where(hit, jnp.maximum(tnear, 0.0), _BIG / 1e6)
        entry = p + (s0 + 1e-6)[..., None] * direction
        cell = jnp.where(hit, self.nearest_site(entry), -1)
        s0_m = s0 * self.scale
        return s0_m, VoronoiState(cell.astype(jnp.int32),
                                  jnp.where(hit, s0_m, _BIG))

    def step(self, state: VoronoiState, origin, direction):
        """Nearest-bisector-plane stepping (ref: VoronoiMesh.cpp:749-844).

        Candidate exits: the bisector plane toward each neighbor (crossed
        when the ray moves toward the neighbor's half-space) and the six
        domain walls.
        """
        o = self._scaled(origin)
        cell, t_m = state
        t = t_m * jnp.float32(1.0 / self.scale)
        inside = cell >= 0
        safe = jnp.maximum(cell, 0)

        si = self.sites[safe]                       # (N, 3)
        nb = self.nbrs[safe]                        # (N, K)
        nb_safe = jnp.maximum(nb, 0)
        sj = self.sites[nb_safe]                    # (N, K, 3)

        # bisector plane: points x with (x - (si+sj)/2) . (sj - si) = 0
        nvec = sj - si[:, None, :]
        mid = 0.5 * (sj + si[:, None, :])
        denom = jnp.sum(nvec * direction[:, None, :], axis=-1)
        numer = jnp.sum((mid - o[:, None, :]) * nvec, axis=-1)
        t_cand = numer / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
        valid = (nb >= 0) & (denom > 1e-30) & (t_cand > t[:, None])
        t_cand = jnp.where(valid, t_cand, _BIG)

        # domain walls
        inv = jnp.where(jnp.abs(direction) > 1e-30, 1.0 / direction, _BIG)
        t1 = (self.lo - o) * inv
        t2 = (self.hi - o) * inv
        t_wall = jnp.min(jnp.where(jnp.abs(direction) > 1e-30,
                                   jnp.maximum(t1, t2), _BIG), axis=-1)
        t_wall = jnp.maximum(t_wall, t)

        t_nb = jnp.min(t_cand, axis=-1)
        k_best = jnp.argmin(t_cand, axis=-1)
        exit_by_wall = t_wall <= t_nb
        t_exit = jnp.minimum(t_nb, t_wall)
        ds = jnp.maximum(t_exit - t, 0.0)

        nxt = jnp.where(exit_by_wall, -1,
                        jnp.take_along_axis(nb, k_best[:, None], axis=1)[:, 0])

        new_state = VoronoiState(
            jnp.where(inside, nxt.astype(jnp.int32), cell),
            jnp.where(inside, t_exit * self.scale, t_m),
        )
        return jnp.where(inside, ds, 0.0) * self.scale, new_state

    def random_position_in_cell_dev(self, key, cells):
        """Device-side in-cell sampling: bbox draws + neighbor-distance
        acceptance, bounded masked resampling."""
        blo = self.bb_lo[cells]
        bhi = self.bb_hi[cells]
        si = self.sites[cells]
        nb = self.nbrs[cells]
        nb_safe = jnp.maximum(nb, 0)
        sj = self.sites[nb_safe]

        def in_cell(p):
            di = jnp.sum((p - si) ** 2, axis=-1)
            dj = jnp.sum((p[:, None, :] - sj) ** 2, axis=-1)
            dj = jnp.where(nb >= 0, dj, jnp.inf)
            return di <= jnp.min(dj, axis=-1)

        p0 = blo + jax.random.uniform(jax.random.fold_in(key, 0),
                                      blo.shape, dtype=jnp.float32) * (bhi - blo)
        ok0 = in_cell(p0)

        def body(state):
            i, p, ok = state
            cand = blo + jax.random.uniform(
                jax.random.fold_in(key, i + 1), blo.shape,
                dtype=jnp.float32) * (bhi - blo)
            cok = in_cell(cand)
            take = jnp.logical_not(ok) & cok
            return i + 1, jnp.where(take[:, None], cand, p), ok | cok

        def cond(state):
            i, _, ok = state
            return (i < 64) & jnp.logical_not(jnp.all(ok))

        _, p, ok = jax.lax.while_loop(cond, body, (jnp.int32(0), p0, ok0))
        # fallback: the site itself
        p = jnp.where(ok[:, None], p, si)
        return p * self.scale
