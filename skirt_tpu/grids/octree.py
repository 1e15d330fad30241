"""Adaptive octree dust grid.

ref: SKIRTcore/TreeDustGrid.cpp:50-233 (BFS subdivision with
maxMassFraction / maxOpticalDepth / maxDensDispFraction criteria, density
estimated by uniform MC sampling per node), OctTreeDustGrid.cpp, leaf-id ↔
cell-number tables (:112-123), and the traversal walks (:390-560, Saftly
et al. 2013).

Batched re-design: construction is host-side NumPy (setup-time, as in the
reference); the tree is frozen into flat arrays (child base index + box
extents + leaf cell ids).  Traversal is a lockstep walk: exit the current
leaf box (Cartesian slab arithmetic), nudge past the wall, and find the
next leaf by one of two schemes (the reference's TopDown and Neighbor
search methods, TreeDustGrid.cpp:390-560):

- 'redescend' (ref TopDown): re-descend from the root with a bounded
  fori loop of octant comparisons — ~2 gathers per tree level.
- 'neighbor' (ref Neighbor, its ski default): per-(leaf, face) neighbor
  lists baked host-side into ONE flat f32 row each
  [lo3 | hi3 | node](K) so a step costs one contiguous row gather + a
  VPU containment argmax (the same row-flat trick as the Voronoi
  block-candidate locate).  Corner/edge-adjacent leaves are included in
  each face list, so diagonal wall crossings resolve without fallback.

The reference's third walk (Bookkeeping, Saftly et al. arithmetic
neighbor computation on fully-refined trees) maps to the voxelized
Cartesian DDA here (voxelize(): leaves of a midpoint tree are unions of
finest-level voxels and the walk is pure index arithmetic) — that is
the production fast path for table mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class OctreeState(NamedTuple):
    node: jnp.ndarray    # current leaf node index (-1 outside)
    t: jnp.ndarray       # ray parameter [m]


_BIG = 3.4e38  # float32 max-ish sentinel (plain float: no backend init at import)


class OctreeGrid:
    """Octree over a cubic/rectangular domain, adaptively refined on a
    dust density field."""

    dimension = 3
    voxelize_exact = True      # leaves are unions of finest-level voxels
    _traversal = "redescend"   # next-leaf search: 'redescend' | 'neighbor'

    def __init__(self, extent, density_fn=None, *, min_level: int = 2,
                 max_level: int = 6, max_mass_fraction: float = 1e-6,
                 samples_per_node: int = 100, seed: int = 9157,
                 max_dens_disp_fraction: float = 0.0,
                 subdivision: str = "midpoint",
                 traversal: str = "redescend"):
        """extent: (xmin, ymin, zmin, xmax, ymax, zmax) in meters.

        density_fn(pos: (n,3) float64) -> density (host callable); nodes
        with mass fraction above max_mass_fraction subdivide until
        max_level.  ref defaults: minLevel 2, maxLevel 6
        (TreeDustGrid.hpp:37,43), 100 samples/node (:166).

        subdivision: 'midpoint' (ref: OctTreeNode) or 'barycentric'
        (ref: BaryOctTreeNode.cpp — children split at the node's density
        barycenter, clamped slightly inside the node so no child is
        degenerate; better leaf economy for steep AGN-torus contrast).
        Barycentric leaves are NOT voxel unions, so voxelize() refuses.
        """
        self.extent = np.asarray(extent, dtype=np.float64)
        if subdivision not in ("midpoint", "barycentric"):
            raise ValueError("subdivision must be 'midpoint' or "
                             "'barycentric'")
        if traversal not in ("redescend", "neighbor"):
            raise ValueError("traversal must be 'redescend' (ref "
                             "TopDown) or 'neighbor' (ref Neighbor)")
        self._traversal = traversal
        self.subdivision = subdivision
        if subdivision == "barycentric":
            self.voxelize_exact = False
        lo = self.extent[:3]
        hi = self.extent[3:]
        if np.any(hi <= lo):
            raise ValueError("invalid extent")

        rng_np = np.random.default_rng(seed)

        # --- BFS subdivision (host) --------------------------------------
        boxes_lo = [lo.copy()]
        boxes_hi = [hi.copy()]
        levels = [0]
        children = [-1]  # child base index per node (-1 = leaf for now)
        parents = [-1]

        def node_mass(los, his):
            """MC mass estimate for a batch of boxes: mean rho * volume.

            ref: TreeDustGrid.cpp:190-229 (N-sample density estimate).
            """
            n = los.shape[0]
            s = samples_per_node
            u = rng_np.uniform(size=(n, s, 3))
            pos = los[:, None, :] + u * (his - los)[:, None, :]
            rho = np.asarray(density_fn(pos.reshape(-1, 3))).reshape(n, s)
            vol = np.prod(his - los, axis=1)
            # density barycenter per node (ref: TreeNodeDensityCalculator
            # barycenter()); midpoint fallback for empty nodes, clamped
            # 5% inside the walls so no child degenerates
            w = rho[:, :, None]
            wsum = w.sum(axis=1)
            midp = 0.5 * (los + his)
            with np.errstate(invalid="ignore"):
                bary = (pos * w).sum(axis=1) / np.where(wsum > 0, wsum, 1.0)
            bary = np.where(wsum > 0, bary, midp)
            bary = np.clip(bary, los + 0.05 * (his - los),
                           his - 0.05 * (his - los))
            return rho.mean(axis=1) * vol, rho, bary

        # The total mass is estimated from the stratified min-level frontier
        # (a single root-box MC estimate badly misses compact structures).
        total_mass = None

        frontier = [0]
        while frontier:
            los = np.array([boxes_lo[i] for i in frontier])
            his = np.array([boxes_hi[i] for i in frontier])
            lvls = np.array([levels[i] for i in frontier])
            if density_fn is not None and total_mass is None \
                    and lvls.min() >= min_level:
                masses, _, _b = node_mass(los, his)
                total_mass = float(masses.sum())
                if total_mass <= 0:
                    total_mass = None
            if density_fn is not None and total_mass:
                masses, rhos, barys = node_mass(los, his)
                mass_frac = masses / total_mass
                disp_ok = np.zeros(len(frontier), dtype=bool)
                if max_dens_disp_fraction > 0:
                    mean = rhos.mean(axis=1)
                    disp = np.where(mean > 0, rhos.std(axis=1) / np.maximum(mean, 1e-300), 0.0)
                    disp_ok = disp > max_dens_disp_fraction
                needs = (lvls < min_level) | (
                    (lvls < max_level) & ((mass_frac > max_mass_fraction) | disp_ok))
            else:
                needs = lvls < min_level
            next_frontier = []
            have_bary = (self.subdivision == "barycentric"
                         and density_fn is not None and total_mass)
            for idx, parent in enumerate(frontier):
                if not needs[idx]:
                    continue
                base = len(boxes_lo)
                children[parent] = base
                plo, phi = boxes_lo[parent], boxes_hi[parent]
                # ref: BaryOctTreeNode.cpp — split at the density
                # barycenter instead of the geometric midpoint
                mid = barys[idx] if have_bary else 0.5 * (plo + phi)
                for octant in range(8):
                    clo = np.where([octant & 1, octant & 2, octant & 4], mid, plo)
                    chi = np.where([octant & 1, octant & 2, octant & 4], phi, mid)
                    boxes_lo.append(clo.astype(np.float64))
                    boxes_hi.append(chi.astype(np.float64))
                    levels.append(levels[parent] + 1)
                    children.append(-1)
                    parents.append(parent)
                    next_frontier.append(base + octant)
            frontier = next_frontier

        self._finalize(boxes_lo, boxes_hi, levels, children)

    def _finalize(self, boxes_lo, boxes_hi, levels, children,
                  linear_depth: int | None = None):
        """Freeze the host-side tree topology into device arrays.

        `linear_depth` is the tree depth in equivalent octree levels (for
        the traversal step bound); defaults to the raw node depth.
        """
        self.nnodes = len(boxes_lo)
        self.lo64 = np.array(boxes_lo)
        self.hi64 = np.array(boxes_hi)
        self.child64 = np.array(children, dtype=np.int64)
        self.levels = np.array(levels)
        self.max_depth = int(self.levels.max())

        # leaf numbering (ref: TreeDustGrid.cpp:112-123)
        leaf_mask = self.child64 < 0
        self.leaf_nodes = np.nonzero(leaf_mask)[0]
        self.ncells = int(self.leaf_nodes.size)
        cellnum = np.full(self.nnodes, -1, dtype=np.int64)
        cellnum[self.leaf_nodes] = np.arange(self.ncells)
        self.cellnum64 = cellnum

        # host (numpy) tables exposed via jnp-wrapping properties
        self._lo_np = np.asarray(self.lo64, np.float32)
        self._hi_np = np.asarray(self.hi64, np.float32)
        self._mid_np = np.asarray(0.5 * (self.lo64 + self.hi64), np.float32)
        self._child_np = np.asarray(self.child64, np.int32)
        self._cellnum_np = np.asarray(cellnum, np.int32)
        self._node_of_cell_np = np.asarray(self.leaf_nodes, np.int32)
        # traversal bound: crossing the domain can visit many leaves,
        # but never more than every cell
        if linear_depth is None:
            linear_depth = self.max_depth
        self.max_steps = min(4 * (1 << min(linear_depth, 24)) + 8,
                             2 * self.ncells + 8)

    # -- device-array views (traced access inlines HLO literals) ------------

    @property
    def lo(self):
        return jnp.asarray(self._lo_np)

    @property
    def hi(self):
        return jnp.asarray(self._hi_np)

    @property
    def mid(self):
        return jnp.asarray(self._mid_np)

    @property
    def child(self):
        return jnp.asarray(self._child_np)

    @property
    def cellnum(self):
        return jnp.asarray(self._cellnum_np)

    @property
    def node_of_cell(self):
        return jnp.asarray(self._node_of_cell_np)

    # -- host metadata -----------------------------------------------------

    def voxelize(self, max_voxels: int = 1 << 24):
        """Exact uniform-voxel view: (CartesianGrid, cell_of_voxel).

        Batched re-design of the tree walk (ref: TreeDustGrid.cpp:390-560):
        midpoint subdivision puts every leaf wall on the lattice of the
        finest leaf size per axis, so rasterizing leaf ids onto that
        uniform grid represents the SAME piecewise-constant density field
        exactly — and traversal becomes the Cartesian DDA (arithmetic
        locate, no per-step re-descend gather chains).  The tree keeps the
        tally/emission resolution: deposits fold voxel -> leaf cell.

        Returns None when the voxel count would exceed `max_voxels`
        (callers fall back to the leaf walk) or when the subdivision is
        barycentric (leaf walls off-lattice: no exact voxel union).
        """
        if not self.voxelize_exact:
            return None
        from .cartesian import CartesianGrid

        lo = self.extent[:3]
        hi = self.extent[3:]
        leaf_lo = self.lo64[self.leaf_nodes]
        leaf_hi = self.hi64[self.leaf_nodes]
        widths = leaf_hi - leaf_lo
        res = np.array([int(round((hi[a] - lo[a]) / widths[:, a].min()))
                        for a in range(3)], dtype=np.int64)
        if int(np.prod(res)) > max_voxels:
            return None
        dx = (hi - lo) / res
        i0 = np.rint((leaf_lo - lo) / dx).astype(np.int64)
        i1 = np.rint((leaf_hi - lo) / dx).astype(np.int64)
        cell_of = np.empty(tuple(res), np.int32)
        for c in range(self.ncells):
            cell_of[i0[c, 0]:i1[c, 0], i0[c, 1]:i1[c, 1],
                    i0[c, 2]:i1[c, 2]] = c
        cart = CartesianGrid(np.linspace(lo[0], hi[0], res[0] + 1),
                             np.linspace(lo[1], hi[1], res[1] + 1),
                             np.linspace(lo[2], hi[2], res[2] + 1))
        return cart, cell_of.ravel()

    def bounding_box(self):
        return tuple(self.extent)

    def cell_volumes(self) -> np.ndarray:
        d = self.hi64[self.leaf_nodes] - self.lo64[self.leaf_nodes]
        return np.prod(d, axis=1)

    def cell_centers(self) -> np.ndarray:
        return 0.5 * (self.lo64[self.leaf_nodes] + self.hi64[self.leaf_nodes])

    def random_positions_in_cells(self, rng_np: np.random.Generator,
                                  cells: np.ndarray) -> np.ndarray:
        nodes = self.leaf_nodes[cells]
        u = rng_np.uniform(size=(cells.size, 3))
        return self.lo64[nodes] + u * (self.hi64[nodes] - self.lo64[nodes])

    # -- device-side -------------------------------------------------------

    def random_position_in_cell_dev(self, key, cells):
        nodes = self.node_of_cell[cells]
        u = jax.random.uniform(key, (cells.shape[0], 3), dtype=jnp.float32)
        return self.lo[nodes] + u * (self.hi[nodes] - self.lo[nodes])

    def descend(self, pos):
        """Leaf node containing pos (-1 outside the root box)."""
        root_lo = self.lo[0]
        root_hi = self.hi[0]
        inside = jnp.all((pos >= root_lo) & (pos <= root_hi), axis=-1)
        node0 = jnp.where(inside, 0, -1)

        def body(_i, node):
            safe = jnp.maximum(node, 0)
            child0 = self.child[safe]
            is_inner = (node >= 0) & (child0 >= 0)
            mid = self.mid[safe]
            octant = ((pos[..., 0] > mid[..., 0]).astype(jnp.int32)
                      + 2 * (pos[..., 1] > mid[..., 1]).astype(jnp.int32)
                      + 4 * (pos[..., 2] > mid[..., 2]).astype(jnp.int32))
            return jnp.where(is_inner, child0 + octant, node)

        return jax.lax.fori_loop(0, self.max_depth + 1, body, node0)

    def cell_of(self, state: OctreeState):
        safe = jnp.maximum(state.node, 0)
        return jnp.where(state.node >= 0, self.cellnum[safe], -1)

    def start(self, pos) -> OctreeState:
        node = self.descend(pos)
        return OctreeState(node, jnp.zeros(pos.shape[:-1], jnp.float32))

    def locate(self, pos):
        return self.cell_of(self.start(pos))

    # -- analytic-mode panel quadrature support ---------------------------

    def ray_span(self, pos, direction):
        """(t_start, t_stop) of the ray inside the root box (slab test)."""
        root_lo = self.lo[0]
        root_hi = self.hi[0]
        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (root_lo - pos) * inv
        t2 = (root_hi - pos) * inv
        tnear = jnp.max(jnp.where(moving, jnp.minimum(t1, t2), -_BIG),
                        axis=-1)
        tfar = jnp.min(jnp.where(moving, jnp.maximum(t1, t2), _BIG), axis=-1)
        par_out = jnp.any(jnp.logical_not(moving)
                          & ((pos < root_lo) | (pos > root_hi)), axis=-1)
        t_start = jnp.maximum(tnear, 0.0)
        hit = (t_start <= tfar) & (tfar > 0) & jnp.logical_not(par_out)
        t_start = jnp.where(hit, t_start, 0.0)
        return t_start, jnp.where(hit, tfar, t_start)

    def locate_batched(self, points):
        """Leaf cell ids for (..., 3) points via batched tree descent
        (max_depth+1 rounds of one gather each)."""
        node = self.descend(points)
        safe = jnp.maximum(node, 0)
        return jnp.where(node >= 0, self.cellnum[safe], -1)

    def enter(self, pos, direction):
        root_lo = self.lo[0]
        root_hi = self.hi[0]
        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (root_lo - pos) * inv
        t2 = (root_hi - pos) * inv
        tnear = jnp.max(jnp.where(moving, jnp.minimum(t1, t2), -_BIG), axis=-1)
        tfar = jnp.min(jnp.where(moving, jnp.maximum(t1, t2), _BIG), axis=-1)
        par_out = jnp.any(jnp.logical_not(moving)
                          & ((pos < root_lo) | (pos > root_hi)), axis=-1)
        hit = (tnear <= tfar) & (tfar > 0) & jnp.logical_not(par_out)
        s0 = jnp.where(hit, jnp.maximum(tnear, 0.0), _BIG)
        span = jnp.max(root_hi - root_lo)
        entry = pos + (s0 + 1e-5 * span)[..., None] * direction
        node = self.descend(entry)
        node = jnp.where(hit, node, -1)
        return s0, OctreeState(node, jnp.where(hit, s0, _BIG))

    def step(self, state: OctreeState, origin, direction):
        node, t = state
        inside = node >= 0
        safe = jnp.maximum(node, 0)
        blo = self.lo[safe]
        bhi = self.hi[safe]

        # per-axis exit parameter; degenerate axes (|d|~0) never exit --
        # guard explicitly, as (border - origin) * BIG collapses to 0 when
        # the origin sits exactly on a border
        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (blo - origin) * inv
        t2 = (bhi - origin) * inv
        t_axis = jnp.where(moving, jnp.maximum(t1, t2), _BIG)
        t_exit = jnp.min(t_axis, axis=-1)
        t_exit = jnp.maximum(t_exit, t)
        ds = jnp.maximum(t_exit - t, 0.0)

        # nudge past the wall relative to the local box size; then FORCE
        # the exit-axis coordinate strictly beyond the wall — when the
        # direction component along the exit axis is tiny, eps*dir
        # vanishes under f32 rounding and the probe lands back ON the
        # wall, stalling the walk at ds=0 forever (observed on a
        # barycentric BinTree knife edge)
        span = jnp.min(bhi - blo, axis=-1)
        eps = 1e-4 * span
        probe = origin + (t_exit + eps)[..., None] * direction
        axis = jnp.argmin(t_axis, axis=-1)
        dsel = jnp.take_along_axis(direction, axis[..., None], -1)[..., 0]
        go_pos = dsel > 0
        wall_hi = jnp.take_along_axis(bhi, axis[..., None], -1)[..., 0]
        wall_lo = jnp.take_along_axis(blo, axis[..., None], -1)[..., 0]
        # compose the eps nudge with an ulp floor: at physical scales
        # (walls ~1e20 m) eps can round below ulp(wall) in f32 and the
        # add becomes a no-op, leaving the ds=0 stall the nudge exists
        # to break — force at least 4 nextafter steps past the wall
        # (ADVICE r4 fix; ref: TreeDustGrid.cpp:437-453 uses nextafter)
        hi_next = wall_hi
        lo_next = wall_lo
        for _ in range(4):
            hi_next = jnp.nextafter(hi_next, jnp.inf)
            lo_next = jnp.nextafter(lo_next, -jnp.inf)
        forced = jnp.where(go_pos,
                           jnp.maximum(wall_hi + eps, hi_next),
                           jnp.minimum(wall_lo - eps, lo_next))
        onehot = jnp.arange(3, dtype=jnp.int32) == axis[..., None]
        probe = jnp.where(onehot, forced[..., None], probe)

        use_nbr = self._traversal == "neighbor"
        if use_nbr:
            self._ensure_face_table()
            use_nbr = self._face_rows_np is not None
        if use_nbr:
            nxt = self._neighbor_next(safe, axis, go_pos, probe)
        else:
            nxt = self.descend(probe)

        new_state = OctreeState(
            jnp.where(inside, nxt, node),
            jnp.where(inside, t_exit, t),
        )
        return jnp.where(inside, ds, 0.0), new_state

    # -- neighbor-list walk (ref Neighbor search method) --------------------

    _FACE_KMAX = 64    # bail to re-descend past this (pathologically
                       # ungraded trees: one coarse face vs >64 fine leaves)

    def _ensure_face_table(self):
        """Host build of the per-(leaf, face) neighbor rows.

        Row (cellnum*6 + face) -> [lo3 | hi3 | node](K) f32: each face's
        candidate leaves' boxes and node ids baked into one contiguous
        row, so the device step costs a single 2D row gather + a VPU
        containment argmax (the Voronoi block-candidate row-flat trick).
        Edge/corner-touching leaves are included (closed-interval overlap
        test), so a probe nudged diagonally past two walls still finds
        its leaf without a re-descend fallback.

        ref: TreeDustGrid.cpp:460-560 (Neighbor search: per-wall sorted
        neighbor lists, walked linearly); the containment test over a
        fixed-width row replaces the data-dependent linear search.
        """
        if hasattr(self, "_face_rows_np"):
            return
        leaves = self.leaf_nodes
        L = int(leaves.size)
        lo = self.lo64[leaves]
        hi = self.hi64[leaves]
        span = float(np.max(self.hi64[0] - self.lo64[0]))
        tol = 1e-9 * span
        nbr = [[[] for _ in range(6)] for _ in range(L)]
        for ax in range(3):
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            planes: dict = {}
            for i, k in enumerate(np.round(hi[:, ax] / tol).astype(np.int64)):
                planes.setdefault(int(k), ([], []))[0].append(i)
            for i, k in enumerate(np.round(lo[:, ax] / tol).astype(np.int64)):
                planes.setdefault(int(k), ([], []))[1].append(i)
            for _k, (A, B) in planes.items():
                if not A or not B:
                    continue
                A = np.asarray(A)
                B = np.asarray(B)
                na, nb_ = len(A), len(B)
                if na * nb_ <= (1 << 16):
                    # small plane: the dense overlap matrix is cheapest
                    ov = ((lo[A][:, None, o1] <= hi[B][None, :, o1] + tol)
                          & (hi[A][:, None, o1] >= lo[B][None, :, o1]
                             - tol)
                          & (lo[A][:, None, o2] <= hi[B][None, :, o2]
                             + tol)
                          & (hi[A][:, None, o2] >= lo[B][None, :, o2]
                             - tol))
                    ii, jj = np.nonzero(ov)
                    pairs = zip(A[ii], B[jj])
                else:
                    # populous midplane (O(4^level) faces per side): the
                    # dense |A|x|B| matrix is multi-GB; bucket faces
                    # along o1 instead (bucket width = the largest face
                    # width, so every face spans <= 2 buckets) and join
                    # per bucket — near-linear in the face count
                    alo1, ahi1 = lo[A, o1], hi[A, o1]
                    blo1, bhi1 = lo[B, o1], hi[B, o1]
                    wmax = max(float(np.max(ahi1 - alo1)),
                               float(np.max(bhi1 - blo1)), tol)
                    base0 = float(min(alo1.min(), blo1.min()))
                    top = float(max(ahi1.max(), bhi1.max()))
                    nbk = max(int(np.ceil((top - base0) / wmax)) + 1, 1)

                    def bix(x):
                        return np.clip(((x - base0) / wmax)
                                       .astype(np.int64), 0, nbk - 1)

                    a_lo_b, a_hi_b = bix(alo1), bix(ahi1)
                    b_lo_b, b_hi_b = bix(blo1), bix(bhi1)
                    buckets: dict = {}
                    for j in range(nb_):
                        for bk in range(b_lo_b[j], b_hi_b[j] + 1):
                            buckets.setdefault(bk, []).append(j)
                    seen = set()
                    pairs = []
                    for bk, js in buckets.items():
                        ia = np.nonzero((a_lo_b <= bk)
                                        & (a_hi_b >= bk))[0]
                        if ia.size == 0:
                            continue
                        jb = np.asarray(js)
                        ov = ((lo[A[ia]][:, None, o1]
                               <= hi[B[jb]][None, :, o1] + tol)
                              & (hi[A[ia]][:, None, o1]
                                 >= lo[B[jb]][None, :, o1] - tol)
                              & (lo[A[ia]][:, None, o2]
                                 <= hi[B[jb]][None, :, o2] + tol)
                              & (hi[A[ia]][:, None, o2]
                                 >= lo[B[jb]][None, :, o2] - tol))
                        ii, jj = np.nonzero(ov)
                        for a, b in zip(A[ia[ii]], B[jb[jj]]):
                            if (a, b) not in seen:
                                seen.add((a, b))
                                pairs.append((a, b))
                for a, b in pairs:
                    nbr[a][2 * ax + 1].append(b)    # a's +ax face sees b
                    nbr[b][2 * ax].append(a)        # b's -ax face sees a
        kmax = max((len(v) for row in nbr for v in row), default=1)
        # byte budget for the baked rows (mirrors voronoi.py's
        # _ensure_blocks): a (L*6, 7K) f32 literal is re-materialized per
        # traced step, and multi-hundred-MB programs compile slowly
        row_bytes = L * 6 * 7 * max(kmax, 1) * 4
        budget = 96 << 20
        if kmax > self._FACE_KMAX or self.nnodes >= (1 << 24) \
                or row_bytes > budget:
            import warnings
            warnings.warn(
                f"{type(self).__name__}: neighbor-list walk disabled "
                f"(face fan-out {kmax} > {self._FACE_KMAX}, node ids "
                f"exceed f32 range, or baked rows {row_bytes >> 20} MB "
                f"> {budget >> 20} MB); stepping falls back to "
                "re-descend")
            self._face_rows_np = None
            return
        K = max(kmax, 1)
        rows = np.empty((L * 6, 7 * K), np.float32)
        rows[:, 0:3 * K] = 1e30      # pad lo: containment always fails
        rows[:, 3 * K:6 * K] = -1e30
        rows[:, 6 * K:] = -1.0
        # round the baked boxes OUTWARD by 2 ulp: non-dyadic (barycentric)
        # walls don't round-trip f64->f32 exactly, and a probe just
        # inside the true box must not fail the f32 containment test
        lof = lo.astype(np.float32)
        lof = np.nextafter(np.nextafter(lof, -np.inf), -np.inf)
        hif = hi.astype(np.float32)
        hif = np.nextafter(np.nextafter(hif, np.inf), np.inf)
        nodef = leaves.astype(np.float32)
        for i in range(L):
            base = i * 6
            for f in range(6):
                c = nbr[i][f]
                if not c:
                    continue
                c = np.asarray(c)
                m = c.size
                r = rows[base + f]
                for a in range(3):
                    r[a * K:a * K + m] = lof[c, a]
                    r[(3 + a) * K:(3 + a) * K + m] = hif[c, a]
                r[6 * K:6 * K + m] = nodef[c]
        self._face_k = K
        self._face_rows_np = rows

    def _neighbor_next(self, safe, axis, go_pos, probe):
        """Next leaf via the exit face's baked neighbor row.

        Corner-case gap (shared with the reference's Neighbor method): a
        probe nudged diagonally past TWO walls can land in a COARSER
        leaf that spans the exit plane without owning a face on it — it
        is absent from the face list.  Those (rare) misses fall back to
        a root re-descend behind a lax.cond, so the descent only
        executes on iterations where some lane actually missed.
        """
        face = axis * 2 + go_pos.astype(jnp.int32)
        cell = self.cellnum[safe]
        K = self._face_k
        rows = jnp.asarray(self._face_rows_np)[cell * 6 + face]  # (N, 7K)
        ok = jnp.ones(rows.shape[:-1] + (K,), bool)
        for a in range(3):
            ok = (ok & (probe[..., a:a + 1] >= rows[..., a * K:(a + 1) * K])
                  & (probe[..., a:a + 1] <= rows[..., (3 + a) * K:
                                                 (4 + a) * K]))
        k = jnp.argmax(ok, axis=-1)
        found = jnp.any(ok, axis=-1)
        sel = jnp.arange(K, dtype=jnp.int32) == k[..., None]
        nid = jnp.sum(jnp.where(sel, rows[..., 6 * K:], 0.0), axis=-1)
        nxt = jnp.where(found, nid.astype(jnp.int32), -1)
        in_root = jnp.all((probe >= self.lo[0]) & (probe <= self.hi[0]),
                          axis=-1)
        miss = jnp.logical_not(found) & in_root
        return jax.lax.cond(
            jnp.any(miss),
            lambda _: jnp.where(miss, self.descend(probe), nxt),
            lambda _: nxt, None)


class BinTreeGrid(OctreeGrid):
    """Adaptive k-d style binary tree: each refined node splits in two along
    the axis `level % 3` at the midpoint (the reference's "Alternating"
    direction method).

    ref: SKIRTcore/BinTreeDustGrid.cpp + BinTreeNode.cpp:40-76 (split
    direction cycling x,y,z with level).  Traversal reuses the octree's
    exit-and-re-descend walk with a single-axis comparison per level.
    """

    def __init__(self, extent, density_fn=None, *, min_level: int = 6,
                 max_level: int = 18, max_mass_fraction: float = 1e-6,
                 samples_per_node: int = 100, seed: int = 9157,
                 max_dens_disp_fraction: float = 0.0,
                 subdivision: str = "midpoint",
                 traversal: str = "redescend"):
        """Levels count binary splits: 3 binary levels = 1 octree level
        (reference defaults scale the same way).  subdivision
        'barycentric' = the reference's directionMethod "Barycenter"
        (ref: BaryBinTreeNode.cpp:34-58): the split AXIS is the one whose
        wall lies fractionally nearest the density barycenter, but the
        split PLANE stays the midpoint — so leaf walls remain on the
        dyadic lattice and exact voxelization still applies."""
        self.extent = np.asarray(extent, dtype=np.float64)
        if subdivision not in ("midpoint", "barycentric"):
            raise ValueError("subdivision must be 'midpoint' or "
                             "'barycentric'")
        if traversal not in ("redescend", "neighbor"):
            raise ValueError("traversal must be 'redescend' (ref "
                             "TopDown) or 'neighbor' (ref Neighbor)")
        self._traversal = traversal
        self.subdivision = subdivision
        lo = self.extent[:3]
        hi = self.extent[3:]
        if np.any(hi <= lo):
            raise ValueError("invalid extent")

        rng_np = np.random.default_rng(seed)

        boxes_lo = [lo.copy()]
        boxes_hi = [hi.copy()]
        levels = [0]
        children = [-1]
        axes = [0]

        def node_mass(los, his):
            n = los.shape[0]
            s = samples_per_node
            u = rng_np.uniform(size=(n, s, 3))
            pos = los[:, None, :] + u * (his - los)[:, None, :]
            rho = np.asarray(density_fn(pos.reshape(-1, 3))).reshape(n, s)
            vol = np.prod(his - los, axis=1)
            # density barycenter per node (ref: TreeNodeDensityCalculator
            # barycenter()); midpoint fallback for empty nodes, clamped
            # 5% inside the walls so no child degenerates
            w = rho[:, :, None]
            wsum = w.sum(axis=1)
            midp = 0.5 * (los + his)
            with np.errstate(invalid="ignore"):
                bary = (pos * w).sum(axis=1) / np.where(wsum > 0, wsum, 1.0)
            bary = np.where(wsum > 0, bary, midp)
            bary = np.clip(bary, los + 0.05 * (his - los),
                           his - 0.05 * (his - los))
            return rho.mean(axis=1) * vol, rho, bary

        total_mass = None
        frontier = [0]
        while frontier:
            los = np.array([boxes_lo[i] for i in frontier])
            his = np.array([boxes_hi[i] for i in frontier])
            lvls = np.array([levels[i] for i in frontier])
            if density_fn is not None and total_mass is None \
                    and lvls.min() >= min_level:
                masses, _, _b = node_mass(los, his)
                total_mass = float(masses.sum())
                if total_mass <= 0:
                    total_mass = None
            if density_fn is not None and total_mass:
                masses, rhos, barys = node_mass(los, his)
                mass_frac = masses / total_mass
                disp_ok = np.zeros(len(frontier), dtype=bool)
                if max_dens_disp_fraction > 0:
                    mean = rhos.mean(axis=1)
                    disp = np.where(mean > 0,
                                    rhos.std(axis=1) / np.maximum(mean, 1e-300),
                                    0.0)
                    disp_ok = disp > max_dens_disp_fraction
                needs = (lvls < min_level) | (
                    (lvls < max_level)
                    & ((mass_frac > max_mass_fraction) | disp_ok))
            else:
                needs = lvls < min_level
                barys = None
            if (self.subdivision == "barycentric" and barys is None
                    and density_fn is not None and np.any(needs)):
                # forced min_level splits still choose the axis from the
                # barycenter (ref: BaryBinTreeNode::createchildren runs
                # unconditionally)
                _, _, barys = node_mass(los, his)
            next_frontier = []
            for idx, parent in enumerate(frontier):
                if not needs[idx]:
                    continue
                base = len(boxes_lo)
                children[parent] = base
                plo, phi = boxes_lo[parent], boxes_hi[parent]
                if self.subdivision == "barycentric" and barys is not None:
                    # ref: BaryBinTreeNode.cpp:38-57 — split axis = the
                    # one whose wall is fractionally nearest the density
                    # barycenter; ties pick the later axis (strict <)
                    b = barys[idx]
                    frac = np.minimum(b - plo, phi - b) / (phi - plo)
                    ax = 2 - int(np.argmin(frac[::-1]))
                else:
                    ax = levels[parent] % 3
                axes[parent] = ax
                # the split plane is always the midpoint (the reference's
                # Barycenter method changes only the direction)
                mid = 0.5 * (plo[ax] + phi[ax])
                for half in range(2):
                    clo = plo.copy()
                    chi = phi.copy()
                    if half == 0:
                        chi[ax] = mid
                    else:
                        clo[ax] = mid
                    boxes_lo.append(clo)
                    boxes_hi.append(chi)
                    levels.append(levels[parent] + 1)
                    children.append(-1)
                    axes.append((levels[parent] + 1) % 3)
                    next_frontier.append(base + half)
            frontier = next_frontier

        # split axis recorded per inner node when its children were made
        self._finalize(boxes_lo, boxes_hi, levels, children,
                       linear_depth=-(-self.__maxlvl(levels) // 3))
        self._split_axis_np = np.asarray(axes, np.int32)

    @property
    def split_axis(self):
        return jnp.asarray(self._split_axis_np)

    @staticmethod
    def __maxlvl(levels):
        return max(levels)

    def descend(self, pos):
        root_lo = self.lo[0]
        root_hi = self.hi[0]
        inside = jnp.all((pos >= root_lo) & (pos <= root_hi), axis=-1)
        node0 = jnp.where(inside, 0, -1)

        def body(_i, node):
            safe = jnp.maximum(node, 0)
            child0 = self.child[safe]
            is_inner = (node >= 0) & (child0 >= 0)
            ax = self.split_axis[safe]
            mid = jnp.take_along_axis(self.mid[safe], ax[..., None],
                                      axis=-1)[..., 0]
            pa = jnp.take_along_axis(pos, ax[..., None], axis=-1)[..., 0]
            pick = (pa > mid).astype(jnp.int32)
            return jnp.where(is_inner, child0 + pick, node)

        return jax.lax.fori_loop(0, self.max_depth + 1, body, node0)


class ParticleTreeGrid(OctreeGrid):
    """Octree refined on particle occupancy: leaves subdivide until each
    holds at most one particle (plus optional uniform extra levels), giving
    resolution that follows an imported SPH particle distribution.

    ref: SKIRTcore/ParticleTreeDustGrid.cpp:58-109 (insert particles one by
    one, subdividing occupied leaves; `extraLevels` refines every leaf
    further).
    """

    def __init__(self, extent, particles, *, extra_levels: int = 0,
                 max_level: int = 16):
        self.extent = np.asarray(extent, dtype=np.float64)
        lo = self.extent[:3]
        hi = self.extent[3:]
        if np.any(hi <= lo):
            raise ValueError("invalid extent")
        pts = np.asarray(particles, dtype=np.float64).reshape(-1, 3)
        inside = np.all((pts >= lo) & (pts <= hi), axis=1)
        pts = pts[inside]

        boxes_lo = [lo.copy()]
        boxes_hi = [hi.copy()]
        levels = [0]
        children = [-1]

        # breadth-first: subdivide any leaf holding >1 particle
        frontier = [(0, np.arange(len(pts)))]
        while frontier:
            next_frontier = []
            for node, idx in frontier:
                if idx.size <= 1 or levels[node] >= max_level:
                    continue
                base = len(boxes_lo)
                children[node] = base
                plo, phi = boxes_lo[node], boxes_hi[node]
                mid = 0.5 * (plo + phi)
                p = pts[idx]
                octant = ((p[:, 0] > mid[0]).astype(int)
                          + 2 * (p[:, 1] > mid[1]).astype(int)
                          + 4 * (p[:, 2] > mid[2]).astype(int))
                for o in range(8):
                    clo = np.where([o & 1, o & 2, o & 4], mid, plo)
                    chi = np.where([o & 1, o & 2, o & 4], phi, mid)
                    boxes_lo.append(clo.astype(np.float64))
                    boxes_hi.append(chi.astype(np.float64))
                    levels.append(levels[node] + 1)
                    children.append(-1)
                    next_frontier.append((base + o, idx[octant == o]))
            frontier = next_frontier

        # uniform extra refinement of every leaf (ref: extraLevels)
        for _ in range(extra_levels):
            leaves = [i for i, c in enumerate(children) if c < 0]
            for node in leaves:
                base = len(boxes_lo)
                children[node] = base
                plo, phi = boxes_lo[node], boxes_hi[node]
                mid = 0.5 * (plo + phi)
                for o in range(8):
                    clo = np.where([o & 1, o & 2, o & 4], mid, plo)
                    chi = np.where([o & 1, o & 2, o & 4], phi, mid)
                    boxes_lo.append(clo.astype(np.float64))
                    boxes_hi.append(chi.astype(np.float64))
                    levels.append(levels[node] + 1)
                    children.append(-1)

        self._finalize(boxes_lo, boxes_hi, levels, children)
