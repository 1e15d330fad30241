"""Adaptive-mesh (AMR) dust grid with device-side re-descend traversal.

ref: SKIRTcore/AdaptiveMeshDustGrid.cpp + AdaptiveMesh.hpp:23-46 — an
imported AMR snapshot is a recursive tree whose internal nodes subdivide
into a regular (nx, ny, nz) linear grid of children and whose leaf cells
are the dust cells; the reference walks paths with its own segment
generator (AdaptiveMesh::path).

Batched re-design: the tree is parsed host-side into flat node arrays (lo,
hi, child base, subdivision counts); traversal mirrors the octree grid's
re-descend walk (grids/octree.py) — exit the current leaf's box
arithmetically, nudge past the wall, and re-descend from the root with
arithmetic child indexing (no neighbor lists, no data-dependent gathers
beyond the node-table lookups).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

_BIG = 3.4e38


class AmrState(NamedTuple):
    node: jnp.ndarray    # current leaf node index (-1 outside)
    t: jnp.ndarray       # ray parameter [m]


def parse_amr_tree(path: str, extent, lines=None):
    """Parse the reference AMR ASCII format keeping the tree structure.

    ref: AdaptiveMeshAsciiFile.cpp — a '!' line introduces an internal
    node with nx ny nz children (x fastest), any other line is a leaf
    cell's data columns.

    Returns dict of numpy arrays: lo/hi (N,3), nsub (N,3) int (0 for
    leaves), child_base (N,), cellnum (N,) (-1 for internal),
    leaf_values (Ncells, ncols), max_depth.
    """
    tokens = []
    if lines is None:
        with open(path) as f:
            lines = f.read().splitlines()
    for line in lines:
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        tokens.append(s)
    it = iter(tokens)

    lo_l, hi_l, nsub_l, child_l, cell_l = [], [], [], [], []
    leaf_values = []
    max_depth = 0

    extent = np.asarray(extent, dtype=np.float64)

    def parse_node(lo, hi, depth):
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        try:
            line = next(it)
        except StopIteration:
            raise ValueError("truncated AMR file")
        idx = len(lo_l)
        lo_l.append(lo.copy())
        hi_l.append(hi.copy())
        if line.startswith("!"):
            parts = line[1:].split()
            nx, ny, nz = int(parts[0]), int(parts[1]), int(parts[2])
            nsub_l.append((nx, ny, nz))
            child_l.append(-2)       # patched below
            cell_l.append(-1)
            xs = np.linspace(lo[0], hi[0], nx + 1)
            ys = np.linspace(lo[1], hi[1], ny + 1)
            zs = np.linspace(lo[2], hi[2], nz + 1)
            children = []
            # reserve child ids in x-fastest order; children are parsed
            # depth-first so ids are not contiguous -- store a child map
            for k in range(nz):
                for j in range(ny):
                    for i in range(nx):
                        children.append(parse_node(
                            np.array([xs[i], ys[j], zs[k]]),
                            np.array([xs[i + 1], ys[j + 1], zs[k + 1]]),
                            depth + 1))
            child_map[idx] = children
        else:
            nsub_l.append((0, 0, 0))
            child_l.append(-1)
            cell_l.append(len(leaf_values))
            leaf_values.append([float(c) for c in line.split()])
        return idx

    child_map: dict[int, list[int]] = {}
    parse_node(extent[:3], extent[3:], 0)

    n = len(lo_l)
    # flatten child maps into one table + per-node base offsets
    child_table = []
    child_base = np.full(n, -1, dtype=np.int64)
    for idx, children in child_map.items():
        child_base[idx] = len(child_table)
        child_table.extend(children)

    ncols = max((len(v) for v in leaf_values), default=0)
    vals = np.zeros((len(leaf_values), ncols))
    for i, v in enumerate(leaf_values):
        vals[i, :len(v)] = v

    return dict(lo=np.asarray(lo_l), hi=np.asarray(hi_l),
                nsub=np.asarray(nsub_l, dtype=np.int64),
                child_base=child_base,
                child_table=np.asarray(child_table, dtype=np.int64),
                cellnum=np.asarray(cell_l, dtype=np.int64),
                leaf_values=vals, max_depth=max_depth)


class AdaptiveMeshGrid:
    """Dust grid whose cells are the leaves of an imported AMR snapshot."""

    dimension = 3

    def __init__(self, path: str, extent, density_column: int = 0,
                 lines=None):
        """`lines` overrides the file: an iterable of ASCII-format lines
        (used by the AMRVAC import, which synthesizes the tree walk)."""
        tree = parse_amr_tree(path, extent, lines=lines)
        self.extent = np.asarray(extent, dtype=np.float64)
        self.lo64 = tree["lo"]
        self.hi64 = tree["hi"]
        self.nsub64 = tree["nsub"]
        self.child_base64 = tree["child_base"]
        self.child_table64 = tree["child_table"]
        self.cellnum64 = tree["cellnum"]
        self.leaf_values = tree["leaf_values"]
        self.density_column = int(density_column)
        self.max_depth = int(tree["max_depth"])

        leaf_mask = self.cellnum64 >= 0
        self.leaf_nodes = np.nonzero(leaf_mask)[0][
            np.argsort(self.cellnum64[leaf_mask])]
        self.ncells = self.leaf_nodes.size

        # host (numpy) tables exposed via jnp-wrapping properties
        self._lo_np = np.asarray(self.lo64, np.float32)
        self._hi_np = np.asarray(self.hi64, np.float32)
        self._nsub_np = np.asarray(self.nsub64, np.int32)
        self._child_base_np = np.asarray(self.child_base64, np.int32)
        self._child_table_np = np.asarray(self.child_table64, np.int32)
        self._cellnum_np = np.asarray(self.cellnum64, np.int32)
        self._node_of_cell_np = np.asarray(self.leaf_nodes, np.int32)

        # bound on cells crossed per chord: depth * max linear resolution
        res = self.nsub64.max(axis=0).sum() if self.nsub64.size else 3
        self.max_steps = int(4 * res * max(self.max_depth, 1) + 16)

    # -- device-array views --------------------------------------------------

    @property
    def lo(self):
        return jnp.asarray(self._lo_np)

    @property
    def hi(self):
        return jnp.asarray(self._hi_np)

    @property
    def nsub(self):
        return jnp.asarray(self._nsub_np)

    @property
    def child_base(self):
        return jnp.asarray(self._child_base_np)

    @property
    def child_table(self):
        return jnp.asarray(self._child_table_np)

    @property
    def cellnum(self):
        return jnp.asarray(self._cellnum_np)

    @property
    def node_of_cell(self):
        return jnp.asarray(self._node_of_cell_np)

    # -- host metadata -----------------------------------------------------

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

    def leaf_density(self) -> np.ndarray:
        """Imported density per cell (snapshot units)."""
        return self.leaf_values[:, self.density_column]

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
            base = self.child_base[safe]
            is_inner = (node >= 0) & (base >= 0)
            blo = self.lo[safe]
            bhi = self.hi[safe]
            nv = self.nsub[safe]
            frac = (pos - blo) / jnp.maximum(bhi - blo, 1e-37)
            ijk = jnp.clip((frac * nv).astype(jnp.int32), 0, nv - 1)
            off = (ijk[..., 0] + nv[..., 0]
                   * (ijk[..., 1] + nv[..., 1] * ijk[..., 2]))
            child = self.child_table[base + off]
            return jnp.where(is_inner, child, node)

        return jax.lax.fori_loop(0, self.max_depth + 1, body, node0)

    def cell_of(self, state: AmrState):
        safe = jnp.maximum(state.node, 0)
        return jnp.where(state.node >= 0, self.cellnum[safe], -1)

    def start(self, pos) -> AmrState:
        node = self.descend(pos)
        return AmrState(node, jnp.zeros(pos.shape[:-1], jnp.float32))

    def locate(self, pos):
        return self.cell_of(self.start(pos))

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
        return s0, AmrState(node, jnp.where(hit, s0, _BIG))

    def step(self, state: AmrState, origin, direction):
        node, t = state
        inside = node >= 0
        safe = jnp.maximum(node, 0)
        blo = self.lo[safe]
        bhi = self.hi[safe]

        moving = jnp.abs(direction) > 1e-30
        inv = jnp.where(moving, 1.0 / direction, 1.0)
        t1 = (blo - origin) * inv
        t2 = (bhi - origin) * inv
        t_axis = jnp.where(moving, jnp.maximum(t1, t2), _BIG)
        t_exit = jnp.min(t_axis, axis=-1)
        t_exit = jnp.maximum(t_exit, t)
        ds = jnp.maximum(t_exit - t, 0.0)

        span = jnp.min(bhi - blo, axis=-1)
        eps = 1e-4 * span
        probe = origin + (t_exit + eps)[..., None] * direction
        nxt = self.descend(probe)

        new_state = AmrState(
            jnp.where(inside, nxt, node),
            jnp.where(inside, t_exit, t),
        )
        return jnp.where(inside, ds, 0.0), new_state
