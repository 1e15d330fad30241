"""Spatial domain decomposition: slab-sharded optical-depth sweeps.

ref: the reference has NO domain decomposition — every MPI rank replicates
the entire grid and tally tables and only work is split (SURVEY.md §5
"long-context analog": replicate-everything-everywhere).  Spatial
decomposition makes the per-device memory footprint scale down with the
device count.

Design: the domain is cut into D contiguous slabs along x,
one per device in a 1-D mesh.  A ray's optical depth is the SUM of its
per-slab contributions, so instead of migrating packets between owners,
the packet batch is replicated, every device sweeps only the ray segment
inside ITS slab (entry/exit of the slab along the ray is arithmetic), and
one `psum` yields the exact total.  Per-device traversal work is
~1/D of the full path, and the per-slab sweep only touches the slab's
cells, which is what later lets the density/tally arrays themselves be
sharded by slab.

This is the building block for decomposing the lifecycle's hottest ops —
escape/absorption accumulation and instrument peel-off are both
optical-depth evaluations along known rays (MonteCarloSimulation.cpp:
438-515, SimpleInstrument.cpp:34-49).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import traversal

SLAB_AXIS = "slabs"


def slab_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices with a slab axis."""
    devs = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (SLAB_AXIS,))


def slab_planes(grid, ndev: int) -> np.ndarray:
    """x-planes splitting the grid's bounding box into ndev equal slabs."""
    box = grid.bounding_box()
    return np.linspace(box[0], box[3], ndev + 1)


def _slab_interval(xlo, xhi, pos, direction):
    """Ray-parameter interval [smin, smax] inside the slab x in [xlo, xhi].

    Returns (smin, smax); empty when smin >= smax.  Rays parallel to the
    slab planes are inside for all s when xlo <= x < xhi, else never.
    """
    dx = direction[..., 0]
    x0 = pos[..., 0]
    moving = jnp.abs(dx) > 1e-30
    inv = jnp.where(moving, 1.0 / jnp.where(moving, dx, 1.0), 0.0)
    t1 = (xlo - x0) * inv
    t2 = (xhi - x0) * inv
    smin = jnp.where(moving, jnp.minimum(t1, t2), 0.0)
    smax = jnp.where(moving, jnp.maximum(t1, t2), jnp.float32(3.4e38))
    inside_par = (x0 >= xlo) & (x0 < xhi)
    smin = jnp.where(moving, smin, jnp.where(inside_par, 0.0, 1.0))
    smax = jnp.where(moving, smax, jnp.where(inside_par, 3.4e38, 0.0))
    return jnp.maximum(smin, 0.0), smax


def make_slab_optical_depth(mesh: Mesh, grid, kapparho_of_cell,
                            max_s=None):
    """Sharded tau(pos, dir): per-slab sweeps + psum over the slab axis.

    kapparho_of_cell(cell) -> extinction [1/m] (0 for cell == -1); in this
    first version the cell tables are replicated, but each device only
    *gathers* cells inside its slab, so the tables can be slab-sharded
    next without changing the traversal.

    Returns a jitted fn(pos (N,3), dir (N,3)) -> tau (N,) equal to the
    single-device traversal.optical_depth to float32 accuracy.
    """
    ndev = mesh.devices.size
    import numpy as np
    planes_np = np.asarray(slab_planes(grid, ndev), np.float32)

    def per_device(pos, direction):
        planes = jnp.asarray(planes_np)
        idx = jax.lax.axis_index(SLAB_AXIS)
        xlo = planes[idx]
        xhi = planes[idx + 1]
        smin, smax = _slab_interval(xlo, xhi, pos, direction)
        has_segment = smax > smin

        # advance the ray to the slab entry (nudged off the slab face so
        # locate() lands inside) and bound the sweep to the slab exit
        eps = 1e-6 * (planes[-1] - planes[0])
        entry = pos + (smin + eps)[..., None] * direction
        span = jnp.maximum(smax - smin - eps, 0.0)

        def kr(cell):
            return kapparho_of_cell(cell)

        limit = span if max_s is None else jnp.minimum(
            span, jnp.maximum(max_s - smin, 0.0))
        tau_local = traversal.optical_depth(
            grid, kr, entry, direction, max_s=limit, active=has_segment)
        tau_local = jnp.where(has_segment, tau_local, 0.0)
        # ref-equivalent reduction: PeerToPeerCommunicator::sum_all
        return jax.lax.psum(tau_local, SLAB_AXIS)

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)
