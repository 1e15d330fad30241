"""Multi-process execution: distributed init + global meshes.

ref: MPIsupport/ProcessManager.cpp — the reference's multi-node model is
raw MPI behind a static facade that degrades to a no-op single-process
build without BUILDING_WITH_MPI (:21-188); work is split over ranks and
tallies are Allreduced at phase edges (SURVEY.md §2.2).

Equivalent here: `jax.distributed` initializes the multi-process runtime
(one process per host, all devices global), and the lifecycle's 1-D
packet axis simply spans every device — the psum at batch end is
inserted by XLA from the same `shard_map` program that runs on one
process.  The tally collectives are a few MB once per batch, so the
packet axis needs no split into intra- and inter-host sub-axes.

Mirroring the reference's graceful degradation, `initialize_distributed`
is a no-op when the environment describes a single process, so the same
driver script runs unchanged on one host.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import PACKET_AXIS

HOST_AXIS = "hosts"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Initialize `jax.distributed` when running multi-process.

    Arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or the
    cluster auto-detection built into jax.distributed.initialize.
    Returns True when a multi-process runtime was initialized, False for
    the single-process no-op path (ref: ProcessManager compiled without
    MPI returns rank 0 / size 1, MPIsupport/ProcessManager.cpp:166-188).
    """
    num = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    # cluster auto-detection (jax.distributed's built-in SlurmCluster /
    # OMPI detectors) must still fire when only the scheduler's own env
    # vars are present
    cluster_size = max(int(os.environ.get("SLURM_NTASKS", "1")),
                       int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1")))
    if num <= 1 and addr is None and cluster_size <= 1:
        return False
    kwargs = {}
    if addr is not None:
        kwargs["coordinator_address"] = addr
    if num_processes is not None or "JAX_NUM_PROCESSES" in os.environ:
        kwargs["num_processes"] = num
    pid = process_id if process_id is not None else \
        os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)
    return True


def pod_mesh(axis: str = PACKET_AXIS) -> Mesh:
    """1-D mesh over ALL devices of every process.

    The cards of a host are joined all to all, so the mesh follows the
    algorithm alone: a plain 1-D axis in device order.
    """
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_device_mesh(axis_hosts: str = HOST_AXIS,
                     axis_packets: str = PACKET_AXIS) -> Mesh:
    """2-D (hosts, local-devices) mesh: the outer axis enumerates
    processes, the inner axis each process's local devices (e.g. slab
    decomposition within a host + packet replication across hosts)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    nproc = jax.process_count()
    return Mesh(np.asarray(devs).reshape(nproc, -1),
                (axis_hosts, axis_packets))


def global_batch(mesh: Mesh, ell_local: np.ndarray, L0_local: np.ndarray,
                 axis: str = PACKET_AXIS):
    """Assemble a global sharded (ell, L0) batch from process-local data.

    Each process passes ITS shard (numpy, length = global/nprocs); the
    result is a global jax.Array sharded over `axis` that feeds the
    sharded lifecycle unchanged.  Single-process this is an ordinary
    device_put over the mesh.
    """
    spec = P(axis)
    sharding = NamedSharding(mesh, spec)
    out = []
    for arr in (np.asarray(ell_local), np.asarray(L0_local)):
        if jax.process_count() == 1:
            out.append(jax.device_put(arr, sharding))
        else:
            out.append(jax.make_array_from_process_local_data(
                sharding, arr))
    return tuple(out)
