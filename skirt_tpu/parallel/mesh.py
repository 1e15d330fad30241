"""Device-mesh parallelism for the photon lifecycle.

ref: the reference's entire distributed model (SURVEY.md §2.2-2.3): MPI
ranks replicate the full grid and tallies and split the (wavelength x
chunk) work; per-cell absorption and instrument tallies are summed with
MPI_Allreduce at phase edges (PeerToPeerCommunicator::sum_all,
SKIRTcore/PeerToPeerCommunicator.cpp:17-77; PanDustSystem::sumResults,
PanDustSystem.cpp:394-404; Instrument::sumResults, Instrument.cpp:57).

Equivalent here: packets are sharded over a 1-D device mesh via
shard_map; the grid/optical-property arrays are replicated; tallies are
psum-reduced at batch end.  This reproduces the reference's
semantics exactly and is the correctness baseline for the later
domain-decomposed (all_to_all packet migration) mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

PACKET_AXIS = "packets"


def packet_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices with a packet axis."""
    import numpy as np
    devs = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (PACKET_AXIS,))


def make_sharded_lifecycle(mesh: Mesh, run_batch, zero_tallies):
    """Wrap a per-device lifecycle batch into a pjit/shard_map SPMD program.

    run_batch(key, ell, L0, tallies) -> tallies is the single-device
    lifecycle (engine.lifecycle.make_lifecycle); zero_tallies() builds the
    per-device tally pytree.  The wrapped function takes globally-sharded
    (ell, L0) batches (leading axis divisible by the mesh size) and returns
    globally-summed tallies.

    The RNG discipline folds the device index into the batch key, so
    results are reproducible for a fixed device count.
    """

    def per_device(key, ell, L0):
        idx = jax.lax.axis_index(PACKET_AXIS)
        key = jax.random.fold_in(key, idx)
        local = run_batch(key, ell, L0, zero_tallies())
        # ref: PeerToPeerCommunicator::sum_all / Instrument::sumResults
        return jax.tree.map(lambda x: jax.lax.psum(x, PACKET_AXIS), local)

    sharded = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(PACKET_AXIS), P(PACKET_AXIS)),
        out_specs=P(),
        check_vma=False)
    return jax.jit(sharded)


def make_sharded_lifecycle_scattered(mesh: Mesh, run_batch, zero_tallies):
    """Like make_sharded_lifecycle, but the (Ncells*Nlambda) absorption
    tally comes back SHARDED over the mesh via reduce-scatter.

    ref: the reference replicates the full Labs table on every MPI rank
    and Allreduces it (PanDustSystem.cpp:394-404) — per-rank memory does
    not scale down with the process count.  Here the cross-device
    reduction of "labs" uses psum_scatter, so each device materializes
    only its 1/D slice after the collective (the instrument tallies stay
    small and replicate as before).  The returned labs has its leading
    axis sharded over the packet axis; callers gather it on host or feed
    it to an equally-sharded emission step.

    Requires the labs length to be divisible by the device count.
    """

    has_labs = "labs" in zero_tallies()

    def per_device(key, ell, L0):
        idx = jax.lax.axis_index(PACKET_AXIS)
        key = jax.random.fold_in(key, idx)
        local = run_batch(key, ell, L0, zero_tallies())
        out = {"instruments": jax.tree.map(
            lambda x: jax.lax.psum(x, PACKET_AXIS), local["instruments"])}
        if has_labs:
            out["labs"] = jax.lax.psum_scatter(
                local["labs"], PACKET_AXIS, tiled=True)
        return out

    out_specs = {"instruments": P()}
    if has_labs:
        out_specs["labs"] = P(PACKET_AXIS)
    sharded = jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(PACKET_AXIS), P(PACKET_AXIS)),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(sharded)
