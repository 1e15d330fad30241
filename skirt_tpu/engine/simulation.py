"""Simulation drivers.

ref: SKIRTcore/Simulation.cpp:18-74 (setupAndRun), MonteCarloSimulation.cpp
(runstellaremission, chunk policy :71-104), OligoMonteCarloSimulation.cpp
(stellar emission then write).

Batched re-design: the (wavelength x chunk) task grid of the reference becomes
a sequence of jit-compiled launch batches with the wavelength index as a
per-packet attribute; tallies accumulate on-device in float32 within a
batch and on the host in float64 across batches.
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from .. import rng
from ..log import Log
from ..units import Units
from .lifecycle import (LifecycleOptions, make_lifecycle,
                        make_lifecycle_with_fallback)


class OligoSimulation:
    """Oligochromatic Monte Carlo simulation: stellar emission only.

    ref: SKIRTcore/OligoMonteCarloSimulation.cpp:69-74.
    """

    # voxelize tree grids automatically (LifecycleOptions.voxelize=False
    # opts out); PanSimulation keeps the leaf walk — its emission solve is
    # per grid cell and must stay at leaf resolution
    _auto_voxelize = True

    def __init__(self, *, stellar_system, instruments, dust_system=None,
                 packets: float = 1e6, seed: int = rng.DEFAULT_SEED,
                 options: LifecycleOptions | None = None,
                 batch_size: int = 1 << 17, log: Log | None = None,
                 units: Units | None = None, out_dir: str = ".",
                 prefix: str = "skirt_tpu", write_convergence: bool = False,
                 write_density: bool = False, write_depth_map: bool = False,
                 checkpoint_every: int = 0,
                 use_mesh: bool | None = None, compaction_iterations: int = 0,
                 dispatch_batches: int = 8, write_grid: bool = False,
                 write_cells_crossed: bool = False):
        self.stellar_system = stellar_system
        self.instruments = list(instruments)
        self.dust_system = dust_system
        self.packets = int(packets)
        self.seed = seed
        self.options = options or LifecycleOptions()
        self.batch_size = int(batch_size)
        self.log = log or Log()
        self.units = units or Units()
        self.out_dir = out_dir
        self.prefix = prefix
        self.write_convergence = write_convergence
        self.write_density = write_density
        self.write_depth_map = write_depth_map
        self.write_grid = write_grid
        self.write_cells_crossed = write_cells_crossed
        # checkpoint/resume is a capability the reference lacks (SURVEY.md
        # §5: "Checkpoint/resume: none"); batches are deterministic per
        # (seed, phase, batch index), so a phase can resume mid-stream.
        self.checkpoint_every = int(checkpoint_every)

        self.wavelength_grid = stellar_system.wavelength_grid
        self.nlambda = self.wavelength_grid.nlambda

        # voxelized tree traversal: trace the identical piecewise-constant
        # field through the Cartesian DDA instead of the per-step tree
        # re-descent (~20x fewer gathers/step); absorption tallies fold
        # voxel -> leaf cell at phase end.  See DustSystem.voxelized.
        self.dust_system_out = dust_system   # original (outputs/diagnostics)
        self._labs_fold = None
        vox_opt = getattr(self.options, "voxelize", None)
        vox_ok = (vox_opt in (True, "table")
                  or (vox_opt is not False and dust_system is not None
                      and getattr(dust_system.grid, "voxelize_exact",
                                  False)))
        if dust_system is not None and self._auto_voxelize and vox_ok:
            # approximate (Voronoi) rasterizations get their field error
            # measured and are refused above 10% (exact voxelizations
            # skip the check) — ref: VoronoiMesh.cpp:512-543 is exact
            v = dust_system.voxelized(max_field_error=0.10, log=self.log)
            if v is not None:
                dust_system, self._labs_fold = v
                self.dust_system = dust_system
                self.log.info(
                    f"Voxelized tree grid: {dust_system.grid.nx}x"
                    f"{dust_system.grid.ny}x{dust_system.grid.nz} voxels "
                    f"over {self.dust_system_out.grid.ncells} leaf cells")
        if (vox_opt == "table" and dust_system is not None
                and not dust_system.analytic):
            # panel-sampled table densities (DustSystem.as_table): applies
            # to the voxelized view or directly to a uniform Cartesian grid
            try:
                dust_system = dust_system.as_table()
            except ValueError as e:
                self.log.warning(f"table density mode unavailable "
                                 f"({e}); keeping the exact walk")
            else:
                self.dust_system = dust_system
                self.log.info("Table density mode: panel quadrature over "
                              "the gridded densities")

        grid = dust_system.grid if dust_system is not None else None
        self.grid = grid

        # survivor compaction (north-star divergence control): run only K
        # scattering events per dispatch, repack alive packets across
        # batches so late iterations run at full lane occupancy
        self.compaction_k = int(compaction_iterations)

        self._mueller = (dust_system.mueller
                         if dust_system is not None else None)
        self._run_batch = None
        self._poly = False
        self._build_main_lifecycle()

        # fold several launch batches into one compiled dispatch: the fixed
        # per-dispatch latency (host->device, worse over network-attached
        # accelerators) otherwise rivals the per-batch compute itself
        self.dispatch_batches = max(int(dispatch_batches), 1)
        self._run_group = None
        if self.dispatch_batches > 1:
            from .lifecycle import make_multibatch

            def grouped(key_p, ell, L0, tallies, b0):
                run_many = make_multibatch(
                    self._lifecycle, self.dispatch_batches,
                    key_fn=lambda k, i: jax.random.fold_in(k, b0 + i))
                return run_many(key_p, ell, L0, tallies)

            self._run_group = jax.jit(grouped, donate_argnums=(3,))
        self._run_batch_io = None
        self._resume_batch = None
        if self.compaction_k > 0 and self._poly:
            raise ValueError("survivor compaction (io_state) is not "
                             "available on polychromatic lanes")
        if self.compaction_k > 0 and dust_system is not None:
            life_io = make_lifecycle(
                grid, dust_system, stellar_system, self.instruments,
                self.options, self.nlambda, io_state=True,
                mueller=self._mueller, max_iterations=self.compaction_k)
            self._run_batch_io = jax.jit(life_io, donate_argnums=(3,))
            self._resume_batch = jax.jit(
                lambda key, tallies, state_in: life_io(
                    key, state_in["ell"], state_in["L0"], tallies,
                    state_in=state_in),
                donate_argnums=(1,))

        # multi-device execution: shard the packet axis over all local
        # devices, psum tallies (ref: the reference's MPI peer-to-peer
        # model).  use_mesh="slab" instead selects the domain-decomposed
        # lifecycle (parallel/slab.py): density + Labs tables sharded by
        # x-slab, replicated packets — per-device table memory ~1/D.
        self.mesh = None
        self._run_batch_sharded = None
        ndev = jax.local_device_count()
        if use_mesh is None:
            use_mesh = ndev > 1
        self._sharded_any_batch = False
        if use_mesh == "slab":
            if ndev <= 1:
                raise ValueError("use_mesh='slab' needs more than 1 device")
            from jax.sharding import Mesh as _Mesh
            from ..parallel import make_slab_lifecycle
            from ..parallel.slab import SLAB_AXIS
            import numpy as _np
            self.mesh = _Mesh(_np.asarray(jax.devices()), (SLAB_AXIS,))
            self._run_batch_sharded = make_slab_lifecycle(
                self.mesh, grid, dust_system, stellar_system,
                self.instruments, self.options, self.nlambda)
            self._ndev = ndev
            # slab mode replicates packets: any batch length works (the
            # divisibility gate below is a packet-sharding constraint)
            self._sharded_any_batch = True
        elif use_mesh and ndev > 1:
            from ..parallel import make_sharded_lifecycle, packet_mesh
            self.mesh = packet_mesh()
            lifecycle = make_lifecycle(
                grid, dust_system, stellar_system, self.instruments,
                self.options, self.nlambda, mueller=self._mueller)

            def zero_tallies():
                t = {"instruments": [ins.zero_tallies()
                                     for ins in self.instruments]}
                if self.options.store_absorption and dust_system is not None:
                    t["labs"] = jnp.zeros(
                        (grid.ncells * self.nlambda,), jnp.float32)
                return t

            self._run_batch_sharded = make_sharded_lifecycle(
                self.mesh, lifecycle, zero_tallies)
            self._ndev = ndev

    # ------------------------------------------------------------------

    def _build_main_lifecycle(self):
        """Build self._lifecycle/_run_batch, engaging polychromatic lanes
        when the options ask for them AND the model qualifies (falling
        back to monochromatic batches otherwise — the batch SHAPES depend
        on which engine built, so the choice must be made up front, not
        by the generic fused fallback)."""
        grid, dust_system = self.grid, self.dust_system
        self._poly = False
        if getattr(self.options, "polychromatic", False):
            try:
                self._lifecycle = make_lifecycle(
                    grid, dust_system, self.stellar_system,
                    self.instruments, self.options, self.nlambda,
                    mueller=self._mueller)
                self._poly = True
            except ValueError as e:
                self.log.info(f"polychromatic lanes unavailable ({e}); "
                              "monochromatic batches")
                from dataclasses import replace as _replace
                self.options = _replace(self.options, polychromatic=False)
        if not self._poly:
            # the options follow a fallback, so that the batches are
            # counted without the fast path's refill
            self._lifecycle, self.options = make_lifecycle_with_fallback(
                grid, dust_system, self.stellar_system, self.instruments,
                self.options, self.nlambda, log=self.log,
                mueller=self._mueller)
        self._run_batch = jax.jit(self._lifecycle, donate_argnums=(3,))

    def _batches(self):
        """Yield (key_tag, ell, L0) per launch batch.

        Every wavelength receives `packets` photon packets (ref:
        dostellaremissionchunk: L = luminosity(ell)/Npp).  Polychromatic
        engines get `count` LANES per batch, each carrying the full
        (nlambda,) launch row Lv/packets — count*refill lanes cover
        count*refill packets per wavelength.
        """
        nl = self.nlambda
        if self._poly:
            per_batch = max(self.batch_size // nl, 1)
            Lv = self.stellar_system.Lv
            k = max(int(self.options.refill_batches), 1)
            nbatches = int(np.ceil(self.packets / (per_batch * k)))
            row = (np.asarray(Lv, np.float64) / self.packets).astype(
                np.float32)
            L0_full = jnp.asarray(np.broadcast_to(
                row, (per_batch, nl)).copy())
            ell_full = jnp.zeros((per_batch,), jnp.int32)
            launched = 0
            for b in range(nbatches):
                count = min(per_batch,
                            -(-(self.packets - launched) // k))
                if count < per_batch:
                    yield b, jnp.zeros((count,), jnp.int32), jnp.asarray(
                        np.broadcast_to(row, (count, nl)).copy())
                else:
                    yield b, ell_full, L0_full
                launched += count * k
            return
        per_batch = max(self.batch_size // nl, 1)
        Lv = self.stellar_system.Lv
        # persistent-lane refill: each lane launches `refill_batches`
        # packets over the batch, so one lane-batch covers k x the packets
        # (the final batch may overshoot `packets` by < k lanes-worth; L0
        # stays Lv/packets, a <=(k-1)/packets normalization excess)
        k = max(int(self.options.refill_batches), 1)
        nbatches = int(np.ceil(self.packets / (per_batch * k)))
        ell_np = np.tile(np.arange(nl, dtype=np.int32), per_batch)
        # one shared device buffer for every full batch (the phase driver
        # materializes the batch list; per-batch copies would pin
        # O(nbatches * batch_size) device memory)
        ell_full = jnp.asarray(ell_np)
        L0_full = jnp.asarray((Lv[ell_np] / self.packets).astype(np.float32))
        launched = 0
        for b in range(nbatches):
            count = min(per_batch, -(-(self.packets - launched) // k))
            if count < per_batch:
                tail_np = np.tile(np.arange(nl, dtype=np.int32), count)
                yield b, jnp.asarray(tail_np), jnp.asarray(
                    (Lv[tail_np] / self.packets).astype(np.float32))
            else:
                yield b, ell_full, L0_full
            launched += count * k

    def run(self):
        """Run the stellar-emission phase and write results."""
        key = rng.root_key(self.seed)
        with self.log.timer("the stellar emission phase"):
            acc = self._run_phase(key, phase_tag=0)
        self.write(acc)
        return acc

    # -- survivor compaction -------------------------------------------------

    def _extract_survivors(self, pstate) -> dict | None:
        """Pull alive packets to the host as compact numpy arrays."""
        alive = np.asarray(pstate["alive"])
        if not alive.any():
            return None
        idx = np.nonzero(alive)[0]
        return {k: np.asarray(v)[idx] for k, v in pstate.items()}

    def _pool_append(self, pool: dict | None, add: dict | None):
        if add is None:
            return pool
        if pool is None:
            return add
        return {k: np.concatenate([pool[k], add[k]]) for k in pool}

    def _pool_take(self, pool: dict, count: int):
        """Take up to `count` packets, padding with dead lanes to `count`."""
        n = pool["L"].shape[0]
        take = min(n, count)
        batch = {k: v[:take] for k, v in pool.items()}
        rest = {k: v[take:] for k, v in pool.items()} if take < n else None
        if take < count:
            pad = count - take
            batch = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in batch.items()}
            batch["alive"][take:] = False
            batch["ell"] = batch["ell"].astype(np.int32)
        dev = {k: jnp.asarray(v) for k, v in batch.items()}
        return dev, rest

    def _run_phase_compacted(self, key, phase_tag: int, acc, tallies_factory,
                             drain):
        """Phase driver with cross-batch survivor repacking."""
        pool = None
        resume_tag = 0
        batch_n = None
        for b, ell, L0 in self._batches():
            batch_n = ell.shape[0]
            bkey = rng.event_key(key, phase_tag, b)
            tallies, pstate = self._run_batch_io(
                bkey, ell, L0, tallies_factory())
            drain(acc, tallies)
            pool = self._pool_append(pool, self._extract_survivors(pstate))
            while pool is not None and pool["L"].shape[0] >= batch_n:
                state_in, pool = self._pool_take(pool, batch_n)
                rkey = rng.event_key(key, phase_tag + 7000, resume_tag)
                resume_tag += 1
                tallies, pstate = self._resume_batch(
                    rkey, tallies_factory(), state_in)
                drain(acc, tallies)
                pool = self._pool_append(pool,
                                         self._extract_survivors(pstate))
        # flush the remaining survivors (padded batches)
        while pool is not None and pool["L"].shape[0] > 0:
            state_in, pool = self._pool_take(pool, batch_n)
            rkey = rng.event_key(key, phase_tag + 7000, resume_tag)
            resume_tag += 1
            tallies, pstate = self._resume_batch(
                rkey, tallies_factory(), state_in)
            drain(acc, tallies)
            pool = self._pool_append(pool, self._extract_survivors(pstate))
        return acc

    def _run_phase(self, key, phase_tag: int):
        tallies = {"instruments": [ins.zero_tallies() for ins in self.instruments]}
        if self.options.store_absorption and self.dust_system is not None:
            tallies["labs"] = jnp.zeros(
                (self.grid.ncells * self.nlambda,), jnp.float32)

        # host-side float64 accumulators
        acc = {"instruments": [
            {k: np.zeros(v.shape, np.float64) for k, v in t.items()}
            for t in tallies["instruments"]]}
        if "labs" in tallies:
            acc["labs"] = np.zeros(tallies["labs"].shape, np.float64)

        def tallies_factory():
            t = {"instruments": [ins.zero_tallies() for ins in self.instruments]}
            if "labs" in acc:
                t["labs"] = jnp.zeros(
                    (self.grid.ncells * self.nlambda,), jnp.float32)
            return t

        def drain(acc_, t):
            for i, ti in enumerate(t["instruments"]):
                for k, v in ti.items():
                    acc_["instruments"][i][k] += np.asarray(v, np.float64)
            if "labs" in acc_:
                acc_["labs"] += np.asarray(t["labs"], np.float64)

        if self.compaction_k > 0 and self._run_batch_io is not None:
            return self._fold_acc(self._run_phase_compacted(
                key, phase_tag, acc, tallies_factory, drain))

        # resume from a phase checkpoint when present
        start_batch = 0
        ckpt_path = os.path.join(self.out_dir,
                                 f"{self.prefix}_phase{phase_tag}.ckpt.npz")
        if self.checkpoint_every and os.path.exists(ckpt_path):
            data = np.load(ckpt_path)
            start_batch = int(data["next_batch"])
            for i in range(len(self.instruments)):
                for k in acc["instruments"][i]:
                    acc["instruments"][i][k] = data[f"ins{i}_{k}"]
            if "labs" in acc:
                acc["labs"] = data["labs"]
            self.log.info(f"Resumed phase {phase_tag} from batch {start_batch}")

        t0 = time.perf_counter()
        total = 0
        batches = [bt for bt in self._batches() if bt[0] >= start_batch]
        pos = 0
        while pos < len(batches):
            b, ell, L0 = batches[pos]
            K = self.dispatch_batches
            # group K consecutive same-shape batches into one dispatch
            # (the final batch may be ragged and runs singly)
            can_group = (self._run_group is not None
                         and self._run_batch_sharded is None
                         and pos + K <= len(batches)
                         and batches[pos + K - 1][1].shape[0]
                         == ell.shape[0])
            if can_group:
                key_p = rng.event_key(key, phase_tag)
                tallies = self._run_group(key_p, ell, L0, tallies, b)
                nproc = K
            else:
                bkey = rng.event_key(key, phase_tag, b)
                if self._run_batch_sharded is not None \
                        and (self._sharded_any_batch
                             or ell.shape[0] % self._ndev == 0):
                    tallies = self._run_batch_sharded(bkey, ell, L0)
                else:
                    tallies = self._run_batch(bkey, ell, L0, tallies)
                nproc = 1
            total += sum(batches[pos + j][1].shape[0] for j in range(nproc))
            # drain to host in float64 and reset device tallies to preserve
            # precision across many batches
            for i, t in enumerate(tallies["instruments"]):
                for k, v in t.items():
                    acc["instruments"][i][k] += np.asarray(v, np.float64)
            if "labs" in tallies:
                acc["labs"] += np.asarray(tallies["labs"], np.float64)
            tallies = {"instruments": [ins.zero_tallies() for ins in self.instruments]}
            if "labs" in acc:
                tallies["labs"] = jnp.zeros(
                    (self.grid.ncells * self.nlambda,), jnp.float32)
            dt = time.perf_counter() - t0
            self.log.info(f"Launched {total:,} photon packages "
                          f"({total / max(dt, 1e-9):,.0f} pps)")
            bend = b + nproc
            if self.checkpoint_every and \
                    (bend // self.checkpoint_every) > (b // self.checkpoint_every):
                self._save_checkpoint(ckpt_path, bend, acc)
            pos += nproc
        if self.checkpoint_every and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # phase complete
        return self._fold_acc(acc)

    def _fold_acc(self, acc):
        """Fold voxel-resolution absorption tallies back onto leaf cells."""
        if self._labs_fold is not None and "labs" in acc:
            acc["labs"] = self._labs_fold(acc["labs"])
        return acc

    def _save_checkpoint(self, path, next_batch, acc):
        os.makedirs(self.out_dir, exist_ok=True)
        payload = {"next_batch": next_batch}
        for i, t in enumerate(acc["instruments"]):
            for k, v in t.items():
                payload[f"ins{i}_{k}"] = v
        if "labs" in acc:
            payload["labs"] = acc["labs"]
        tmp = path + ".tmp"
        np.savez(tmp, **payload)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)

    def write(self, acc):
        os.makedirs(self.out_dir, exist_ok=True)
        for ins, a in zip(self.instruments, acc["instruments"]):
            ins.write(a, self.wavelength_grid, self.units, self.out_dir,
                      self.prefix)
        if self.dust_system_out is not None:
            # diagnostics run on the original (leaf-resolution) system
            from ..media import outputs as ds_out
            if self.write_convergence:
                ds_out.write_convergence(self.dust_system_out, self.units,
                                         self.out_dir, self.prefix, self.log)
            if self.write_density:
                ds_out.write_density_cuts(self.dust_system_out, self.units,
                                          self.out_dir, self.prefix)
            if self.write_depth_map:
                ds_out.write_tau_map(self.dust_system_out, self.units,
                                     self.out_dir, self.prefix, log=self.log)
            if self.write_grid:
                # ref: DustGrid::writegrid (DustGrid.cpp:53-74)
                ds_out.write_grid_plots(self.dust_system_out.grid,
                                        self.units, self.out_dir,
                                        self.prefix, log=self.log)
            if self.write_cells_crossed:
                # ref: DustSystem.cpp:965-971, :1010-1021
                ds_out.write_cells_crossed(
                    self.dust_system_out.grid, self.dust_system_out,
                    self.stellar_system, self.out_dir, self.prefix,
                    log=self.log)
        self.log.success("Wrote instrument outputs to " + self.out_dir)
