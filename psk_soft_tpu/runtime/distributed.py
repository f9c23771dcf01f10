"""Multi-host runtime driver: the distributed receiver (round 5).

BASELINE config 5 (4096 channels across hosts) at the RUNTIME layer, not
just the model layer: each process ingests ITS OWN channels (its local
slice of the global bank), the demod step runs as ONE SPMD program over
the global channel-sharded mesh, and each process assembles packets for
its local channels only.  The reference's analog is one component per
host deployed under a domain manager (/root/reference/cpp/main.cpp:24-29,
rh.psk_soft.spec:88-95); here the "domain" is jax.distributed and the
component is this engine.

Launch recipe (every host runs the same program):

    from psk_soft_tpu.parallel import launch
    from psk_soft_tpu.runtime.distributed import DistributedBatchEngine

    launch.initialize()          # PSK_COORDINATOR / PSK_NUM_PROCESSES /
                                 # PSK_PROCESS_ID env
    eng = DistributedBatchEngine(cfg, channels_global=4096)
    eng.set_input_sri(sri)
    for block in my_ingest():            # (eng.channels, S*sps) local rows
        eng.push_block(block)
        pkts = eng.step_packets()        # packets for the LOCAL channels

Design notes:

- The channel axis is communication-free (SURVEY section 2.5), so the
  sharded step inserts NO collectives -- each host's devices demodulate
  their own channel rows; ``jax.distributed`` provides the mesh and the
  compile-consistency barrier, exactly the control-plane-only role CORBA
  plays in the reference.
- Host-local data enters via ``jax.make_array_from_process_local_data``
  (the documented multi-host ingest path): no host ever materializes
  another host's samples.
- Packet assembly (SRI propagation, symbol-accurate timestamps, EOS) is
  the SAME BankAssembler the single-process engines use, over the local
  rows -- a 2-process run is packet-for-packet identical to a
  single-process run of the same bank (tests/test_distributed_launch.py
  gates it), because per-channel demod math is independent of the mesh.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DemodConfig
from .engine_batch import BatchEngine


class DistributedBatchEngine(BatchEngine):
    """Channel-sharded multi-host bank engine.

    Args:
      cfg: demod configuration (shared by the whole bank).
      channels_global: total channels across all hosts; must divide
        evenly over the mesh's channel axis.
      mesh: a 1-axis ("chan") jax Mesh over the GLOBAL device list
        (default: ``launch.global_mesh()`` -- all devices on chan).
      block_symbols / pipeline / pipeline_depth: as BatchEngine.

    The engine's public surface (``push`` / ``push_block`` /
    ``step_packets`` / ``flush_packets`` / metrics) is the LOCAL view:
    ``self.channels`` is the local channel count and ``local_offset`` is
    the first global channel this process owns.
    """

    def __init__(self, cfg: DemodConfig, channels_global: int,
                 mesh: Mesh | None = None, block_symbols: int = 512,
                 pipeline: str = "ff", pipeline_depth: int = 0,
                 guard_nonfinite: bool = False):
        if guard_nonfinite:
            # The base guard's fresh-carry rebuild is sized to LOCAL
            # channels while the sharded state is global -- supporting it
            # needs a sharded rebuild; reject loudly rather than build a
            # guard that never fires.
            raise ValueError("guard_nonfinite is not supported on the "
                             "distributed engine (per-channel resync is "
                             "host-local; run it on the per-host view)")
        if mesh is None:
            from ..parallel.launch import global_mesh
            mesh = global_mesh()
        if tuple(mesh.axis_names) != ("chan",) and "chan" not in \
                mesh.axis_names:
            raise ValueError("mesh needs a 'chan' axis")
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        if channels_global % n_dev:
            raise ValueError(f"{channels_global} channels not divisible "
                             f"by {n_dev} devices")
        self.mesh = mesh
        self.channels_global = int(channels_global)
        spec = P("chan") if tuple(mesh.axis_names) == ("chan",) else P(
            tuple(mesh.axis_names))
        self._chan_spec = spec
        # Local row span from the sharding itself (contiguous for the
        # standard process-ordered global device list; asserted).  A
        # shard covering the whole axis (1-device mesh / replicated
        # leaf) comes back as slice(None, None): normalize both ends.
        sh = NamedSharding(mesh, spec)
        imap = sh.addressable_devices_indices_map((channels_global,))
        rows = sorted(
            (idx[0].start if idx[0].start is not None else 0,
             idx[0].stop if idx[0].stop is not None else channels_global)
            for idx in imap.values())
        lo = rows[0][0]
        hi = rows[-1][1]
        if [r for r, _ in rows] != [lo + i * (rows[0][1] - rows[0][0])
                                    for i in range(len(rows))]:
            raise ValueError("process-local channel rows are not "
                             "contiguous on this mesh; reorder devices")
        self.local_offset = int(lo)
        channels_local = int(hi - lo)
        super().__init__(cfg, channels_local, block_symbols=block_symbols,
                         pipeline=pipeline, pipeline_depth=pipeline_depth)
        # Replace the local state/step with the GLOBAL sharded pair.
        self._state = self._shard_state(self._ops.init(
            cfg, (channels_global,)))

    # -- sharding plumbing -------------------------------------------------

    def _leaf_sharding(self, ndim: int) -> NamedSharding:
        extra = (None,) * (ndim - 1)
        base = (self._chan_spec if isinstance(self._chan_spec, tuple)
                else tuple(self._chan_spec))
        return NamedSharding(self.mesh, P(*base, *extra))

    def _shard_state(self, full_state):
        """Global init computed on every process (cheap, deterministic);
        each keeps only its local rows on device."""
        lo, n = self.local_offset, self.channels

        def shard_leaf(leaf):
            leaf = np.asarray(leaf)
            sh = self._leaf_sharding(leaf.ndim)
            return jax.make_array_from_process_local_data(
                sh, leaf[lo:lo + n], leaf.shape)

        return jax.tree_util.tree_map(shard_leaf, full_state)

    def _global_input(self, x_local: np.ndarray):
        sh = self._leaf_sharding(2)
        return jax.make_array_from_process_local_data(
            sh, np.ascontiguousarray(x_local),
            (self.channels_global, x_local.shape[1]))

    def _fetch_local(self, arr):
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    def _run_block(self, x_local: np.ndarray):
        """BatchEngine's device-dispatch hook, swapped for the SPMD path:
        global sharded input in, LOCAL rows out.  All staging, metrics,
        and packet logic is inherited unchanged.  NOTE on flush(): the
        drain length must agree across processes (the SPMD step is one
        program) -- feed equal-length streams or flush at block edges.
        """
        with self.step_timer.measure():
            self._state, out = self._fn(self._state,
                                        self._global_input(x_local))
            out = jax.tree_util.tree_map(self._fetch_local, out)
        return out

    # -- BatchEngine overrides --------------------------------------------

    def reset(self) -> None:
        super().reset()
        self._state = self._shard_state(self._ops.init(
            self.cfg, (self.channels_global,)))

    def configure(self, new_cfg: DemodConfig) -> None:
        # reconfigure_ff's carry surgery is jax ops on (C, ...) leaves --
        # SPMD-identical on the sharded global state, so the inherited
        # path works; it just needs every process to call configure with
        # the same config (same single-program discipline as step).
        super().configure(new_cfg)
