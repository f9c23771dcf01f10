"""BatchEngine: C aligned streams demodulated as one vmapped device
step (channel-parallel production path for homogeneous banks).  Part of
the runtime/engine facade (import from there).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig
from .. import state as state_mod
from .engine_stream import EngineMetrics, _PipelineOps, logger, \
    reconfigure_ff
from .engine_bank import BankAssembler, _PipelinedPackets
from .streams import SRI


class BatchEngine(_PipelinedPackets):
    """C aligned streams demodulated as one vmapped device step.

    Packets are pushed per channel slot; a device step runs whenever every
    slot holds at least ``block_symbols`` symbols (channelizer-aligned
    streams advance in lockstep).  Flush/reset/reconfigure semantics apply
    group-wide, matching C independent reference components with shared
    properties.
    """

    def __init__(self, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline: str = "ff",
                 guard_nonfinite: bool = False, pipeline_depth: int = 0):
        self._init_pipeline(pipeline_depth)
        if guard_nonfinite and pipeline_depth:
            # The guard must inspect each block's outputs on the host before
            # the next dispatch, which is exactly the sync pipelining removes.
            raise ValueError("guard_nonfinite and pipeline_depth are "
                             "mutually exclusive")
        self.cfg = cfg
        self.channels = channels
        self.block_symbols = int(block_symbols)
        self.guard_nonfinite = guard_nonfinite
        self._ops = _PipelineOps(pipeline)
        self._state = self._ops.init(cfg, (channels,))
        self._staging = [np.zeros(0, np.complex64) for _ in range(channels)]
        self.metrics = EngineMetrics()
        self.channel_resyncs = np.zeros(channels, np.int64)
        self.assembler = BankAssembler(cfg)
        from ..utils.profiling import StepTimer
        self.step_timer = StepTimer()
        import functools
        self._fn = jax.jit(jax.vmap(functools.partial(self._ops.block, cfg)))
        self._guard_fn = jax.jit(self._guard) if guard_nonfinite else None

    def set_input_sri(self, sri: SRI, t: float = 0.0) -> None:
        """Bank input SRI for packet assembly (step_packets/flush_packets)."""
        self.assembler.set_sri(sri, t)

    def push(self, channel: int, data: np.ndarray) -> None:
        self._staging[channel] = np.concatenate(
            [self._staging[channel], np.asarray(data, np.complex64).ravel()])
        self.metrics.samples_in += data.size

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        return all(s.size >= need for s in self._staging)

    def _run_block(self, x: np.ndarray):
        """One device step over a staged (C, T) block; returns outputs.
        The distributed engine overrides ONLY this (global-mesh dispatch,
        local-row fetch); all staging/metrics/guard logic stays shared."""

        with self.step_timer.measure():
            self._state, out = self._fn(self._state, jnp.asarray(x))
        return out

    def step(self):
        """Run one batched block; returns DemodOutputs (C, S) or None."""
        if not self.ready():
            return None
        need = self.block_symbols * self.cfg.sps
        x = np.stack([s[:need] for s in self._staging])
        self._staging = [s[need:] for s in self._staging]
        out = self._run_block(x)
        if self._guard_fn is not None:
            self._state, bad = self._guard_fn(self._state, out)
            nbad = np.asarray(bad)
            if nbad.any():
                # Per-stream drop-and-resync (SURVEY.md section 5): a
                # poisoned channel (non-finite input burst, NaN propagation)
                # restarts its own tracking without touching its neighbors --
                # the reference's accepted-data-loss recovery, per channel.
                self.channel_resyncs[nbad] += 1
                self.metrics.resets += int(nbad.sum())
        if self._pipe_depth == 0:
            nv = int(np.asarray(out.valid).sum())
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol
        return out

    def _guard(self, state, out):
        """Reset carries of channels whose outputs went non-finite."""
        bad = ~jnp.all(jnp.isfinite(out.soft.real)
                       & jnp.isfinite(out.soft.imag)
                       & jnp.isfinite(out.phase), axis=-1)      # (C,)
        fresh = self._ops.init(self.cfg, (self.channels,))

        def pick(new, old):
            b = bad.reshape(bad.shape + (1,) * (old.ndim - 1))
            return jnp.where(b, new, old)

        state2 = jax.tree_util.tree_map(pick, fresh, state)
        return state2, bad

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change for the whole bank (C7 resync semantics,
        like StreamEngine.configure)."""
        import functools
        if new_cfg == self.cfg:
            return
        logger.debug("batch reconfigure: %s -> %s", self.cfg, new_cfg)
        self._drain_pending()
        if self._ops.kind == "exact":
            self._state = state_mod.reconfigure(self.cfg, new_cfg, self._state)
        else:
            self._state = reconfigure_ff(self.cfg, new_cfg, self._state)
        self.cfg = new_cfg
        self._fn = jax.jit(jax.vmap(functools.partial(self._ops.block,
                                                      new_cfg)))
        # The guard closure captures self.cfg via _ops.init at trace time;
        # rebuild so a post-reconfigure channel reset uses the new config.
        self._guard_fn = jax.jit(self._guard) if self.guard_nonfinite else None
        self.assembler.reconfigure(new_cfg)
        self.metrics.reconfigures += 1

    def flush(self):
        """EOS drain: process the remaining staged whole symbols (below the
        block size) as one final, shape-recompiled step; drops the < sps
        tail like the reference's never-completed last window."""
        sps = self.cfg.sps
        n = (min(s.size for s in self._staging) // sps) * sps
        self._staging = [s[:n] for s in self._staging]
        if n == 0:
            self._staging = [np.zeros(0, np.complex64)
                             for _ in range(self.channels)]
            return None
        x = np.stack(self._staging)
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        out = self._run_block(x)
        if self._pipe_depth == 0:
            nv = int(np.asarray(out.valid).sum())
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol
        return out

    def reset(self) -> None:
        self._state = self._ops.init(self.cfg, (self.channels,))
        self._staging = [np.zeros(0, np.complex64) for _ in range(self.channels)]
        self._pending.clear()
        self._held.clear()
        self.assembler.reset()
        self.metrics.resets += 1


