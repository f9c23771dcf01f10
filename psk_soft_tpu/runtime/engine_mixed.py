"""MixedKernelBatchEngine: one steady step over a heterogeneous
(M, differential) bank via per-channel mode planes (BASELINE config 4 in
production).  Part of the runtime/engine facade (import from there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig
from .engine_bank import BankAssembler
from .engine_full import FullKernelBatchEngine


class MixedKernelBatchEngine(FullKernelBatchEngine):
    """BASELINE config 4 in production: ONE steady step demodulates a
    heterogeneous (M, differential) bank -- per-channel modes live in the
    carry's mode planes (models/full mixed mode), so a 1024-channel
    BPSK/QPSK/8-PSK mix costs one program instead of one bucketed
    program per mode (compare GroupEngine, which buckets and is still
    required when sps/numAvg/phaseAvg themselves differ).

    Inherits the whole FullKernelBatchEngine surface: plane ingest
    (push_planes, int16 wire via ingest_scale), pipelined packets, flush/
    reset, live configure().  The shared config's constellation_size/
    differential are ignored (per-channel params rule); packet assembly
    uses the 3-bit port layout for every channel (consumers mask with
    ``params.bits_per_symbol``), since one bank packet cannot carry
    per-channel bit rates.

    ``set_params`` is the per-channel analogue of the reference's
    constellation-change listener (cpp/psk_soft.cpp:643-646 semantics,
    applied per channel): channels whose M changed get their phase history
    force-cleared; differential-only changes keep tracking (the reference
    registers no listener on differentialDecoding).
    """

    def __init__(self, params, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline_depth: int = 0,
                 ingest_scale: float | None = None,
                 guard_nonfinite: bool = False,
                 debug_ports: bool = True,
                 soft_i8: bool = False, soft_i8_scale: float = 100.0):
        import dataclasses

        from ..models.mixed import MixedParams

        self.params = MixedParams.make(np.asarray(params.m),
                                       np.asarray(params.diff))
        if np.asarray(self.params.m).shape != (channels,):
            raise ValueError(f"params must carry {channels} channel modes")
        super().__init__(cfg, channels, block_symbols=block_symbols,
                         pipeline_depth=pipeline_depth,
                         ingest_scale=ingest_scale,
                         guard_nonfinite=guard_nonfinite,
                         debug_ports=debug_ports,
                         soft_i8=soft_i8, soft_i8_scale=soft_i8_scale)
        self._full_kwargs["mixed"] = True
        import functools
        self._full_fn = jax.jit(functools.partial(
            self._full_mod.demod_block_full, cfg, **self._full_kwargs))
        # Uniform bit-plane port layout for the heterogeneous bank: wide
        # enough for the bank's largest M (3 planes for {2,4,8} banks,
        # 4/5 when 16/32-PSK channels are present).
        self.assembler = BankAssembler(
            dataclasses.replace(cfg,
                                constellation_size=1 << self.params.max_bits,
                                differential=False),
            skip_debug=not debug_ports)

    def _make_warm_fn(self, cfg: DemodConfig):
        from ..models.mixed import make_mixed_demod_fn

        fn = make_mixed_demod_fn(cfg, max_bits=self.params.max_bits)
        return lambda st, x: fn(self.params, st, x)

    def configure(self, new_cfg: DemodConfig) -> None:
        """Shared-property change; the port layout stays as wide as the
        bank's largest M (the base configure narrows the assembler to the
        shared cfg, which a 16/32-PSK bank must override)."""
        import dataclasses

        super().configure(new_cfg)
        self.assembler.reconfigure(dataclasses.replace(
            new_cfg, constellation_size=1 << self.params.max_bits,
            differential=False))

    def _handoff(self, raw):
        return self._full_mod.full_from_ff(self.cfg, self._warm_state,
                                           raw_win=raw,
                                           mixed_params=self.params)

    def _fresh_planes(self, planes: jnp.ndarray) -> jnp.ndarray:
        """Guarded channels restart with ZEROED tracking but their
        per-channel mode rows intact (losing the mode would silently turn
        a poisoned 8-PSK channel into BPSK)."""
        from ..ops.phase import UNWRAP_TREND_LEN

        misc = (self.cfg.phase_avg - 1) + 2 * (UNWRAP_TREND_LEN - 1)
        z = jnp.zeros_like(planes)
        z = z.at[misc + 6].set(jnp.asarray(self.params.m, planes.dtype))
        z = z.at[misc + 7].set(jnp.asarray(self.params.diff, planes.dtype))
        return z

    def set_params(self, new_params) -> None:
        """Live per-channel mode change (C7, per channel)."""
        from ..models.mixed import MixedParams

        new = MixedParams.make(np.asarray(new_params.m),
                               np.asarray(new_params.diff))
        if np.asarray(new.m).shape != (self.channels,):
            raise ValueError(f"params must carry {self.channels} modes")
        old_m = np.asarray(self.params.m)
        self._drain_pending()
        if self._full_state is not None and self._win_stale:
            self._full_state = self._materialize_state()
        self._prev_planes = None
        self._roll_fn = None
        self._roll_ok = None
        if self._full_state is not None:
            if self._ingest_scale is not None:
                self._full_state = self._full_mod.dequantize_full_state(
                    self._full_state, self._ingest_scale)
            if self.cfg.matched_filter != "none":
                wr = np.asarray(self._full_state.win_re)
                wi = np.asarray(self._full_state.win_im)
                self._raw_tail = np.ascontiguousarray(
                    (wr + 1j * wi).T.astype(np.complex64))
            ff = self._full_mod.ff_from_full(self.cfg, self._full_state)
            self._full_state = None
        else:
            ff = self._warm_state
        changed = (old_m != np.asarray(new.m))
        if changed.any():
            hist = np.asarray(ff.phase_hist).copy()
            hist[changed] = 0.0
            ff = ff._replace(
                phase_hist=jnp.asarray(hist),
                phase_count=jnp.asarray(np.where(
                    changed, 0, np.asarray(ff.phase_count)).astype(np.int32)),
                last_phase=jnp.asarray(np.where(
                    changed, 0.0, np.asarray(ff.last_phase)).astype(
                        np.float32)))
        self.params = new
        self._warm_state = ff
        self._warm_fn = self._make_warm_fn(self.cfg)  # rebinds params
        self._make_guard_fns()                        # guard rebinds modes
        self._consumed = 0                            # re-run the warm gate
        self.metrics.reconfigures += 1


