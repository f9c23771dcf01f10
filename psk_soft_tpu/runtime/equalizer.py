"""Adaptive-equalizer front-end wrapped around the bank engines.

Extension beyond the reference (see ops/equalizer.py): per-channel blind
CMA equalization in front of demodulation, the way a REDHAWK deployment
chains an equalizer component ahead of psk_soft on multipath links.
Mirrors the AgcFrontEnd wrapper contract (runtime/agc.py): the batched
device paths (``push_block``/``push_planes``) pass through equalized;
everything else delegates to the wrapped engine.

The weight-update schedule is one block-CMA step per lockstep device step,
so the front-end is deterministic for a given push sequence; with
``freeze=True`` (or after calling :meth:`freeze`) the weights hold and the
data path is a pure per-channel FIR.  Per-channel ragged ``push`` is staged
to the lockstep grid (block CMA shares one update schedule across the
bank), so upstream wrappers that forward per channel -- AgcFrontEnd,
AutoCfoEngine -- compose unchanged.  int16 wire planes are rejected like
the other front-ends: equalizing before dequantization would change the
wire contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.equalizer import EqConfig, eq_init, make_eq_fn


class EqFrontEnd:
    """Blind CMA equalizer in front of any bank engine.

    Args:
      engine: wrapped bank engine (BatchEngine, FullKernelBatchEngine,
        MixedKernelBatchEngine, ...).
      eq_cfg: equalizer configuration; ``stride`` defaults to 1
        (rectangular pulses -- set sps for band-limited ones).
      dd_switch: enable the CMA -> DD-LMS handover: once the WORST
        channel's CMA cost (bank max -- a mean gate could flip
        still-unconverged minority channels into DD cold-start, the
        wrong-decision lock EqConfig.mode warns about) stays below this
        threshold for ``dd_hold`` consecutive updates (lock), the error
        switches to decision-directed LMS
        (EqConfig.mode docs) which removes the CMA excess-MSE floor at
        high SNR.  None (default) keeps pure CMA.  Ignored when eq_cfg
        already starts in "dd" mode.
      dd_hold: consecutive below-threshold updates required to switch.
    """

    def __init__(self, engine, eq_cfg: EqConfig | None = None, *,
                 dd_switch: float | None = None, dd_hold: int = 3):
        self.engine = engine
        self.eq_cfg = eq_cfg if eq_cfg is not None else EqConfig()
        self._state = eq_init(self.eq_cfg, (engine.channels,))
        self._fn = make_eq_fn(self.eq_cfg)
        self._last_cm_err = np.zeros(engine.channels, np.float32)
        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(engine.channels)]
        self.updates = 0
        self.dd_switch = dd_switch
        self.dd_hold = int(dd_hold)
        self._lock_streak = 0

    def _run(self, x):
        self._state, y, info = self._fn(self._state,
                                        jnp.asarray(np.asarray(x,
                                                             np.complex64)))
        self._last_cm_err = np.asarray(info["cm_err"], np.float32)
        if not self.eq_cfg.freeze:
            self.updates += 1
            if (self.dd_switch is not None and self.eq_cfg.mode == "cma"
                    and self._dd_gate_metric() < self.dd_switch):
                self._lock_streak += 1
                if self._lock_streak >= self.dd_hold:
                    self.eq_cfg = dataclasses.replace(self.eq_cfg,
                                                      mode="dd")
                    self._fn = make_eq_fn(self.eq_cfg)
            elif self.eq_cfg.mode == "cma":
                self._lock_streak = 0
        return jax.device_get(y)

    def _dd_gate_metric(self) -> float:
        """Lock metric for the CMA -> DD handover: the WORST channel's
        CMA cost.  A bank-mean gate could hand a still-unconverged
        minority of channels to decision-directed mode cold -- the
        wrong-decision lock condition EqConfig.mode documents."""
        return float(self._last_cm_err.max())

    @property
    def mode(self) -> str:
        """Current adaptation mode: "cma" (acquisition) or "dd"
        (post-lock decision-directed refinement)."""
        return self.eq_cfg.mode

    # -- data paths ----------------------------------------------------------

    def push(self, channel: int, data) -> None:
        """Per-channel push, staged to the lockstep grid.

        Block CMA shares one update schedule across the bank, so ragged
        pushes are held per channel and the common prefix (stride-aligned,
        >= taps samples) runs as one lockstep device step -- upstream
        wrappers that forward per channel (AgcFrontEnd, AutoCfoEngine)
        compose unchanged.  Constant push sizes keep the compiled block
        shape stable."""
        self._staged[channel] = np.concatenate(
            [self._staged[channel], np.asarray(data, np.complex64).ravel()])
        self._drain_staged()

    def _drain_staged(self) -> None:
        cfg = self.eq_cfg
        m = min(s.size for s in self._staged)
        m -= m % cfg.stride
        if m < max(cfg.taps, cfg.stride):
            return
        x = np.stack([s[:m] for s in self._staged])
        self._staged = [s[m:] for s in self._staged]
        y = self._run(x)
        for c in range(self.engine.channels):
            self.engine.push(c, y[c])

    def push_block(self, x) -> None:
        """Lockstep (C, T) block: equalize on device, then the wrapped
        engine's per-channel ingest."""
        if any(s.size for s in self._staged):
            # Ragged remainders would reorder against the lockstep block.
            raise ValueError("staged ragged pushes pending; keep one push "
                             "style per stream")
        y = self._run(np.asarray(x))
        for c in range(self.engine.channels):
            self.engine.push(c, y[c])

    def push_planes(self, re, im) -> None:
        """Time-major (T, C) f32 planes, equalized on device."""
        if getattr(self.engine, "_ingest_scale", None) is not None:
            raise ValueError("equalizing before int16 dequantization would "
                             "change the wire contract; build the inner "
                             "engine without ingest_scale")
        if any(s.size for s in self._staged):
            raise ValueError("staged ragged pushes pending; keep one push "
                             "style per stream")
        x = np.asarray(re).T + 1j * np.asarray(im).T
        y = self._run(x)
        if hasattr(self.engine, "push_planes"):
            self.engine.push_planes(
                np.ascontiguousarray(y.real.T, np.float32),
                np.ascontiguousarray(y.imag.T, np.float32))
        else:                       # plane-less engines take channel pushes
            for c in range(self.engine.channels):
                self.engine.push(c, y[c])

    # -- control / observability ----------------------------------------------

    def freeze(self) -> None:
        """Hold the current weights (production mode after convergence)."""
        if not self.eq_cfg.freeze:
            self.eq_cfg = dataclasses.replace(self.eq_cfg, freeze=True)
            self._fn = make_eq_fn(self.eq_cfg)

    def adapt(self) -> None:
        """Resume weight adaptation."""
        if self.eq_cfg.freeze:
            self.eq_cfg = dataclasses.replace(self.eq_cfg, freeze=False)
            self._fn = make_eq_fn(self.eq_cfg)

    @property
    def weights(self) -> np.ndarray:
        """(C, L) current per-channel equalizer taps."""
        return jax.device_get(self._state.w)

    @property
    def cm_err(self) -> np.ndarray:
        """(C,) CMA cost E[(|y|^2 - R2)^2] of the last block (convergence
        observable; ~0 when the channel is inverted)."""
        return self._last_cm_err.copy()

    def reset(self) -> None:
        """Queue-flush semantics: drop staged data and the FIR history
        (the stream is discontinuous) but KEEP the converged weights --
        the channel response is a physical property that survives a data
        gap (use :meth:`reset_eq` to also forget the weights)."""

        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(self.engine.channels)]
        self._state = self._state._replace(
            hist=jnp.zeros(self._state.hist.shape, jnp.complex64))
        self.engine.reset()

    def reset_eq(self) -> None:
        if self.dd_switch is not None and self.eq_cfg.mode == "dd":
            # Fresh identity weights need re-acquisition: DD decisions on
            # an unequalized channel are unreliable, so drop back to CMA.
            self.eq_cfg = dataclasses.replace(self.eq_cfg, mode="cma")
            self._fn = make_eq_fn(self.eq_cfg)
        self._lock_streak = 0
        self._state = eq_init(self.eq_cfg, (self.engine.channels,))
        self._last_cm_err = np.zeros(self.engine.channels, np.float32)
        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(self.engine.channels)]
        self.updates = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)
