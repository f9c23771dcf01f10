"""Automatic carrier acquisition in front of the batch engines.

Extension beyond the reference: its M-th-power tracker only locks while the
per-symbol phase step ``M * 2pi * f * sps`` stays well under pi
(cpp/psk_soft.cpp:474-481 unwraps each symbol against the previous
estimate), so a carrier offset beyond ``1 / (2*M*sps)`` cycles/sample makes
it slip cycles forever; the reference simply fails there (its tests inject
no frequency offset at all, tests/test_psk_soft.py:98-117).  This wrapper
closes that gap the way a production receiver does:

  1. stage input until ``acq_samples`` per channel have arrived,
  2. coarse-acquire per-channel CFO from the M-th-power spectrum
     (:func:`psk_soft_tpu.eval.cfo.acquire_cfo`),
  3. derotate EVERYTHING (the staged samples too -- acquisition loses no
     data) with a phase-continuous NCO and feed the wrapped engine, whose
     LinearFit-equivalent tracker then absorbs the small residual,
  4. optionally (``track=True``) watch the residual on the phase debug
     port every block and fold it back into the NCO *phase-continuously*
     (a slope change, never a phase jump) when drift approaches the edge
     of the lock range -- doppler-slew immunity the reference lacks.

The NCO runs in float64 on the host clock (wrapped ``(f*n) mod 1``), so
precision never drifts over unbounded streams; device-resident planes are
derotated on device (ops/mixer.derotate -- elementwise work XLA fuses
into the neighbouring ops) with the host supplying the wrapped start phase.

Works in front of any bank engine with the standard surface
(BatchEngine, FullKernelBatchEngine, MixedKernelBatchEngine): per-channel
complex ``push`` and, where the engine supports it, time-major f32
``push_planes`` both pass through derotated.  int16 wire planes are
rejected -- dequantize first (build the inner engine without
``ingest_scale`` and feed f32), since mixing before scaling would change
the wire contract silently.
"""

from __future__ import annotations

import numpy as np

from ..eval.cfo import acquire_cfo, cfo_from_phase
from .streams import PORT_PHASE

TWO_PI = 2.0 * np.pi


class AutoCfoEngine:
    """Acquisition + NCO derotation wrapped around a batch engine.

    Args:
      engine: the wrapped bank engine (its ``cfg``/``channels`` drive the
        defaults; every non-ingest attribute passes through).
      acq_samples: per-channel samples staged before coarse acquisition
        (more = finer FFT resolution; the staged data is replayed through
        the NCO, nothing is dropped).
      m: constellation size override for acquisition (scalar or (C,)).
        Defaults to the engine's per-channel modes (mixed banks) or
        ``cfg.constellation_size``.
      nfft: FFT size for acquisition (default: next pow2 >= acq_samples).
      track: fold the fine residual (phase-port slope, eval/cfo) back into
        the NCO whenever it exceeds ``track_guard`` of the lock range.
      track_guard: fraction of the ``1/(2*M*sps)`` lock range that triggers
        a fold (phase-continuous, no tracker reset needed).
    """

    def __init__(self, engine, *, acq_samples: int = 4096, m=None,
                 nfft: int | None = None, track: bool = False,
                 track_guard: float = 0.25):
        self.engine = engine
        self.acq_samples = int(acq_samples)
        self.nfft = nfft
        self.track = bool(track)
        self.track_guard = float(track_guard)
        self._user_m = m
        C = engine.channels
        self._m = self._derive_m()
        self.freq = None                     # (C,) cycles/sample, float64
        self._phi = np.zeros(C, np.float64)  # NCO phase offset (fold carry)
        self._n = np.zeros(C, np.int64)      # per-channel sample position
        self._pre = [np.zeros(0, np.complex64) for _ in range(C)]
        self._pre_planes: list = []          # (re, im) staged plane chunks
        self._pre_rows = 0
        self.folds = np.zeros(C, np.int64)   # track-mode refolds per channel
        self.acquisitions = 0

    # ---- plumbing ---------------------------------------------------------
    def _derive_m(self) -> np.ndarray:
        if self._user_m is not None:
            m = np.asarray(self._user_m, np.float64)
        elif hasattr(self.engine, "params"):   # mixed bank: per-channel M
            m = np.asarray(self.engine.params.m, np.float64)
        else:
            m = np.asarray(float(self.engine.cfg.constellation_size))
        return np.broadcast_to(m, (self.engine.channels,)).copy()

    def _lock_range(self) -> np.ndarray:
        return 1.0 / (2.0 * self._m * self.engine.cfg.sps)

    def __getattr__(self, name):
        # metrics / assembler / cfg / set_input_sri / step_timer / ...
        return getattr(self.engine, name)

    @property
    def cfo(self) -> np.ndarray | None:
        """Current per-channel NCO frequency (cycles/input sample)."""
        return None if self.freq is None else self.freq.copy()

    # ---- NCO --------------------------------------------------------------
    def _angle(self, c: int, count: int) -> np.ndarray:
        """Wrapped NCO phase (radians) for the next `count` samples of
        channel `c`; float64 with an fmod'd linear term so precision holds
        at any stream position."""
        n = self._n[c] + np.arange(count, dtype=np.float64)
        return TWO_PI * np.mod(self.freq[c] * n, 1.0) + self._phi[c]

    def _derotate_host(self, c: int, x: np.ndarray) -> np.ndarray:
        y = x * np.exp(-1j * self._angle(c, x.size))
        self._n[c] += x.size
        return y.astype(np.complex64)

    def _derotate_planes(self, re, im):
        """Derotate a (rows, C) plane pair; device-resident planes stay on
        device (ops/mixer.derotate), host planes stay host numpy."""
        import jax

        rows = re.shape[0]
        n0 = self._n[0]
        assert np.all(self._n == n0), "plane mode keeps channels in lockstep"
        phase0 = (TWO_PI * np.mod(self.freq * n0, 1.0) + self._phi)
        phase0 = np.mod(phase0 + np.pi, TWO_PI) - np.pi
        if isinstance(re, jax.Array):
            from ..ops.mixer import derotate
            import jax.numpy as jnp
            y_re, y_im, _ = derotate(
                re, im, jnp.asarray(self.freq.astype(np.float32)),
                jnp.asarray(phase0.astype(np.float32)))
        else:
            t = np.arange(rows, dtype=np.float64)[:, None]
            ang = (TWO_PI * np.mod(self.freq[None, :] * t, 1.0)
                   + phase0[None, :])
            c, s = np.cos(ang), np.sin(ang)
            y_re = (re * c + im * s).astype(np.float32)
            y_im = (im * c - re * s).astype(np.float32)
        self._n += rows
        return y_re, y_im

    def _fold(self, residual: np.ndarray, mask: np.ndarray) -> None:
        """Phase-continuous slope change: adjust phi so the NCO phase at the
        CURRENT position is identical under the new frequency."""
        # phi_new - phi_old = 2*pi*((f_old - f_new) * n mod 1): the NCO
        # phase at the current position is identical before/after the fold.
        self._phi[mask] += TWO_PI * np.mod(
            -residual[mask] * self._n[mask], 1.0)
        self._phi[mask] = np.mod(self._phi[mask] + np.pi, TWO_PI) - np.pi
        self.freq[mask] += residual[mask]
        self.folds[mask] += 1

    # ---- acquisition ------------------------------------------------------
    def _acquire_from(self, x: np.ndarray) -> None:
        """Coarse acquisition from a (C, T) host block."""
        self.freq = np.asarray(
            acquire_cfo(x, self._m, nfft=self.nfft), np.float64).reshape(-1)
        self.acquisitions += 1

    def _maybe_acquire(self) -> None:
        if self.freq is not None:
            return
        if self._pre_rows:                          # plane staging
            if self._pre_rows < self.acq_samples:
                return
            re = np.concatenate([np.asarray(r) for r, _ in self._pre_planes])
            im = np.concatenate([np.asarray(i) for _, i in self._pre_planes])
            self._acquire_from(
                (re[:self.acq_samples].T
                 + 1j * im[:self.acq_samples].T).astype(np.complex64))
            self._replay()
        else:                                       # per-channel staging
            if not all(s.size >= self.acq_samples for s in self._pre):
                return
            self._acquire_from(
                np.stack([s[:self.acq_samples] for s in self._pre]))
            self._replay()

    def _replay(self) -> None:
        """Feed everything staged pre-acquisition through the fresh NCO."""
        for r, i in self._pre_planes:
            self.engine.push_planes(*self._derotate_planes(
                np.asarray(r), np.asarray(i)))
        self._pre_planes, self._pre_rows = [], 0
        for c, s in enumerate(self._pre):
            if s.size:
                self.engine.push(c, self._derotate_host(c, s))
        self._pre = [np.zeros(0, np.complex64)
                     for _ in range(self.engine.channels)]

    def reacquire(self, reset_engine: bool = True) -> None:
        """Drop carrier lock and re-run coarse acquisition on the next
        ``acq_samples`` (retune / hand-off semantics).  The wrapped engine
        is reset by default: a new carrier means the old phase history is
        meaningless (same reasoning as the reference's constellation-change
        listener, cpp/psk_soft.cpp:416-420)."""
        self.freq = None
        self._phi[:] = 0.0
        self._n[:] = 0
        if reset_engine:
            self.engine.reset()

    # ---- ingest -----------------------------------------------------------
    def push(self, channel: int, data: np.ndarray) -> None:
        d = np.asarray(data, np.complex64).ravel()
        if self.freq is None:
            self._pre[channel] = np.concatenate([self._pre[channel], d])
            self._maybe_acquire()
        else:
            self.engine.push(channel, self._derotate_host(channel, d))

    def push_block(self, block) -> None:
        """Channel-major (C, n) complex append (native-bank fast path)."""
        block = np.asarray(block, np.complex64)
        if self.freq is None:
            for c in range(block.shape[0]):
                self._pre[c] = np.concatenate([self._pre[c], block[c]])
            self._maybe_acquire()
        else:
            n = (self._n[:, None]
                 + np.arange(block.shape[1], dtype=np.float64)[None, :])
            ang = (TWO_PI * np.mod(self.freq[:, None] * n, 1.0)
                   + self._phi[:, None])
            self._n += block.shape[1]
            self.engine.push_block(
                (block * np.exp(-1j * ang)).astype(np.complex64))

    def push_planes(self, re, im) -> None:
        if getattr(re, "dtype", None) == np.int16:
            raise ValueError(
                "AutoCfoEngine mixes before the engine, so int16 wire "
                "planes must be dequantized first: feed float32 planes and "
                "build the inner engine without ingest_scale")
        if self.freq is None:
            self._pre_planes.append((re, im))
            self._pre_rows += re.shape[0]
            self._maybe_acquire()
        else:
            self.engine.push_planes(*self._derotate_planes(re, im))

    # ---- engine surface ---------------------------------------------------
    def _track_packets(self, pkts):
        if not (self.track and isinstance(pkts, dict)
                and PORT_PHASE in pkts):
            return pkts
        ph = np.asarray(pkts[PORT_PHASE].data, np.float64)
        if ph.ndim != 2 or ph.shape[1] < 8:
            return pkts
        residual = cfo_from_phase(ph, self._m, self.engine.cfg.sps)
        mask = np.abs(residual) > self.track_guard * self._lock_range()
        if mask.any():
            self._fold(residual, mask)
        return pkts

    def step_packets(self):
        return self._track_packets(self.engine.step_packets())

    def step(self):
        return self.engine.step()

    def _flush_pending(self) -> None:
        """Short-stream path: if EOS arrives before ``acq_samples``,
        acquire from whatever is staged (a shorter FFT is coarser but the
        tracker still pulls in the residual) -- zero CFO only when there is
        nothing to measure."""
        if self.freq is not None:
            return
        have = (self._pre_rows if self._pre_rows
                else min((s.size for s in self._pre), default=0))
        if have >= 64:
            saved, self.acq_samples = self.acq_samples, int(have)
            try:
                self._maybe_acquire()
            finally:
                self.acq_samples = saved
        else:
            self.freq = np.zeros(self.engine.channels, np.float64)
            self._replay()

    def flush_packets(self):
        self._flush_pending()
        return self.engine.flush_packets()

    def flush(self):
        self._flush_pending()
        return self.engine.flush()

    def configure(self, new_cfg) -> None:
        self.engine.configure(new_cfg)
        self._m = self._derive_m()

    def set_params(self, params) -> None:            # mixed banks
        self.engine.set_params(params)
        self._m = self._derive_m()

    def reset(self) -> None:
        """Queue-flush semantics (cpp/psk_soft.cpp:353-357): demod state
        resets; the carrier estimate survives -- the RF chain did not
        change because packets were lost.  Use :meth:`reacquire` when the
        carrier itself may have."""
        self.engine.reset()
        self._pre = [np.zeros(0, np.complex64)
                     for _ in range(self.engine.channels)]
        self._pre_planes, self._pre_rows = [], 0
