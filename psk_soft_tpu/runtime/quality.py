"""Per-channel link-quality monitor wrapped around the bank engines.

Extension beyond the reference (see ops/quality.py): EVM / M2M4-SNR /
carrier-lock tracking for every channel, updated from the soft-decision
packets the engine already emits -- the wrapper taps ``step_packets`` /
``flush_packets``, so it composes with any engine surface (Batch, FullKernel,
Mixed, Group members, AutoCfo/Agc-wrapped stacks) without touching the data
path.  Follows the AgcFrontEnd / AutoCfoEngine wrapper contract: everything
not overridden delegates to the wrapped engine.

Per block the (C, S) soft payload runs one jitted moment-reduction launch
(ops/quality.block_quality); the monitor then folds the block summaries into
per-channel EMAs on the host (alpha per *symbol*, normalized by block count,
so different block sizes converge identically).  ``snapshot()`` returns the
current per-channel state in engineering units; ``alarms()`` flags channels
whose lock or SNR sits below thresholds -- the "squelch view" an operator
watches.  Mixed banks are detected automatically (``engine.params.m``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.quality import evm_pct, make_quality_fn, snr_db
from .streams import PORT_SOFT


class QualityMonitor:
    """EVM / SNR / lock tracking in front of any bank engine's packet API.

    Args:
      engine: wrapped bank engine (or wrapper stack) exposing
        ``step_packets``/``flush_packets`` and ``channels``.
      alpha: EMA weight per *symbol* (effective averaging window is
        ``1/alpha`` symbols); 1.0 = latest block only.
      m: constellation size override -- int or (C,) array; default is the
        engine's per-channel modes (mixed banks) or ``cfg.constellation_size``.
    """

    def __init__(self, engine, alpha: float = 0.01, m=None):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        self.engine = engine
        self.alpha = float(alpha)
        if m is None:
            params = getattr(engine, "params", None)
            m = (np.asarray(params.m, np.int32) if params is not None
                 else engine.cfg.constellation_size)
        self._m = m
        self._fn = make_quality_fn(m)
        c = engine.channels
        self._sym = np.zeros(c, np.int64)       # total symbols measured
        self._amp = np.zeros(c, np.float64)
        self._power = np.zeros(c, np.float64)
        self._snr = np.zeros(c, np.float64)
        self._lock = np.zeros(c, np.float64)
        self._evm2 = np.zeros(c, np.float64)    # EMA of EVM^2 (power-like)

    # -- update --------------------------------------------------------------

    def observe(self, soft: np.ndarray) -> None:
        """Fold one (C, S) block of soft decisions into the EMAs."""
        soft = np.asarray(soft)
        if soft.ndim != 2 or soft.shape[0] != self.engine.channels:
            raise ValueError(f"expected ({self.engine.channels}, S) soft "
                             f"block; got {soft.shape}")
        if soft.shape[1] == 0:
            return
        q = self._fn(jnp.asarray(soft))
        n = np.asarray(q.count, np.int64)
        # Per-symbol EMA folded once per block: weight = 1-(1-a)^n, exact
        # for a constant within the block, so block size never biases the
        # time constant.
        w = 1.0 - (1.0 - self.alpha) ** n
        first = self._sym == 0
        w = np.where(first, 1.0, w)
        w = np.where(n > 0, w, 0.0)

        def fold(acc, val):
            return (1.0 - w) * acc + w * np.asarray(val, np.float64)

        self._amp = fold(self._amp, q.amp)
        self._power = fold(self._power, q.power)
        self._snr = fold(self._snr, q.snr)
        self._lock = fold(self._lock, q.lock)
        self._evm2 = fold(self._evm2, np.asarray(q.evm, np.float64) ** 2)
        self._sym += n

    def _tap(self, pkts):
        if pkts:
            soft = pkts.get(PORT_SOFT)
            if soft is not None and soft.data.size:
                self.observe(soft.data)
        return pkts

    # -- engine surface ------------------------------------------------------

    def step_packets(self):
        return self._tap(self.engine.step_packets())

    def flush_packets(self):
        return self._tap(self.engine.flush_packets())

    def reset(self) -> None:
        self.reset_quality()
        self.engine.reset()

    def reset_quality(self) -> None:
        for a in (self._amp, self._power, self._snr, self._lock, self._evm2):
            a[:] = 0.0
        self._sym[:] = 0

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Current per-channel quality in engineering units."""
        return {
            "symbols": self._sym.copy(),
            "amp": self._amp.astype(np.float32),
            "power": self._power.astype(np.float32),
            "snr_db": snr_db(self._snr),
            "evm_pct": evm_pct(np.sqrt(self._evm2)),
            "lock": self._lock.astype(np.float32),
        }

    def alarms(self, min_lock: float = 0.5,
               min_snr_db: float = 3.0) -> np.ndarray:
        """(C,) bool: channels measured but below lock/SNR thresholds."""
        measured = self._sym > 0
        bad = (self._lock < min_lock) | (snr_db(self._snr) < min_snr_db)
        return measured & bad

    def __getattr__(self, name):
        return getattr(self.engine, name)
