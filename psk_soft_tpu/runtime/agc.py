"""AGC/squelch front-end wrapped around the bank engines.

Extension beyond the reference (see ops/agc.py): normalizes each channel's
level before demodulation and mutes dead channels, the way a REDHAWK
deployment chains an AGC component in front of psk_soft.  Mirrors the
AutoCfoEngine wrapper contract (runtime/autocfo.py): per-channel complex
``push`` and time-major ``push_planes`` both pass through gained; everything
else (step/flush/reset/configure/packets) delegates to the wrapped engine.

Two data paths, equivalence-gated in tests:

- **device batched** (``push_block``/``push_planes``): the (C, T) block or
  (T, C) planes run through the jitted matmul form (ops/agc.agc_block) in one
  launch.
- **host ragged** (``push``): per-channel pushes of arbitrary length run the
  same chunk EMA on the host in float64 via the segment closed form (one
  (K, K) numpy matmul per 512-chunk segment -- no Python-per-chunk loop).

Samples that do not fill a whole chunk are staged per channel, so any push
granularity yields the same gains as one-shot processing.  int16 wire planes
are rejected like AutoCfoEngine: gain before dequantization would silently
change the wire contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.agc import AgcConfig, agc_init, make_agc_fn

_SEG = 512  # chunks per host-side closed-form segment


class AgcFrontEnd:
    """AGC + squelch in front of any bank engine.

    Args:
      engine: wrapped bank engine (BatchEngine, FullKernelBatchEngine,
        MixedKernelBatchEngine, ...).
      agc_cfg: AGC configuration; ``chunk`` defaults to the engine's sps so
        the gain is constant within each symbol.
    """

    def __init__(self, engine, agc_cfg: AgcConfig | None = None):
        self.engine = engine
        if agc_cfg is None:
            agc_cfg = AgcConfig(chunk=engine.cfg.sps)
        self.agc_cfg = agc_cfg
        c = engine.channels
        self._power = np.ones(c, np.float64)
        self._primed = np.zeros(c, bool)
        self._tail = [np.zeros(0, np.complex64) for _ in range(c)]
        self._dev_fn = None
        self._dev_state = None
        # Host closed-form mats (float64), built lazily per segment length.
        self._mats: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- host ragged path --------------------------------------------------

    def _host_mats(self, k: int):
        if k not in self._mats:
            a = self.agc_cfg.alpha
            j = np.arange(k)
            expo = j[:, None] - j[None, :]
            l = a * (1.0 - a) ** np.maximum(expo, 0) * (expo >= 0)
            self._mats[k] = (l, (1.0 - a) ** (j + 1))
        return self._mats[k]

    def _host_gain(self, c: int, x: np.ndarray) -> np.ndarray:
        """Chunk EMA + gain for one channel (float64, segment matmuls)."""
        cfg = self.agc_cfg
        k = x.size // cfg.chunk
        q = np.mean(np.abs(x.reshape(k, cfg.chunk)) ** 2, axis=-1
                    ).astype(np.float64)
        p = np.empty(k, np.float64)
        pos = 0
        while pos < k:
            seg = min(_SEG, k - pos)
            l, d = self._host_mats(seg)
            if not self._primed[c]:
                p0 = q[0]
            else:
                p0 = self._power[c]
            ps = l[:seg, :seg] @ q[pos:pos + seg] + d[:seg] * p0
            if not self._primed[c] and pos == 0:
                ps[0] = q[0]
            p[pos:pos + seg] = ps
            self._power[c] = ps[-1]
            self._primed[c] = True
            pos += seg
        gain = cfg.target_rms / np.sqrt(np.maximum(p, cfg.eps))
        if cfg.squelch_power > 0.0:
            gain = np.where(p >= cfg.squelch_power, gain, 0.0)
        return gain

    def push(self, c: int, x) -> None:
        """Per-channel ragged push; sub-chunk remainders are staged."""
        cfg = self.agc_cfg
        x = np.concatenate([self._tail[c], np.asarray(x, np.complex64)])
        n = (x.size // cfg.chunk) * cfg.chunk
        self._tail[c] = x[n:]
        if not n:
            return
        head = x[:n]
        gain = self._host_gain(c, head)
        y = (head.reshape(-1, cfg.chunk)
             * gain[:, None]).reshape(-1).astype(np.complex64)
        self.engine.push(c, y)

    # -- device batched paths ----------------------------------------------

    def _device(self):
        if self._dev_fn is None:
            self._dev_fn = make_agc_fn(self.agc_cfg)
        # Re-seed the device carry from the host-tracked truth so the two
        # paths can interleave freely.
        self._dev_state = type(agc_init(self.agc_cfg))(
            power=jnp.asarray(self._power.astype(np.float32)),
            primed=jnp.asarray(self._primed))
        return self._dev_fn

    def _absorb(self, st) -> None:
        self._power = np.asarray(st.power, np.float64).copy()
        self._primed = np.asarray(st.primed, bool).copy()

    def push_block(self, x) -> None:
        """Lockstep (C, T) block through the jitted matmul form, then the
        wrapped engine's per-channel ingest."""
        if any(t.size for t in self._tail):
            raise ValueError("staged sub-chunk tails pending; lockstep "
                             "push_block cannot interleave with ragged "
                             "remainders")

        fn = self._device()
        st, y, _ = fn(self._dev_state,
                      jnp.asarray(np.asarray(x, np.complex64)))
        self._absorb(st)
        y = jax.device_get(y)
        for c in range(self.engine.channels):
            self.engine.push(c, y[c])

    def push_planes(self, re, im) -> None:
        """Time-major (T, C) f32 planes, gained on device, passed through."""
        if getattr(self.engine, "_ingest_scale", None) is not None:
            raise ValueError("AGC before int16 dequantization would change "
                             "the wire contract; build the inner engine "
                             "without ingest_scale")
        if any(t.size for t in self._tail):
            raise ValueError("staged sub-chunk tails pending; push_planes "
                             "cannot interleave with ragged remainders")
        fn = self._device()
        # Combine the planes on the device.
        x = jax.lax.complex(jnp.asarray(re).T, jnp.asarray(im).T)   # (C, T)
        st, y, _ = fn(self._dev_state, x)
        self._absorb(st)
        self.engine.push_planes(np.asarray(y.real).T.astype(np.float32),
                                np.asarray(y.imag).T.astype(np.float32))

    # -- passthrough ---------------------------------------------------------

    @property
    def gains_db(self) -> np.ndarray:
        """Current per-channel gain in dB (observability)."""
        g = self.agc_cfg.target_rms / np.sqrt(
            np.maximum(self._power, self.agc_cfg.eps))
        return (20.0 * np.log10(np.maximum(g, 1e-30))).astype(np.float32)

    @property
    def squelched(self) -> np.ndarray:
        """Per-channel squelch state (True = muted)."""
        if self.agc_cfg.squelch_power <= 0.0:
            return np.zeros_like(self._primed)
        return self._primed & (self._power < self.agc_cfg.squelch_power)

    def reset_agc(self) -> None:
        self._power[:] = 1.0
        self._primed[:] = False
        self._tail = [np.zeros(0, np.complex64)
                      for _ in range(self.engine.channels)]

    def __getattr__(self, name):
        return getattr(self.engine, name)
