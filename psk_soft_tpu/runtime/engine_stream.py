"""Single-stream engines: the serviceFunction equivalent.

StreamEngine mirrors the reference's per-packet service loop (C4,
cpp/psk_soft.cpp:346-618): getPacket -> flush/mode/reset checks -> property
snapshot -> SRI propagation -> block step -> four conditional pushPackets.
StreamRegistry multiplexes streamIDs to per-stream engines (BulkIO port
semantics).  Part of the runtime/engine facade (import from there).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

# Structured logging in place of the reference's log4cxx macros
# (PREPARE_LOGGING/LOG_WARN/LOG_DEBUG, cpp/psk_soft.cpp:33,355,361,639-650).
logger = logging.getLogger("psk_soft_tpu.engine")

from ..config import DemodConfig
from ..models import blockpsk, psk
from .. import state as state_mod
from .streams import (SRI, Packet, PortStats, PORT_BITS, PORT_PHASE,
                      PORT_SAMPLE_INDEX, PORT_SOFT, propagate_sri,
                      record_packets)


@dataclasses.dataclass
class EngineMetrics:
    """Observability counters (SURVEY.md section 5: add symbols out, resyncs)."""

    packets_in: int = 0
    samples_in: int = 0
    symbols_out: int = 0
    bits_out: int = 0
    resets: int = 0
    reconfigures: int = 0
    real_mode_drops: int = 0
    eos_seen: int = 0


class _PipelineOps:
    """Pipeline-kind dispatch: exact scan vs feed-forward."""

    def __init__(self, kind: str):
        if kind == "ff":
            self.init = lambda cfg, shape=(): blockpsk.ff_init(cfg, shape)
            self.block = blockpsk.demod_block_ff
        elif kind == "exact":
            self.init = lambda cfg, shape=(): state_mod.init_state(cfg, shape)
            self.block = psk.demod_block
        else:
            raise ValueError(f"unknown pipeline {kind!r}")
        self.kind = kind


class StreamEngine:
    """Single-stream streaming demodulator with reference service semantics."""

    def __init__(self, cfg: DemodConfig, block_symbols: int = 512,
                 pipeline: str = "ff"):
        self.cfg = cfg
        self.block_symbols = int(block_symbols)
        self._ops = _PipelineOps(pipeline)
        self._state = self._ops.init(cfg)
        self._staging = np.zeros(0, np.complex64)
        self._sri: Optional[SRI] = None
        self._sri_dirty = True
        # Per-output-port counters (ProvidesPortStatisticsProvider analog,
        # psk_soft.scd.xml:86-95).
        self.port_stats: dict[str, PortStats] = {}
        self._time_origin: Optional[float] = None  # time of stream sample 0
        self._symbols_emitted = 0    # valid outputs so far (for timestamps)
        self._symbols_consumed = 0   # whole symbols fed to the device
        self.metrics = EngineMetrics()
        from ..utils.profiling import StepTimer
        self.step_timer = StepTimer()  # per-device-block wall time
        self._fns: dict = {}

    # ------------------------------------------------------------- config

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change: explicit resync (C7 semantics).

        Mirrors cpp/psk_soft.cpp:365-426,619-651 -- the carry is re-derived,
        not cleared, so tracking survives compatible changes.
        """
        if new_cfg == self.cfg:
            return
        logger.debug("reconfigure: %s -> %s", self.cfg, new_cfg)
        if self._ops.kind == "exact":
            self._state = state_mod.reconfigure(self.cfg, new_cfg, self._state)
        else:
            self._state = reconfigure_ff(self.cfg, new_cfg, self._state)
        self.cfg = new_cfg
        self._sri_dirty = True
        # Conservatively drop back to the flexible (warm-up-capable) program:
        # a resync may leave partially-filled windows.
        self._symbols_consumed = 0
        # Re-anchor timestamps: the resync changes the symbol period and may
        # suppress emission for a re-warm-up, so the old origin/counter pair
        # no longer maps emitted-symbol index to time.
        self._symbols_emitted = 0
        self._time_origin = None
        self.metrics.reconfigures += 1

    def reset(self) -> None:
        """Full demod state reset (the resetState property,
        psk_soft.prf.xml:55-60, consumed at cpp/psk_soft.cpp:365-372)."""
        self._state = self._ops.init(self.cfg)
        self._staging = np.zeros(0, np.complex64)
        self._symbols_emitted = 0
        self._symbols_consumed = 0
        self._time_origin = None  # re-anchor timestamps at the next packet
        self.metrics.resets += 1

    def _reset_phase_only(self) -> None:
        """Clear only the phase-fit history (LinearFit::reset with a new
        sample rate, cpp/psk_soft.cpp:89-102): timing window, warm-up and
        staging survive."""
        fresh = self._ops.init(self.cfg)
        if self._ops.kind == "ff":
            self._state = self._state._replace(
                phase_hist=fresh.phase_hist, phase_count=fresh.phase_count,
                last_phase=fresh.last_phase)
        else:
            self._state = self._state._replace(
                ring=fresh.ring, ring_pos=fresh.ring_pos,
                ring_fill=fresh.ring_fill, phase_est=fresh.phase_est)

    # ------------------------------------------------------------- data

    def process(self, packet: Packet) -> dict[str, Packet]:
        """Feed one input packet; returns {port_name: Packet} for non-empty
        outputs (like the four conditional pushPackets,
        cpp/psk_soft.cpp:605-615)."""
        self.metrics.packets_in += 1
        if packet.input_queue_flushed:
            # cpp/psk_soft.cpp:353-357: data was dropped upstream; restart
            # tracking rather than demodulate across the gap.
            logger.warning("input queue flushed - data has been thrown on "
                           "the floor; flushing internal buffers (stream %s)",
                           packet.sri.stream_id)
            self.reset()
        if packet.sri.mode != 1:
            # cpp/psk_soft.cpp:359-363: cannot work with real data.
            logger.warning("cannot work with real data (stream %s mode=%d)",
                           packet.sri.stream_id, packet.sri.mode)
            self.metrics.real_mode_drops += 1
            return {}
        if self._sri is None or packet.sri != self._sri or packet.sri_changed:
            if self._sri is not None and packet.sri.xdelta != self._sri.xdelta:
                # Rate change invalidates only the phase-tracker history
                # (cpp/psk_soft.cpp:394-397 -> LinearFit.reset with the new
                # rate clears the fit; the timing deques survive).
                self._reset_phase_only()
                # Re-anchor the timestamp base: output times are computed as
                # origin + new_xdelta*sps*k, so the old (origin, k) pair would
                # misdate every packet after the rate change.  Symbols emitted
                # from this packet on are timed from this packet's T; staged
                # old-rate samples ahead of it are nudged to the new clock
                # (bounded by one block -- acceptable, like the reference's
                # input-packet-T stamping).
                self._time_origin = packet.t - \
                    packet.sri.xdelta * float(self._staging.size)
                self._symbols_emitted = 0
            self._sri = packet.sri
            self._sri_dirty = True

        data = np.asarray(packet.data, np.complex64).ravel()
        if self._time_origin is None:
            self._time_origin = packet.t
        self.metrics.samples_in += data.size
        self._staging = np.concatenate([self._staging, data])

        outputs = self._drain(final=packet.eos)
        if packet.eos:
            self.metrics.eos_seen += 1
            outputs = self._mark_eos(outputs, packet)
        return record_packets(self.port_stats, outputs)

    # ------------------------------------------------------------- internals

    def _step_fn(self, steady: bool) -> Callable:
        # One jitted step per (config, steadiness); XLA re-specializes per
        # block shape (steady state uses a single shape, EOS adds one more).
        key = (self.cfg, steady)
        fn = self._fns.get(key)
        if fn is None:
            import functools
            if self._ops.kind == "ff":
                fn = jax.jit(functools.partial(self._ops.block, self.cfg,
                                               assume_steady=steady))
            else:
                fn = jax.jit(functools.partial(self._ops.block, self.cfg))
            self._fns[key] = fn
        return fn

    def _is_steady(self) -> bool:
        """Warm-up fully behind us: timing window full and tracker window
        full; the compiled steady program then skips all warm-up machinery."""
        return (self._ops.kind == "ff" and self._symbols_consumed
                >= self.cfg.num_avg + self.cfg.phase_avg)

    def _drain(self, final: bool) -> dict[str, Packet]:
        sps = self.cfg.sps
        block = self.block_symbols * sps
        chunks = []
        while self._staging.size >= block:
            chunks.append(self._run_block(self._staging[:block]))
            self._staging = self._staging[block:]
        if final and self._staging.size >= sps:
            n = (self._staging.size // sps) * sps
            chunks.append(self._run_block(self._staging[:n]))
            self._staging = self._staging[n:]
        if final:
            self._staging = np.zeros(0, np.complex64)
        return self._assemble(chunks)

    def _run_block(self, samples: np.ndarray):
        fn = self._step_fn(self._is_steady())
        with self.step_timer.measure():
            self._state, out = fn(self._state, jnp.asarray(samples))
        self._symbols_consumed += samples.size // self.cfg.sps
        return out

    def _assemble(self, chunks) -> dict[str, Packet]:
        if not chunks:
            return {}
        chunks = [jax.device_get(c) for c in chunks]
        valid = np.concatenate([np.asarray(c.valid) for c in chunks])
        if not valid.any():
            return {}
        soft = np.concatenate([np.asarray(c.soft) for c in chunks])[valid]
        bits3 = np.concatenate([np.asarray(c.bits) for c in chunks])[valid]
        phase = np.concatenate([np.asarray(c.phase) for c in chunks])[valid]
        sidx = np.concatenate([np.asarray(c.sample_index) for c in chunks])[valid]
        nb = self.cfg.bits_per_symbol
        bits = bits3[:, :nb].reshape(-1).astype(np.int16)

        sri = self._sri or SRI(stream_id="unknown")
        out_sri = propagate_sri(self.cfg, sri)
        # Timestamp: the first emitted symbol of this batch is stream symbol
        # k0 = symbols_emitted; its first sample's time is origin+k0*sps*xdelta.
        # (Deviation, documented: the reference stamps outputs with the
        # triggering *input* packet's T, cpp/psk_soft.cpp:608-615, which is
        # off by the window latency; we stamp the actual symbol time.)
        k0 = self._symbols_emitted
        t_out = (self._time_origin or 0.0) + sri.xdelta * self.cfg.sps * k0

        self._symbols_emitted += int(valid.sum())
        self.metrics.symbols_out += int(valid.sum())
        self.metrics.bits_out += bits.size

        sri_changed = self._sri_dirty
        self._sri_dirty = False

        def pkt(data, port):
            return Packet(data=data, sri=out_sri[port], t=t_out,
                          sri_changed=sri_changed)

        return {
            PORT_SOFT: pkt(soft, PORT_SOFT),
            PORT_BITS: pkt(bits, PORT_BITS),
            PORT_PHASE: pkt(phase.astype(np.float32), PORT_PHASE),
            PORT_SAMPLE_INDEX: pkt(sidx.astype(np.int16), PORT_SAMPLE_INDEX),
        }

    def _mark_eos(self, outputs, packet) -> dict[str, Packet]:
        # EOS must reach consumers even if no data is emitted.
        if not outputs:
            sri = self._sri or packet.sri
            out_sri = propagate_sri(self.cfg, sri)
            outputs = {p: Packet(data=np.zeros(0, np.float32), sri=s,
                                 t=packet.t)
                       for p, s in out_sri.items()}
        for p in outputs.values():
            p.eos = True
        return outputs


def reconfigure_ff(old_cfg: DemodConfig, new_cfg: DemodConfig,
                   state: blockpsk.FFState) -> blockpsk.FFState:
    """C7 resync for the feed-forward carry (see state.reconfigure for the
    exact-path equivalent and the reference rules)."""
    state = jax.tree_util.tree_map(np.asarray, state)
    channel_shape = np.shape(state.seen)
    new = blockpsk.ff_init(new_cfg, channel_shape)
    new = new._replace(last_any=jnp.asarray(state.last_any))
    mf_keys = ("matched_filter", "sps", "rrc_beta", "rrc_span")
    if all(getattr(old_cfg, k) == getattr(new_cfg, k) for k in mf_keys):
        new = new._replace(mf_tail=jnp.asarray(state.mf_tail))

    resync = state_mod.resync_window(old_cfg, new_cfg, state.win_samples,
                                     state.seen)
    if resync is None:
        new = new._replace(
            win_samples=jnp.asarray(state.win_samples),
            win_energy=jnp.asarray(state.win_energy),
            seen=jnp.asarray(state.seen),
        )
    else:
        ws, we, seen = resync
        new = new._replace(win_samples=jnp.asarray(ws),
                           win_energy=jnp.asarray(we),
                           seen=jnp.asarray(seen))

    if old_cfg.constellation_size != new_cfg.constellation_size:
        return new  # phase history force-cleared (cpp/psk_soft.cpp:416-420)

    n_old, n_new = old_cfg.phase_avg, new_cfg.phase_avg
    hist = np.asarray(state.phase_hist)           # right-aligned (n_old-1,)
    # The FF history retains at most n_old-1 live values (the window's
    # newest n-1; the n-th lives only inside the fit), so cap the carried
    # count by what actually survives -- otherwise growing phase_avg counts
    # a zero slot as live history.
    count = np.minimum(np.asarray(state.phase_count), max(n_old - 1, 1))
    keep = np.minimum(count, max(n_new - 1, 0))
    m = max(n_new - 1, 0)
    L = max(n_old - 1, 0)
    # Right-align the newest keep values: new[..., s] = hist[..., L-m+s]
    # masked to s >= m-keep -- one vectorized gather, no per-channel host
    # loop (a 4096-channel property change is milliseconds, not seconds).
    if m > 0 and L > 0:
        s = np.arange(m)
        src_idx = np.clip(L - m + s, 0, L - 1)
        idx = np.broadcast_to(src_idx, channel_shape + (m,))
        gathered = np.take_along_axis(hist, idx, axis=-1)
        mask = s >= (m - np.asarray(keep)[..., None])
        new_hist = np.where(mask, gathered, 0.0).astype(np.float32)
    else:
        new_hist = np.zeros(channel_shape + (m,), np.float32)
    return new._replace(
        phase_hist=jnp.asarray(new_hist),
        phase_count=jnp.asarray(np.minimum(count, n_new).astype(np.int32)),
        last_phase=jnp.asarray(state.last_phase),
    )




class StreamRegistry:
    """Route interleaved packets of multiple streams to per-stream engines.

    BulkIO ports multiplex streams by streamID with independent SRI/EOS per
    stream (SURVEY.md section 1 L2); the reference component implicitly
    handles one stream at a time.  Here each streamID gets its own
    StreamEngine (lazily created with the registry's config); EOS retires
    the stream.
    """

    def __init__(self, cfg: DemodConfig, block_symbols: int = 512,
                 pipeline: str = "ff", max_streams: int = 1024):
        self.cfg = cfg
        self.block_symbols = block_symbols
        self.pipeline = pipeline
        self.max_streams = max_streams
        self.engines: dict[str, StreamEngine] = {}

    def process(self, packet: Packet) -> dict[str, Packet]:
        sid = packet.sri.stream_id
        eng = self.engines.get(sid)
        if eng is None:
            if len(self.engines) >= self.max_streams:
                raise RuntimeError(f"stream limit {self.max_streams} reached")
            eng = StreamEngine(self.cfg, self.block_symbols, self.pipeline)
            self.engines[sid] = eng
        out = eng.process(packet)
        if packet.eos:
            del self.engines[sid]
        return out

    def configure(self, new_cfg: DemodConfig) -> None:
        self.cfg = new_cfg
        for eng in self.engines.values():
            eng.configure(new_cfg)


