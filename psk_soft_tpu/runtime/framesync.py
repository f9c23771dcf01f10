"""Streaming frame synchronizer wrapped around the bank engines.

Extension beyond the reference (see ops/framesync.py): detects unique-word
frame starts in the demodulated soft stream, resolves the M-fold carrier
ambiguity per frame, and emits aligned, derotated, re-sliced payloads.
Follows the QualityMonitor wrapper contract (runtime/quality.py): taps
``step_packets``/``flush_packets`` soft payloads, everything else delegates
to the wrapped engine.

Streaming is EXACTLY one-shot detection: the local-max peak criterion
(ops/framesync.detect_peaks) depends only on a bounded neighborhood of the
detection statistic, so the syncer holds back just enough lookahead
(``sep - 1`` correlation lags, i.e. ``sep + uw - 2`` symbols) plus the
payload span before committing a frame start, and carries a bounded
(C, ~frame+sep) soft tail across blocks -- no re-detection, no duplicates,
identical frames for any block split (gated in tests/test_framesync.py).

**Device-resident (round 4).**  The retained tail lives on device, the
correlation/local-max/compaction run as one launch per scan
(ops/framesync.detect_uw_sparse), and the host fetches only sparse
candidates (16 bytes each) plus the committed frames' payload rows (one
batched gather launch, ops/framesync.extract_heads) -- host bytes per
block are proportional to FRAMES, not samples.  When the wrapped engine
exposes ``set_device_tap`` (the _PipelinedPackets batch engines), the
syncer observes the kernel's device-resident block outputs directly, so
sync adds no plane-sized host transfer at all; otherwise it taps the
host packet stream and uploads blocks once (the upload replaces the old
path's full correlation-plane FETCH per scan, runtime/framesync.py@r3:96).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.framesync import (Frame, FrameFormat, detect_uw_sparse,
                             extract_heads, resolve_rotation_angle)
from .streams import PORT_SOFT


@jax.jit
def _tm_combine(re, im, inv):
    """Time-major kernel planes -> channel-major complex soft block
    (device; handles int8 soft_i8 planes via the dequantize scale)."""
    return (jax.lax.complex(re.astype(jnp.float32) * inv,
                            im.astype(jnp.float32) * inv)).T


@jax.jit
def _dequant_cmajor(re_q, im_q, inv):
    return jax.lax.complex(re_q.astype(jnp.float32) * inv,
                           im_q.astype(jnp.float32) * inv)


@jax.jit
def _append(tail, block):
    return jnp.concatenate([tail, block], axis=1)


class FrameSyncer:
    """UW frame sync on a bank's soft-decision stream.

    Args:
      engine: wrapped bank engine (or wrapper stack), or an int channel
        count for standalone use via :meth:`observe`.
      fmt: frame format (UW indices, payload length, M, threshold).
      max_frames: ring limit on buffered frames (oldest dropped, counted
        in ``dropped_frames``) so an unserviced syncer cannot grow
        unboundedly.
    """

    def __init__(self, engine, fmt: FrameFormat, max_frames: int = 4096,
                 device_tap: bool = True):
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        self.fmt = fmt
        self.max_frames = int(max_frames)
        # Emit peak t only once norm[t .. t+sep-1] is final AND the payload
        # is present: lookahead = max(frame span, detection window span).
        self._need_after = max(fmt.frame_len,
                               fmt.separation + fmt.uw_len - 1)
        # Left context so future peaks' look-back windows stay intact.
        self._keep_back = fmt.separation - 1
        self._buf = None        # device (C, L) complex64; None = empty
        self._buf_len = 0
        self._base = 0          # absolute symbol index of buf[:, 0]
        self._next_scan = 0     # first absolute start not yet committed
        self.frames: list[Frame] = []
        self.dropped_frames = 0
        self.frames_synced = 0
        # Observe the wrapped engine's device-resident block outputs when
        # it offers the hook (frames-proportional host traffic); fall back
        # to tapping the host packet stream otherwise.
        self._tap_device = False
        if self.engine is not None and device_tap:
            hook = getattr(self.engine, "set_device_tap", None)
            if callable(hook):
                hook(self._observe_engine_out)
                self._tap_device = True

    # -- core ----------------------------------------------------------------

    def observe(self, soft: np.ndarray) -> list[Frame]:
        """Fold one (C, S) soft block; returns frames committed by it."""

        soft = np.asarray(soft, np.complex64)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        if soft.shape[1] == 0:
            return []
        return self.observe_device(jnp.asarray(soft))

    def observe_device(self, soft) -> list[Frame]:
        """:meth:`observe` for an already-device-resident (C, S) complex
        block: appends to the device tail, scans, fetches only sparse
        candidates + committed payloads."""
        if soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) device block")
        if soft.shape[1]:
            self._buf = (soft if self._buf is None
                         else _append(self._buf, soft))
            self._buf_len = int(self._buf.shape[1])
        new = self._scan()
        self._trim()
        return self._commit(new)

    def _observe_engine_out(self, out) -> None:
        """Device tap (engine ``set_device_tap`` hook): fold one raw block
        output -- TMOutputs or channel-major DemodOutputs -- without any
        plane-sized host transfer."""
        soft = self._engine_out_soft(out)
        if soft is not None and soft.shape[1]:
            self.observe_device(soft)

    def _engine_out_soft(self, out):
        from .engine import TMOutputs
        from ..models.full import QuantSoft

        if out is None:
            return None
        if isinstance(out, TMOutputs):
            fo = out.fo
            re, im = fo.soft_re, fo.soft_im
            v = out.valid_rows
            if v is not None:
                idx = np.flatnonzero(np.asarray(v))
                if idx.size == 0:
                    return None
                lo, hi = int(idx[0]), int(idx[-1]) + 1
                if hi - lo != idx.size:      # non-contiguous (never today)
                    sel = jnp.asarray(idx)
                    re, im = jnp.take(re, sel, 0), jnp.take(im, sel, 0)
                else:
                    re, im = re[lo:hi], im[lo:hi]
            inv = 1.0 / out.soft_scale if out.soft_scale else 1.0
            return _tm_combine(re, im, jnp.float32(inv))
        # Channel-major DemodOutputs (warm-up blocks): lockstep bank, so
        # row 0 of the valid plane gives the emitted-symbol span.
        soft = out.soft
        if isinstance(soft, QuantSoft):
            soft = _dequant_cmajor(soft.re_q, soft.im_q,
                                   jnp.float32(1.0 / soft.scale))
        v = np.asarray(out.valid[0] if out.valid.ndim > 1 else out.valid)
        idx = np.flatnonzero(v)
        if idx.size == 0:
            return None
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        if hi - lo != idx.size:
            return jnp.take(soft, jnp.asarray(idx), axis=1)
        return soft[:, lo:hi]

    def _commit(self, new: list[Frame]) -> list[Frame]:
        if new:
            self.frames_synced += len(new)
            self.frames.extend(new)
            excess = len(self.frames) - self.max_frames
            if excess > 0:
                del self.frames[:excess]
                self.dropped_frames += excess
        return new

    def _scan(self, hi: int | None = None) -> list[Frame]:
        l = self._buf_len
        if hi is None:
            hi = l - self._need_after      # inclusive last committable t
        lo = self._next_scan - self._base
        if hi < lo or l < self.fmt.uw_len:
            return []
        fmt = self.fmt
        # One detection launch over the bounded device tail + new block;
        # fetch = 16 bytes per candidate (ops/framesync sparse path).
        cand = detect_uw_sparse(self._buf, fmt)
        self._next_scan = self._base + hi + 1
        if cand.idx.shape[0] == 0:
            return []
        ts = cand.idx[:, 1].astype(np.int64)
        keep = (ts >= lo) & (ts <= hi)
        idx, vals = cand.idx[keep], cand.vals[keep]
        if idx.shape[0] == 0:
            return []
        cs = idx[:, 0].astype(np.int64)
        ts = idx[:, 1].astype(np.int64)
        ks, ress = resolve_rotation_angle(vals[:, 1].astype(np.float64),
                                          fmt.m)
        # Batched payload derotate + re-slice: ONE gather launch, fetch
        # exactly the committed frames' payload rows.
        pm, bits = extract_heads(self._buf, fmt, cs, ts, ks)
        return [Frame(channel=int(cs[i]), start=self._base + int(ts[i]),
                      rotation=int(ks[i]), corr=float(vals[i, 0]),
                      residual_phase=float(ress[i]),
                      soft=pm[i], bits=bits[i])
                for i in range(idx.shape[0])]

    def _trim(self) -> None:
        keep_from = self._next_scan - self._base - self._keep_back
        if keep_from > 0 and self._buf is not None:
            self._buf = (self._buf[:, keep_from:]
                         if keep_from < self._buf_len else None)
            self._buf_len = max(self._buf_len - keep_from, 0)
            self._base += keep_from

    # -- engine surface --------------------------------------------------------

    def _tap(self, pkts):
        # With the device tap registered, blocks were already observed
        # device-side at emit time; the packet stream passes through
        # untouched.
        if pkts and not self._tap_device:
            soft = pkts.get(PORT_SOFT)
            if soft is not None and soft.data.size:
                self.observe(soft.data)
        return pkts

    def step_packets(self):
        return self._tap(self.engine.step_packets())

    def flush_packets(self):
        pkts = self._tap(self.engine.flush_packets())
        self.finalize()
        return pkts

    def finalize(self) -> list[Frame]:
        """End of stream: commit frames in the held-back tail whose payload
        is fully present (right detection windows see the stream edge,
        matching one-shot extraction on the whole stream)."""
        new = self._scan(hi=self._buf_len - self.fmt.frame_len)
        self._trim()
        return self._commit(new)

    def pop_frames(self) -> list[Frame]:
        """Drain and return all buffered frames."""
        out, self.frames = self.frames, []
        return out

    def reset(self) -> None:
        self.reset_sync()
        if self.engine is not None:
            self.engine.reset()

    def reset_sync(self) -> None:
        self._buf = None
        self._buf_len = 0
        self._base = 0
        self._next_scan = 0
        self.frames = []

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)


class GroupFrameSyncer:
    """Per-channel frame formats over one bank (mixed-format banks).

    Mixed banks (models/mixed.py, MixedKernelBatchEngine) demodulate a
    heterogeneous (M, differential) channel mix in one kernel; their
    frame structure is naturally heterogeneous too.  This stage groups
    channels by format and runs one FrameSyncer per group over the
    channel-row slices of the tapped soft block -- each group keeps the
    single-format device correlation (one launch per group per block),
    and frames come back with bank-level channel indices.

    Args:
      engine: wrapped bank engine (or an int channel count for
        standalone ``observe``).
      fmts: per-channel formats, length = channels (channels sharing a
        format object form one group).
    """

    def __init__(self, engine, fmts, max_frames: int = 4096):
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        fmts = list(fmts)
        if len(fmts) != self._channels:
            raise ValueError(f"need one format per channel "
                             f"({self._channels}); got {len(fmts)}")
        groups: dict[int, list[int]] = {}
        uniq: list = []
        for c, fmt in enumerate(fmts):
            for gi, g_fmt in enumerate(uniq):
                if g_fmt is fmt or g_fmt == fmt:
                    groups[gi].append(c)
                    break
            else:
                uniq.append(fmt)
                groups[len(uniq) - 1] = [c]
        self.fmts = fmts
        self._rows = [np.asarray(groups[gi], np.int64)
                      for gi in range(len(uniq))]
        self._syncers = [FrameSyncer(len(rows), uniq[gi],
                                     max_frames=max_frames)
                         for gi, rows in enumerate(self._rows)]

    # -- core ----------------------------------------------------------------

    def observe(self, soft: np.ndarray) -> list[Frame]:
        soft = np.asarray(soft, np.complex64)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        out = []
        for rows, sync in zip(self._rows, self._syncers):
            for f in sync.observe(np.ascontiguousarray(soft[rows])):
                f.channel = int(rows[f.channel])
                out.append(f)
        return out

    def finalize(self) -> list[Frame]:
        out = []
        for rows, sync in zip(self._rows, self._syncers):
            for f in sync.finalize():
                f.channel = int(rows[f.channel])
                out.append(f)
        return out

    def pop_frames(self) -> list[Frame]:
        out = []
        for rows, sync in zip(self._rows, self._syncers):
            for f in sync.pop_frames():
                # observe/finalize already remapped committed frames; a
                # direct pop on a standalone group must remap too -- the
                # mapping is idempotent only when done once, so frames
                # drain through THIS object's pop, never the children's.
                out.append(f)
        out.sort(key=lambda f: (f.start, f.channel))
        return out

    @property
    def frames_synced(self) -> int:
        return sum(s.frames_synced for s in self._syncers)

    @property
    def dropped_frames(self) -> int:
        return sum(s.dropped_frames for s in self._syncers)

    def reset_sync(self) -> None:
        for s in self._syncers:
            s.reset_sync()

    def reset(self) -> None:
        self.reset_sync()
        if self.engine is not None:
            self.engine.reset()

    # -- engine surface --------------------------------------------------------

    def _tap(self, pkts):
        if pkts:
            soft = pkts.get(PORT_SOFT)
            if soft is not None and soft.data.size:
                self.observe(soft.data)
        return pkts

    def step_packets(self):
        return self._tap(self.engine.step_packets())

    def flush_packets(self):
        pkts = self._tap(self.engine.flush_packets())
        self.finalize()
        return pkts

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)
