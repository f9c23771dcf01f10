"""FEC-decoding frame stage wrapped around the frame synchronizer.

Extension beyond the reference (see ops/fec.py): decodes the convolutional
code on every synchronized frame payload, turning the receive chain into
engine -> FrameSyncer -> FecFrameDecoder -> information bits.  Follows the
wrapper contract of the other runtime stages (everything not overridden
delegates inward); the syncer's ``pop_frames`` surface is preserved --
frames come back with ``info_bits`` filled in.

Batching strategy: frames drain in bursts (one per channel per frame slot),
so payloads are decoded in ONE Viterbi launch per drain, padded to
power-of-two batch buckets to bound jit cache growth (the trellis scan
dominates; padding rows ride along in the same batched steps).

Observability: the decoder re-encodes each decoded frame and counts
disagreements with the received hard decisions -- ``corrected`` per frame
(the channel-error count the code absorbed) and a cumulative
``errors_corrected`` across the stream; frames whose re-encode mismatch
exceeds the code's plausible correction span are flagged ``suspect``
(decoder ran out of distance -- payload should not be trusted).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fec import (CODE_K7, ConvCode, conv_encode, info_bits_for,
                       make_stream_soft_fn, make_viterbi_fn, psk_llrs,
                       viterbi_stream_flush, viterbi_stream_init)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class FecFrameDecoder:
    """Viterbi-decode synchronized frame payloads.

    Args:
      syncer: a runtime.framesync.FrameSyncer (or compatible wrapper)
        whose frames carry derotated soft payloads.
      code: the convolutional code (default K=7 (171,133) rate 1/2).
      terminate: payloads end with K-1 zero flush bits (frame mode).
      suspect_fraction: flag a frame ``suspect`` when the re-encoded
        disagreement fraction exceeds this (0.08 ~ the hard-decision BER
        where the K=7 code's output starts failing).

    Payload contract: ``fmt.payload * log2(M)`` code bits must form a
    whole number of trellis steps (after depuncturing) with room for the
    flush bits -- validated at construction against the syncer's format.
    """

    def __init__(self, syncer, code: ConvCode = CODE_K7,
                 terminate: bool = True, suspect_fraction: float = 0.08,
                 interleave_rows: int | None = None,
                 labeling: str = "scd", backend: str = "auto"):
        self.syncer = syncer
        self.code = code
        self.terminate = terminate
        self.suspect_fraction = float(suspect_fraction)
        self.interleave_rows = interleave_rows
        self.labeling = labeling
        fmt = syncer.fmt
        self._m = fmt.m
        self._nb = int(np.log2(fmt.m))
        self._code_bits = fmt.payload * self._nb
        # Shared TX/RX contract: divisibility + flush-room validation.
        self.info_bits = info_bits_for(code, self._code_bits, terminate)
        if interleave_rows is not None:
            from ..ops.interleave import _perm
            _perm(self._code_bits, int(interleave_rows))   # validates
        self._decode = make_viterbi_fn(code, terminate=terminate,
                                       backend=backend)
        self.frames_decoded = 0
        self.errors_corrected = 0
        self.suspect_frames = 0

    # -- decode --------------------------------------------------------------

    def decode_payloads(self, payloads: np.ndarray):
        """(N, payload) complex soft payloads -> (info, corrected).

        info: (N, info_bits) int8; corrected: (N,) int32 re-encode
        disagreement counts.  One padded launch per power-of-two bucket.
        """

        payloads = np.ascontiguousarray(payloads, np.complex64)
        n = payloads.shape[0]
        if n == 0:
            return (np.zeros((0, self.info_bits), np.int8),
                    np.zeros(0, np.int32))
        b = _bucket(n)
        if b != n:
            payloads = np.concatenate(
                [payloads, np.zeros((b - n,) + payloads.shape[1:],
                                    np.complex64)])
        llr = psk_llrs(self._m, jnp.asarray(payloads), labeling=self.labeling)
        llr = llr.reshape(b, self._code_bits)
        if self.interleave_rows is not None:
            from ..ops.interleave import deinterleave
            llr = deinterleave(llr, self.interleave_rows)
        info = self._decode(llr)
        # Corrected-error observability: re-encode and compare against the
        # received hard decisions (same launch group, all device work).
        reenc = conv_encode(self.code, info, terminate=self.terminate)
        hard = (llr < 0)
        corrected = (reenc.astype(bool) ^ hard).sum(axis=-1)
        info, corrected = jax.device_get((info, corrected))
        return info[:n].astype(np.int8), corrected[:n].astype(np.int32)

    def _decode_frames(self, frames: list) -> list:
        if not frames:
            return frames
        info, corrected = self.decode_payloads(
            np.stack([f.soft for f in frames]))
        limit = self.suspect_fraction * self._code_bits
        for f, i, c in zip(frames, info, corrected):
            f.info_bits = i
            f.corrected = int(c)
            f.suspect = bool(c > limit)
            self.suspect_frames += f.suspect
        self.frames_decoded += len(frames)
        self.errors_corrected += int(corrected.sum())
        return frames

    # -- syncer surface --------------------------------------------------------

    def pop_frames(self) -> list:
        """Drain the syncer's frames, decoded (one batched launch)."""
        return self._decode_frames(self.syncer.pop_frames())

    def reset(self) -> None:
        """Queue-flush semantics: stream state resets downstream; the
        cumulative counters survive (engine-metrics convention -- use
        :meth:`reset_fec` to zero them explicitly)."""
        self.syncer.reset()

    def reset_fec(self) -> None:
        self.frames_decoded = 0
        self.errors_corrected = 0
        self.suspect_frames = 0

    def __getattr__(self, name):
        return getattr(self.syncer, name)


class StreamFecDecoder:
    """Streaming Viterbi over a continuous (unframed) soft stream.

    For links that run the convolutional code over the whole stream
    rather than per frame: taps ``step_packets``/``flush_packets`` soft
    payloads (the QualityMonitor wrapper contract) or standalone
    ``observe(soft)``.  Soft symbols buffer on the host; each drained
    block runs as ONE fused device launch (constellation LLRs ->
    depuncture -> ACS scan -> windowed traceback,
    ops/fec.make_stream_soft_fn) so only soft symbols go up and decoded
    bits come down -- intermediate LLR planes never cross the host
    boundary.  Bits emerge ``depth`` trellis steps
    behind the input (the standard survivor-merge argument; depth
    defaults to 10 constraint lengths, at which the output matches
    full-stream Viterbi -- gated in tests).

    The decoder assumes the encoder started at the stream head
    (``known_start``); puncturing is depunctured on device per
    period-aligned chunk.  ``pop_bits()`` drains the decoded (C, N)
    bit stream.
    """

    def __init__(self, engine, code: ConvCode = CODE_K7, m=None,
                 depth: int | None = None, block_steps: int = 512,
                 known_start: bool = True, labeling: str = "scd"):
        self.labeling = labeling
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        self.code = code
        if m is None and self.engine is not None:
            m = int(self.engine.cfg.constellation_size)
        if m is None:
            raise ValueError("pass m for standalone use")
        self._m = int(m)
        self._nb = int(np.log2(self._m))
        self.depth = int(depth) if depth is not None else 10 * code.k
        if block_steps < 1:
            raise ValueError("block_steps must be >= 1")
        # Chunk grain: a whole number of trellis steps that is ALSO a
        # whole number of symbols (puncture-period and log2(M) aligned).
        if code.puncture is not None:
            p = np.asarray(code.puncture)
            kept, period = int(p.sum()), p.shape[0]
        else:
            kept, period = code.n, 1
        g_wire = np.lcm(kept, self._nb)
        self._grain_syms = int(g_wire // self._nb)
        self._grain_steps = int(g_wire // kept * period)
        g = self._grain_steps
        self.block_steps = ((int(block_steps) + g - 1) // g) * g
        self._syms_per_block = self.block_steps // g * self._grain_syms
        self._known_start = bool(known_start)
        self._fn = make_stream_soft_fn(code, self._m, labeling)
        self._buf = np.zeros((self._channels, 0), np.complex64)
        self._state = viterbi_stream_init(code, self._channels, self.depth,
                                          known_start=known_start)
        self._steps_emitted = 0          # incl. the first `depth` garbage
        self._out = []                   # list of (C, T) decoded chunks
        self.steps_decoded = 0

    # -- core ------------------------------------------------------------

    def observe(self, soft: np.ndarray) -> None:
        """Fold one (C, S) block of soft decisions into the decoder."""
        soft = np.asarray(soft)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        if soft.shape[1] == 0:
            return
        self._buf = np.concatenate(
            [self._buf, soft.astype(np.complex64)], axis=1)
        while self._buf.shape[1] >= self._syms_per_block:
            self._emit_chunk(self._syms_per_block)

    def _emit_chunk(self, syms: int) -> None:
        chunk, self._buf = self._buf[:, :syms], self._buf[:, syms:]
        self._state, bits = self._fn(self._state,
                                     jnp.asarray(np.ascontiguousarray(chunk)))
        self._append(jax.device_get(bits))

    def _append(self, bits: np.ndarray) -> None:
        """Drop the pre-stream garbage (the first `depth` emitted steps)."""
        t = bits.shape[1]
        skip = max(0, self.depth - self._steps_emitted)
        self._steps_emitted += t
        if skip < t:
            self._out.append(np.ascontiguousarray(bits[:, skip:],
                                                  np.int8))
            self.steps_decoded += t - skip

    def finalize(self) -> None:
        """End of stream: decode everything still buffered + in-window.

        A sub-grain tail (fewer symbols than one puncture/symbol-aligned
        trellis step) cannot form a step and is dropped.
        """
        left = (self._buf.shape[1] // self._grain_syms) * self._grain_syms
        if left:
            self._emit_chunk(left)       # one distinct-shape launch at EOS
        tail = jax.device_get(viterbi_stream_flush(self.code, self._state))
        self._append(tail)

    def pop_bits(self) -> np.ndarray:
        """Drain the decoded (C, N) info-bit stream emitted so far."""
        if not self._out:
            return np.zeros((self._channels, 0), np.int8)
        out = np.concatenate(self._out, axis=1)
        self._out = []
        return out

    # -- engine surface ----------------------------------------------------

    def _tap(self, pkts):
        if pkts:
            from .streams import PORT_SOFT
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

    def reset(self) -> None:
        """Queue-flush semantics: drop buffered soft data and the decoder
        window (the stream is discontinuous); the cumulative
        ``steps_decoded`` counter survives (engine-metrics convention)."""
        self._clear()
        if self.engine is not None:
            self.engine.reset()

    def _clear(self) -> None:
        self._buf = np.zeros((self._channels, 0), np.complex64)
        self._state = viterbi_stream_init(self.code, self._channels,
                                          self.depth,
                                          known_start=self._known_start)
        self._steps_emitted = 0
        self._out = []

    def reset_fec(self) -> None:
        self._clear()
        self.steps_decoded = 0

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)
