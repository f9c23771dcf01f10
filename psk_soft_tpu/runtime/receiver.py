"""One-call receiver assembly: the CLI's stack composition as a library API.

``build_receiver`` wires the full receive chain in the canonical order
(the CLI's ``demod-batch`` flags, cli.py):

    AgcFrontEnd( EqFrontEnd( AutoCfoEngine( engine )))   <- sample side
    FrameCrcChecker( FrameDescrambler( FecFrameDecoder(
        FrameSyncer( QualityMonitor( ... )))))           <- frame side

Sample-side wrappers return as ``rx.engine`` (push data into it); the
frame side drains via ``rx.pop_frames()``.  Every stage is optional;
omitted stages collapse out of the stack.  The returned Receiver also
exposes the individual stages for observability (``rx.quality``,
``rx.fec``, ...).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DemodConfig


@dataclasses.dataclass
class Receiver:
    """The assembled stack.  ``engine`` ingests; ``frames`` drains."""

    engine: object                 # outermost sample-side stage (push here)
    frames: object | None          # outermost frame-side stage (pop here)
    quality: object | None = None  # QualityMonitor, if enabled
    syncer: object | None = None   # FrameSyncer, if enabled
    fec: object | None = None      # FecFrameDecoder, if enabled
    stream_fec: object | None = None

    def pop_frames(self) -> list:
        if self.frames is None:
            raise ValueError("receiver built without frame sync (uw=...)")
        return self.frames.pop_frames()

    def __getattr__(self, name):
        return getattr(self.engine, name)


def build_receiver(cfg: DemodConfig, channels: int, *,
                   engine: str = "batch", block_symbols: int = 1024,
                   agc: bool = False, equalize=None, acquire_cfo: bool = False,
                   quality: bool = False,
                   uw=None, frame_payload: int = 0, uw_threshold: float = 0.7,
                   fec=None, fec_interleave: int | None = None,
                   fec_labeling: str = "scd",
                   descramble=None, crc=None,
                   stream_fec=None,
                   engine_kwargs: dict | None = None) -> Receiver:
    """Assemble a complete receive chain.

    Args:
      engine: "batch" (XLA feed-forward), "full" (the steady-state flagship),
        or "chain" (the ONE-LAUNCH fused chain, runtime/chain_engine.py:
        demod + seam sync + Viterbi + CRC as a single device program per
        block -- requires uw + fec, gray labeling, no sample-side
        wrappers/descramble/interleave; the fastest path when the frame
        format is fixed).
      agc / equalize / acquire_cfo: sample-side front ends (equalize
        takes an ops.equalizer.EqConfig or True for defaults).
      quality: attach a QualityMonitor tap.
      uw: unique-word symbol indices enabling frame sync.
      fec: ops.fec.ConvCode (frame payloads Viterbi-decoded).
      descramble: ops.scramble.Lfsr (frame-synchronous additive).
      crc: ops.crc.CrcSpec (checked + stripped per frame).
      stream_fec: ops.fec.ConvCode for CONTINUOUS (unframed) decoding --
        mutually exclusive with ``fec``.

    Returns a :class:`Receiver`.
    """
    from .engine import BatchEngine, FullKernelBatchEngine

    if engine == "chain":
        if uw is None or fec is None:
            raise ValueError("engine='chain' is the fused frame pipeline; "
                             "it requires uw=... and fec=...")
        if (agc or equalize or acquire_cfo or quality or descramble
                or stream_fec or fec_interleave):
            raise ValueError("engine='chain' composes demod+sync+FEC+CRC "
                             "in ONE program; per-stage wrappers "
                             "(agc/equalize/cfo/quality/descramble/"
                             "interleave/stream_fec) need the per-stage "
                             "stack (engine='full')")
        if fec_labeling != "gray":
            raise ValueError("engine='chain' decodes gray-labeled "
                             "payloads (fec_labeling='gray')")
        from ..ops.framesync import FrameFormat
        from .chain_engine import ChainEngine
        fmt = FrameFormat(
            uw=tuple(int(v) for v in np.asarray(uw).reshape(-1)),
            payload=frame_payload, m=cfg.constellation_size,
            threshold=uw_threshold)
        eng = ChainEngine(cfg, channels, fmt, fec, crc,
                          block_symbols=block_symbols,
                          **(engine_kwargs or {}))
        return Receiver(engine=eng, frames=eng)

    kw = dict(engine_kwargs or {})
    if engine == "full":
        eng = FullKernelBatchEngine(cfg, channels,
                                    block_symbols=block_symbols, **kw)
    elif engine == "batch":
        eng = BatchEngine(cfg, channels=channels,
                          block_symbols=block_symbols, **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    if acquire_cfo:
        from .autocfo import AutoCfoEngine
        eng = AutoCfoEngine(eng)
    if equalize:
        from ..ops.equalizer import EqConfig
        from .equalizer import EqFrontEnd
        eq_cfg = (equalize if not isinstance(equalize, bool)
                  else EqConfig(dd_m=cfg.constellation_size))
        eng = EqFrontEnd(eng, eq_cfg)
    if agc:
        from ..ops.agc import AgcConfig
        from .agc import AgcFrontEnd
        eng = AgcFrontEnd(eng, AgcConfig(chunk=cfg.sps))

    qual = None
    if quality:
        from .quality import QualityMonitor
        eng = qual = QualityMonitor(eng)

    sfec = None
    if stream_fec is not None:
        if fec is not None:
            raise ValueError("fec (framed) and stream_fec (continuous) "
                             "decode the same bits two ways; pick one")
        from .fec import StreamFecDecoder
        eng = sfec = StreamFecDecoder(eng, stream_fec,
                                      labeling=fec_labeling)

    syncer = frames = fec_stage = None
    if uw is not None:
        from ..ops.framesync import FrameFormat
        from .framesync import FrameSyncer
        eng = syncer = frames = FrameSyncer(eng, FrameFormat(
            uw=tuple(int(v) for v in np.asarray(uw).reshape(-1)),
            payload=frame_payload, m=cfg.constellation_size,
            threshold=uw_threshold))
        if fec is not None:
            from .fec import FecFrameDecoder
            frames = fec_stage = FecFrameDecoder(
                syncer, fec, interleave_rows=fec_interleave,
                labeling=fec_labeling)
        if descramble is not None:
            from .scramble import FrameDescrambler
            frames = FrameDescrambler(frames, descramble)
        if crc is not None:
            from .crc import FrameCrcChecker
            frames = FrameCrcChecker(frames, crc)
    elif fec is not None or descramble is not None or crc is not None:
        raise ValueError("fec/descramble/crc are frame stages; they "
                         "require uw=... frame sync")

    # The frame-side wrappers tap packets THROUGH the sample side: route
    # step/flush through the outermost frame stage when present.
    top = frames if frames is not None else eng
    return Receiver(engine=top, frames=frames, quality=qual,
                    syncer=syncer, fec=fec_stage, stream_fec=sfec)
