"""One-launch receive chain: demod -> frame sync -> Viterbi -> CRC.

The full coded receive path composes into a single jitted program with
no host round trips; this module is that composition as a public,
reusable API.
Everything is static-shaped, so the step jits, scans, vmaps, and runs
inside ``shard_map`` bodies unchanged -- the chan axis needs no
collectives because every post-demod stage is per-channel independent
(the multi-chip twin is ``eval/scaling.chain_scaling_report``).

**Seam-correct streaming (round 5).**  The chain step carries the last
``seam_lead(fmt)`` soft columns across blocks and positions the sync
commit window so every stream position is committable in EXACTLY one
step, with full local-max context on both sides -- frames that straddle
a block boundary are decoded once, never dropped and never duplicated
(the reference's whole design is state carried across packet boundaries,
/root/reference/cpp/psk_soft.cpp:349, 442-467; the streaming FrameSyncer
proves the criterion is locally decidable, runtime/framesync.py).  The
stream is treated as preceded by ``seam_lead(fmt)`` zero symbols (the
zero lead has zero correlation energy, so it produces no peaks of its
own).  Reported ``pos`` is relative to the current block's first soft
row; negative values mean the frame started in the previous block.

Stages (each individually equivalence-gated elsewhere):

- steady-state time-major demod (``models/full.demod_block_full``),
- time-major fixed-capacity frame sync (``ops/framesync.
  sync_extract_topk_tm`` -- consumes the demod's native (S, C) planes
  with zero relayout; per-channel total peak ``count`` makes the fixed
  capacity observable),
- max-log PSK LLRs (``ops/fec.psk_llrs``),
- Viterbi (``ops/fec.viterbi_decode``: the Pallas ACS+traceback kernel
  on a GPU, the XLA scan on the CPU),
- optional CRC check (``ops/crc.crc_bits``).

Reference anchor: the bits pipeline the chain feeds,
/root/reference/cpp/psk_soft.cpp:502-566, 605-615 (the reference emits
raw sliced bits and leaves sync/FEC/CRC to downstream REDHAWK
components; here they are one device program).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import DemodConfig
from ..ops.crc import CrcSpec, crc_bits
from ..ops.fec import ConvCode, info_bits_for, psk_llrs, viterbi_decode
from ..ops.framesync import FrameFormat, sync_extract_topk_tm
from .full import demod_block_full


class ChainOutputs(NamedTuple):
    """Per-block decoded frames, fixed capacity k per channel.

    Rows where ``found`` is False are garbage (fixed-capacity contract of
    sync_extract_topk).  ``count`` is the total number of committable
    peaks per channel INCLUDING any beyond capacity -- ``count > k``
    means the cap dropped frames (observable, never silent)."""

    msg: jnp.ndarray      # (C, k, n_msg) int8 decoded message bits
    ok: jnp.ndarray       # (C, k) bool CRC pass (all-True when no CRC)
    found: jnp.ndarray    # (C, k) bool frame detected
    pos: jnp.ndarray      # (C, k) int32 UW start (demod-output symbols;
    #                       seam chain: relative to the current block's
    #                       first row, negative = started last block)
    ang: jnp.ndarray      # (C, k) float32 raw UW correlation angle
    count: jnp.ndarray    # (C,) int32 total committable peaks


def chain_msg_bits(fmt: FrameFormat, code: ConvCode,
                   crc: CrcSpec | None) -> int:
    """Message bits per frame after FEC (and CRC field, if any)."""
    nb = int(np.log2(fmt.m))
    n_info = info_bits_for(code, fmt.payload * nb)
    return n_info - (crc.degree if crc is not None else 0)


def chain_tail(soft_re, soft_im, fmt: FrameFormat, code: ConvCode,
               k_frames: int, crc: CrcSpec | None = None,
               labeling: str = "gray", *,
               commit_lo: int | None = None,
               commit_hi: int | None = None) -> ChainOutputs:
    """Post-demod chain: (S, C) soft planes -> decoded frames.

    Jit-composable; pairs with any producer of time-major soft planes
    (demod_block_full / demod_block_full_rolling outputs feed it
    directly).  Default commit window = one-shot containment; the seam
    chain passes explicit bounds (see :func:`make_seam_tail_fn`).
    """
    nb = int(np.log2(fmt.m))
    n_info = info_bits_for(code, fmt.payload * nb)
    n_msg = n_info - (crc.degree if crc is not None else 0)
    c_dim = soft_re.shape[1]
    sync = sync_extract_topk_tm(soft_re, soft_im, fmt, k_frames,
                                commit_lo=commit_lo, commit_hi=commit_hi)
    n_rows = c_dim * k_frames
    llr = psk_llrs(fmt.m, sync.payloads.reshape(n_rows, fmt.payload),
                   labeling=labeling)
    bits = viterbi_decode(code, llr.reshape(n_rows, fmt.payload * nb))
    msg = bits[:, :n_msg]
    if crc is not None:
        ok = jnp.all(crc_bits(crc, msg) == bits[:, n_msg:], axis=-1)
    else:
        ok = jnp.ones((n_rows,), bool)
    return ChainOutputs(msg.reshape(c_dim, k_frames, n_msg),
                        ok.reshape(c_dim, k_frames), sync.found, sync.pos,
                        sync.ang, sync.count)


# --- seam-carrying streaming tail (round 5) --------------------------------

def _need_after(fmt: FrameFormat) -> int:
    """Columns that must exist at/after a peak before it is final: the
    payload span AND the right local-max window (norm through t+sep-1,
    i.e. soft through t+sep+uw-2) -- runtime/framesync.FrameSyncer's
    lookahead rule, here as static geometry."""
    return max(fmt.frame_len, fmt.separation + fmt.uw_len - 1)


def seam_lead(fmt: FrameFormat) -> int:
    """Soft columns the seam chain carries across blocks.

    Sized so the commit window's left edge keeps its full ``sep - 1``
    look-back context inside the carried planes:
    ``need_after + sep - 2`` (VERDICT r4 item 1's
    ``frame_len + separation - 2`` generalized to short separations,
    where the detection window outspans the frame)."""
    return _need_after(fmt) + fmt.separation - 2


def commit_bounds(fmt: FrameFormat, s_block: int) -> tuple[int, int]:
    """Commit window [lo, hi] (inclusive) in extended-plane coordinates
    for one block of ``s_block`` soft rows behind a ``seam_lead`` tail.

    Consecutive blocks' windows tile the stream exactly: position ``a``
    of the stream is committable in the one block where it falls in
    [lo, hi], with full left (``sep - 1``) and right (``need_after - 1``)
    context present in the extended planes."""
    lead = seam_lead(fmt)
    na = _need_after(fmt)
    return lead - na + 1, lead + s_block - na


class SeamTailState(NamedTuple):
    """Carried soft columns: the last ``seam_lead(fmt)`` rows of the
    demodulated stream (time-major planes, the demod's layout)."""

    tail_re: jnp.ndarray   # (seam_lead, C) float32
    tail_im: jnp.ndarray


def seam_tail_init(fmt: FrameFormat, channels: int,
                   dtype=jnp.float32) -> SeamTailState:
    """Zero lead: the stream is treated as preceded by ``seam_lead``
    zero symbols (zero energy -> no peaks of their own)."""
    lead = seam_lead(fmt)
    return SeamTailState(jnp.zeros((lead, channels), dtype),
                         jnp.zeros((lead, channels), dtype))


def make_seam_tail_fn(fmt: FrameFormat, code: ConvCode, k_frames: int,
                      crc: CrcSpec | None = None, *,
                      labeling: str = "gray"):
    """Seam-correct post-demod chain step over (S, C) soft planes.

    Returns ``step(tail, soft_re, soft_im) -> (tail', ChainOutputs)``:
    syncs over [carried tail; block], commits exactly the positions whose
    detection is final this block (streaming == one-shot; every stream
    position commits exactly once), decodes them, and carries the new
    tail.  ``pos`` is relative to the block's first row (negative =
    frame started in a previous block).  Feed blocks of ANY (static)
    length >= 1; pairs with demod_block_full, demod_block_full_rolling,
    or raw soft planes.
    """
    lead = seam_lead(fmt)

    def step(tail: SeamTailState, soft_re, soft_im):
        s_out = soft_re.shape[0]
        ext_re = jnp.concatenate([tail.tail_re, soft_re], axis=0)
        ext_im = jnp.concatenate([tail.tail_im, soft_im], axis=0)
        lo, hi = commit_bounds(fmt, s_out)
        out = chain_tail(ext_re, ext_im, fmt, code, k_frames, crc=crc,
                         labeling=labeling, commit_lo=lo, commit_hi=hi)
        out = out._replace(pos=out.pos - lead)
        return SeamTailState(ext_re[s_out:], ext_im[s_out:]), out

    return step


class ChainState(NamedTuple):
    """Seam chain carry: demod state + the carried soft tail."""

    demod: Any              # models/full.FullState (or its planes)
    tail: SeamTailState


def chain_init(fmt: FrameFormat, channels: int,
               demod_state) -> ChainState:
    """Wrap a converged demod state (models/full.full_from_ff) for the
    seam chain step."""
    return ChainState(demod_state, seam_tail_init(fmt, channels))


def make_chain_fn(cfg: DemodConfig, fmt: FrameFormat, code: ConvCode,
                  k_frames: int, crc: CrcSpec | None = None, *,
                  labeling: str = "gray", debug_ports: bool = False,
                  seam: bool = True):
    """Build the one-launch chain step.

    seam=True (default, the streaming contract): returns
    ``step(state, x_re, x_im) -> (state', ChainOutputs)`` with ``state``
    a :class:`ChainState` (build via :func:`chain_init`); frames may
    straddle block boundaries freely -- each is decoded exactly once, in
    the step whose commit window contains its start.

    seam=False (one-shot mode): ``state`` is the bare demod FullState and
    each block is synced independently under the containment rule (frames
    not fully inside a block's demod output are NOT seen) -- only correct
    when the transmit cadence guarantees containment, e.g. single-capture
    analysis.

    ``x_re/x_im`` are (S*sps, C) time-major input planes.  Wrap in
    ``jax.jit`` (or a scan/shard_map) at the call site.
    """
    step_demod = functools.partial(demod_block_full, cfg,
                                   debug_ports=debug_ports)

    if not seam:
        def step(state, x_re, x_im):
            st2, fo = step_demod(state, x_re, x_im)
            out = chain_tail(fo.soft_re, fo.soft_im, fmt, code, k_frames,
                             crc=crc, labeling=labeling)
            return st2, out

        return step

    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling=labeling)

    def step(state: ChainState, x_re, x_im):
        st2, fo = step_demod(state.demod, x_re, x_im)
        tail2, out = tail_step(state.tail, fo.soft_re, fo.soft_im)
        return ChainState(st2, tail2), out

    return step


# --- front-end stages inside the one-launch program (round 5) --------------

class FrontState(NamedTuple):
    """Carried front-end state: NCO phase (continuous across blocks, so
    derotation never jumps) and the AGC power EMA."""

    freq: jnp.ndarray     # (C,) NCO frequency, cycles per input sample
    phase: jnp.ndarray    # (C,) NCO phase at the block head (radians)
    agc: Any              # ops/agc.AgcState (or None when AGC disabled)


class FrontChainState(NamedTuple):
    front: FrontState
    demod: Any
    tail: SeamTailState


def front_chain_init(fmt: FrameFormat, channels: int, demod_state, *,
                     agc_cfg=None, freq=None) -> FrontChainState:
    """Wrap a converged demod state for :func:`make_front_chain_fn`.

    freq: (C,) NCO frequencies in cycles/input-sample (e.g. from
    eval/cfo.acquire_cfo); zeros when only AGC is wanted.
    """
    from ..ops.agc import agc_init

    f = (jnp.zeros((channels,), jnp.float32) if freq is None
         else jnp.asarray(freq, jnp.float32))
    agc = agc_init(agc_cfg, (channels,)) if agc_cfg is not None else None
    front = FrontState(freq=f, phase=jnp.zeros((channels,), jnp.float32),
                       agc=agc)
    return FrontChainState(front, demod_state,
                           seam_tail_init(fmt, channels))


def make_front_chain_fn(cfg: DemodConfig, fmt: FrameFormat,
                        code: ConvCode, k_frames: int,
                        crc: CrcSpec | None = None, *, agc_cfg=None,
                        labeling: str = "gray", debug_ports: bool = False):
    """One-launch chain with the FRONT-END stages inside the program:
    "wideband capture -> info bits" as one jitted step.

    NCO derotation (ops/mixer.derotate: per-channel carrier removal for
    offsets beyond the M-th-power tracker's pull-in) and optional AGC
    (ops/agc.agc_block_tm: gain normalization + squelch) run on the same
    (T, C) input planes the demod eats -- elementwise work XLA fuses ahead
    of it, no extra round trip through the host.  The seam sync tail is carried exactly as in
    :func:`make_chain_fn` (seam mode).

    Returns ``step(state, x_re, x_im) -> (state', ChainOutputs)`` with
    ``state`` a :class:`FrontChainState` (build via
    :func:`front_chain_init`).  The NCO frequency lives in the STATE, so
    re-acquisition updates it without recompiling.

    Reference anchor: the upstream AGC/tuner components a REDHAWK
    deployment places before psk_soft (SURVEY section 2.4); here they are
    rows of the same device program.
    """
    from ..ops.agc import agc_block_tm
    from ..ops.mixer import derotate

    step_demod = functools.partial(demod_block_full, cfg,
                                   debug_ports=debug_ports)
    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling=labeling)

    def step(state: FrontChainState, x_re, x_im):
        fr = state.front
        y_re, y_im, phase2 = derotate(x_re, x_im, fr.freq, fr.phase)
        agc2 = fr.agc
        if agc_cfg is not None:
            agc2, y_re, y_im, _ = agc_block_tm(agc_cfg, fr.agc, y_re,
                                               y_im)
        st2, fo = step_demod(state.demod, y_re, y_im)
        tail2, out = tail_step(state.tail, fo.soft_re, fo.soft_im)
        return FrontChainState(FrontState(fr.freq, phase2, agc2), st2,
                               tail2), out

    return step
