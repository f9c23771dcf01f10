"""The one-launch receive chain as a production engine.

``ChainEngine`` puts the fastest path in the framework -- capture ->
steady demod -> seam frame sync -> Viterbi -> CRC as ONE jitted program
per block (models/chain.py, the ``bench.py --profile
chain`` composition) -- behind the same ingest/drain surface as the
per-stage stack (FullKernelBatchEngine + FrameSyncer + FecFrameDecoder +
FrameCrcChecker).  The per-stage stack keeps its place for flexibility
(dynamic frame lists, per-stage observability, wrappers); this engine is
for deployments that want maximum throughput on a fixed frame format:
the only device->host traffic per block is the decoded-frame table
(~tens of bytes per frame), not planes.

Semantics:

- **Warm-up**: the first block converges the tracker through the
  flexible pipeline (the reference likewise emits nothing for the first
  numAvg*sps samples, cpp/psk_soft.cpp:457).  The carried seam tail is
  initialized from the warm block's own soft output, so frames
  straddling the warm-up boundary are still caught; only frames wholly
  inside the early warm region are lost (counted: ``warmup_symbols``).
- **Seam contract**: thereafter every stream position is committed in
  exactly one block -- frames may straddle block boundaries freely
  (models/chain.py seam mode).  ``flush()`` finalizes the carried tail
  (frames whose payload is fully present commit, matching
  FrameSyncer.finalize).
- **Observability**: ``frames_synced``, ``crc_failures``, and
  ``overflow_peaks`` (sync capacity exceeded -- count > k, never
  silent).

Frames come back as ops/framesync.Frame objects with ``start`` in
INPUT-symbol coordinates (same convention as the FrameSyncer stack over
a FullKernelBatchEngine: a frame planted at input symbol p syncs at
start == p), ``info_bits`` decoded and ``crc_ok`` set when a CRC is
configured.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..models.chain import (ChainState, FrontChainState, chain_msg_bits,
                            chain_tail, make_chain_fn,
                            make_front_chain_fn, seam_lead, _need_after)
from ..ops.crc import CrcSpec
from ..ops.fec import ConvCode
from ..ops.framesync import Frame, FrameFormat


class ChainEngine:
    """One-launch chain engine over a homogeneous channel bank.

    Args:
      cfg: demod configuration (matched-filter configs currently
        unsupported here -- the warm handoff needs the raw-window carry;
        use the per-stage stack for those).
      channels: bank width.
      fmt: frame format (UW indices, payload, M == cfg.constellation_size,
        threshold).
      code / crc: FEC + optional CRC (ops/fec.ConvCode, ops/crc.CrcSpec).
      k_frames: sync capacity per block per channel (default: the densest
        packing, ceil(block/separation) + 1 for seam carries).
      block_symbols: symbols per device step.
      pipeline_depth: 0 = synchronous; 1 = commit block k-1 while block
        k's device work is in flight (fastest; frames lag one step).
      acquire_cfo: estimate a per-channel carrier offset from the warm
        block (M-th-power spectrum) and remove it with an in-program NCO
        (models/chain.make_front_chain_fn).  Handles offsets beyond the
        M-th-power tracker's pull-in (~1/(2*pi*M*sps) per-symbol slope)
        UP TO the acquisition's unambiguous range |cfo| < 1/(2M)
        cycles/sample -- beyond that the M-th power aliases and the
        estimate is silently wrong (CRC failures reveal it).  The
        estimate is fixed after warm-up; update it mid-stream with
        :meth:`set_cfo` (no recompile -- frequency lives in the carried
        state).
    """

    def __init__(self, cfg: DemodConfig, channels: int, fmt: FrameFormat,
                 code: ConvCode, crc: CrcSpec | None = None, *,
                 k_frames: int | None = None, block_symbols: int = 512,
                 pipeline_depth: int = 0, acquire_cfo: bool = False,
                 labeling: str = "gray"):
        if pipeline_depth not in (0, 1):
            raise ValueError("pipeline_depth must be 0 (synchronous) or "
                             "1 (commit block k-1 while block k's device "
                             "work is in flight)")
        if fmt.m != cfg.constellation_size:
            raise ValueError(f"fmt.m={fmt.m} != constellation_size="
                             f"{cfg.constellation_size}")
        if cfg.matched_filter != "none":
            raise ValueError("ChainEngine supports matched_filter='none' "
                             "configs; use the per-stage stack (engine + "
                             "FrameSyncer + FecFrameDecoder) otherwise")
        self.cfg = cfg
        self.channels = channels
        self.fmt = fmt
        self.code = code
        self.crc = crc
        self.block_symbols = int(block_symbols)
        if self.block_symbols < _need_after(fmt):
            raise ValueError(f"block_symbols {block_symbols} shorter than "
                             f"the sync window {_need_after(fmt)}")
        self.k = (k_frames if k_frames is not None
                  else self.block_symbols // fmt.separation + 1)
        self.n_msg = chain_msg_bits(fmt, code, crc)
        self._labeling = labeling
        self.acquire_cfo = bool(acquire_cfo)
        if self.acquire_cfo:
            # Front chain: per-channel NCO derotation INSIDE the program
            # (offsets beyond the M-th-power tracker's pull-in, within
            # the acquisition's |cfo| < 1/(2M) unambiguous range); the
            # frequency lives in the carried state, so set_cfo() updates
            # it without recompiling (models/chain.py).
            self._step = jax.jit(make_front_chain_fn(
                cfg, fmt, code, self.k, crc=crc, labeling=labeling))
        else:
            self._step = jax.jit(make_chain_fn(cfg, fmt, code, self.k,
                                               crc=crc, labeling=labeling))
        self._state: ChainState | None = None
        self._staging = [np.zeros(0, np.complex64) for _ in range(channels)]
        self._plane_re: list = []   # plane-ingest staging ((rows, C) f32)
        self._plane_im: list = []
        self._plane_rows = 0
        self._pipe_depth = int(pipeline_depth)
        self._pending: list = []    # [(block_index, ChainOutputs)]
        self._blocks = 0            # chain blocks processed (post warm-up)
        self._base = 0              # input symbols consumed by warm-up
        self._finalized = False
        self.frames: list[Frame] = []
        self.frames_synced = 0
        self.crc_failures = 0
        self.overflow_peaks = 0
        self.warmup_symbols = 0

    # -- ingest ------------------------------------------------------------

    def push(self, channel: int, data) -> None:
        self._check_open()
        if self._plane_rows:
            raise ValueError("engine already has plane-staged data; "
                             "plane and channel pushes cannot mix")
        self._staging[channel] = np.concatenate(
            [self._staging[channel],
             np.asarray(data, np.complex64).ravel()])

    def push_block(self, block) -> None:
        block = np.asarray(block, np.complex64)
        for c in range(self.channels):
            self.push(c, block[c])

    def push_planes(self, re, im) -> None:
        """Kernel-native ingest: (rows, C) float32 time-major I/Q planes
        (the NativePlaneBank / channelizer output layout) -- no
        channel-major staging, no transpose on the hot path.  Integer
        wire planes must be dequantized first (the engine has no
        in-kernel ingest_scale)."""
        self._check_open()
        re = np.asarray(re)
        im = np.asarray(im)
        if np.issubdtype(re.dtype, np.integer) \
                or np.issubdtype(im.dtype, np.integer):
            raise ValueError("integer wire planes must be dequantized "
                             "before push_planes (multiply by the wire "
                             "scale); ChainEngine has no in-kernel "
                             "ingest_scale")
        re = np.asarray(re, np.float32)
        im = np.asarray(im, np.float32)
        if re.shape != im.shape or re.ndim != 2 \
                or re.shape[1] != self.channels:
            raise ValueError(f"planes must be (rows, {self.channels})")
        if any(st.size for st in self._staging):
            raise ValueError("engine already has per-channel staged "
                             "data; plane and channel pushes cannot mix")
        self._plane_re.append(re)
        self._plane_im.append(im)
        self._plane_rows += re.shape[0]

    def _pop_planes(self, need: int):
        """Pop `need` rows from the plane staging (incremental: no
        O(backlog) re-concatenation per block)."""
        take_re, take_im, got = [], [], 0
        while got < need:
            r, i = self._plane_re[0], self._plane_im[0]
            want = need - got
            if r.shape[0] <= want:
                take_re.append(r)
                take_im.append(i)
                got += r.shape[0]
                self._plane_re.pop(0)
                self._plane_im.pop(0)
            else:
                take_re.append(r[:want])
                take_im.append(i[:want])
                self._plane_re[0] = r[want:]
                self._plane_im[0] = i[want:]
                got = need
        self._plane_rows -= need
        if len(take_re) == 1:
            return (np.ascontiguousarray(take_re[0]),
                    np.ascontiguousarray(take_im[0]))
        return (np.concatenate(take_re, axis=0),
                np.concatenate(take_im, axis=0))

    def _check_open(self) -> None:
        if self._finalized:
            raise ValueError("stream finalized by flush(); reset() or "
                             "restore_chain_state() to start a new one")

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows >= need:
            return True
        return all(s.size >= need for s in self._staging)

    # -- core --------------------------------------------------------------

    def _warm(self, x: np.ndarray) -> None:
        """Converge through the flexible pipeline; seed the seam tail from
        the warm block's own soft output so the seam carries across the
        warm-up boundary."""
        import functools

        from ..models.blockpsk import demod_block_ff, ff_init
        from ..models.chain import SeamTailState, seam_tail_init
        from ..models.full import full_from_ff

        freq_est = None
        if self.acquire_cfo:
            # Coarse M-th-power acquisition from the warm block itself;
            # the tracker absorbs the sub-bin residual, the in-program
            # NCO removes the bulk (eval/cfo.acquire_cfo).
            from ..eval.cfo import acquire_cfo as _acq
            from ..ops.mixer import derotate_host
            freq_est = np.asarray(_acq(x, self.cfg.constellation_size),
                                  np.float32)
            x = derotate_host(x, freq_est)
        warm = jax.jit(jax.vmap(functools.partial(demod_block_ff,
                                                  self.cfg)))
        st_ff, out = warm(ff_init(self.cfg, (self.channels,)),
                          jnp.asarray(x))
        full = full_from_ff(self.cfg, st_ff)
        lead = seam_lead(self.fmt)
        v = np.asarray(out.valid[0])          # lockstep bank
        idx = np.flatnonzero(v)
        tail = seam_tail_init(self.fmt, self.channels)
        if idx.size:
            lo = max(int(idx[0]), int(idx[-1]) + 1 - lead)
            hi = int(idx[-1]) + 1
            soft = np.asarray(out.soft[:, lo:hi])     # (C, n) complex
            n = soft.shape[1]
            t_re = np.array(tail.tail_re)       # writable host copies
            t_im = np.array(tail.tail_im)
            t_re[lead - n:] = soft.real.T
            t_im[lead - n:] = soft.imag.T
            tail = SeamTailState(jnp.asarray(t_re), jnp.asarray(t_im))
        if self.acquire_cfo:
            from ..models.chain import FrontState
            from ..ops.phase import wrap_to_pi
            # NCO phase continuity: the warm block consumed n_samp
            # samples of carrier already (derotate_host ran from phase
            # 0); start the in-program NCO where it left off.
            ph = wrap_to_pi(2 * np.pi * freq_est * x.shape[1])
            front = FrontState(freq=jnp.asarray(freq_est, jnp.float32),
                               phase=jnp.asarray(ph, jnp.float32),
                               agc=None)
            self._state = FrontChainState(front, full, tail)
        else:
            self._state = ChainState(full, tail)
        self.warmup_symbols = self._base = x.shape[1] // self.cfg.sps

    def _commit(self, out, block_index: int) -> list[Frame]:
        """ChainOutputs -> Frame objects (input-symbol start coords);
        ``block_index`` is the 1-based chain-block number the outputs
        belong to (deferred commits pass the index captured at
        dispatch)."""
        # One host fetch per plane, not one per frame.
        found = np.asarray(out.found)
        pos = np.asarray(out.pos)
        ok = np.asarray(out.ok)
        msg = np.asarray(out.msg)
        count = np.asarray(out.count)
        ang = np.asarray(out.ang)
        self.overflow_peaks += int(np.maximum(count - self.k, 0).sum())
        a1 = self.cfg.num_avg - 1
        # The chain's first post-warm block emits demod rows for input
        # symbols [base - a1, base - a1 + S): block-relative row r of
        # block b is input symbol base - a1 + b*S + r.
        base = self._base - a1 + (block_index - 1) * self.block_symbols
        new = []
        for c, j in zip(*np.nonzero(found)):
            crc_ok = bool(ok[c, j]) if self.crc is not None else None
            if self.crc is not None and not ok[c, j]:
                self.crc_failures += 1
            new.append(Frame(
                channel=int(c), start=base + int(pos[c, j]), rotation=0,
                corr=0.0, residual_phase=float(ang[c, j]),
                soft=None, bits=None, info_bits=msg[c, j].copy(),
                crc_ok=crc_ok))
        self.frames_synced += len(new)
        self.frames.extend(new)
        return new

    def step(self) -> list[Frame] | None:
        """Consume one staged block; returns the frames committed by
        this call (empty list for the warm-up block), or None if not
        enough data.  With ``pipeline_depth=1`` the returned frames are
        the PREVIOUS block's (its device work overlapped this call's
        staging; JAX dispatch is async) -- flush() drains the last one."""
        if not self.ready():
            return None
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows >= need:
            re_t, im_t = self._pop_planes(need)
            if self._state is None:
                x = np.empty((self.channels, need), np.complex64)
                x.real = re_t.T
                x.imag = im_t.T
                self._warm(x)
                return []
            x_re = jnp.asarray(np.ascontiguousarray(re_t))
            x_im = jnp.asarray(np.ascontiguousarray(im_t))
        else:
            x = np.stack([s[:need] for s in self._staging])
            self._staging = [s[need:] for s in self._staging]
            if self._state is None:
                self._warm(x)
                return []
            x_re = jnp.asarray(np.ascontiguousarray(x.real.T))
            x_im = jnp.asarray(np.ascontiguousarray(x.imag.T))
        self._state, out = self._step(self._state, x_re, x_im)
        self._blocks += 1
        if self._pipe_depth == 0:
            return self._commit(out, self._blocks)
        self._pending.append((self._blocks, out))
        if len(self._pending) > self._pipe_depth:
            bi, prev = self._pending.pop(0)
            return self._commit(prev, bi)
        return []

    def flush(self) -> list[Frame]:
        """EOS: drain whole staged blocks, then finalize the carried tail
        (frames whose payload is fully present commit -- the
        FrameSyncer.finalize analog)."""
        if self._finalized:                   # idempotent at EOS
            return []
        out_frames = []
        while self.ready():
            out_frames += self.step() or []
        for bi, out in self._pending:         # drain in-flight blocks
            out_frames += self._commit(out, bi)
        self._pending = []
        self._finalized = True
        if self._state is None:
            return out_frames
        lead = seam_lead(self.fmt)
        # Tail-relative window: positions after the last block's
        # commit_hi (= lead - need_after in tail coords) through the last
        # start whose payload is fully inside the tail planes.
        t_lo = lead - _need_after(self.fmt) + 1
        hi = lead - self.fmt.frame_len
        if lead >= self.fmt.frame_len and hi >= t_lo:
            fin = jax.jit(lambda re, im: chain_tail(
                re, im, self.fmt, self.code, self.k, crc=self.crc,
                labeling=self._labeling, commit_lo=t_lo, commit_hi=hi))
            tail = self._state.tail
            out = fin(tail.tail_re, tail.tail_im)
            # _commit's base formula with _blocks+1 and pos-lead lands on
            # absolute = base - a1 + blocks*S + (t - lead): the tail rows
            # ARE the last `lead` emitted rows.
            out = out._replace(pos=out.pos - lead)
            out_frames += self._commit(out, self._blocks + 1)
        return out_frames

    def pop_frames(self) -> list[Frame]:
        out, self.frames = self.frames, []
        return out

    def set_cfo(self, freq) -> None:
        """Update the in-program NCO frequencies mid-stream (no
        recompile -- frequency lives in the carried state).  The
        frequency step introduces a phase discontinuity the tracker and
        per-frame UW rotation resolution absorb within ~numAvg symbols;
        frames in that re-convergence window may fail CRC (counted)."""
        if not self.acquire_cfo:
            raise ValueError("set_cfo needs acquire_cfo=True (the plain "
                             "chain has no in-program NCO)")
        if self._state is None:
            raise ValueError("engine not warmed up yet")
        f = jnp.asarray(np.broadcast_to(
            np.asarray(freq, np.float32), (self.channels,)))
        self._state = self._state._replace(
            front=self._state.front._replace(freq=f))

    @property
    def cfo_estimates(self):
        """Per-channel NCO frequencies (cycles/input-sample) when
        acquire_cfo is on; None otherwise / before warm-up."""
        if not self.acquire_cfo or self._state is None:
            return None
        return np.asarray(self._state.front.freq)

    # -- checkpoint/resume -------------------------------------------------

    @property
    def chain_state(self):
        """The current carry -- a ChainState, or a FrontChainState when
        ``acquire_cfo`` is on (None during warm-up) -- pair with
        utils.checkpoint.save_state; restore via
        :meth:`restore_chain_state`."""
        return self._state

    def restore_chain_state(self, state: ChainState | FrontChainState, *,
                            base_symbols: int | None = None,
                            blocks_done: int = 0) -> None:
        """Resume the fused chain from a checkpointed carry
        (utils/checkpoint.load_state) -- a ChainState, or a
        FrontChainState for an ``acquire_cfo`` engine (type-checked):
        exact mid-stream restart, the
        FullKernelBatchEngine.restore_full_state analog.  Staged samples
        and buffered frames from before the restore are discarded (they
        belong to the old stream).

        base_symbols / blocks_done restore the absolute input-symbol
        clock for Frame.start (save them in the checkpoint's ``extra``;
        defaults keep relative numbering from the restore point)."""
        want_cls = FrontChainState if self.acquire_cfo else ChainState
        if not isinstance(state, want_cls):
            raise ValueError(f"engine mode needs a {want_cls.__name__} "
                             f"checkpoint, got {type(state).__name__} "
                             f"(acquire_cfo mismatch)")
        tail = state.tail.tail_re
        lead = seam_lead(self.fmt)
        if tail.shape != (lead, self.channels):
            raise ValueError(f"tail is {tail.shape}, engine needs "
                             f"{(lead, self.channels)} (format/channel "
                             f"mismatch)")
        self._state = state
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re, self._plane_im, self._plane_rows = [], [], 0
        self._pending = []
        self._finalized = False
        self.frames = []
        self._blocks = int(blocks_done)
        if base_symbols is not None:
            self._base = int(base_symbols)

    def reset(self) -> None:
        self._state = None
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re, self._plane_im, self._plane_rows = [], [], 0
        self._pending = []
        self._finalized = False
        self._blocks = 0
        self._base = 0
        self.frames = []
