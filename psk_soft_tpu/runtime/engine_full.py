"""FullKernelBatchEngine: the flagship bank engine -- feed-forward
warm-up, time-major steady state (models/full.py), rolling-window fast
path, plane ingest, int8/int16 wire formats.  Part of the
runtime/engine facade (import from there).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig
from .engine_stream import EngineMetrics, _PipelineOps, logger, \
    reconfigure_ff
from .engine_bank import BankAssembler, TMOutputs, _PipelinedPackets
from .streams import SRI


class FullKernelBatchEngine(_PipelinedPackets):
    """BatchEngine for the flagship: warms up through the channel-major
    feed-forward pipeline, then hands the carry to the steady-state step
    (models/full.py) and streams time-major blocks through it.
    """

    def __init__(self, cfg: DemodConfig, channels: int,
                 block_symbols: int = 512, pipeline_depth: int = 0,
                 ingest_scale: float | None = None,
                 guard_nonfinite: bool = False,
                 debug_ports: bool = True, data_ports: bool = True,
                 soft_i8: bool = False, soft_i8_scale: float = 100.0):
        import functools
        from ..models import full as full_mod

        if guard_nonfinite and pipeline_depth:
            raise ValueError("guard_nonfinite and pipeline_depth are "
                             "mutually exclusive")
        if guard_nonfinite and soft_i8:
            # The guard detects poisoned channels via isfinite on the soft
            # planes; int8 planes quantize non-finites away.
            raise ValueError("guard_nonfinite and soft_i8 are mutually "
                             "exclusive")
        self._init_pipeline(pipeline_depth)
        self.guard_nonfinite = guard_nonfinite
        self.channel_resyncs = np.zeros(channels, np.int64)
        self.cfg = cfg
        self.channels = channels
        self.block_symbols = int(block_symbols)
        # int16-ingest mode: push_planes takes i16 wire planes dequantized
        # as i16 * ingest_scale; the steady step then reads 2-byte input
        # and the carry window stays on the wire format
        # (quantize_full_state at the handoff).
        self._ingest_scale = (float(ingest_scale) if ingest_scale is not None
                              else None)
        # debug_ports=False = phase/sampleIndex ports unconnected: the
        # steady step never writes those symbol-rate planes and the packet
        # layer never assembles them (reference: bulkio skips pushes on
        # ports without consumers).
        self.debug_ports = debug_ports
        # soft_i8: the steady step emits int8-quantized soft planes
        # (round(s * scale), the SDR soft-bit wire format) -- the dominant
        # output plane crosses HBM and the host link at 2 bytes/symbol/
        # channel instead of 8; PORT_SOFT packets are dequantized on the
        # host (grid-snapped values, error <= 0.5/scale per component).
        self._soft_scale = float(soft_i8_scale) if soft_i8 else None
        self._full_kwargs = dict(in_scale=self._ingest_scale or 1.0,
                                 soft_i8_scale=self._soft_scale,
                                 debug_ports=debug_ports)
        self._warm_ops = _PipelineOps("ff")
        self._warm_state = self._warm_ops.init(cfg, (channels,))
        self._warm_fn = self._make_warm_fn(cfg)
        self._full_fn = jax.jit(functools.partial(
            full_mod.demod_block_full, cfg, **self._full_kwargs))
        self._full_mod = full_mod
        self._full_state = None
        # Rolling-window fast path: after the first steady block the step
        # slices its timing window from the previous block's planes
        # (demod_block_full_rolling) instead of writing a window copy.  _win_stale marks _full_state.win_* as superseded by
        # _prev_planes (materialized on demand: full_state property).
        self._prev_planes = None
        self._roll_fn = None
        self._roll_ok: bool | None = None
        self._win_stale = False
        self._staging = [np.zeros(0, np.complex64) for _ in range(channels)]
        self._plane_re: list[np.ndarray] = []   # staged (rows, C) planes
        self._plane_im: list[np.ndarray] = []
        self._plane_rows = 0
        self._consumed = 0
        # Raw-input tail for the steady handoff under a matched filter: the
        # steady step filters [window | block], so its window carry holds
        # RAW samples,
        # which the FF warm-up carry does not keep (it stores the filtered
        # window).  Tracked host-side from the staged blocks.
        self._raw_tail = np.zeros((channels, 0), np.complex64)
        # data_ports=False: soft/bits unconnected too (frames-only
        # consumer via the device tap) -- packet assembly advances the
        # clock but fetches no planes (cpp/psk_soft.cpp:605-615's
        # connected-port guard applied to every port).
        self.assembler = BankAssembler(cfg, skip_debug=not debug_ports,
                                       skip_data=not data_ports)
        self.metrics = EngineMetrics()
        self._make_guard_fns()

    def _make_warm_fn(self, cfg: DemodConfig):
        import functools

        return jax.jit(jax.vmap(functools.partial(self._warm_ops.block,
                                                  cfg)))

    def _handoff(self, raw):
        """Warm-up -> steady carry conversion (hook for subclasses)."""
        return self._full_mod.full_from_ff(self.cfg, self._warm_state,
                                           raw_win=raw)

    def _fresh_planes(self, planes: jnp.ndarray) -> jnp.ndarray:
        """Reset value for a guarded channel's state-plane column (hook:
        the mixed engine re-writes its per-channel mode rows)."""
        return jnp.zeros_like(planes)

    def _make_guard_fns(self):
        """(Re)build the jitted guard closures; called at construction and
        after configure() so they never retain a stale config (the
        BatchEngine ADVICE-round fix, applied here from the start)."""
        if not self.guard_nonfinite:
            self._guard_full_jit = self._guard_warm_jit = None
            return
        self._guard_full_jit = jax.jit(self._guard_full)

        def guard_warm(state, out):
            bad = ~jnp.all(jnp.isfinite(out.soft.real)
                           & jnp.isfinite(out.soft.imag)
                           & jnp.isfinite(out.phase), axis=-1)    # (C,)
            fresh = self._warm_ops.init(self.cfg, (self.channels,))

            def pick(new, old):
                b = bad.reshape(bad.shape + (1,) * (old.ndim - 1))
                return jnp.where(b, new, old)

            return jax.tree_util.tree_map(pick, fresh, state), bad

        self._guard_warm_jit = jax.jit(guard_warm)

    def _note_bad(self, bad) -> None:
        nbad = np.asarray(bad)
        if nbad.any():
            self.channel_resyncs[nbad] += 1
            self.metrics.resets += int(nbad.sum())

    def _guard_full(self, state, soft_re, soft_im, phase):
        """Per-channel drop-and-resync on the steady carry: zero the
        poisoned channel's window + state planes; it re-converges within
        numAvg + phaseAvg symbols (accepted-data-loss recovery, SURVEY
        section 5 -- the per-channel analogue of the reference's
        queue-flush reset, cpp/psk_soft.cpp:353-357)."""
        bad = ~jnp.all(jnp.isfinite(soft_re) & jnp.isfinite(soft_im)
                       & jnp.isfinite(phase), axis=0)             # (C,)
        state2 = type(state)(
            win_re=jnp.where(bad[None, :],
                             jnp.zeros_like(state.win_re), state.win_re),
            win_im=jnp.where(bad[None, :],
                             jnp.zeros_like(state.win_im), state.win_im),
            planes=jnp.where(bad[None, :],
                             self._fresh_planes(state.planes), state.planes),
        )
        return state2, bad

    def _materialize_state(self):
        """Re-attach the window planes (sliced from the previous block) to
        _full_state after rolling steps made them stale."""
        keep = (self.cfg.num_avg - 1) * self.cfg.sps
        pr, pi = self._prev_planes
        self._win_stale = False
        return self._full_state._replace(
            win_re=pr[pr.shape[0] - keep:], win_im=pi[pi.shape[0] - keep:])

    @property
    def full_state(self):
        """The current steady carry as a standard FullState (None
        during warm-up).  Materializes the window from the rolling-path
        planes when needed -- use this (not _full_state) for checkpointing."""
        if self._full_state is not None and self._win_stale:
            self._full_state = self._materialize_state()
        return self._full_state

    def restore_full_state(self, state) -> None:
        """Resume the steady step from a checkpointed FullState
        (utils.checkpoint.load_state): the mid-stream restart story the
        reference lacks entirely (SURVEY section 5 checkpoint/resume --
        a reference restart re-converges blind over numAvg*sps samples).
        Pair with the ``full_state`` property on the saving side."""
        rows = (self.cfg.num_avg - 1) * self.cfg.sps + (
            max(self.cfg.mf_ntaps - 1, 0)
            if self.cfg.matched_filter != "none" else 0)
        if state.win_re.shape != (rows, self.channels):
            raise ValueError(
                f"state window is {state.win_re.shape}, engine needs "
                f"{(rows, self.channels)} (config/channel mismatch)")
        # Discard any in-flight stream state from before the restore --
        # staged samples, pipelined blocks and the assembler clock belong
        # to the OLD stream and must not mix with the resumed one.
        self._pending.clear()
        self._held.clear()
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re, self._plane_im, self._plane_rows = [], [], 0
        self._raw_tail = np.zeros((self.channels, 0), np.complex64)
        self.assembler.reset()
        self._full_state = state
        self._warm_state = None
        self._consumed = self.cfg.num_avg + self.cfg.phase_avg
        self._prev_planes = None
        self._roll_fn = None
        self._roll_ok = None
        self._win_stale = False

    def _steady_step(self, x_re, x_im):
        """One steady block.  Uses the rolling-window mode when eligible
        (same-shape consecutive blocks, no matched filter, no per-channel
        guard); otherwise the standard window-carry path."""
        import functools

        roll = (not self.guard_nonfinite and self._roll_ok is not False
                and self._prev_planes is not None
                and self._prev_planes[0].shape == x_re.shape
                and self._prev_planes[0].dtype == x_re.dtype)
        if roll:
            if self._roll_fn is None:
                self._roll_fn = jax.jit(functools.partial(
                    self._full_mod.demod_block_full_rolling, self.cfg,
                    **self._full_kwargs))
            try:
                planes, fo = self._roll_fn(self._full_state.planes,
                                           *self._prev_planes, x_re, x_im)
            except ValueError as e:
                # Expected for configs the rolling mode cannot serve;
                # anything else still surfaces here, so record why before
                # falling back.
                logger.info("rolling-window mode unavailable, using the "
                            "window-carry path: %s", e)
                self._roll_ok = False
            else:
                self._roll_ok = True
                self._full_state = self._full_state._replace(planes=planes)
                self._win_stale = True
                self._prev_planes = (x_re, x_im)
                return fo
        if self._win_stale:
            self._full_state = self._materialize_state()
        self._full_state, fo = self._full_fn(self._full_state, x_re, x_im)
        self._prev_planes = (x_re, x_im)
        return fo

    @property
    def _raw_keep(self) -> int:
        if self.cfg.matched_filter == "none":
            return 0
        return (self.cfg.num_avg - 1) * self.cfg.sps + self.cfg.mf_ntaps - 1

    def _track_raw(self, x: np.ndarray) -> None:
        keep = self._raw_keep
        if not keep:
            return
        cat = np.concatenate([self._raw_tail, x], axis=1)
        self._raw_tail = cat[:, max(0, cat.shape[1] - keep):]

    @property
    def steady(self) -> bool:
        return self._full_state is not None

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change on the flagship engine (C7 resync semantics,
        cpp/psk_soft.cpp:638-651).

        The steady carry is converted back to the feed-forward layout
        (models/full.ff_from_full), resynced with the standard C7 rules
        (reconfigure_ff: timing window re-binned/truncated, phase history
        carried or cleared), and the engine re-warms on the flexible path
        before handing back to the steady step -- tracking survives compatible
        changes, exactly like StreamEngine.configure.
        """
        import functools

        if new_cfg == self.cfg:
            return
        logger.debug("full-kernel reconfigure: %s -> %s", self.cfg, new_cfg)
        self._drain_pending()
        if self._full_state is not None and self._win_stale:
            self._full_state = self._materialize_state()
        self._prev_planes = None
        self._roll_fn = None
        self._roll_ok = None
        if self._full_state is not None:
            if self._ingest_scale is not None:
                self._full_state = self._full_mod.dequantize_full_state(
                    self._full_state, self._ingest_scale)
            if self.cfg.matched_filter != "none":
                # Steady window rows are raw input: seed the raw tail so the
                # next steady handoff has its history.
                wr = np.asarray(self._full_state.win_re)
                wi = np.asarray(self._full_state.win_im)
                self._raw_tail = np.ascontiguousarray(
                    (wr + 1j * wi).T.astype(np.complex64))
            ff = self._full_mod.ff_from_full(self.cfg, self._full_state)
            self._full_state = None
        else:
            ff = self._warm_state
        self._warm_state = reconfigure_ff(self.cfg, new_cfg, ff)
        self.cfg = new_cfg
        self._warm_fn = self._make_warm_fn(new_cfg)
        self._full_fn = jax.jit(functools.partial(
            self._full_mod.demod_block_full, new_cfg, **self._full_kwargs))
        self._make_guard_fns()
        # Conservatively re-run the warm-up gate: a resync may leave
        # partially-filled windows that the steady step cannot represent.
        self._consumed = 0
        self.assembler.reconfigure(new_cfg)
        self.metrics.reconfigures += 1

    def reset(self) -> None:
        """Full state reset (the resetState property / queue-flush answer)."""
        self._warm_state = self._warm_ops.init(self.cfg, (self.channels,))
        self._full_state = None
        self._prev_planes = None
        self._win_stale = False
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        self._plane_re = []
        self._plane_im = []
        self._plane_rows = 0
        self._consumed = 0
        self._raw_tail = np.zeros((self.channels, 0), np.complex64)
        self._pending.clear()
        self._held.clear()
        self.assembler.reset()
        self.metrics.resets += 1

    def set_input_sri(self, sri: SRI, t: float = 0.0) -> None:
        self.assembler.set_sri(sri, t)

    def push(self, channel: int, data: np.ndarray) -> None:
        if self._plane_rows:
            raise ValueError("engine is in plane-ingest mode (push_planes); "
                             "per-channel push would interleave streams")
        self._staging[channel] = np.concatenate(
            [self._staging[channel], np.asarray(data, np.complex64).ravel()])
        self.metrics.samples_in += data.size

    def push_planes(self, re: np.ndarray, im: np.ndarray) -> None:
        """Time-major (rows, C) re/im plane append -- the native plane
        bank's output (runtime/native_bank.NativePlaneBank) and the steady
        step's exact input layout, so the steady path uploads with ZERO
        host transposes.  float32 planes, or int16 wire planes when the
        engine was built with ``ingest_scale``."""
        if not isinstance(re, jax.Array):
            re = np.asarray(re)
            im = np.asarray(im)
        if re.shape != im.shape or re.ndim != 2 or re.shape[1] != self.channels:
            raise ValueError(f"expected (rows, {self.channels}) planes")
        if re.dtype == np.int16:
            if self._ingest_scale is None:
                raise ValueError("int16 planes need ingest_scale at "
                                 "construction")
        elif re.dtype != np.float32:
            raise ValueError(f"planes must be float32 or int16, got "
                             f"{re.dtype}")
        if any(s.size for s in self._staging):
            raise ValueError("engine already has per-channel staged data; "
                             "plane and channel pushes cannot mix")
        self._plane_re.append(re)
        self._plane_im.append(im)
        self._plane_rows += re.shape[0]
        self.metrics.samples_in += re.size

    def _take_plane_rows(self, rows: int):
        """Pop `rows` rows from the plane staging as contiguous planes."""
        take_re, take_im, got = [], [], 0
        while got < rows:
            r, i = self._plane_re[0], self._plane_im[0]
            need = rows - got
            if r.shape[0] <= need:
                take_re.append(r)
                take_im.append(i)
                got += r.shape[0]
                self._plane_re.pop(0)
                self._plane_im.pop(0)
            else:
                take_re.append(r[:need])
                take_im.append(i[:need])
                self._plane_re[0] = r[need:]
                self._plane_im[0] = i[need:]
                got = rows
        self._plane_rows -= rows
        if len(take_re) == 1:
            if isinstance(take_re[0], jax.Array):
                # device-resident planes (e.g. straight from the resampler)
                # flow through without a host round trip; the steady step's
                # jnp.asarray is then the identity
                return take_re[0], take_im[0]
            return (np.ascontiguousarray(take_re[0]),
                    np.ascontiguousarray(take_im[0]))
        return (np.concatenate([np.asarray(a) for a in take_re], axis=0),
                np.concatenate([np.asarray(a) for a in take_im], axis=0))

    def _planes_to_cmajor(self, re, im) -> np.ndarray:
        """Channel-major complex view of a plane block (warm-up path only;
        the steady step consumes the planes directly)."""
        re, im = np.asarray(re), np.asarray(im)
        if re.dtype == np.int16:
            s = self._ingest_scale
            return ((re.T.astype(np.float32) * s)
                    + 1j * (im.T.astype(np.float32) * s)).astype(np.complex64)
        return (re.T + 1j * im.T).astype(np.complex64)

    def ready(self) -> bool:
        need = self.block_symbols * self.cfg.sps
        if self._plane_rows:
            return self._plane_rows >= need
        return all(s.size >= need for s in self._staging)

    def _step_core(self):
        """One block: warm-up returns channel-major DemodOutputs; the
        steady step returns raw TMOutputs (time-major planes, fetched and
        converted only by whichever surface consumes them)."""
        if not self.ready():
            return None
        need = self.block_symbols * self.cfg.sps
        plane_blk = None
        if self._plane_rows:
            plane_blk = self._take_plane_rows(need)
            x = None
        else:
            x = np.stack([s[:need] for s in self._staging])
            self._staging = [s[need:] for s in self._staging]
        self._consumed += self.block_symbols
        if self._full_state is None:
            if plane_blk is not None:
                x = self._planes_to_cmajor(*plane_blk)
            self._track_raw(x)
            self._warm_state, out = self._warm_fn(self._warm_state,
                                                  jnp.asarray(x))
            if self._guard_warm_jit is not None:
                self._warm_state, bad = self._guard_warm_jit(
                    self._warm_state, out)
                self._note_bad(bad)
            if (self._consumed >= self.cfg.num_avg + self.cfg.phase_avg
                    and self._raw_tail.shape[1] >= self._raw_keep):
                raw = (self._raw_tail if self._raw_keep else None)
                self._full_state = self._handoff(raw)
                if self._ingest_scale is not None:
                    self._full_state = self._full_mod.quantize_full_state(
                        self._full_state, self._ingest_scale)
                self._warm_state = None
                self._raw_tail = np.zeros((self.channels, 0), np.complex64)
        else:
            if plane_blk is not None:
                x_re = jnp.asarray(plane_blk[0])    # no transpose, no split
                x_im = jnp.asarray(plane_blk[1])
            else:
                x_re = jnp.asarray(np.ascontiguousarray(x.real.T))
                x_im = jnp.asarray(np.ascontiguousarray(x.imag.T))
            fo = self._steady_step(x_re, x_im)
            if self._guard_full_jit is not None:
                phase = fo.phase if fo.phase is not None else fo.soft_re
                self._full_state, bad = self._guard_full_jit(
                    self._full_state, fo.soft_re, fo.soft_im, phase)
                self._note_bad(bad)
            out = TMOutputs(fo=fo, soft_scale=self._soft_scale)
        if self._pipe_depth == 0:
            nv = self._count_symbols(out)
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol
        return out

    def _count_symbols(self, out) -> int:
        if isinstance(out, TMOutputs):
            sv = (int(out.valid_rows.sum()) if out.valid_rows is not None
                  else out.fo.bits_packed.shape[0])
            return sv * self.channels
        return int(np.asarray(out.valid).sum())

    def _to_cmajor(self, out):
        """TMOutputs -> channel-major DemodOutputs (the step()/flush()
        array surface; the packet surface consumes TMOutputs directly)."""
        if not isinstance(out, TMOutputs):
            return out
        # Mixed high-order banks widen the bit planes past the shared cfg's
        # width; the assembler cfg carries the port layout either way.
        do = self._full_mod.to_demod_outputs(self.assembler.cfg, out.fo,
                                             soft_i8_scale=out.soft_scale)
        if out.valid_rows is not None:
            do = do._replace(
                valid=do.valid & jnp.asarray(out.valid_rows)[None, :])
        return do

    def step(self):
        """Returns channel-major DemodOutputs (via the adapter) or None."""
        return self._to_cmajor(self._step_core())

    def _step_for_packets(self):
        return self._step_core()

    def _flush_for_packets(self):
        return self._flush_core()

    def flush(self):
        """EOS drain (channel-major DemodOutputs surface)."""
        return self._to_cmajor(self._flush_core())

    def _flush_core(self):
        """EOS drain.  Before the steady handoff the flexible path handles
        any length; afterwards the remainder is zero-padded to a full block
        through the steady step and outputs whose timing window reaches into the
        padding are masked invalid (the reference never emits those symbols
        either, cpp/psk_soft.cpp:457)."""
        sps, num_avg = self.cfg.sps, self.cfg.num_avg
        plane_blk = None
        if self._plane_rows:
            n = (self._plane_rows // sps) * sps
            plane_blk = self._take_plane_rows(n) if n else None
            self._plane_re, self._plane_im, self._plane_rows = [], [], 0
            x = None
        else:
            n = (min(s.size for s in self._staging) // sps) * sps
            x = np.stack([s[:n] for s in self._staging]) if n else None
        self._staging = [np.zeros(0, np.complex64)
                         for _ in range(self.channels)]
        if n == 0:
            return None
        if self._full_state is None:
            if plane_blk is not None:
                x = self._planes_to_cmajor(*plane_blk)
            self._warm_state, out = self._warm_fn(self._warm_state,
                                                  jnp.asarray(x))
        else:
            nsym = n // sps
            pad = self.block_symbols * sps - n
            if plane_blk is not None:
                x_re = jnp.asarray(np.pad(plane_blk[0], ((0, pad), (0, 0))))
                x_im = jnp.asarray(np.pad(plane_blk[1], ((0, pad), (0, 0))))
            else:
                xp = np.pad(x, ((0, 0), (0, pad)))
                x_re = jnp.asarray(np.ascontiguousarray(xp.real.T))
                x_im = jnp.asarray(np.ascontiguousarray(xp.imag.T))
            fo = self._steady_step(x_re, x_im)
            # Output o's window covers carry rows [o, o+numAvg-1]; with a
            # full carry (steady) plus nsym real new rows, windows are fully
            # real for o < nsym -- exactly the outputs the reference would
            # still emit before the stream ends.  A matched filter looks
            # mf_ntaps-1 raw samples ahead, so its last ceil((L-1)/sps)
            # symbols also touch the padding and are masked.
            nvalid = nsym
            if self.cfg.matched_filter != "none":
                nvalid = max(0, nsym - (-(-(self.cfg.mf_ntaps - 1)
                                          // self.cfg.sps)))
            mask = np.zeros(self.block_symbols, bool)
            mask[:nvalid] = True
            out = TMOutputs(fo=fo, valid_rows=mask,
                            soft_scale=self._soft_scale)
        if self._pipe_depth == 0:
            nv = self._count_symbols(out)
            self.metrics.symbols_out += nv
            self.metrics.bits_out += nv * self.assembler.cfg.bits_per_symbol
        return out


