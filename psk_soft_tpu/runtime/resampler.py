"""Streaming per-channel resampler bank: heterogeneous native rates in,
one common-sps (T, C) plane block out.

Host/device split (same philosophy as the native deframer): channels
arrive at their own rates, so per-block consumption is RAGGED -- that
bookkeeping (per-channel queues, window assembly, carry rebasing) stays on
the host in numpy, while the device step (ops/resample.py) sees one
static-shape (W, C) window every block and one compile for the bank's
lifetime.  The output planes feed the batch engines directly
(FullKernelBatchEngine.push_planes / BatchEngine), so a bank whose
channels natively run at sps 7.3, 8.0 and 9.25 demodulates through ONE
steady step at the common sps.

Position bookkeeping is rebased every block (the carry stays within one
tap-span of zero), so float32 phase accumulation never loses precision
over unbounded stream lengths.

Fast paths: rational ratios auto-select the zero-gather banded-matmul
device step -- one matrix for a uniform bank, one per distinct
ratio (with its own anti-alias cutoff) for a grouped bank -- with a
device-side output FIFO decoupling the rational cycle from block_out.
The per-(n, c) gather step remains for irrational or live-retuned
(`set_ratio`) ratios.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from ..ops.resample import (kaiser_sinc_table, resample_block,
                            resample_block_uniform, uniform_poly_matrix)


class ResamplerBank:
    """Convert C channels at per-channel input rates to a common output
    rate, block-streaming.

    ratios: input samples per output sample, per channel (in_rate/out_rate;
      e.g. native sps 7.3 -> bank sps 8 is ratio 7.3/8).
    block_out: output rows per step (= the downstream engine's T).

    Backpressure note: a step consumes ~block_out*ratio_c input samples per
    channel, so when channels ARRIVE at a common capture rate but their
    ratios differ, the lower-ratio channels' queues grow while the highest
    ratio gates block cadence.  That skew is inherent to putting different
    bauds on one output grid; for endless streams with widely different
    bauds, group channels of similar baud into separate banks (GroupEngine
    composition) and keep each bank's ratio spread small.
    """

    def __init__(self, ratios, block_out: int, n_phases: int = 128,
                 taps_per_phase: int = 8, kaiser_beta: float = 8.0,
                 cutoff: float | None = None, uniform: bool | None = None):
        self.ratios = np.asarray(ratios, np.float64)
        if self.ratios.ndim != 1 or not np.all(self.ratios > 0):
            raise ValueError("ratios must be a 1-D array of positive "
                             "in/out rate quotients")
        self.channels = self.ratios.size
        self.block_out = int(block_out)
        self.K = int(taps_per_phase)
        if self.K % 2 or self.K < 4:
            raise ValueError(f"taps_per_phase must be even and >= 4, got "
                             f"{self.K}")
        if float(self.ratios.max()) > self.K / 2:
            # Two reasons: (a) an interpolator spanning K input samples has
            # no anti-alias stopband left at >K/2-fold decimation -- the
            # output would be aliasing junk; (b) the step's row-drop would
            # outrun the buffered window (drop-need grows like ratio-K) and
            # silently desync.  Decimate with a proper FIR first.
            raise ValueError(
                f"max ratio {self.ratios.max():.3g} exceeds taps_per_phase/2"
                f" = {self.K / 2:.3g}: a {self.K}-tap interpolation span "
                f"cannot anti-alias that decimation; pre-decimate or raise "
                f"taps_per_phase")
        self._max_ratio = float(self.ratios.max())   # set_ratio bound
        # anti-alias margin for the largest downsampling ratio in the bank.
        # NOTE one table serves the whole bank: with a wide ratio spread the
        # low-ratio (upsampling) channels are narrowed more than they need;
        # pass an explicit cutoff, or split wide-spread banks (see the
        # backpressure note above, same remedy).
        user_cutoff = cutoff
        if cutoff is None:
            cutoff = min(1.0, 1.0 / self._max_ratio)
        self._table = jnp.asarray(kaiser_sinc_table(
            n_phases, self.K, cutoff=cutoff, beta=kaiser_beta))
        # One shared RATIONAL ratio -> the zero-gather matmul form (banded
        # polyphase matmul, ops/resample.resample_block_uniform): measured
        # ~30x the gather form's rate on CPU.  uniform=None auto-detects; False keeps the gather
        # path (needed for set_ratio); True asserts eligibility.
        self._uniform = None
        self._fifo = None
        self._groups = None
        if uniform is not False and np.all(self.ratios == self.ratios[0]):
            fr = Fraction(float(self.ratios[0])).limit_denominator(512)
            if (fr.numerator > 0
                    and abs(float(fr) - float(self.ratios[0]))
                    <= 1e-9 * float(self.ratios[0])):
                self._uniform = (fr.numerator, fr.denominator)
                self._S = jnp.asarray(uniform_poly_matrix(
                    fr.numerator, fr.denominator, self.K, cutoff=cutoff,
                    beta=kaiser_beta))
        if uniform is True and self._uniform is None:
            raise ValueError("uniform=True needs one shared ratio "
                             "expressible as a fraction with denominator "
                             "<= 512")
        # Heterogeneous but FEW distinct rational ratios -> grouped-uniform
        # decomposition: one sub-bank (banded matmul) per distinct ratio,
        # outputs scattered back to bank columns.  Same ~30x over gathers,
        # paid once per group.
        if (uniform is None and self._uniform is None
                and self.channels > 1):
            uniq = sorted(set(self.ratios.tolist()))
            if len(uniq) <= 8:
                frs = [Fraction(r).limit_denominator(512) for r in uniq]
                if all(f.numerator > 0 and abs(float(f) - r) <= 1e-9 * r
                       for f, r in zip(frs, uniq)):
                    self._groups = []
                    for r in uniq:
                        idx = np.nonzero(self.ratios == r)[0]
                        # per-group cutoff: each group gets exactly the
                        # anti-alias margin ITS ratio needs (a shared
                        # table would over-filter the upsampling groups)
                        sub = ResamplerBank(
                            [r] * len(idx), self.block_out,
                            n_phases=n_phases, taps_per_phase=self.K,
                            kaiser_beta=kaiser_beta,
                            cutoff=(user_cutoff if user_cutoff is not None
                                    else min(1.0, 1.0 / r)),
                            uniform=True)
                        self._groups.append((idx, sub))
                    self._col_of = {int(ch): (gi, int(sl))
                                    for gi, (idx, _) in
                                    enumerate(self._groups)
                                    for sl, ch in enumerate(idx)}
        # static device window: covers the worst-case block span + carry
        self.window = (int(math.ceil((self.block_out - 1)
                                     * float(self.ratios.max())))
                       + 2 * self.K + 8)
        self._ratio_dev = jnp.asarray(self.ratios.astype(np.float32))
        # per-channel input queues (complex64 host buffers) + carry
        self._buf = [np.zeros(0, np.complex64) for _ in range(self.channels)]
        # real (non-padding) samples still queued, for EOS drain accounting
        self._real = np.zeros(self.channels, np.int64)
        # first output sample position, relative to each buffer's row 0;
        # starts at the earliest in-contract point so the filter's lead-in
        # reads real (pushed) samples once enough arrive
        self._pos = np.full(self.channels, self.K // 2 - 1, np.float64)

    def set_ratio(self, channel: int, ratio: float) -> None:
        """Live per-channel rate change (C7-style property reactor): the
        channel continues from its current stream position at the new rate
        -- doppler/baud-drift tracking semantics, no resync, no recompile.

        Bounded by the ratio the bank was sized for: the static device
        window and the anti-alias cutoff were chosen from the construction-
        time maximum, so a larger ratio needs a new bank.
        """
        if self._uniform is not None or self._groups is not None:
            raise ValueError(
                "this bank runs the uniform/grouped (banded-matmul) fast "
                "path, which bakes ratios into phase matrices; construct "
                "with uniform=False for live retuning")
        r = float(ratio)
        if not 0 < r <= self._max_ratio:
            raise ValueError(
                f"ratio {r:.6g} outside (0, {self._max_ratio:.6g}]: the "
                f"window/table were sized for the construction-time "
                f"maximum; build a new bank for a larger ratio")
        self.ratios[channel] = r
        self._ratio_dev = jnp.asarray(self.ratios.astype(np.float32))

    def push(self, channel: int, data: np.ndarray) -> None:
        if self._groups is not None:
            gi, slot = self._col_of[int(channel)]
            self._groups[gi][1].push(slot, data)
            return
        d = np.asarray(data)
        if d.ndim != 1:
            raise ValueError("per-channel input must be 1-D complex samples")
        self._buf[channel] = np.concatenate(
            [self._buf[channel], d.astype(np.complex64)])
        self._real[channel] += d.size

    def _fifo_rows(self) -> int:
        return 0 if self._fifo is None else int(self._fifo[0].shape[0])

    def _uniform_cycles(self) -> int:
        """Full rational cycles the next uniform step must run so the
        output FIFO can cover one block."""
        short = self.block_out - self._fifo_rows()
        den = self._uniform[1]
        return max(-(-short // den), 0)

    def _need(self) -> np.ndarray:
        if self._uniform is not None:
            q = self._uniform_cycles()
            n = q * self._uniform[0] + self.K if q else 0
            return np.full(self.channels, n, np.int64)
        last = self._pos + (self.block_out - 1) * self.ratios
        return np.floor(last).astype(np.int64) + self.K // 2 + 1

    def ready(self) -> bool:
        if self._groups is not None:
            return all(sub.ready() for _, sub in self._groups)
        need = self._need()
        return all(len(b) >= n for b, n in zip(self._buf, need))

    def pending(self) -> np.ndarray:
        """Per-channel samples still missing for the next block (0 when
        ready); observability for the feeder."""
        if self._groups is not None:
            out = np.zeros(self.channels, np.int64)
            for idx, sub in self._groups:
                out[idx] = sub.pending()
            return out
        need = self._need()
        return np.maximum(0, need - np.array([len(b) for b in self._buf]))

    def step_planes(self):
        """One block: (y_re, y_im) time-major (block_out, C) float32 device
        planes at the common rate, or None until every channel has enough
        input."""
        if not self.ready():
            return None
        if self._groups is not None:
            return self._scatter([sub.step_planes()
                                  for _, sub in self._groups])
        if self._uniform is not None:
            return self._step_uniform()
        need = self._need()
        W = self.window
        assert int(need.max()) <= W, "window sizing bug"
        x_re = np.zeros((W, self.channels), np.float32)
        x_im = np.zeros((W, self.channels), np.float32)
        for c, b in enumerate(self._buf):
            n = int(need[c])
            x_re[:n, c] = b[:n].real
            x_im[:n, c] = b[:n].imag
        y_re, y_im, _ = resample_block(
            jnp.asarray(x_re), jnp.asarray(x_im),
            jnp.asarray(self._pos.astype(np.float32)), self._ratio_dev,
            self._table, self.block_out)
        # advance + rebase: drop rows the next block can no longer read
        pos_end = self._pos + self.block_out * self.ratios
        drop = np.maximum(
            np.floor(pos_end).astype(np.int64) - (self.K // 2 - 1), 0)
        for c in range(self.channels):
            # guaranteed by the ratio <= K/2 bound checked in __init__
            # (drop - need ~ ratio - K - 2 < 0) plus ready()'s len >= need
            assert drop[c] <= len(self._buf[c]), "row-drop outran the buffer"
            self._buf[c] = self._buf[c][int(drop[c]):]
        self._real = np.maximum(self._real - drop, 0)
        self._pos = pos_end - drop
        return y_re, y_im

    def _step_uniform(self):
        """Uniform-ratio step: run Q rational cycles through the banded
        matmul, stage outputs in a device FIFO, emit exactly block_out
        rows.  Consumption is Q*num rows per channel (K-row tap tail
        kept), no position carry at all."""
        num, den = self._uniform
        Q = self._uniform_cycles()
        if Q:
            need = Q * num + self.K
            x_re = np.empty((need, self.channels), np.float32)
            x_im = np.empty((need, self.channels), np.float32)
            for c, b in enumerate(self._buf):
                x_re[:, c] = b[:need].real
                x_im[:, c] = b[:need].imag
            y_re, y_im = resample_block_uniform(
                jnp.asarray(x_re), jnp.asarray(x_im), self._S, num, den)
            if self._fifo is None:
                self._fifo = (y_re, y_im)
            else:
                self._fifo = (jnp.concatenate([self._fifo[0], y_re]),
                              jnp.concatenate([self._fifo[1], y_im]))
            drop = Q * num
            for c in range(self.channels):
                self._buf[c] = self._buf[c][drop:]
            self._real = np.maximum(self._real - drop, 0)
        f_re, f_im = self._fifo
        out = (f_re[:self.block_out], f_im[:self.block_out])
        if f_re.shape[0] > self.block_out:
            self._fifo = (f_re[self.block_out:], f_im[self.block_out:])
        else:
            self._fifo = None
        return out

    def step(self):
        """Like :meth:`step_planes` but returns a host (C, block_out)
        complex64 array (BatchEngine.push-compatible per channel)."""
        out = self.step_planes()
        if out is None:
            return None
        y_re, y_im = out
        return (np.asarray(y_re).T + 1j * np.asarray(y_im).T).astype(
            np.complex64)

    def _scatter(self, group_planes):
        """Reassemble per-group (B, C_g) planes into bank (B, C) columns."""
        y_re = jnp.zeros((self.block_out, self.channels), jnp.float32)
        y_im = jnp.zeros_like(y_re)
        for (idx, _), blk in zip(self._groups, group_planes):
            y_re = y_re.at[:, idx].set(blk[0])
            y_im = y_im.at[:, idx].set(blk[1])
        return y_re, y_im

    def drain(self, planes: bool = True):
        """EOS: zero-pad every channel until all REAL queued samples have
        been consumed, yielding the final full blocks (the downstream
        engines then pad/flush their own sub-block tails).  Returns a list
        of step_planes()/step() results."""
        if self._groups is not None:
            tails = [sub.drain(planes=True) for _, sub in self._groups]
            n = max((len(t) for t in tails), default=0)
            out = []
            for i in range(n):
                blks = [t[i] if i < len(t) else
                        (jnp.zeros((self.block_out, len(idx)), jnp.float32),
                         jnp.zeros((self.block_out, len(idx)), jnp.float32))
                        for (idx, _), t in zip(self._groups, tails)]
                y = self._scatter(blks)
                if not planes:
                    y = (np.asarray(y[0]).T
                         + 1j * np.asarray(y[1]).T).astype(np.complex64)
                out.append(y)
            return out
        out = []
        # a channel's tail is spent once fewer than a tap-span of real
        # samples remains (the rest is filter lead-out)
        while np.any(self._real > self.K):
            pad = self.pending()
            for c in range(self.channels):
                if pad[c]:
                    self._buf[c] = np.concatenate(
                        [self._buf[c], np.zeros(int(pad[c]), np.complex64)])
            blk = self.step_planes() if planes else self.step()
            if blk is None:    # cannot happen after padding; stay safe
                break
            out.append(blk)
        return out


class ResampledBankEngine:
    """Heterogeneous-native-rate bank behind the standard engine surface:
    ResamplerBank -> FullKernelBatchEngine (or BatchEngine), with the
    packet clock rescaled to the common grid.

    push() takes NATIVE-rate complex samples per channel; everything
    downstream (step_packets / flush_packets / configure / reset /
    metrics) is the wrapped engine's surface.  flush_packets returns a
    LIST of per-port packet dicts (the resampler's EOS drain can complete
    several engine blocks, each with its own timestamps) -- the one
    deliberate signature difference from the single-rate engines.
    """

    def __init__(self, cfg, channels: int, native_sps, *,
                 block_symbols: int = 512, pipeline: str = "full",
                 resampler_kwargs: dict | None = None, **engine_kwargs):
        from .engine import BatchEngine, FullKernelBatchEngine
        vals = np.broadcast_to(np.asarray(native_sps, np.float64),
                               (channels,))
        self.resampler = ResamplerBank(
            (vals / cfg.sps).tolist(), block_out=block_symbols * cfg.sps,
            **(resampler_kwargs or {}))
        self._full = pipeline == "full"
        if self._full:
            self.engine = FullKernelBatchEngine(
                cfg, channels, block_symbols=block_symbols, **engine_kwargs)
        else:
            self.engine = BatchEngine(cfg, channels,
                                      block_symbols=block_symbols,
                                      **engine_kwargs)

    # ---- ingest ----------------------------------------------------------
    def push(self, channel: int, data: np.ndarray) -> None:
        self.resampler.push(channel, data)

    def pending(self) -> np.ndarray:
        return self.resampler.pending()

    def _feed(self, blk) -> None:
        if self._full:
            self.engine.push_planes(blk[0], blk[1])
        else:
            self.engine.push_block(blk)

    def _pump(self) -> None:
        while True:
            blk = (self.resampler.step_planes() if self._full
                   else self.resampler.step())
            if blk is None:
                return
            self._feed(blk)

    # ---- engine surface --------------------------------------------------
    def set_input_sri(self, sri, t: float = 0.0) -> None:
        """Input SRI at the CAPTURE rate; the engine sees the common-grid
        clock (xdelta scaled by the ratio -- exact for uniform banks, the
        median otherwise, same convention as the CLI)."""
        import dataclasses
        r = self.resampler.ratios
        scale = float(r[0]) if np.allclose(r, r[0]) else float(np.median(r))
        self.engine.set_input_sri(
            dataclasses.replace(sri, xdelta=sri.xdelta * scale), t)

    def step_packets(self):
        self._pump()
        return self.engine.step_packets()

    def step(self):
        self._pump()
        return self.engine.step()

    def flush_packets(self) -> list:
        for blk in self.resampler.drain(planes=self._full):
            self._feed(blk)
        out = []
        while True:
            pkts = self.engine.step_packets()
            if pkts is None:
                break
            out.append(pkts)
        out.append(self.engine.flush_packets())
        return out

    def configure(self, new_cfg) -> None:
        if new_cfg.sps != self.engine.cfg.sps:
            raise ValueError("sps change alters every channel's ratio; "
                             "rebuild the ResampledBankEngine instead")
        self.engine.configure(new_cfg)

    def reset(self) -> None:
        self.engine.reset()

    @property
    def metrics(self):
        return self.engine.metrics
