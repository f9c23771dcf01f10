"""Block-parallel feed-forward PSK demodulator: the performance flagship.

Recasts the reference's strictly sequential per-symbol recursion
(cpp/psk_soft.cpp:442-603) into a pipeline with **no scan at all**
(SURVEY.md section 7 stage 4):

* C2 timing: windowed segmented energy sums + argmax -- already parallel
  (ops/timing.py).
* C3 phase: the reference unwraps each M-th-power phase against the running
  *estimate* (cpp/psk_soft.cpp:477-478).  Here the block's raw phases are
  unwrapped against the *previous unwrapped phase* -- cumulative wrap counts
  are a prefix sum (ops/phase.block_unwrap) -- and the sliding linear fit
  becomes an FIR filter over the unwrapped phases (the fit-at-newest-point is
  linear in its window; ops/linear_fit.endpoint_fir_weights), evaluated as a
  convolution.  Warm-up (growing window) is handled exactly with the
  right-aligned warm-up weight matrix on the first ``phase_avg`` outputs.

Feedback -> feed-forward equivalence (SURVEY.md "hard part #1"): the two
formulations agree whenever the tracker's prediction and the previous sample
agree to within half a turn of the M-th-power phase -- i.e. except under
phase dynamics of >~ pi per symbol where an M-th-power tracker has already
lost lock.  ``tests/test_block_equiv.py`` gates the equivalence against the
exact-scan pipeline on the golden vectors and under frequency offset.

This is also the pipeline that time-shards over a mesh (parallel/sharded.py):
every stage is either local, a halo exchange, or a prefix combine.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..ops import linear_fit, phase as phase_ops
from .common import correct_and_slice, maybe_matched_filter, timing_frontend
from .psk import DemodOutputs


class FFState(NamedTuple):
    """Carry for the feed-forward pipeline (leading axes batch channels)."""

    win_samples: jnp.ndarray   # (num_avg-1, sps) complex64
    win_energy: jnp.ndarray    # (num_avg-1, sps) float32
    seen: jnp.ndarray          # () int32, saturating at num_avg
    # Right-aligned history of the last (phase_avg-1) unwrapped phases;
    # only the rightmost min(phase_count, phase_avg-1) entries are live.
    phase_hist: jnp.ndarray    # (phase_avg-1,) float32
    phase_count: jnp.ndarray   # () int32, saturating at phase_avg
    last_phase: jnp.ndarray    # () float32, last unwrapped phase
    last_any: jnp.ndarray      # () complex64
    mf_tail: jnp.ndarray       # (mf_ntaps-1 or 0,) complex64


def ff_init(cfg: DemodConfig, channel_shape: tuple = ()) -> FFState:
    a1 = max(cfg.num_avg - 1, 0)
    n1 = max(cfg.phase_avg - 1, 0)
    return FFState(
        win_samples=jnp.zeros(channel_shape + (a1, cfg.sps), jnp.complex64),
        win_energy=jnp.zeros(channel_shape + (a1, cfg.sps), jnp.float32),
        seen=jnp.zeros(channel_shape, jnp.int32),
        phase_hist=jnp.zeros(channel_shape + (n1,), jnp.float32),
        phase_count=jnp.zeros(channel_shape, jnp.int32),
        last_phase=jnp.zeros(channel_shape, jnp.float32),
        last_any=jnp.ones(channel_shape, jnp.complex64),
        mf_tail=jnp.zeros(channel_shape + (max(cfg.mf_ntaps - 1, 0),), jnp.complex64),
    )


def _fir_phase_track(cfg: DemodConfig, hist, phase_count, unwrapped, valid,
                     assume_steady: bool = False):
    """Sliding linear-fit estimates for one block, as convolution + warm-up fix.

    Args:
      hist: (n-1,) right-aligned unwrapped-phase history.
      phase_count: () int32 valid phases before this block (saturated at n).
      unwrapped: (S,) block unwrapped phases (garbage where ~valid).
      valid: (S,) bool; invalid entries form a prefix and never interleave.

    Returns (est (S,), new_hist (n-1,), new_phase_count ()).
    """
    n = cfg.phase_avg
    S = unwrapped.shape[0]
    cat = jnp.concatenate([hist, unwrapped])            # (n-1+S,)

    # Steady-state FIR: est[o] = w . cat[o:o+n]  (fit at newest point).
    w = jnp.asarray(linear_fit.endpoint_fir_weights(n))
    if n == 1:
        est = unwrapped
    else:
        est = jnp.convolve(cat, w[::-1], mode="valid",  # (S,); HIGHEST:
                           precision=jax.lax.Precision.HIGHEST)  # no TF32

    if assume_steady:
        new_hist = cat[S:] if n > 1 else hist
        return est, new_hist, phase_count

    # Warm-up: outputs whose effective window p < n get the right-aligned
    # p-point weights (exactly matching LinearFit's growing window,
    # cpp/psk_soft.cpp:81-83,135-174).  p depends on the valid rank, which
    # only differs from o during the first blocks of a stream.
    rank = jnp.cumsum(valid.astype(jnp.int32))           # 1-based among valid
    p = jnp.minimum(phase_count + rank, n)
    if n > 1:
        # Warm-up rows are the first (at most) n *valid* rows of a fresh
        # stream; they start at the first-valid index, which can sit anywhere
        # in the block (the timing warm-up numAvg spans blocks), so the
        # fix-up window is dynamically placed.
        k = min(n, S)
        fv = jnp.argmax(valid).astype(jnp.int32)
        start = jnp.minimum(fv, S - k)
        wm = jnp.asarray(linear_fit.warmup_fir_weight_matrix(n))
        warm_cat = jax.lax.dynamic_slice(cat, (start,), (k + n - 1,))
        idx = jnp.arange(k)[:, None] + jnp.arange(n)[None, :]
        windows = warm_cat[idx]                          # (k, n)
        p_warm = jax.lax.dynamic_slice(p, (start,), (k,))
        w_sel = wm[jnp.clip(p_warm, 1, n) - 1]           # (k, n)
        est_warm = jnp.sum(windows * w_sel, axis=-1)
        est_slice = jax.lax.dynamic_slice(est, (start,), (k,))
        fixed = jnp.where(p_warm < n, est_warm, est_slice)
        est = jax.lax.dynamic_update_slice(est, fixed, (start,))

    new_count = jnp.minimum(phase_count + jnp.sum(valid.astype(jnp.int32)), n)
    new_hist = cat[S:] if n > 1 else hist
    return est, new_hist, new_count


class SymbolBackendState(NamedTuple):
    """Symbol-rate carry: everything downstream of timing recovery."""

    phase_hist: jnp.ndarray    # (phase_avg-1,) float32
    phase_count: jnp.ndarray   # () int32
    last_phase: jnp.ndarray    # () float32
    last_any: jnp.ndarray      # () complex64


def symbol_backend(cfg: DemodConfig, st: SymbolBackendState,
                   sel: jnp.ndarray, valid: jnp.ndarray,
                   prev_exists: jnp.ndarray, assume_steady: bool = False):
    """Phase recovery + correction + slicing over one block's decision
    samples (single chain; vmap for channels).

    ``assume_steady=True`` compiles the converged fast path: every output
    valid and the tracker window full, so all warm-up machinery (first-valid
    search, growing-window weight fix-up, origin snapping) drops out of the
    program.  The streaming engines flip to it once warm-up has passed.

    Returns (new SymbolBackendState, (soft, bits, phase_seq)).
    """
    m = cfg.constellation_size
    S = sel.shape[0]
    n1 = cfg.phase_avg - 1

    # --- phase: trend-robust prefix unwrap + FIR fit ---
    raw = phase_ops.mth_power_phase(sel, m)
    if assume_steady:
        raw_eff = raw
    else:
        fv = jnp.argmax(valid)  # index of first valid (0 if none/all)
        first_raw = raw[jnp.clip(fv, 0, S - 1)]
        prev_eff = jnp.where(st.phase_count > 0, st.last_phase, first_raw)
        raw_eff = jnp.where(valid, raw, prev_eff)
    # Unwrap over [history, block] in one locally-consistent chain (history
    # values are unwrapped but enter mod 2pi, which is all the trend needs;
    # hist[-1] is the chronologically newest value just before the block),
    # then snap the absolute origin back onto the carry with an exact
    # multiple of 2pi.
    head = st.phase_hist if n1 > 0 else st.last_phase[None]
    h = head.shape[0]
    ext = jnp.concatenate([head, raw_eff])
    u_ext = phase_ops.robust_block_unwrap(ext)
    cont_shift = phase_ops.TWO_PI * jnp.round(
        (st.last_phase - u_ext[h - 1]) / phase_ops.TWO_PI)
    if assume_steady:
        shift = cont_shift
    else:
        start_shift = phase_ops.TWO_PI * jnp.round(
            (first_raw - u_ext[h + jnp.clip(fv, 0, S - 1)]) / phase_ops.TWO_PI)
        shift = jnp.where(st.phase_count > 0, cont_shift, start_shift)
    unwrapped = u_ext[h:] + shift
    est, new_hist, new_count = _fir_phase_track(
        cfg, st.phase_hist, st.phase_count, unwrapped, valid,
        assume_steady=assume_steady)
    phase_seq = jnp.where(valid, est, 0.0) if not assume_steady else est

    if assume_steady:
        new_last_phase = unwrapped[S - 1]
        last_est = est[S - 1]
    else:
        any_valid = jnp.any(valid)
        last_idx = jnp.where(any_valid, S - 1 - jnp.argmax(valid[::-1]), 0)
        new_last_phase = jnp.where(any_valid, unwrapped[last_idx],
                                   st.last_phase)
        last_est = jnp.where(any_valid, est[last_idx], 0.0)

    # End-of-block re-wrap about M*2pi (cpp/psk_soft.cpp:592-603): keep the
    # carried history bounded; estimates already emitted are unaffected.
    off = phase_ops.rewrap_offset(last_est, m)
    new_hist = new_hist - off
    new_last_phase = new_last_phase - off

    soft, bits, last_any = correct_and_slice(cfg, sel, prev_exists,
                                             st.last_any, phase_seq)
    new_st = SymbolBackendState(
        phase_hist=new_hist,
        phase_count=new_count,
        last_phase=new_last_phase,
        last_any=last_any,
    )
    return new_st, (soft, bits, phase_seq)


def demod_block_ff(cfg: DemodConfig, state: FFState, x: jnp.ndarray,
                   assume_steady: bool = False):
    """Feed-forward demod of one symbol-aligned block (single chain; vmap for
    channels).  Same outputs as models/psk.demod_block.

    ``assume_steady`` compiles the converged fast path (see symbol_backend);
    only call it once warm-up has passed (engines track this).
    """
    sps = cfg.sps
    T = x.shape[0]
    if T % sps != 0:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    S = T // sps
    x, mf_tail = maybe_matched_filter(cfg, state, x)
    xs = x.reshape(S, sps)

    fe = timing_frontend(cfg, state.win_samples, state.win_energy, state.seen, xs)
    sel = fe["sel"]
    if assume_steady:
        valid = jnp.ones((S,), bool)
        prev_exists = valid
    else:
        valid, prev_exists = fe["valid"], fe["prev_exists"]

    bst = SymbolBackendState(state.phase_hist, state.phase_count,
                             state.last_phase, state.last_any)
    bst2, (soft, bits, phase_seq) = symbol_backend(
        cfg, bst, sel, valid, prev_exists, assume_steady=assume_steady)

    new_state = FFState(
        win_samples=fe["new_win_samples"],
        win_energy=fe["new_win_energy"],
        seen=fe["seen2"],
        phase_hist=bst2.phase_hist,
        phase_count=bst2.phase_count,
        last_phase=bst2.last_phase,
        last_any=bst2.last_any,
        mf_tail=mf_tail,
    )
    if assume_steady:
        outputs = DemodOutputs(
            soft=soft, bits=bits.astype(jnp.int8), phase=phase_seq,
            sample_index=fe["sample_index"], valid=valid,
        )
    else:
        outputs = DemodOutputs(
            soft=jnp.where(valid, soft, 0),
            bits=jnp.where(valid[:, None], bits, 0).astype(jnp.int8),
            phase=phase_seq,
            sample_index=jnp.where(valid, fe["sample_index"], 0),
            valid=valid,
        )
    return new_state, outputs


def make_ff_demod_fn(cfg: DemodConfig, channels: int | None = None,
                     jit: bool = True, assume_steady: bool = False):
    """Build a (optionally channel-batched) jitted feed-forward step."""
    fn = functools.partial(demod_block_ff, cfg, assume_steady=assume_steady)
    if channels is not None:
        fn = jax.vmap(fn)
    return jax.jit(fn) if jit else fn


def make_scanned_ff_demod_fn(cfg: DemodConfig, channels: int | None = None,
                             assume_steady: bool = False):
    """Many block-steps in ONE dispatch: fn(state, xs) with xs shaped
    (K, T) (or (K, C, T) with channels), scanning the carried step over the
    leading axis and returning (state, stacked DemodOutputs).

    One compiled program processes a whole recording -- useful for offline
    batch work and for amortizing per-dispatch overhead.
    """
    step = functools.partial(demod_block_ff, cfg, assume_steady=assume_steady)
    if channels is not None:
        step = jax.vmap(step)

    def run(state, xs):
        return jax.lax.scan(step, state, xs)

    return jax.jit(run)
