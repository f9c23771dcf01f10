"""Exact-semantics PSK demodulator: the golden-parity pipeline.

Functionally reproduces the reference hot loop (C2/C3/C4/C5/C6,
``cpp/psk_soft.cpp:442-603``) as a pure block step

    demod_block(cfg, state, x) -> (state', DemodOutputs)

Array-first structure: everything that is actually parallel in the reference's
per-sample loop is computed in parallel (energy binning, windowed argmax,
decision-sample gather, M-th-power phase, rotation, slicing); only the truly
sequential recursion -- unwrap-against-estimate feeding the sliding linear
fit (cpp/psk_soft.cpp:477-481) -- runs under ``jax.lax.scan`` at *symbol*
granularity (not sample granularity), with all channels vectorized inside
each scan step.  The fully feed-forward (scan-free) recast lives in
``models/blockpsk.py``; this module is the semantics oracle it is tested
against.

Alignment (see state.py): the carry holds the previous ``num_avg - 1`` symbol
rows; block row o is output symbol o, emitted using the forward window of
symbols [o, o + num_avg - 1] exactly like the reference emits the *oldest*
symbol of its just-completed window (cpp/psk_soft.cpp:457-465).  Output o of
a block is stream symbol ``seen_before + o - (num_avg - 1)``; the first
``num_avg - 1`` window positions of a fresh stream are marked invalid
(warm-up, cpp/psk_soft.cpp:457).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..state import DemodState, init_state
from ..ops import linear_fit, phase as phase_ops
from .common import correct_and_slice, maybe_matched_filter, timing_frontend

TWO_PI = phase_ops.TWO_PI


class DemodOutputs(NamedTuple):
    """Per-block outputs; the four reference output ports plus validity.

    soft:         (S,) complex64  -- softDecision_dataFloat_out
    bits:         (S, 3) int8     -- bits_dataShort_out, LSB-first, only the
                                     first cfg.bits_per_symbol columns valid
    phase:        (S,) float32    -- phase_dataFloat_out (unwrapped estimate)
    sample_index: (S,) int32      -- sampleIndex_dataShort_out
    valid:        (S,) bool       -- warm-up gate; invalid rows are padding
    """

    soft: jnp.ndarray
    bits: jnp.ndarray
    phase: jnp.ndarray
    sample_index: jnp.ndarray
    valid: jnp.ndarray


def _phase_scan(cfg: DemodConfig, state: DemodState, raw: jnp.ndarray,
                valid: jnp.ndarray):
    """Sequential unwrap + sliding linear fit over a block's symbols.

    raw/valid: (S, ...) with optional trailing channel axes (scan is over
    axis 0; each step is fully vectorized over channels).
    """
    n = cfg.phase_avg

    def cell(carry, inp):
        ring, pos, fill, est = carry
        raw_o, valid_o = inp
        y = phase_ops.unwrap_step(est, raw_o)
        ring2 = _ring_set(ring, pos, y)
        fill2 = jnp.minimum(fill + 1, n)
        pos2 = (pos + 1) % n
        est2 = linear_fit.ring_fit(ring2, pos2, fill2, y)
        # Invalid (warm-up) symbols do not touch the tracker: the reference
        # only runs phase recovery when a symbol is emitted
        # (cpp/psk_soft.cpp:457-481).
        keep = valid_o
        carry2 = (
            jnp.where(keep[..., None] if ring.ndim > 1 else keep, ring2, ring),
            jnp.where(keep, pos2, pos),
            jnp.where(keep, fill2, fill),
            jnp.where(keep, est2, est),
        )
        return carry2, jnp.where(keep, est2, 0.0)

    carry0 = (state.ring, state.ring_pos, state.ring_fill, state.phase_est)
    (ring, pos, fill, est), phase_seq = jax.lax.scan(cell, carry0, (raw, valid))

    # End-of-block re-wrap about M*2pi (cpp/psk_soft.cpp:592-603) keeps the
    # estimate bounded over long streams without changing soft symbols.
    off = phase_ops.rewrap_offset(est, cfg.constellation_size)
    ring = ring - off[..., None] if ring.ndim > 1 else ring - off
    est = est - off
    return (ring, pos, fill, est), phase_seq


def _ring_set(ring: jnp.ndarray, pos: jnp.ndarray, val: jnp.ndarray) -> jnp.ndarray:
    """ring[..., pos] = val with per-channel traced pos (one-hot scatter)."""
    n = ring.shape[-1]
    onehot = jnp.arange(n) == pos[..., None]
    return jnp.where(onehot, val[..., None], ring)


def demod_block(cfg: DemodConfig, state: DemodState, x: jnp.ndarray):
    """Demodulate one symbol-aligned block.

    Args:
      cfg: static configuration.
      state: carry (unbatched: this function is single-chain; use jax.vmap
        for channel batching -- see make_demod_fn).
      x: (T,) complex64 with T = S * cfg.sps, S >= 1.

    Returns:
      (new_state, DemodOutputs) with S output rows.
    """
    sps, m = cfg.sps, cfg.constellation_size
    T = x.shape[0]
    if T % sps != 0:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    S = T // sps
    x, mf_tail = maybe_matched_filter(cfg, state, x)
    xs = x.reshape(S, sps)

    # --- C2: windowed max-energy timing recovery, fully parallel ---
    fe = timing_frontend(cfg, state.win_samples, state.win_energy, state.seen, xs)
    sel, sample_index, valid = fe["sel"], fe["sample_index"], fe["valid"]

    # --- C3: M-th-power phase + unwrap + linear-fit tracking ---
    raw = phase_ops.mth_power_phase(sel, m)
    (ring, pos, fill, est), phase_seq = _phase_scan(cfg, state, raw, valid)

    # --- C5/C6: differential decode or derotation, then slicing ---
    soft, bits, last_any = correct_and_slice(cfg, sel, fe["prev_exists"],
                                             state.last_any, phase_seq)

    new_state = DemodState(
        win_samples=fe["new_win_samples"],
        win_energy=fe["new_win_energy"],
        seen=fe["seen2"],
        ring=ring,
        ring_pos=pos,
        ring_fill=fill,
        phase_est=est,
        last_any=last_any,
        mf_tail=mf_tail,
    )
    outputs = DemodOutputs(
        soft=jnp.where(valid, soft, 0),
        bits=jnp.where(valid[:, None], bits, 0).astype(jnp.int8),
        phase=jnp.where(valid, phase_seq, 0.0),
        sample_index=jnp.where(valid, sample_index, 0),
        valid=valid,
    )
    return new_state, outputs


def make_demod_fn(cfg: DemodConfig, channels: int | None = None, jit: bool = True):
    """Build a (optionally channel-batched) jitted block-demod step.

    Returns ``fn(state, x) -> (state, DemodOutputs)``; with ``channels`` set,
    state/x carry a leading channel axis (channel-parallel is the DP-like
    axis of this domain, SURVEY.md section 2.5).
    """
    fn = functools.partial(demod_block, cfg)
    if channels is not None:
        fn = jax.vmap(fn)
    return jax.jit(fn) if jit else fn


def demod_init(cfg: DemodConfig, channels: int | None = None) -> DemodState:
    """Fresh carry (see state.init_state)."""
    return init_state(cfg, () if channels is None else (channels,))
