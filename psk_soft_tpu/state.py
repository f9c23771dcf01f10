"""Demodulator carry state: an explicit pytree.

The reference keeps its cross-packet state in mutable deques and counters
(``cpp/psk_soft.h:66-86``: ``samples``, ``energy``, ``symbolEnergy``,
``index``, ``last``, ``phaseEstimate``, LinearFit history).  Here the entire
demod state is one NamedTuple of arrays, so

* the jitted step is ``step(state, block) -> (state, outputs)`` -- pure,
  vmappable over channels, shardable over a mesh;
* checkpoint = serialize the pytree, resume = pass it back in (the reference
  has no checkpointing; a restart re-converges only after the numAvg*sps
  warm-up, cpp/psk_soft.cpp:377,457);
* ``reconfigure`` (property-change semantics, C7) is an explicit pure
  function old-state -> new-state instead of dirty flags + mutation.

Alignment convention: the timing window carry holds the most recent
``num_avg - 1`` *whole symbols* (rows of sps samples), right-aligned against
the next block, so that block row o is both "the window starting at output
symbol o" and "the symbol emitted for window o" (the reference emits the
oldest symbol of its full window, cpp/psk_soft.cpp:462-465).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DemodConfig


class DemodState(NamedTuple):
    """Carry for one demod chain (leading axes may batch channels)."""

    # Timing window: previous num_avg-1 symbol rows (samples + energies).
    win_samples: jnp.ndarray   # (num_avg-1, sps) complex64
    win_energy: jnp.ndarray    # (num_avg-1, sps) float32
    # Symbols absorbed so far, saturating at num_avg (warm-up gate,
    # cpp/psk_soft.cpp:457: output only once samples.size()==numDataPts).
    seen: jnp.ndarray          # () int32
    # Phase tracker (LinearFit equivalent): ring of unwrapped phases.
    ring: jnp.ndarray          # (phase_avg,) float32
    ring_pos: jnp.ndarray      # () int32, next write slot
    ring_fill: jnp.ndarray     # () int32, saturating at phase_avg
    phase_est: jnp.ndarray     # () float32, last fit output
    # Previous selected (pre-correction) symbol sample; feeds differential
    # decoding (cpp/psk_soft.cpp:486-495).  The reference default-initializes
    # `last` to 0 making its very first differential output NaN (its tests
    # skip symbol 0); we initialize to 1+0j for defined behavior.
    last_any: jnp.ndarray      # () complex64
    # Matched-filter input tail (ntaps-1 samples; empty when disabled).
    mf_tail: jnp.ndarray       # (mf_ntaps-1 or 0,) complex64


def init_state(cfg: DemodConfig, channel_shape: tuple = ()) -> DemodState:
    """Fresh converged-from-scratch state (optionally batched over channels)."""
    a1 = max(cfg.num_avg - 1, 0)
    return DemodState(
        win_samples=jnp.zeros(channel_shape + (a1, cfg.sps), jnp.complex64),
        win_energy=jnp.zeros(channel_shape + (a1, cfg.sps), jnp.float32),
        seen=jnp.zeros(channel_shape, jnp.int32),
        ring=jnp.zeros(channel_shape + (cfg.phase_avg,), jnp.float32),
        ring_pos=jnp.zeros(channel_shape, jnp.int32),
        ring_fill=jnp.zeros(channel_shape, jnp.int32),
        phase_est=jnp.zeros(channel_shape, jnp.float32),
        last_any=jnp.ones(channel_shape, jnp.complex64),
        mf_tail=jnp.zeros(channel_shape + (max(cfg.mf_ntaps - 1, 0),), jnp.complex64),
    )


def resync_window(old_cfg: DemodConfig, new_cfg: DemodConfig,
                  win_samples: np.ndarray, seen: np.ndarray):
    """resyncEnergy semantics (cpp/psk_soft.cpp:619-636): keep the most
    recent whole new-sps symbols that fit the new window, re-bin energies,
    restart the warm-up count from what was kept.

    Returns (win_samples', win_energy', seen') as numpy arrays shaped for
    ``new_cfg`` (right-aligned rows), or None when the window is unchanged.
    """
    if (old_cfg.sps, old_cfg.num_avg) == (new_cfg.sps, new_cfg.num_avg):
        return None
    channel_shape = np.shape(seen)
    old_rows = min(int(np.min(seen)) if np.size(seen) else 0,
                   old_cfg.num_avg - 1)
    flat = np.asarray(win_samples).reshape(channel_shape + (-1,))
    flat = flat[..., (old_cfg.num_avg - 1 - old_rows) * old_cfg.sps:]
    keep_syms = min(flat.shape[-1] // new_cfg.sps, new_cfg.num_avg - 1)
    a1 = max(new_cfg.num_avg - 1, 0)
    ws = np.zeros(channel_shape + (a1, new_cfg.sps), np.complex64)
    we = np.zeros(channel_shape + (a1, new_cfg.sps), np.float32)
    if keep_syms > 0:
        tail = flat[..., flat.shape[-1] - keep_syms * new_cfg.sps:]
        rows = tail.reshape(channel_shape + (keep_syms, new_cfg.sps))
        ws[..., a1 - keep_syms:, :] = rows
        we[..., a1 - keep_syms:, :] = (rows.real ** 2
                                       + rows.imag ** 2).astype(np.float32)
    return ws, we, np.full(channel_shape, keep_syms, np.int32)


def reconfigure(old_cfg: DemodConfig, new_cfg: DemodConfig,
                state: DemodState) -> DemodState:
    """Pure re-derivation of carry state after a property change (C7).

    Mirrors the reference's dirty-flag consumers (cpp/psk_soft.cpp:408-426,
    619-651):

    * sps / num_avg change -> ``resyncEnergy``: keep up to the new window's
      worth of the most recent samples, re-bin with the new sps, restart the
      warm-up count from what was kept (cpp/psk_soft.cpp:619-636).  (The
      reference re-bins only on an sps change and can stall when numAvg
      shrinks -- numAvg has no change listener and the window size test at
      cpp/psk_soft.cpp:380 only catches growth; we resync on any change.)
    * constellation change -> clear phase history
      (``phaseEstimator.reset(NULL,NULL,true)``, cpp/psk_soft.cpp:416-420).
    * phase_avg change -> resize the fit window keeping the newest points
      (``phaseEstimator.reset(&numPts)``, cpp/psk_soft.cpp:421-426,
      LinearFit::reset cpp/psk_soft.cpp:104-109 pops oldest).

    Host-side (shapes change); not jittable.
    """
    state = jax.tree_util.tree_map(np.asarray, state)
    channel_shape = np.shape(state.seen)
    new = init_state(new_cfg, channel_shape)
    new = new._replace(last_any=jnp.asarray(state.last_any))
    mf_keys = ("matched_filter", "sps", "rrc_beta", "rrc_span")
    if all(getattr(old_cfg, k) == getattr(new_cfg, k) for k in mf_keys):
        new = new._replace(mf_tail=jnp.asarray(state.mf_tail))

    # --- timing window ---
    resync = resync_window(old_cfg, new_cfg, state.win_samples, state.seen)
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

    # --- phase tracker ---
    if old_cfg.constellation_size != new_cfg.constellation_size:
        return new  # history force-cleared; phase_est back to 0
    ring = np.asarray(state.ring)
    pos = np.asarray(state.ring_pos)
    fill = np.asarray(state.ring_fill)
    n_old, n_new = old_cfg.phase_avg, new_cfg.phase_avg
    # Reorder each channel's ring chronologically, keep newest min(fill, n_new).
    idx = (np.arange(n_old) + np.where(fill == n_old, pos, 0)[..., None]) % n_old
    chrono = np.take_along_axis(ring, idx, axis=-1)  # oldest..newest
    keep = np.minimum(fill, n_new)
    # Newest keep chronological values, written from slot 0:
    # new[..., j] = chrono[..., fill-keep+j] for j < keep -- one vectorized
    # gather, no per-channel host loop (milliseconds at 4096 channels).
    j = np.arange(n_new)
    src_idx = np.clip(np.asarray(fill)[..., None]
                      - np.asarray(keep)[..., None] + j, 0, n_old - 1)
    gathered = np.take_along_axis(chrono, src_idx, axis=-1)
    new_ring = np.where(j < np.asarray(keep)[..., None], gathered,
                        0.0).astype(np.float32)
    new_fill = keep.astype(np.int32)
    new_pos = (new_fill % n_new).astype(np.int32)
    phase_est = np.asarray(state.phase_est, np.float32)
    if n_old != n_new:
        # The reference recomputes the fit after a window resize
        # (LinearFit::reset ends in calculateFit(), cpp/psk_soft.cpp:122).
        i = np.arange(n_new, dtype=np.float64)
        p = new_fill.astype(np.float64)
        ysum = np.sum(new_ring, axis=-1)
        xysum = np.sum(i * new_ring, axis=-1)
        d = p * (p * p - 1.0) / 12.0
        m = np.where(d != 0, (xysum - (p - 1) / 2 * ysum) / np.where(d == 0, 1, d), 0.0)
        fit = np.where(p > 1,
                       ysum / np.where(p == 0, 1, p) + m * (p - 1) / 2,
                       np.where(p == 1, new_ring[..., 0], 0.0))
        phase_est = fit.astype(np.float32)
    return new._replace(
        ring=jnp.asarray(new_ring),
        ring_pos=jnp.asarray(new_pos),
        ring_fill=jnp.asarray(new_fill),
        phase_est=jnp.asarray(phase_est),
    )
