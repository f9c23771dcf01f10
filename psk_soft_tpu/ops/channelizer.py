"""Polyphase DFT analysis channelizer (wideband frontend).

Extension beyond the reference: every deployment of the reference runs it
downstream of a channelizer -- the component demodulates ONE narrowband
stream (cpp/psk_soft.cpp serviceFunction), and a wideband capture is split
into C such streams by an upstream filterbank before C component instances
consume them.  This framework already demodulates the whole bank in one
steady step; this module supplies the missing upstream step natively, so a
single wideband stream goes capture -> channels -> bits without leaving the
device.

Design: a critically-sampled weighted-overlap-add (WOLA) DFT bank over
static shapes.  The block of B*C wideband samples is reshaped to (B, C)
branch rows (zero-copy layout change, no gathers), the K-tap polyphase
branches reduce over K stacked row shifts (an unrolled fused multiply-add
chain -- K is small and static), and the branch axis is closed with one
batched C-point FFT.  The carry between
blocks is the last K-1 branch rows, so streaming is block-split invariant
by construction.  Everything is jit-compatible.

Conventions (pinned by tests/test_channelizer.py against a direct
per-channel DDC oracle):

* channel ``m`` is the band centered at ``+m/C`` of the wideband sample
  rate (m > C/2 aliases to negative frequencies, FFT order);
* output rate is ``fs / C`` (critically sampled);
* alignment is block-anticausal: output row t of the block reads wideband
  samples ``tC .. tC + K*C - 1`` of (carry ++ block), i.e. the bank's
  group delay is absorbed into the carry rather than trimmed from the
  output -- the same contract as the demod kernel's window carry.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def prototype_taps(channels: int, taps_per_branch: int = 8,
                   beta: float = 9.0, cutoff_scale: float = 1.0,
                   dtype=np.float32) -> np.ndarray:
    """Kaiser-windowed-sinc prototype lowpass, length K*C.

    Cutoff is ``cutoff_scale / (2C)`` of the wideband rate (the critical
    per-channel Nyquist edge; < 1 trades edge droop for alias rejection;
    > 1 only makes sense for the oversampled-by-2 bank, whose output rate
    represents up to 2x the critical edge).  Normalized to unit passband
    gain through the bank (a tone at a channel center comes out at
    amplitude 1).
    """
    if channels < 2:
        raise ValueError(f"channels must be >= 2, got {channels}")
    if taps_per_branch < 2:
        raise ValueError(f"taps_per_branch must be >= 2, "
                         f"got {taps_per_branch}")
    if not 0 < cutoff_scale <= 2:
        raise ValueError(f"cutoff_scale must be in (0, 2], "
                         f"got {cutoff_scale}")
    L = channels * taps_per_branch
    n = np.arange(L, dtype=np.float64) - (L - 1) / 2
    h = (cutoff_scale / channels) * np.sinc(cutoff_scale * n / channels)
    x = np.clip(n / ((L - 1) / 2), -1.0, 1.0)
    h *= np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    return (h / h.sum()).astype(dtype)


def channelizer_init(channels: int, taps_per_branch: int) -> jnp.ndarray:
    """Fresh carry: K-1 zero branch rows of (C,) complex64."""
    return jnp.zeros((taps_per_branch - 1, channels), jnp.complex64)


@jax.jit
def channelize_block(taps: jnp.ndarray, carry: jnp.ndarray,
                     x: jnp.ndarray):
    """One streaming analysis step.

    Args:
      taps: (K*C,) float32 prototype (``prototype_taps``).
      carry: (K-1, C) complex64 branch-row history (``channelizer_init``).
      x: (B*C,) complex64 wideband block, B >= 1.

    Returns:
      (new_carry, y) with y (B, C) complex64: y[t, m] is channel m's
      baseband sample t at rate fs/C.  Oracle identity (tests):
      ``y[t, m] == sum_l h[l] * xx[t*C + l] * exp(-2j*pi*m*l/C)`` where
      xx = concat(carry_samples, x).
    """
    C = carry.shape[1]
    K = carry.shape[0] + 1
    if x.ndim != 1 or x.shape[0] % C:
        raise ValueError(f"block length must be a multiple of C={C}, "
                         f"got shape {x.shape}")
    B = x.shape[0] // C
    z = jnp.concatenate([carry, x.reshape(B, C)], axis=0)  # (B+K-1, C)
    hpoly = taps.reshape(K, C)
    # K static row shifts, reduced as one fused multiply-add chain.  The
    # DFT over the branch axis then closes the channel sum: one batched
    # C-point FFT (e^{-2j pi m p / C} matches the l = kC + p split of the
    # oracle identity above).
    v = hpoly[0, :] * z[0:B]
    for k in range(1, K):
        v = v + hpoly[k, :] * z[k:k + B]
    y = jnp.fft.fft(v, axis=-1).astype(jnp.complex64)
    return z[B:], y


def channelizer_os2_init(channels: int, taps_per_branch: int) -> jnp.ndarray:
    """Fresh carry for the 2x-oversampled bank: 2K-1 zero half-rows of
    (C/2,) complex64."""
    if channels % 2:
        raise ValueError("oversampled-by-2 bank needs even channels")
    return jnp.zeros((2 * taps_per_branch - 1, channels // 2), jnp.complex64)


@jax.jit
def channelize_block_os2(taps: jnp.ndarray, carry: jnp.ndarray,
                         x: jnp.ndarray):
    """2x-oversampled analysis step: hop C/2 instead of C.

    The critically-sampled bank's output Nyquist sits exactly at the
    channel edge, so any occupancy near +-fs/(2C) aliases.  Halving the
    hop doubles each channel's output rate to 2fs/C: the full band
    survives, at the cost of the decimation no longer cancelling the
    t-dependent twiddle -- odd output rows pick up e^{-j pi m} = (-1)^m
    (applied as one sign plane; everything else is the same reshape +
    K-shift FMA + batched FFT).

    Args/returns as :func:`channelize_block`, except carry is (2K-1, C/2)
    (``channelizer_os2_init``) and y has 2B rows per B*C-sample block.
    Oracle identity (tests): ``y[t, m] == sum_l h[l] * xx[t*C/2 + l] *
    exp(-2j*pi*m*(t*C/2 + l)/C)`` with xx = concat(carry_samples, x) --
    i.e. a plain DDC decimated by C/2.
    """
    R = carry.shape[1]                        # C/2
    C = 2 * R
    K = (carry.shape[0] + 1) // 2
    if x.ndim != 1 or x.shape[0] % C:
        raise ValueError(f"block length must be a multiple of C={C}, "
                         f"got shape {x.shape}")
    B = 2 * (x.shape[0] // C)                 # output rows (even per block)
    u = jnp.concatenate([carry, x.reshape(B, R)], axis=0)  # (B+2K-1, R)
    hpoly = taps.reshape(K, C)
    # branch p < R reads u[t + 2k, p]; branch p >= R reads u[t + 2k + 1,
    # p - R]: two half-width shift chains, concatenated on the branch axis.
    lo = hpoly[0, :R] * u[0:B]
    hi = hpoly[0, R:] * u[1:B + 1]
    for k in range(1, K):
        lo = lo + hpoly[k, :R] * u[2 * k:2 * k + B]
        hi = hi + hpoly[k, R:] * u[2 * k + 1:2 * k + 1 + B]
    v = jnp.concatenate([lo, hi], axis=1)     # (B, C)
    y = jnp.fft.fft(v, axis=-1).astype(jnp.complex64)
    # odd rows: e^{-j pi m t} twiddle (the hop no longer spans a full DFT
    # period).  B is even, so block parity never leaks into the carry.
    alt = jnp.where((jnp.arange(C) % 2) == 1, -1.0, 1.0).astype(jnp.float32)
    sign = jnp.where((jnp.arange(B)[:, None] % 2) == 1, alt[None, :], 1.0)
    y = y * sign
    return u[B:], y


def channel_frequencies(channels: int, xdelta: float) -> np.ndarray:
    """Center frequency of each output channel in Hz for an input SRI
    sample spacing ``xdelta`` (FFT bin order: m > C/2 are negative)."""
    fs = 1.0 / xdelta
    f = np.arange(channels, dtype=np.float64) * fs / channels
    f[channels // 2 + 1:] -= fs
    return f
