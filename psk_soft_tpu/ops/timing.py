"""Symbol-timing recovery: windowed max-energy decision-sample selection.

Array-native recast of the reference's sliding deque + incremental energy bins
(C2: ``cpp/psk_soft.cpp:442-467, 568-584, 619-636``).  The reference keeps the
last ``numAvg*sps`` samples, accumulates per-sample energy into
``symbolEnergy[sps]`` bins keyed by intra-symbol index, picks
``argmax(symbolEnergy)`` at each symbol boundary, then subtracts the oldest
symbol's energies (sliding window) with a periodic full resync every 2^20
symbols against FP drift.

Key observation for a parallel device: the sliding accumulation is a *windowed
segmented sum* with no sequential dependence at all.  For symbol-aligned data
``E[k, j] = |x[k*sps + j]|^2``, the bin state the reference holds when input
symbol ``k + numAvg - 1`` completes is exactly

    W[k, j] = sum_{t=k}^{k+numAvg-1} E[t, j]

and the emitted symbol is the *oldest* in the window (``samples.begin() +
sampleIndex``, cpp/psk_soft.cpp:462-465), i.e. output symbol k uses the
forward-looking window [k, k+numAvg-1].  We compute W for a whole block with
one windowed reduction (exact tree sums, no drift -> the 2^20 resync is
unnecessary by construction) and take a row-wise first-max argmax
(``std::max_element`` also returns the first maximum).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def symbol_energy_rows(xs: jnp.ndarray) -> jnp.ndarray:
    """Per-sample energy |x|^2 for symbol-aligned data.

    Args:
      xs: (..., S, sps) complex64.
    Returns:
      (..., S, sps) float32 (the reference accumulates in double,
      cpp/psk_soft.h:67-68; exact windowed reductions make float32 adequate
      within the 1e-3 tolerance of tests/test_psk_soft.py:204,238).
    """
    return (xs.real * xs.real + xs.imag * xs.imag).astype(jnp.float32)


def windowed_bin_sums(e_rows: jnp.ndarray, num_avg: int,
                      axis: int = -2) -> jnp.ndarray:
    """Rolling sum of energy rows over a forward window of num_avg symbols.

    Implemented as cumsum-diff: O(1) per output instead of the O(num_avg)
    a direct windowed reduction costs -- this is the sample-rate hot loop
    (the reference's incremental add/subtract with drift resyncs,
    cpp/psk_soft.cpp:445-452,568-584, has the same O(1) recurrence; exact
    prefix sums need no resync and stay well inside the 1e-3 tolerance:
    relative error ~R*eps over a block).

    Args:
      e_rows: energies for R = S + num_avg - 1 consecutive symbols (carry
        rows prepended to the block's rows) along ``axis``: (..., R, sps)
        channel-major, or (R, sps, C) time-major with ``axis=0``.
      num_avg: window length in symbols.
    Returns:
      The same layout with S rows: W[o] = sum(e_rows[o:o+num_avg]).
    """
    if num_avg == 1:
        return e_rows
    r = e_rows.shape[axis]
    s = r - (num_avg - 1)
    cs = jnp.cumsum(e_rows, axis=axis)
    upper = jax.lax.slice_in_dim(cs, num_avg - 1, r, axis=axis)
    lower = jax.lax.slice_in_dim(cs, 0, s - 1, axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(upper, 0, 1, axis=axis))
    return upper - jnp.concatenate([zero, lower], axis=axis)


def windowed_bin_sums_direct(e_rows: jnp.ndarray, num_avg: int) -> jnp.ndarray:
    """Reference windowed reduction (tree sums); used to cross-check the
    cumsum-diff fast path in tests."""
    if num_avg == 1:
        return e_rows
    return jax.lax.reduce_window(
        e_rows,
        jnp.float32(0),
        jax.lax.add,
        window_dimensions=(1,) * (e_rows.ndim - 2) + (num_avg, 1),
        window_strides=(1,) * e_rows.ndim,
        padding="valid",
    )


def select_decision_samples_interp(s_flat: jnp.ndarray, w: jnp.ndarray,
                                   sps: int, axis: int = -1):
    """Fractional-timing refined decision (feed-forward early-late).

    Circular first-harmonic (centroid) timing estimate: the intra-symbol
    energy profile W[j] is periodic in j, so its fundamental's phase gives
    the peak position using *all* bins -- far lower variance than a 3-point
    parabola around the argmax, and continuous across the bin wrap, so the
    symbol framing never slips when the peak straddles bins 0/sps-1 (the
    plain argmax pick, like the reference cpp/psk_soft.cpp:462-465, slips
    there).  This is the Oerder&Meyr square-law estimator applied to the
    already-binned energies -- the feed-forward equivalent of an early-late
    gate driving an NCO.  The decision sample is linearly interpolated
    between the two nearest samples in *time* (crossing symbol-row
    boundaries via the flat signal).

    Args:
      s_flat: flattened time-contiguous samples; window row o starts at
        flat index o*sps.  (..., R*sps) channel-major, or (R*sps, C)
        time-major with ``axis=1``.
      w: windowed bin sums, (..., S, sps), or (S, sps, C) time-major.
      axis: the bin axis of ``w`` (-1 channel-major, 1 time-major); the
        symbol axis precedes it and is also the time axis of ``s_flat``.
    Returns (sample_index int32, decision complex64), shaped like ``w``
    without its bin axis.
    """
    axis = axis % w.ndim
    t_axis = axis - 1
    bshape = [1] * w.ndim
    bshape[axis] = sps
    ang = (2.0 * jnp.pi * jnp.arange(sps, dtype=jnp.float32) / sps
           ).reshape(bshape)
    zr = jnp.sum(w * jnp.cos(ang), axis=axis)
    zi = jnp.sum(w * jnp.sin(ang), axis=axis)
    p = jnp.arctan2(zi, zr) * (sps / (2.0 * jnp.pi))      # (-sps/2, sps/2]
    p = jnp.where(p < -0.5, p + sps, p)                   # [-0.5, sps-0.5)
    p = jnp.where(p > sps - 0.5, p - sps, p)
    b = jnp.round(p).astype(jnp.int32) % sps              # index actually used
    i0 = jnp.floor(p)
    frac = (p - i0).astype(jnp.float32)
    s = w.shape[t_axis]
    rshape = [1] * p.ndim
    rshape[t_axis] = s
    row = jnp.arange(s, dtype=jnp.int32).reshape(rshape)
    raw_base = row * sps + i0.astype(jnp.int32)
    # Row 0 with a negative fractional offset would reach one sample before
    # the flat buffer; fall back to the on-sample decision there rather than
    # interpolating with an unrelated sample.
    oob = raw_base < 0
    frac = jnp.where(oob, 0.0, frac)
    base = jnp.clip(raw_base, 0, s_flat.shape[t_axis] - 2)
    s0 = jnp.take_along_axis(s_flat, base, axis=t_axis)
    s1 = jnp.take_along_axis(s_flat, base + 1, axis=t_axis)
    sel = (s0 * (1.0 - frac) + s1 * frac).astype(jnp.complex64)
    return b, sel


def select_decision_samples(s_rows: jnp.ndarray, w: jnp.ndarray,
                            axis: int = -1):
    """Pick the max-energy intra-symbol index and gather the decision sample.

    Args:
      s_rows: complex symbol rows (block rows, carry-aligned so row o is
        output symbol o): (..., S, sps), or (S, sps, C) time-major.
      w: windowed bin sums aligned with s_rows.
      axis: the bin axis (-1 channel-major, 1 time-major).
    Returns:
      (sample_index int32, decision complex64) without the bin axis.
    """
    idx = jnp.argmax(w, axis=axis).astype(jnp.int32)
    sel = jnp.take_along_axis(s_rows, jnp.expand_dims(idx, axis), axis=axis)
    return idx, jnp.squeeze(sel, axis)
