"""Sliding-window least-squares line fit evaluated at the newest point.

Array-native re-derivation of the reference's ``LinearFit`` class
(``cpp/psk_soft.cpp:35-185``, decl ``cpp/psk_soft.h:33-53``): a window of the
last ``n`` uniformly spaced points is fit with a line and the fit is evaluated
at the newest point, making it a trend-following smoother whose slope absorbs
carrier-frequency offset.

Design notes (array-first, not a translation):

* The reference maintains incremental ``ySum``/``xySum`` accumulators with a
  periodic full recompute every 2^20 points to bound FP drift
  (``cpp/psk_soft.cpp:50-52``).  We instead compute the windowed sums directly
  each step (the reference's own resync target), so there is no drift and no
  resync counter.  Divergence from the reference is bounded by the
  reference's own drift bound.
* The fit value is independent of the x-axis spacing ``xdelta``
  (``cpp/psk_soft.cpp:148-162``): we work in units of ``xdelta = 1``.
* In steady state the fit-at-newest-point is a *linear* function of the
  window, i.e. an FIR filter.  :func:`endpoint_fir_weights` returns those
  weights so the block-parallel pipeline can evaluate the tracker as a
  convolution instead of a sequential recursion.

Closed forms (``cpp/psk_soft.cpp:135-185``), with x_i = i for i in [0, p):

  m    = (xySum - (p-1)/2 * ySum) / D(p)
  b    = ySum/p - m * (p-1)/2
  fit  = m*(p-1) + b = ySum/p + m*(p-1)/2
  D(p) = p*(p^2-1)/12          (equals the reference's expanded polynomial
                                cpp/psk_soft.cpp:183 for uniform x)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def denominator(pts: jnp.ndarray) -> jnp.ndarray:
    """D(p) = p(p^2-1)/12 in units of xdelta=1 (cpp/psk_soft.cpp:176-185)."""
    p = pts.astype(jnp.float32)
    return p * (p * p - 1.0) / 12.0


def fit_at_newest(ysum: jnp.ndarray, xysum: jnp.ndarray, pts: jnp.ndarray,
                  newest: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the window fit at the newest point (cpp/psk_soft.cpp:135-174).

    Args:
      ysum: sum of the window's y values.
      xysum: sum of i * y_i with i the 0-based position inside the window.
      pts: window length p (traced, >= 0).
      newest: the newest y value, returned when p <= 1 (the reference returns
        ``b = yvals.back()`` for a single point, 0 for empty;
        cpp/psk_soft.cpp:163-172).

    All arguments broadcast elementwise.
    """
    p = pts.astype(jnp.float32)
    d = denominator(pts)
    safe_d = jnp.where(d == 0, 1.0, d)
    m = (xysum - (p - 1.0) / 2.0 * ysum) / safe_d
    safe_p = jnp.where(p == 0, 1.0, p)
    fit = ysum / safe_p + m * (p - 1.0) / 2.0
    fit = jnp.where(pts > 1, fit, newest)
    return jnp.where(pts == 0, 0.0, fit)


def endpoint_fir_weights(n: int, dtype=np.float32) -> np.ndarray:
    """Steady-state FIR weights w with fit = sum_i w[i] * y[window_i].

    w[i] = 1/n + 6*(2i - (n-1)) / (n*(n+1)), i = 0 (oldest) .. n-1 (newest).

    Derivation: fit = ybar + m*(n-1)/2, m = sum_i (i - (n-1)/2) y_i / D(n),
    D(n) = n(n^2-1)/12.
    """
    if n == 1:
        return np.ones((1,), dtype=dtype)
    i = np.arange(n, dtype=np.float64)
    w = 1.0 / n + (i - (n - 1) / 2.0) * ((n - 1) / 2.0) / (n * (n * n - 1) / 12.0)
    return w.astype(dtype)


def warmup_fir_weight_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """(n, n) matrix whose row p-1 holds the length-p fit weights, right-aligned.

    Row p-1, columns n-p .. n-1 contain the endpoint weights for a window of
    length p (columns before that are zero).  Used by the block-parallel path
    to evaluate the tracker during warm-up with one gather + dot.
    """
    out = np.zeros((n, n), dtype=np.float64)
    for p in range(1, n + 1):
        out[p - 1, n - p:] = endpoint_fir_weights(p, dtype=np.float64)
    return out.astype(dtype)


def ring_rank(n: int, pos: jnp.ndarray, fill: jnp.ndarray) -> jnp.ndarray:
    """Chronological rank of each ring-buffer slot.

    The exact-semantics scan stores the phase history in a rolling ring
    buffer: slots are written at ``pos`` (then pos advances mod n) and
    ``fill`` saturates at n.  Rank r means r-th oldest (0 = oldest).  While
    filling, slots 0..fill-1 were written in order; once full, the oldest
    slot is ``pos`` (the next one to be overwritten).
    """
    idx = jnp.arange(n, dtype=jnp.int32)
    start = jnp.where(fill == n, pos, 0)
    return (idx - start) % n


def ring_fit(ring: jnp.ndarray, pos: jnp.ndarray, fill: jnp.ndarray,
             newest: jnp.ndarray) -> jnp.ndarray:
    """Fit-at-newest from a ring buffer (direct windowed sums, no drift).

    Args:
      ring: (..., n) history values (unordered ring slots).
      pos: (...,) next write slot (i.e. the slot holding the *oldest* value
        when full).
      fill: (...,) number of valid slots, saturating at n.
      newest: (...,) most recently written value (used for fill <= 1).
    """
    n = ring.shape[-1]
    rank = ring_rank(n, pos[..., None], fill[..., None])
    maskv = (rank < fill[..., None]).astype(ring.dtype)
    ysum = jnp.sum(ring * maskv, axis=-1)
    xysum = jnp.sum(rank.astype(ring.dtype) * ring * maskv, axis=-1)
    return fit_at_newest(ysum, xysum, fill, newest)
