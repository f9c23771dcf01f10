"""Carrier-phase recovery primitives: M-th-power phase and unwrapping.

Array-native recast of C3 in the reference (``cpp/psk_soft.cpp:471-500,
592-603``): per selected symbol, ``thisPhase = arg(sample^M)`` removes the
PSK modulation; the phase is unwrapped against the running estimate
(``numWraps = round((phaseEstimate - thisPhase)/2pi)``), fed to the sliding
linear fit, and the correction applied is ``-phaseEstimate/M`` (+pi/4
constellation rotation for QPSK only).  At packet end the whole estimator
history is re-wrapped about ``M*2pi`` (NOT 2pi -- the estimate is of the
M-th-power phase) to keep it bounded (``cpp/psk_soft.cpp:592-603``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def mth_power_phase(sample: jnp.ndarray, m: int) -> jnp.ndarray:
    """arg(sample**m) for power-of-two m (2..32) via repeated squaring.

    Matches ``arg(pow(sample, numSyms))`` at cpp/psk_soft.cpp:474 but avoids
    the transcendental complex pow: log2(m) squarings, then one atan2.
    """
    if m < 2 or (m & (m - 1)) != 0:
        raise ValueError(f"unsupported constellation size {m}")
    s = sample
    k = m
    while k > 1:
        s = s * s
        k >>= 1
    return jnp.arctan2(s.imag, s.real).astype(jnp.float32)


def mth_power_phase_dynamic(sample: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """M-th-power phase with traced per-element m in {2, 4, 8, 16, 32}."""
    s2 = sample * sample
    s4 = s2 * s2
    s8 = s4 * s4
    s16 = s8 * s8
    s32 = s16 * s16
    s = jnp.where(m == 2, s2,
                  jnp.where(m == 4, s4,
                            jnp.where(m == 8, s8,
                                      jnp.where(m == 16, s16, s32))))
    return jnp.arctan2(s.imag, s.real).astype(jnp.float32)


def unwrap_step(prev_estimate: jnp.ndarray, raw: jnp.ndarray) -> jnp.ndarray:
    """One reference unwrap: shift raw by whole turns toward the estimate.

    cpp/psk_soft.cpp:477-478.
    """
    wraps = jnp.round((prev_estimate - raw) / TWO_PI)
    return raw + wraps * TWO_PI


def block_unwrap(raw: jnp.ndarray, prev: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Feed-forward unwrap of a block of raw phases against a carried value.

    Classic prefix unwrap: each element is shifted by a whole number of turns
    so that successive differences lie in (-pi, pi]; the first element is
    unwrapped against ``prev`` (the last unwrapped phase before the block).
    Cumulative wrap counts are a prefix sum, i.e. fully parallel -- this is
    the feed-forward equivalent of the reference's sequential
    unwrap-against-the-estimate.  The two differ only when the linear-fit
    estimate and the previous sample disagree by more than ~pi, i.e. under
    phase dynamics faster than pi/symbol where any M-th-power tracker has
    already lost lock; the equivalence is gated by tests on the golden
    vectors (SURVEY.md section 7 stage 4).

    Args:
      raw: raw principal-value phases.
      prev: carried last unwrapped phase; broadcastable to raw with the
        scanned axis removed.
    """
    first = jnp.expand_dims(prev, axis)
    d = jnp.diff(jnp.concatenate([first, raw], axis=axis), axis=axis)
    adj = jnp.cumsum(jnp.round(d / TWO_PI), axis=axis)
    return raw - adj * TWO_PI


def wrap_to_pi(x: jnp.ndarray) -> jnp.ndarray:
    """Map angles to (-pi, pi]."""
    return x - TWO_PI * jnp.round(x / TWO_PI)


# Trend window for the robust unwrap.  sigma of the squared/4th/8th-power
# phase noise shrinks ~1/sqrt(K); K=9 keeps the false-wrap probability
# negligible down to the tracker's own lock threshold while adding only a
# half-window of trend lag (irrelevant: the unwrap tolerates +-pi of lag).
UNWRAP_TREND_LEN = 9


# Trend decimation: one trend reference per D symbols.  The unwrap stays
# correct as long as the phase moves < pi across a group of D symbols --
# still far beyond any M-th-power tracker's lock range -- while the prefix
# sum, the trend window sums, and two of the three atan2 passes shrink by D.
UNWRAP_TREND_STRIDE = 4


def causal_complex_ma(phases: jnp.ndarray, k: int, stride: int = 1,
                      pad_left: int | None = None,
                      axis: int = -1) -> jnp.ndarray:
    """Causal moving average of exp(i*phase) over the last k entries,
    optionally strided (one output per ``stride`` inputs, anchored at each
    group's last element), along ``axis``.

    The length along ``axis`` must be divisible by stride.  Head entries
    average over what is available.  Returns the trend *angle*, with
    ``length // stride`` entries along ``axis``.  The window sums are
    shifted-slice adds in exact float32 (no convolution, so no TF32).
    """
    axis = axis % phases.ndim
    t = phases.shape[axis]
    lpad = k - stride if pad_left is None else pad_left
    g = (t + lpad - k) // stride + 1

    def window_sum(v):
        if lpad:
            zshape = list(v.shape)
            zshape[axis] = lpad
            v = jnp.concatenate([jnp.zeros(zshape, v.dtype), v], axis=axis)
        acc = None
        for i in range(k):
            term = jax.lax.slice_in_dim(v, i, i + (g - 1) * stride + 1,
                                        stride=stride, axis=axis)
            acc = term if acc is None else acc + term
        return acc

    return jnp.arctan2(window_sum(jnp.sin(phases)),
                       window_sum(jnp.cos(phases)))


def robust_block_unwrap(raw: jnp.ndarray, axis: int = -1,
                        k: int = UNWRAP_TREND_LEN,
                        stride: int = UNWRAP_TREND_STRIDE) -> jnp.ndarray:
    """Feed-forward unwrap robust to per-symbol phase noise.

    A strict previous-sample prefix unwrap takes a false +-2pi wrap whenever
    two *consecutive* raw phases differ by more than pi -- common for M-th
    power phases at low Es/N0 (sigma ~ M * noise).  The reference avoids this
    by unwrapping each raw phase against its *smoothed estimate*
    (cpp/psk_soft.cpp:477-481).  The feed-forward equivalent: average
    exp(i*raw) over a short causal window, unwrap the low-noise trend angles
    (prefix sum), and re-attach each raw phase as a (-pi, pi] residual about
    its trend:

        u[t] = unwrap(trend)[g(t)] + wrap_to_pi(raw[t] - trend[g(t)])

    where g(t) is t's trend group (one trend value per ``stride`` symbols).
    u[t] === raw[t] (mod 2pi) exactly, like any unwrap.  Works along
    ``axis`` in place (time-major callers pass axis=0; no transpose).
    """
    axis = axis % raw.ndim
    t = raw.shape[axis]
    pad = (-t) % stride
    rawp = raw
    if pad:
        first = jax.lax.slice_in_dim(raw, 0, 1, axis=axis)
        rawp = jnp.concatenate([jnp.repeat(first, pad, axis=axis), raw],
                               axis=axis)
    ang_dec = causal_complex_ma(rawp, k, stride=stride, axis=axis)
    unwrapped_dec = block_unwrap(ang_dec, jnp.take(ang_dec, 0, axis=axis),
                                 axis=axis)
    u = (jnp.repeat(unwrapped_dec, stride, axis=axis)
         + wrap_to_pi(rawp - jnp.repeat(ang_dec, stride, axis=axis)))
    return jax.lax.slice_in_dim(u, pad, pad + t, axis=axis)


def rewrap_offset(estimate: jnp.ndarray, m: int) -> jnp.ndarray:
    """End-of-block re-wrap offset about M*2pi (cpp/psk_soft.cpp:592-603).

    Returns the constant to subtract from the estimator history (0 if the
    estimate is already within +-M*2pi).  Subtracting a constant from the
    window shifts the fit by that constant (the reference implements this as
    ``LinearFit::subtractConst``, cpp/psk_soft.cpp:126-133), and the applied
    correction ``-estimate/M`` changes by a multiple of 2pi, so soft symbols
    are unaffected.
    """
    wrap_value = TWO_PI * m
    wraps = jnp.round(estimate / wrap_value)
    return jnp.where(jnp.abs(estimate) > wrap_value, wraps * wrap_value, 0.0)
