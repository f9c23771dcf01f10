"""Per-channel arbitrary-ratio polyphase resampler (bank frontend).

Extension beyond the reference: the reference component processes ONE
stream at its configured samplesPerBaud (cpp/psk_soft.cpp serviceFunction);
a bank of channels with heterogeneous native rates would need one component
per rate.  GroupEngine already buckets exact-config duplicates; this
resampler removes the restriction entirely by converting every channel to
the bank's common sps on device, so ONE steady program serves channels whose
native rates differ per channel (and even fractionally, e.g. sps 7.3).

Design: a quantized-phase polyphase interpolation bank over time-major
(T, C) planes.  Output sample n of channel c reads K input rows at
``floor(pos)`` with ``pos = pos0[c] + n * ratio[c]``; the K tap values come
from a (P, K) windowed-sinc table indexed by the fractional part (with
linear interpolation between adjacent phase rows).  Everything is
static-shape: the per-(n, c) row indices are data, not shapes, so the whole
block lowers to K (or 2K) `take_along_axis` gathers + fused multiply-adds
-- bandwidth-bound elementwise work, the right cost model for a frontend
that feeds the demod.  Ragged per-channel consumption
bookkeeping stays on the HOST (runtime/resampler.py), exactly like the
deframer: the device sees fixed shapes every block.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def kaiser_sinc_table(n_phases: int = 128, taps_per_phase: int = 8,
                      cutoff: float = 1.0, beta: float = 8.0,
                      dtype=np.float32) -> np.ndarray:
    """(P, K) polyphase interpolation table.

    Row p reconstructs x(i0 + K//2 - 1 + p/P) from input rows
    i0 .. i0+K-1: ``table[p, k] = c*sinc(c*(K//2 - 1 + p/P - k)) * w_k``
    with a Kaiser window centered on the interpolation point.  cutoff < 1
    (relative to input Nyquist) widens the anti-alias margin for
    downsampling ratios > 1.
    """
    if not 0 < cutoff <= 1:
        raise ValueError(f"cutoff must be in (0, 1], got {cutoff}")
    P, K = n_phases, taps_per_phase
    k = np.arange(K, dtype=np.float64)
    # include phase row P (== next integer sample, phase 0) so linear
    # interpolation between rows p and p+1 never wraps
    u = np.arange(P + 1, dtype=np.float64)[:, None] / P
    t = K // 2 - 1 + u - k[None, :]          # signed distance to tap k
    h = cutoff * np.sinc(cutoff * t)
    # Kaiser window evaluated at the same offsets, half-width K/2
    x = np.clip(t / (K / 2), -1.0, 1.0)
    w = np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    h = h * w
    # unit DC gain per phase row (flat passband through the interpolator)
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(dtype)


@functools.partial(jax.jit, static_argnames=("n_out",))
def resample_block(x_re: jnp.ndarray, x_im: jnp.ndarray,
                   pos0: jnp.ndarray, ratio: jnp.ndarray,
                   table: jnp.ndarray, n_out: int):
    """Resample (T_in, C) planes to (n_out, C) at per-channel ratios.

    pos0: (C,) float32 -- absolute position (input rows, fractional) of
      output sample 0 per channel.  The caller guarantees every read stays
      in bounds: K//2 - 1 <= pos < T_in - K//2 for all n < n_out (the
      streaming wrapper sizes its window so this holds; indices are clipped
      as a belt-and-braces guard, never as semantics).
    ratio: (C,) float32 -- input samples per output sample (in_rate/out_rate).
    table: (P+1, K) from :func:`kaiser_sinc_table`.

    Returns (y_re, y_im, pos_end) with pos_end = pos0 + n_out*ratio, the
    carry for the next block.
    """
    T_in = x_re.shape[0]
    P = table.shape[0] - 1
    K = table.shape[1]
    n = jnp.arange(n_out, dtype=jnp.float32)[:, None]          # (n_out, 1)
    pos = pos0[None, :] + n * ratio[None, :]                    # (n_out, C)
    base = jnp.floor(pos)
    frac = pos - base                                           # [0, 1)
    i0 = base.astype(jnp.int32) - (K // 2 - 1)
    fp = frac * P
    p = jnp.floor(fp).astype(jnp.int32)                         # 0..P-1
    a = (fp - p.astype(jnp.float32)).astype(x_re.dtype)         # lerp weight

    y_re = jnp.zeros(pos.shape, x_re.dtype)
    y_im = jnp.zeros(pos.shape, x_im.dtype)
    for k in range(K):
        col = table[:, k]
        tap = (1.0 - a) * col[p] + a * col[p + 1]               # (n_out, C)
        idx = jnp.clip(i0 + k, 0, T_in - 1)
        y_re = y_re + tap * jnp.take_along_axis(x_re, idx, axis=0)
        y_im = y_im + tap * jnp.take_along_axis(x_im, idx, axis=0)
    return y_re, y_im, pos0 + n_out * ratio


def resample_positions_valid(pos0: np.ndarray, ratio: np.ndarray,
                             n_out: int, t_in: int, taps_per_phase: int
                             ) -> bool:
    """Host-side check of the in-bounds contract documented on
    :func:`resample_block` (the streaming wrapper asserts it per block)."""
    K = taps_per_phase
    last = pos0 + (n_out - 1) * ratio
    return bool(np.all(pos0 >= K // 2 - 1) and np.all(last < t_in - K // 2))


def uniform_poly_matrix(num: int, den: int, taps_per_phase: int = 8,
                        cutoff: float = 1.0, beta: float = 8.0,
                        dtype=np.float32) -> np.ndarray:
    """Banded polyphase selection matrix for a UNIFORM rational ratio
    num/den (input samples per output sample).

    Row j holds the taps that produce output phase j of a den-output cycle
    from the cycle's (num + K)-row input window:
    ``y[q*den + j] = sum_t S[j, t] * x[q*num + t]`` with the exact
    fractional phases (no table quantization, unlike the gather path).

    This is the matmul form: when every channel shares one ratio, the
    whole resampler is two reshapes + one einsum against this matrix --
    zero gathers.
    """
    if num <= 0 or den <= 0:
        raise ValueError("num/den must be positive")
    K = taps_per_phase
    p0 = K // 2 - 1          # same start contract as resample_block
    S = np.zeros((den, num + K), np.float64)
    for j in range(den):
        pos = p0 + j * num / den
        base = int(np.floor(pos))
        u = pos - base
        i0 = base - (K // 2 - 1)
        k = np.arange(K, dtype=np.float64)
        t = K // 2 - 1 + u - k
        h = cutoff * np.sinc(cutoff * t)
        x = np.clip(t / (K / 2), -1.0, 1.0)
        h *= np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
        h /= h.sum()
        S[j, i0: i0 + K] = h
    return S.astype(dtype)


@functools.partial(jax.jit, static_argnames=("num", "den"))
def resample_block_uniform(x_re: jnp.ndarray, x_im: jnp.ndarray,
                           S: jnp.ndarray, num: int, den: int):
    """Uniform-ratio resample of (T_in, C) planes: every den outputs
    consume num inputs, T_in = Q*num + K rows (Q full cycles + tap tail),
    returns (Q*den, C) planes.

    Streaming contract: output row 0 sits at input position K//2 - 1
    (same as resample_block); after the call the caller keeps the last
    T_in - Q*num input rows as the next block's head.  The rational grid
    restarts each cycle exactly, so there is NO position carry and no
    float drift by construction.
    """
    K = S.shape[1] - num
    T_in = x_re.shape[0]
    Q = (T_in - K) // num
    if Q <= 0:
        raise ValueError(f"need at least num+K={num + K} rows, got {T_in}")

    # Overlapping (num+K)-row windows at stride num, built from a handful
    # of shifted reshapes (2 when num >= K) -- no gathers.  Padded rows can
    # only land in window columns >= K of the final cycle, which the band
    # structure of S never touches.
    m_shifts = -(-(num + K) // num)
    need_rows = (m_shifts - 1) * num + Q * num
    pad = max(0, need_rows - T_in)

    def windows(x):
        xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
        parts = [xp[s * num: s * num + Q * num].reshape(Q, num, -1)
                 for s in range(m_shifts)]
        return jnp.concatenate(parts, axis=1)[:, :num + K]

    w_re = windows(x_re)
    w_im = windows(x_im)
    hp = jax.lax.Precision.HIGHEST        # taps/samples not TF32-exact
    y_re = jnp.einsum("jt,qtc->qjc", S, w_re, precision=hp,
                      preferred_element_type=jnp.float32)
    y_im = jnp.einsum("jt,qtc->qjc", S, w_im, precision=hp,
                      preferred_element_type=jnp.float32)
    C = x_re.shape[1]
    return y_re.reshape(Q * den, C), y_im.reshape(Q * den, C)
