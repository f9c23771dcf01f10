"""Automatic gain control + squelch front-end (block recast, matmul form).

Extension beyond the reference: REDHAWK deployments put an AGC component in
front of psk_soft (whose energy-argmax timing is scale-invariant but whose
soft-decision amplitudes track the input level, cpp/psk_soft.cpp:465-500 —
nothing in the component normalizes them) and a squelch to silence dead
channels.  This module provides both, designed array-first:

The classical AGC is a per-sample sequential recursion:

    p[n] = (1-a) * p[n-1] + a * |x[n]|^2 ;  g[n] = target / sqrt(p[n])

Two recasts make it a block-parallel device op:

1. **Chunked envelope** — the power envelope moves at channel dynamics
   (fades, bursts), orders of magnitude slower than the sample rate, so the
   EMA runs at one update per ``chunk`` samples (e.g. one per symbol) over
   *chunk-mean* powers: a segmented mean (reshape + mean, the same recast as
   the timing bins, ops/timing.py) followed by a K-step recurrence instead
   of a T-step one.
2. **Affine recurrence -> lower-triangular matmul** — over a block of K
   chunk powers q the EMA is the causal exponential-weight FIR

       p[k] = (1-a)^(k+1) * p0  +  sum_j  a (1-a)^(k-j) q[j]

   i.e. one (K, K) lower-triangular matmul against the (K, C) chunk-power
   plane plus a decay vector times the carried power.
   Bit-for-bit identical to running the chunk recurrence sequentially is
   not required (FP association differs); equivalence is gated to 1e-6.

Squelch: chunks whose tracked power sits below ``squelch_power`` emit zero
output (gain forced to 0) while the EMA keeps tracking, so a channel coming
back above threshold re-opens instantly with a converged gain.

State carries one scalar per channel (the EMA power) plus a primed flag
(the first chunk initializes p directly from the data — no attack
transient from an arbitrary init).  Streaming over any block split is
equivalent to one-shot processing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class AgcConfig:
    """AGC/squelch configuration.

    Attributes:
      target_rms: output RMS the gain drives toward.
      alpha: per-chunk EMA weight (attack/decay time constant is
        ``chunk / alpha`` samples).
      chunk: samples per gain update; pair it with the demod's sps so the
        gain is constant within each symbol.
      squelch_power: mean-square power threshold; chunks tracking below it
        are muted (0.0 disables squelch).
      eps: floor inside the inverse square root.
    """

    target_rms: float = 1.0
    alpha: float = 0.05
    chunk: int = 8
    squelch_power: float = 0.0
    eps: float = 1e-12

    def __post_init__(self):
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {self.alpha}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1; got {self.chunk}")


class AgcState(NamedTuple):
    power: jnp.ndarray   # (...,) carried EMA of chunk-mean |x|^2
    primed: jnp.ndarray  # (...,) bool: power holds real data


def agc_init(cfg: AgcConfig, channel_shape: tuple = ()) -> AgcState:
    return AgcState(power=jnp.ones(channel_shape, jnp.float32),
                    primed=jnp.zeros(channel_shape, bool))


@functools.lru_cache(maxsize=64)
def _ema_mats(alpha: float, k: int):
    """Lower-triangular exponential-weight matrix L (K, K) and decay d (K,).

    p = L @ q + d * p0, the closed form of the chunk EMA over a K-block.
    """
    j = np.arange(k)
    expo = j[:, None] - j[None, :]
    l = alpha * (1.0 - alpha) ** np.maximum(expo, 0) * (expo >= 0)
    d = (1.0 - alpha) ** (j + 1)
    # numpy (not jnp): device constants created inside one jit trace must
    # not be cached and reused inside another (UnexpectedTracerError).
    return l.astype(np.float32), d.astype(np.float32)


def agc_block(cfg: AgcConfig, state: AgcState, x: jnp.ndarray):
    """Apply AGC to a block.

    Args:
      state: per-channel carry; shapes broadcast from ``x.shape[:-1]``.
      x: (..., T) complex64 with T a multiple of ``cfg.chunk``.

    Returns:
      (new_state, y, info) where y is the gained (and squelched) block and
      info is a dict with the per-chunk ``gain`` (..., K), tracked ``power``
      (..., K) and squelch ``active`` mask (..., K) — the observability
      planes (the AGC analogue of the reference's phase/sampleIndex debug
      ports).
    """
    t = x.shape[-1]
    if t % cfg.chunk:
        raise ValueError(f"block length {t} not a multiple of "
                         f"chunk {cfg.chunk}")
    k = t // cfg.chunk
    lead = x.shape[:-1]
    pwr = x.real * x.real + x.imag * x.imag
    q = jnp.mean(pwr.reshape(lead + (k, cfg.chunk)),
                 axis=-1).astype(jnp.float32)

    # First chunk primes the EMA with data (no attack transient).
    p0 = jnp.where(state.primed, state.power, q[..., 0])
    l, d = _ema_mats(cfg.alpha, k)
    p = (jnp.einsum("kj,...j->...k", jnp.asarray(l), q,
                    precision=jax.lax.Precision.HIGHEST)   # no TF32
         + jnp.asarray(d) * p0[..., None])
    # An unprimed stream's first chunk is exactly its own mean power.
    p = p.at[..., 0].set(jnp.where(state.primed, p[..., 0], q[..., 0]))

    gain = cfg.target_rms / jnp.sqrt(jnp.maximum(p, cfg.eps))
    active = (p >= cfg.squelch_power) if cfg.squelch_power > 0.0 \
        else jnp.ones_like(p, bool)
    gain = jnp.where(active, gain, 0.0)

    y = (x.reshape(lead + (k, cfg.chunk))
         * gain[..., None].astype(jnp.float32)).reshape(x.shape)
    new_state = AgcState(power=p[..., -1],
                         primed=jnp.ones_like(state.primed))
    return new_state, y.astype(x.dtype), dict(gain=gain, power=p,
                                              active=active)


def agc_block_tm(cfg: AgcConfig, state: AgcState, x_re: jnp.ndarray,
                 x_im: jnp.ndarray):
    """:func:`agc_block` on time-major (T, C) float planes -- the demod
    kernel's native layout, so the AGC fuses into a one-launch chain with
    zero relayout (models/chain.make_front_chain_fn).  Same math as
    agc_block term for term (the EMA matmul runs ``kj,jc->kc``); gated
    equal in tests/test_agc.py.

    Returns (new_state, y_re, y_im, info); state shapes are (C,).
    """
    t, c = x_re.shape
    if t % cfg.chunk:
        raise ValueError(f"block length {t} not a multiple of "
                         f"chunk {cfg.chunk}")
    k = t // cfg.chunk
    pwr = x_re * x_re + x_im * x_im
    q = jnp.mean(pwr.reshape(k, cfg.chunk, c), axis=1).astype(jnp.float32)
    p0 = jnp.where(state.primed, state.power, q[0])
    l, d = _ema_mats(cfg.alpha, k)
    p = (jnp.einsum("kj,jc->kc", jnp.asarray(l), q,
                    precision=jax.lax.Precision.HIGHEST)   # no TF32
         + jnp.asarray(d)[:, None] * p0[None, :])
    p = p.at[0].set(jnp.where(state.primed, p[0], q[0]))
    gain = cfg.target_rms / jnp.sqrt(jnp.maximum(p, cfg.eps))
    active = (p >= cfg.squelch_power) if cfg.squelch_power > 0.0 \
        else jnp.ones_like(p, bool)
    gain = jnp.where(active, gain, 0.0)                    # (K, C)
    g_t = jnp.repeat(gain, cfg.chunk, axis=0)              # (T, C)
    new_state = AgcState(power=p[-1],
                         primed=jnp.ones_like(state.primed))
    return (new_state, (x_re * g_t).astype(x_re.dtype),
            (x_im * g_t).astype(x_im.dtype),
            dict(gain=gain, power=p, active=active))


def make_agc_fn(cfg: AgcConfig, jit: bool = True):
    """fn(state, x) -> (state, y, info); jitted, any leading channel axes."""
    fn = functools.partial(agc_block, cfg)
    return jax.jit(fn) if jit else fn


def agc_reference(cfg: AgcConfig, x: np.ndarray,
                  p0: float | None = None):
    """Sequential chunk-recurrence oracle (numpy, float64) for tests."""
    t = x.size
    k = t // cfg.chunk
    q = np.mean(np.abs(x.reshape(k, cfg.chunk)) ** 2, axis=-1)
    p = np.empty(k, np.float64)
    prev = q[0] if p0 is None else p0
    for i in range(k):
        if i == 0 and p0 is None:
            p[0] = q[0]
        else:
            p[i] = (1.0 - cfg.alpha) * prev + cfg.alpha * q[i]
        prev = p[i]
    gain = cfg.target_rms / np.sqrt(np.maximum(p, cfg.eps))
    if cfg.squelch_power > 0.0:
        gain = np.where(p >= cfg.squelch_power, gain, 0.0)
    y = (x.reshape(k, cfg.chunk) * gain[:, None]).reshape(x.shape)
    return y.astype(np.complex64), gain, p
