"""Blind adaptive channel equalizer (block CMA, matmul form).

Extension beyond the reference: psk_soft assumes an ISI-free input (its
rectangular-pulse test signals, tests/test_psk_soft.py:98-117) -- multipath
mitigation is left to an upstream REDHAWK equalizer component.  This module
provides one, designed array-first.

The classical constant-modulus algorithm (CMA, Godard) is a per-sample
sequential recursion:

    y[n] = w^H x_n ;  e[n] = y[n] (|y[n]|^2 - R2) ;  w <- w - mu e[n] x_n*

The block recast ("block LMS" schedule) freezes the weights within each
block, so both halves become large static-shape device ops:

1. **Filtering** -- an L-tap FIR with per-channel weights over the (C, T)
   block: L static-shifted fused multiply-adds (the channelizer/framesync
   branch-FMA pattern), with an (L-1)-sample history carry so streaming
   over any block split is identical to one-shot filtering (gated with
   mu=0 in tests).
2. **Gradient** -- g[l] = sum_k e[k] * conj(x[k*stride + L-1 - l]) is a
   correlation of the error sequence against L static strided slices of
   the input: one (C, L, K) x (C, K) batched contraction.
   One weight update per block with the SUMMED, power-normalized gradient
   (the classical Block-LMS schedule: each error sample contributes a
   mu-sized step computed at the block's frozen weights, so convergence
   per sample matches sample-wise CMA).  Consequence: the stable range of
   mu shrinks with the per-block error count K -- keep mu * K <~ 0.25 at
   unit input power (the tests converge 3-tap multipath with mu=5e-4,
   K=400).

CMA properties that shape the design:

- **Phase-blind**: CMA converges to the channel inverse up to an arbitrary
  unitary rotation -- exactly the ambiguity class the downstream
  M-th-power carrier recovery (cpp/psk_soft.cpp:474-481) and the UW frame
  sync (ops/framesync.py) already absorb, so no phase bootstrap is needed.
- **stride**: with the reference's rectangular pulses the modulus is
  constant at every sample, so errors are taken at every output sample
  (stride=1, K=T errors/block).  For band-limited (RRC) pulses set
  stride=sps to take errors at symbol decisions only.
- R2 = E|a|^4 / E|a|^2 = 1 for unit-modulus PSK; inputs should be AGC'd
  to unit RMS (runtime/agc.py) or the power normalization absorbs the
  scale.

State = weights + history, an explicit pytree carry: checkpoint/resume and
reconfigure follow the framework's standard semantics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_MAX_TAPS = 128


@dataclasses.dataclass(frozen=True)
class EqConfig:
    """Equalizer configuration.

    Attributes:
      taps: FIR length L (odd recommended; the identity init puts the
        unit tap at ``center``).
      mu: CMA step per error sample (Block-LMS sum schedule: keep
        mu * errors-per-block <~ 0.25 at unit input power).
      r2: Godard dispersion constant (1.0 for unit-modulus PSK).
      stride: error-sample spacing in output samples (1 = every sample,
        rectangular pulses; sps = symbol-spaced decisions).
      center: identity-init tap index; default L // 2.
      leak: per-update multiplicative weight leakage (0 disables; a tiny
        value e.g. 1e-4 bounds drift on long silent streams).
      freeze: compute outputs but skip weight updates (decision-directed
        hold / converged production mode).
      mode: "cma" (blind Godard error, acquisition) or "dd" --
        decision-directed LMS on the sliced M-PSK decisions, the
        post-lock refinement that removes the CMA excess-MSE floor (CMA's
        error is zero anywhere ON the unit circle, so residual ISI that
        only rotates symbols is invisible to it; the DD error e = y - a
        sees it).  DD decisions are rotation-invariant: the block's
        M-th-power phase (the same estimator as the carrier tracker,
        cpp/psk_soft.cpp:474-481) anchors the decision grid, so CMA's
        arbitrary unitary convergence rotation never breaks the slicer.
        Switch after CMA lock (cm_err small) -- DD from a cold start can
        lock onto wrong decisions.
      dd_m: constellation order for DD decisions.
      dd_gate: selective-DD reliability gate: error samples with
        |y - a| >= dd_gate contribute NO gradient (with rect pulses and a
        dispersive channel, samples near symbol transitions carry
        inter-symbol mixtures no linear equalizer can fix; their
        "decisions" are junk that biases the update -- gating them is
        what makes DD actually beat the CMA floor, measured ~1.8x in
        tests/test_equalizer.py).  In units of the unit-circle
        constellation (QPSK min distance = sqrt(2)); 0 disables gating.
    """

    taps: int = 11
    mu: float = 1e-4
    r2: float = 1.0
    stride: int = 1
    center: int | None = None
    leak: float = 0.0
    freeze: bool = False
    mode: str = "cma"
    dd_m: int = 4
    dd_gate: float = 0.25

    def __post_init__(self):
        if not (1 <= self.taps <= _MAX_TAPS):
            raise ValueError(f"taps must be in [1, {_MAX_TAPS}]")
        if self.stride < 1:
            raise ValueError("stride must be >= 1")
        c = self.center if self.center is not None else self.taps // 2
        if not (0 <= c < self.taps):
            raise ValueError("center tap out of range")
        if self.mu < 0 or self.leak < 0:
            raise ValueError("mu and leak must be >= 0")
        if self.mode not in ("cma", "dd"):
            raise ValueError(f"unknown equalizer mode {self.mode!r}")
        if self.dd_m not in (2, 4, 8, 16, 32):
            raise ValueError(f"dd_m must be a supported PSK order; "
                             f"got {self.dd_m}")
        if self.dd_gate < 0:
            raise ValueError("dd_gate must be >= 0")

    @property
    def center_tap(self) -> int:
        return self.center if self.center is not None else self.taps // 2


class EqState(NamedTuple):
    w: jnp.ndarray     # (..., L) complex64 per-channel weights
    hist: jnp.ndarray  # (..., L-1) complex64 input history carry


def eq_init(cfg: EqConfig, channel_shape: tuple = ()) -> EqState:
    """Identity initialization: w = delta at the center tap."""

    w = np.zeros(channel_shape + (cfg.taps,), np.complex64)
    w[..., cfg.center_tap] = 1.0
    hist = np.zeros(channel_shape + (max(cfg.taps - 1, 0),), np.complex64)
    return EqState(w=jnp.asarray(w), hist=jnp.asarray(hist))


def eq_block(cfg: EqConfig, state: EqState, x: jnp.ndarray):
    """Filter one block and (unless frozen) apply one block-CMA update.

    Args:
      state: per-channel carry; leading axes broadcast from ``x``.
      x: (..., T) complex64 block, T a multiple of ``cfg.stride`` and
        T >= taps - 1.

    Returns:
      (new_state, y, info): y is the equalized block (same shape; sample n
      is the FIR over x[n-L+1 .. n], i.e. group delay ``center_tap``);
      info carries the mean squared modulus error ``cm_err`` (the CMA cost
      E[(|y|^2-R2)^2], the convergence observable) and the gradient norm.
    """
    l = cfg.taps
    t = x.shape[-1]
    if t % cfg.stride:
        raise ValueError(f"block length {t} not a multiple of "
                         f"stride {cfg.stride}")
    if t < l - 1:
        raise ValueError(f"block length {t} shorter than taps-1 = {l - 1}")
    if isinstance(x, np.ndarray):
        x = jnp.asarray(x)
    xx = jnp.concatenate([state.hist, jnp.asarray(x)], axis=-1)

    # FIR: y[n] = sum_l w[l] * xx[n + L-1 - l]  (L static-shifted FMAs).
    y = jnp.zeros(x.shape, jnp.complex64)
    for i in range(l):
        seg = jax.lax.slice_in_dim(xx, l - 1 - i, l - 1 - i + t, axis=-1)
        y = y + state.w[..., i:i + 1] * seg

    mod = y.real * y.real + y.imag * y.imag
    # Error samples on the stride grid.
    ys = y[..., ::cfg.stride]
    ms = mod[..., ::cfg.stride]
    if cfg.mode == "dd":
        # Rotation-invariant M-PSK decisions: anchor the grid on the
        # block's M-th-power phase, quantize each symbol to it.
        m = cfg.dd_m
        phi = jnp.angle(jnp.sum(ys ** m, axis=-1, keepdims=True)) / m
        theta = jnp.angle(ys)
        kq = jnp.round((theta - phi) * (m / (2.0 * np.pi)))
        a_ang = (phi + kq * (2.0 * np.pi / m)).astype(jnp.float32)
        a = jax.lax.complex(jnp.cos(a_ang), jnp.sin(a_ang))
        e = (ys - a).astype(jnp.complex64)
        e2 = e.real * e.real + e.imag * e.imag
        # Observable: decision-directed MSE (the quantity DD minimizes).
        cm_err = jnp.mean(e2, axis=-1)
        if cfg.dd_gate > 0:
            # Selective DD: drop unreliable decisions from the gradient.
            e = e * (e2 < cfg.dd_gate * cfg.dd_gate).astype(jnp.float32)
    else:
        e = (ys * (ms - cfg.r2)).astype(jnp.complex64)
        cm_err = jnp.mean((ms - cfg.r2) ** 2, axis=-1)

    if cfg.freeze or cfg.mu == 0.0:
        new_w = state.w
        gn = jnp.zeros(cm_err.shape, jnp.float32)
    else:
        # g[l] = sum_k e[k] conj(x window): stack L static strided slices
        # -> one batched (..., L, K) x (..., K) contraction.
        slices = [
            jax.lax.slice_in_dim(xx, l - 1 - i, l - 1 - i + t,
                                 axis=-1)[..., ::cfg.stride]
            for i in range(l)
        ]
        xw = jnp.stack(slices, axis=-2)               # (..., L, K)
        g = jnp.einsum("...lk,...k->...l", jnp.conj(xw), e,
                       precision=jax.lax.Precision.HIGHEST)   # no TF32
        # Power normalization: the CMA gradient scales with the cube of
        # the signal level (normalize by power^2); the DD/LMS gradient is
        # linear in it (normalize by power).  Either way mu transfers
        # across input scales.
        p = jnp.mean(xx.real * xx.real + xx.imag * xx.imag,
                     axis=-1, keepdims=True)
        g = g / jnp.maximum(p if cfg.mode == "dd" else p * p, 1e-12)
        new_w = (state.w * (1.0 - cfg.leak) - cfg.mu * g).astype(
            jnp.complex64)
        gn = jnp.sqrt(jnp.sum(jnp.abs(g) ** 2, axis=-1)).astype(jnp.float32)

    new_hist = xx[..., xx.shape[-1] - (l - 1):] if l > 1 \
        else xx[..., :0]
    return (EqState(w=new_w, hist=new_hist), y.astype(jnp.complex64),
            dict(cm_err=cm_err.astype(jnp.float32), grad_norm=gn))


def make_eq_fn(cfg: EqConfig, jit: bool = True):
    """fn(state, x) -> (state, y, info); jitted, any leading channel axes."""
    fn = functools.partial(eq_block, cfg)
    return jax.jit(fn) if jit else fn


def multipath(x: np.ndarray, taps) -> np.ndarray:
    """Test/bench helper: apply a FIR channel along the last axis (causal,
    same length -- the leading samples see a zero history)."""
    taps = np.asarray(taps, np.complex64)
    y = np.zeros_like(np.asarray(x, np.complex64))
    for d, h in enumerate(taps):
        if h == 0:
            continue
        y[..., d:] += h * x[..., :x.shape[-1] - d]
    return y
