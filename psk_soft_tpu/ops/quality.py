"""Per-channel signal-quality estimation: EVM, M2M4 SNR, carrier lock.

Extension beyond the reference: the only observability the reference exports
is the raw debug ports (unwrapped phase estimate and timing index,
cpp/psk_soft_base.cpp:44-47); a REDHAWK operator derives link quality from
those in downstream components.  Here signal quality is a first-class,
device-computed per-channel summary of each block of soft decisions, cheap
enough (a handful of reductions over an already-resident plane) to run
on every block of every channel.

Three estimators, all single-pass moment reductions over the (..., S) soft
plane -- no sorting, no data-dependent shapes, vmap/pjit-clean:

- **M2M4 SNR** (moments method, constant-modulus kurtosis ka=1, complex
  AWGN): with M2 = E|s|^2 and M4 = E|s|^4, the signal power is
  S = sqrt(2*M2^2 - M4) and noise N = M2 - S, so snr = S/N.  Blind --
  needs no decisions, no reference constellation, works mid-acquisition.
- **Carrier lock** |E[(s/|s|)^M]| in [0, 1]: the M-th power removes PSK
  modulation (the same trick as the carrier recovery itself,
  cpp/psk_soft.cpp:474), so a phase-locked channel concentrates u^M on one
  angle (lock -> 1) while an unlocked or noise-only channel spreads it
  (lock -> 0).  Invariant to any fixed constellation rotation, including
  the QPSK +pi/4 convention and the M-fold recovery ambiguity.
- **EVM** (decision-directed, rotation-free): per symbol the phase error is
  delta = angle(u^M * conj(zbar)) / M  where zbar = E[u^M] is the measured
  cluster center -- i.e. dispersion is measured around where the
  constellation actually sits, so no grid convention (diff vs non-diff,
  +pi/4 vs not, M-fold ambiguity) can bias it.  With A = E|s|, the exact
  per-symbol error vector magnitude to the amplitude-A reference point at
  angle theta - delta is  |s|^2 + A^2 - 2|s|A cos(delta)  (since
  s = |s| e^{j theta}), and EVM_rms = sqrt(E[.]) / A.

All three accept a per-channel (traced) M plane, so mixed banks
(models/mixed.py) get per-channel quality in the same launch, and a
validity mask for warm-up gating.  ``valid`` rows with no valid symbols
report count 0 and neutral metrics (snr 0, lock 0, evm 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class QualityBlock(NamedTuple):
    """Per-channel block quality (all shapes = soft.shape[:-1]).

    Linear-scale values; convert with :func:`snr_db` / :func:`evm_pct`.
    """

    count: jnp.ndarray   # int32 valid symbols measured
    amp: jnp.ndarray     # mean |s| (the constellation radius estimate)
    power: jnp.ndarray   # mean |s|^2 (M2)
    snr: jnp.ndarray     # M2M4 moments SNR estimate (linear)
    lock: jnp.ndarray    # |E[(s/|s|)^M]| in [0, 1]
    evm: jnp.ndarray     # RMS error-vector magnitude / amp (fraction)
    center: jnp.ndarray  # complex E[(s/|s|)^M] (cluster center, carried
    #                      so streaming accumulation can merge blocks)


def block_quality(soft: jnp.ndarray, m, valid=None,
                  eps: float = 1e-20) -> QualityBlock:
    """Quality metrics for one block of soft decisions.

    Args:
      soft: (..., S) complex soft symbols (any leading channel axes).
      m: constellation size -- python int or (...,) int array broadcast
        against the leading axes (mixed banks).
      valid: optional (..., S) bool mask (warm-up gating); None = all valid.

    Returns:
      QualityBlock of per-channel scalars.
    """
    if isinstance(soft, np.ndarray):
        soft = jnp.asarray(soft)
    else:
        soft = jnp.asarray(soft)
    mag2 = (soft.real * soft.real + soft.imag * soft.imag).astype(jnp.float32)
    mag = jnp.sqrt(mag2)
    if valid is None:
        w = jnp.ones(soft.shape, jnp.float32)
    else:
        w = jnp.asarray(valid).astype(jnp.float32)
    n = jnp.sum(w, axis=-1)
    inv_n = 1.0 / jnp.maximum(n, 1.0)

    amp = jnp.sum(w * mag, axis=-1) * inv_n
    m2 = jnp.sum(w * mag2, axis=-1) * inv_n
    m4 = jnp.sum(w * mag2 * mag2, axis=-1) * inv_n

    # M2M4: S = sqrt(2 M2^2 - M4), N = M2 - S (ka = 1 for M-PSK).  The
    # f32 moment cancellation limits the estimator's range; values above
    # the cap mean "cleaner than measurable", not a precise figure.
    s_pow = jnp.sqrt(jnp.maximum(2.0 * m2 * m2 - m4, 0.0))
    n_pow = jnp.maximum(m2 - s_pow, eps)
    snr = jnp.minimum(s_pow / n_pow, 1e6)  # cap: 60 dB

    # Modulation-removed unit phasors u^M (per-channel M supported).
    theta = jnp.arctan2(soft.imag, soft.real).astype(jnp.float32)
    m_arr = jnp.asarray(m, jnp.float32)
    mtheta = m_arr[..., None] * theta if m_arr.ndim else m_arr * theta
    z = jax.lax.complex(jnp.cos(mtheta), jnp.sin(mtheta))
    center = jnp.sum(w * z, axis=-1) * inv_n.astype(jnp.float32)
    lock = jnp.abs(center)

    # Rotation-free decision-directed EVM around the measured center.
    czn = jnp.conj(center) / jnp.maximum(lock, eps).astype(jnp.float32)
    delta = jnp.angle(z * czn[..., None]) / jnp.maximum(
        m_arr[..., None] if m_arr.ndim else m_arr, 1.0)
    ev2 = mag2 + (amp * amp)[..., None] \
        - 2.0 * mag * amp[..., None] * jnp.cos(delta)
    evm = jnp.sqrt(jnp.maximum(jnp.sum(w * ev2, axis=-1) * inv_n, 0.0)) \
        / jnp.maximum(amp, eps)

    has = n > 0
    zf = jnp.zeros_like(amp)
    return QualityBlock(
        count=n.astype(jnp.int32),
        amp=jnp.where(has, amp, zf),
        power=jnp.where(has, m2, zf),
        snr=jnp.where(has, snr, zf),
        lock=jnp.where(has, lock, zf),
        evm=jnp.where(has, evm, zf),
        center=jnp.where(has, center, jnp.zeros_like(center)),
    )


def make_quality_fn(m, jit: bool = True):
    """fn(soft, valid=None) -> QualityBlock with ``m`` closed over.

    ``m`` may be an int or a per-channel array (device constant).
    """
    fn = functools.partial(block_quality, m=m)
    return jax.jit(fn) if jit else fn


def snr_db(snr_linear) -> np.ndarray:
    """Linear SNR -> dB (host helper; floors at -100 dB)."""
    s = np.asarray(snr_linear, np.float64)
    return (10.0 * np.log10(np.maximum(s, 1e-10))).astype(np.float32)


def evm_pct(evm_fraction) -> np.ndarray:
    """EVM fraction -> percent (host helper)."""
    return (100.0 * np.asarray(evm_fraction, np.float64)).astype(np.float32)
