"""Front-end matched filtering: boxcar and root-raised-cosine.

Extension beyond the reference (BASELINE.json north star + config 3): the
reference demodulates unfiltered rectangular pulses and relies on max-energy
sample selection alone (cpp/psk_soft.cpp:442-465).  A matched filter
maximizes decision-point SNR for shaped pulses; timing recovery then runs on
the *filtered* signal and its energy peak is the filter's correlation peak.

The complex FIR is evaluated as a real conv over stacked re/im planes with
`lax.conv_general_dilated` (channels = batch, planes = features), at
HIGHEST precision so no TF32 rounding enters.  Streaming uses an explicit (ntaps-1)-sample
input tail carried across blocks (overlap-save).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig


def rrc_taps(sps: int, beta: float = 0.35, span: int = 8,
             dtype=np.float32) -> np.ndarray:
    """Root-raised-cosine taps, unit energy, length span*sps + 1.

    Standard closed form with the singularity fills at t=0 and
    t = +-Ts/(4 beta).
    """
    if not 0 < beta <= 1:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    n = span * sps
    # Symmetric grid for any parity of n (floor-div arange would skew odd
    # lengths by half a sample and break linear phase).
    t = (np.arange(n + 1, dtype=np.float64) - n / 2.0) / sps
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            taps[i] = 1.0 - beta + 4 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1.0 / (4 * beta)) < 1e-9:
            taps[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            taps[i] = num / den
    taps /= np.sqrt(np.sum(taps ** 2))
    return taps.astype(dtype)


def boxcar_taps(sps: int, dtype=np.float32) -> np.ndarray:
    """Integrate-and-dump filter matched to rectangular pulses; normalized so
    a full-symbol rectangular pulse keeps unit amplitude at the peak."""
    return (np.ones(sps) / sps).astype(dtype)


def filter_taps(cfg: DemodConfig) -> np.ndarray | None:
    if cfg.matched_filter == "none":
        return None
    if cfg.matched_filter == "boxcar":
        return boxcar_taps(cfg.sps)
    # Unit-energy RRC: matched to a unit-energy TX pulse, the correlation
    # peak is 1, so decision amplitudes stay on the constellation.
    return rrc_taps(cfg.sps, cfg.rrc_beta, cfg.rrc_span)


def apply_fir(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Causal complex FIR, 'valid' alignment: y[t] = sum_k taps[k] x[t+k]
    with x already including the (ntaps-1)-sample left tail.

    x: (..., T + ntaps - 1) complex; returns (..., T) complex.
    """
    lead = x.shape[:-1]
    xf = x.reshape((-1, x.shape[-1]))
    planes = jnp.stack([xf.real, xf.imag], axis=1)       # (B, 2, T+L-1)
    k = taps[None, None, :]
    out = jax.lax.conv_general_dilated(
        planes.reshape(-1, 1, x.shape[-1]), k,
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,     # samples/taps not TF32-exact
    ).reshape(xf.shape[0], 2, -1)
    y = jax.lax.complex(out[:, 0], out[:, 1])
    return y.reshape(lead + (y.shape[-1],))


def streaming_filter(x: jnp.ndarray, tail: jnp.ndarray, taps: jnp.ndarray):
    """Overlap-save streaming FIR.

    Args:
      x: (..., T) new samples.
      tail: (..., ntaps-1) previous block's last inputs (zeros at start).
    Returns (y (..., T), new_tail).
    """
    xt = jnp.concatenate([tail, x], axis=-1)
    y = apply_fir(xt, taps)
    ntaps = taps.shape[-1]
    new_tail = xt[..., xt.shape[-1] - (ntaps - 1):] if ntaps > 1 else tail
    return y, new_tail
