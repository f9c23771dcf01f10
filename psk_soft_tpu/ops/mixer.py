"""NCO derotation (complex mixer) over time-major planes.

Extension beyond the reference: the reference relies on the M-th-power
phase tracker alone, which only locks when the per-symbol phase step
``M * 2pi * f * sps`` stays well under pi (cpp/psk_soft.cpp:560-580's
unwrap-against-estimate).  Larger carrier offsets need acquisition +
derotation first: estimate with :func:`psk_soft_tpu.eval.cfo.acquire_cfo`
(coarse, M-th-power spectrum) or ``cfo_from_phase`` (fine, from the phase
port), then mix the block down with this op before the demod.

Shape: pure elementwise work on the same (T, C) planes the steady demod
eats; XLA fuses it into the neighbouring ops.  Streaming: the returned
``phase_end`` is the next block's ``phase0`` (wrapped, so precision never
drifts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TWO_PI = 2.0 * np.pi


@jax.jit
def derotate(x_re: jnp.ndarray, x_im: jnp.ndarray,
             freq: jnp.ndarray, phase0: jnp.ndarray):
    """Multiply (T, C) planes by exp(-j*(2pi*freq*t + phase0)) per channel.

    freq: (C,) cycles per input sample; phase0: (C,) radians.
    Returns (y_re, y_im, phase_end) -- phase_end wrapped to (-pi, pi].
    """
    T = x_re.shape[0]
    t = jnp.arange(T, dtype=jnp.float32)[:, None]
    ang = -(TWO_PI * freq[None, :] * t + phase0[None, :])
    c, s = jnp.cos(ang), jnp.sin(ang)
    y_re = x_re * c - x_im * s
    y_im = x_re * s + x_im * c
    phase_end = phase0 + TWO_PI * freq * T
    phase_end = jnp.mod(phase_end + jnp.pi, TWO_PI) - jnp.pi
    return y_re, y_im, phase_end


def derotate_host(x: np.ndarray, freq, phase0=0.0) -> np.ndarray:
    """Channel-major complex host convenience (eval/tests): x (C, T) or
    (T,), freq cycles/sample scalar or (C,)."""
    x = np.asarray(x)
    one = x.ndim == 1
    x2 = x[None, :] if one else x
    f = np.broadcast_to(np.asarray(freq, np.float64), (x2.shape[0],))
    p0 = np.broadcast_to(np.asarray(phase0, np.float64), (x2.shape[0],))
    t = np.arange(x2.shape[1], dtype=np.float64)
    y = x2 * np.exp(-1j * (TWO_PI * f[:, None] * t[None, :]
                           + p0[:, None]))
    y = y.astype(np.complex64)
    return y[0] if one else y
