"""Blind signal survey: symbol-rate estimation + PSK order classification.

Extension beyond the reference: psk_soft must be *configured* with the
samples-per-baud and constellation size (psk_soft.prf.xml:23-48) -- an
operator derives them upstream.  This module estimates both, plus the
coarse CFO, directly from a captured bank, so a deployment can
auto-configure (see the ``probe`` CLI subcommand and runtime/autocfo.py
for the CFO half of the loop).

Estimators (both are classical cyclostationary detectors, laid out
array-first -- the heavy work is one batched FFT launch per bank; only
O(band) magnitudes / O(1) scalars are fetched for the data-dependent
peak logic, the framesync split):

- **Symbol rate**: the transition-energy sequence d[n] = |x[n+1]-x[n]|^2
  is periodic at the baud (rectangular pulses spike at symbol
  boundaries; band-limited pulses fluctuate at the symbol rate), so its
  spectrum carries a line at 1/sps.  One rFFT over the (C, T) plane;
  the host picks the peak in the configured sps band, prefers a
  sub-harmonic when the fundamental is comparably strong (narrow
  transition spikes put energy in all harmonics), and refines to
  sub-bin accuracy with a 3-point parabolic fit.
- **PSK order + coarse CFO**: unit phasors u = x/|x| raised to the M-th
  power collapse M-PSK modulation to a tone at M*cfo
  (cpp/psk_soft.cpp:474's trick, applied to classification): the
  *smallest* M whose spectrum shows a dominant line is the constellation
  order, and the line's (parabolically refined) frequency / M is the
  CFO.  All candidate powers run in one launch; u^{2M} = (u^M)^2 chains
  the squarings.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_CANDIDATE_M = (2, 4, 8, 16, 32)


@functools.partial(jax.jit, static_argnames=("nfft",))
def _baud_spectrum(re, im, nfft: int):
    """(C, T) planes -> (C, nfft//2+1) transition-energy magnitudes."""
    dr = re[:, 1:] - re[:, :-1]
    di = im[:, 1:] - im[:, :-1]
    d = dr * dr + di * di
    d = d - jnp.mean(d, axis=1, keepdims=True)
    return jnp.abs(jnp.fft.rfft(d, n=nfft, axis=1))


@functools.partial(jax.jit, static_argnames=("n_m", "nfft"))
def _power_spectra(re, im, n_m: int, nfft: int):
    """(C, T) planes -> (C, n_m, nfft) |FFT(u^{2^(k+1)})| for k < n_m.

    u = x/|x| (envelope removed); repeated squaring chains the powers
    2, 4, 8, ... so candidate M are powers of two.
    """
    mag = jnp.sqrt(jnp.maximum(re * re + im * im, 1e-30))
    ur, ui = re / mag, im / mag
    outs = []
    for _ in range(n_m):
        ur, ui = ur * ur - ui * ui, 2.0 * ur * ui      # u <- u^2
        z = jax.lax.complex(ur, ui)
        outs.append(jnp.abs(jnp.fft.fft(z, n=nfft, axis=1)))
    return jnp.stack(outs, axis=1)


def _parabolic(mag_row: np.ndarray, k: int) -> float:
    """3-point parabolic peak interpolation; returns the sub-bin offset."""
    if not (0 < k < mag_row.size - 1):
        return 0.0
    a, b, c = float(mag_row[k - 1]), float(mag_row[k]), float(mag_row[k + 1])
    den = a - 2.0 * b + c
    return 0.0 if den == 0.0 else float(np.clip(0.5 * (a - c) / den,
                                                -0.5, 0.5))


def estimate_baud(x, sps_min: float = 2.0, sps_max: float = 64.0,
                  nfft: int | None = None):
    """Per-channel symbol-rate estimate from the transition-energy line.

    Args:
      x: (C, T) or (T,) complex baseband (numpy or device array).
      sps_min / sps_max: the plausible samples-per-symbol band.
      nfft: FFT length (default: next power of two >= T-1; more = finer
        raw bins, the parabolic fit refines either way).

    Returns:
      (sps, confidence): per-channel float arrays (scalars for 1-D
      input).  ``confidence`` is the line-to-median ratio inside the
      search band -- < ~5 means "no usable baud line" (noise, CW, or
      constant-envelope data with no transitions).
    """

    arr = np.asarray(x) if isinstance(x, np.ndarray) else x
    one = arr.ndim == 1
    if one:
        arr = arr[None]
    t = arr.shape[-1]
    if t < 8:
        raise ValueError("need at least 8 samples")
    if not (1.0 < sps_min < sps_max):
        raise ValueError("need 1 < sps_min < sps_max")
    if nfft is None:
        nfft = 1 << int(np.ceil(np.log2(max(t - 1, 2))))
    if isinstance(arr, np.ndarray):
        dev = jnp.asarray(np.ascontiguousarray(arr, np.complex64))
    else:
        dev = arr
    mags = np.asarray(_baud_spectrum(dev.real.astype(jnp.float32),
                                     dev.imag.astype(jnp.float32), nfft))
    k_lo = max(int(np.floor(nfft / sps_max)), 1)
    k_hi = min(int(np.ceil(nfft / sps_min)), mags.shape[1] - 2)
    if k_hi <= k_lo:
        raise ValueError("sps band resolves to an empty FFT bin range; "
                         "capture more samples or widen the band")
    sps = np.zeros(mags.shape[0], np.float64)
    conf = np.zeros(mags.shape[0], np.float64)
    for c in range(mags.shape[0]):
        band = mags[c, k_lo:k_hi + 1]
        k = k_lo + int(np.argmax(band))
        peak = mags[c, k]
        # Prefer a strong sub-harmonic: narrow transition spikes spread
        # energy across harmonics and bin k may be a multiple of the
        # true line.
        for div in (2, 3):
            ks = int(round(k / div))
            if ks >= k_lo and mags[c, max(ks - 1, 0):ks + 2].max() \
                    >= 0.5 * peak:
                k = ks - 1 + int(np.argmax(mags[c, max(ks - 1, 0):ks + 2]))
                break
        f = (k + _parabolic(mags[c], k)) / nfft
        sps[c] = 1.0 / f if f > 0 else np.inf
        med = float(np.median(band))
        conf[c] = float(mags[c, k]) / max(med, 1e-30)
    if one:
        return float(sps[0]), float(conf[0])
    return sps, conf


def classify_psk(x, max_m: int = 8, nfft: int | None = None,
                 line_snr: float = 8.0):
    """Blind PSK order + coarse CFO from the M-th-power line.

    Args:
      x: (C, T) or (T,) complex baseband.
      max_m: largest candidate order (power of two <= 32).
      line_snr: peak-to-median ratio a spectrum must show to count as a
        line (the off-line statistic is Rayleigh-flat, so this is a
        false-alarm knob like FrameFormat.threshold).

    Returns:
      (m, cfo, conf) per channel (scalars for 1-D input): the smallest
      power-of-two order whose spectrum shows a dominant line (0 when
      none does -- noise or not PSK), the CFO in cycles/sample
      (parabolically refined, aliasing caveat of eval/cfo.acquire_cfo
      applies), and that line's peak-to-median ratio.
    """

    if max_m not in _CANDIDATE_M:
        raise ValueError(f"max_m must be one of {_CANDIDATE_M}")
    arr = np.asarray(x) if isinstance(x, np.ndarray) else x
    one = arr.ndim == 1
    if one:
        arr = arr[None]
    t = arr.shape[-1]
    if t < 8:
        raise ValueError("need at least 8 samples")
    n_m = _CANDIDATE_M.index(max_m) + 1
    if nfft is None:
        nfft = 1 << int(np.ceil(np.log2(max(t, 2))))
    if isinstance(arr, np.ndarray):
        dev = jnp.asarray(np.ascontiguousarray(arr, np.complex64))
    else:
        dev = arr
    mags = np.asarray(_power_spectra(dev.real.astype(jnp.float32),
                                     dev.imag.astype(jnp.float32),
                                     n_m, nfft))                 # (C, nM, F)
    c_count = mags.shape[0]
    m_out = np.zeros(c_count, np.int32)
    cfo = np.zeros(c_count, np.float64)
    conf = np.zeros(c_count, np.float64)

    def line_ratio(row, k):
        # A spectral LINE is a single-bin spike: compare the peak to its
        # local neighborhood (excluding +/-2 bins, wrap-around window).
        # A merely *colored* spectrum -- e.g. the low-pass telegraph
        # pedestal of u^2 for QPSK -- has comparable neighbors and fails
        # this test even though it beats the whole-band median.
        half = 32
        idx = (k + np.arange(-half, half + 1)) % row.size
        w = row[idx]
        keep = np.abs(np.arange(-half, half + 1)) > 2
        return float(row[k]) / max(float(np.mean(w[keep])), 1e-30)

    for c in range(c_count):
        for mi in range(n_m):
            m = _CANDIDATE_M[mi]
            row = mags[c, mi]
            k = int(np.argmax(row))
            ratio = line_ratio(row, k)
            if ratio >= line_snr:
                kf = k + _parabolic(row, k) if 0 < k < nfft - 1 else float(k)
                f = ((kf / nfft + 0.5) % 1.0) - 0.5
                m_out[c], cfo[c], conf[c] = m, f / m, ratio
                break
    if one:
        return int(m_out[0]), float(cfo[0]), float(conf[0])
    return m_out, cfo, conf
