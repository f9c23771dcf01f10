"""Reference-semantics oracle: the C++ component's sequential algorithm
re-implemented in plain numpy, directly from the survey of
cpp/psk_soft.cpp (NOT a code copy -- an independent executable spec).

Used by tests to prove the array pipelines reproduce the reference recursion:
per-sample deque windows, incremental energy bins, first-max argmax,
arg(sample^M), unwrap-against-estimate, incremental LinearFit with history
re-wrap about M*2pi, differential decode, +pi/4 QPSK rotation.

Deviations follow PARITY.md: `last` initialized to 1+0j (#2); bit slicing is
not modeled here (slicers are unit-tested against the documented mapping).
"""

from __future__ import annotations

import math

import numpy as np

M_2PI = 2.0 * math.pi


class LinearFitRef:
    """Sliding-window least-squares fit evaluated at the newest point, with
    the reference's incremental ySum/xySum update equations
    (cpp/psk_soft.cpp:35-185)."""

    def __init__(self, num_pts: int, sample_rate: float):
        self.n = num_pts
        self.xdelta = 1.0 / sample_rate
        self.yvals: list[float] = []
        self.ysum = 0.0
        self.xysum = 0.0
        self.denominator = 1.0
        self.x_avg = 0.0
        self.count = 0

    def next(self, yval: float) -> float:
        if self.count == 1 << 20:
            self.reset()
        steady = len(self.yvals) == self.n
        if steady:
            self.ysum -= self.yvals.pop(0)
            self.xysum -= self.xdelta * self.ysum
        self.ysum += yval
        self.xysum += yval * len(self.yvals) * self.xdelta
        self.yvals.append(yval)
        if not steady:
            self._calc_denominator()
        self.count += 1
        return self._calc_fit(yval)

    def reset(self, num_pts=None, sample_rate=None, force_clear=False) -> float:
        if sample_rate is not None:
            nxd = 1.0 / sample_rate
            if nxd != self.xdelta:
                self.xdelta = nxd
                force_clear = True
        if force_clear:
            self.yvals = []
        if num_pts is not None and num_pts != self.n:
            self.n = num_pts
            while len(self.yvals) > self.n:
                self.yvals.pop(0)
        self.ysum = sum(self.yvals)
        self.xysum = sum(j * self.xdelta * y
                         for j, y in enumerate(self.yvals))
        self._calc_denominator()
        self.count = 0
        return self._calc_fit(self.yvals[-1] if self.yvals else 0.0)

    def subtract_const(self, yval: float) -> float:
        self.yvals = [y - yval for y in self.yvals]
        return self.reset()

    def _calc_denominator(self):
        pts = len(self.yvals)
        if pts <= 1:
            return
        u = pts - 1
        self.denominator = (self.xdelta ** 2) * (
            u ** 3 / 3.0 + u ** 2 / 2.0 + u / 6.0 - u ** 2 * pts / 4.0)
        self.x_avg = self.xdelta * u / 2.0

    def _calc_fit(self, newest: float) -> float:
        pts = len(self.yvals)
        if pts > 1:
            m = (self.xysum - self.xdelta * (pts - 1) / 2.0 * self.ysum) \
                / self.denominator
            b = self.ysum / pts - m * self.x_avg
            return m * (self.xdelta * (pts - 1)) + b
        return newest if pts == 1 else 0.0


def demod_reference(x: np.ndarray, sps: int, num_avg: int, m: int,
                    phase_avg: int, differential: bool = False,
                    sample_rate: float = 1.0):
    """Run the reference per-sample recursion over a whole stream.

    Returns dict(soft, phase, sample_index) as numpy arrays (one entry per
    emitted symbol, exactly the reference's emission schedule).
    """
    samples: list[complex] = []
    energy: list[float] = []
    symbol_energy = [0.0] * sps
    index = 0
    last = 1.0 + 0.0j   # PARITY.md #2 (reference: 0 -> NaN first output)
    phase_estimate = 0.0
    fit = LinearFitRef(phase_avg, sample_rate)
    num_data_pts = sps * num_avg

    soft_out, phase_out, idx_out = [], [], []
    for v in np.asarray(x, np.complex64):
        v = complex(v)
        if sps > 1:
            samples.append(v)
            e = abs(v) ** 2
            energy.append(e)
            symbol_energy[index] += e
        if index == sps - 1:
            if len(samples) == num_data_pts or sps == 1:
                if sps > 1:
                    sample_index = int(np.argmax(symbol_energy))
                    sample = samples[sample_index]
                    idx_out.append(sample_index)
                else:
                    sample = v
                    idx_out.append(0)
                this_phase = math.atan2((sample ** m).imag, (sample ** m).real)
                wraps = round((phase_estimate - this_phase) / M_2PI)
                this_phase += wraps * M_2PI
                phase_estimate = fit.next(this_phase)
                phase_out.append(phase_estimate)
                correction = 0.0
                if differential:
                    decoded = sample / last
                    last = sample
                    sample = decoded
                else:
                    correction = -phase_estimate / m
                if m == 4:
                    correction += math.pi / 4.0
                soft_out.append(sample * complex(math.cos(correction),
                                                math.sin(correction)))
                if sps > 1:
                    for j in range(sps):
                        symbol_energy[j] -= energy[j]
                    del energy[:sps]
                    del samples[:sps]
            index = 0
        else:
            index += 1
    # End-of-packet re-wrap about m*2pi (cpp/psk_soft.cpp:592-603).
    wrap_value = M_2PI * m
    if abs(phase_estimate) > wrap_value:
        k = round(phase_estimate / wrap_value)
        phase_estimate = fit.subtract_const(k * wrap_value)
    return dict(soft=np.array(soft_out, np.complex64),
                phase=np.array(phase_out, np.float32),
                sample_index=np.array(idx_out, np.int32))
