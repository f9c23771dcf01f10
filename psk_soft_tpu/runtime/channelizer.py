"""Wideband frontend: stage a single capture-rate stream, emit demod-bank
input blocks through the polyphase DFT channelizer (ops/channelizer.py).

This is the host-side bookkeeping twin of runtime/resampler.py: ragged
wideband arrivals stage on the host; the device sees fixed-shape blocks.
The channelizer's (rows, C) output IS the steady step's time-major plane
layout, so ``step_planes`` feeds FullKernelBatchEngine.push_planes with
device-resident planes -- capture bytes to demodulated bits with zero host
transposes and zero device->host round trips on the steady path.

Deployment shape it replaces: a wideband capture fanned through an upstream
channelizer into C narrowband streams, each consumed by one instance of the
reference component (cpp/psk_soft.cpp serviceFunction is strictly
single-stream).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.channelizer import (channel_frequencies, channelize_block,
                               channelizer_init, prototype_taps)


class ChannelizerFrontEnd:
    """Streaming wideband -> C-channel splitter in front of a bank engine.

    Push capture-rate complex64 samples in any chunking; pop fixed blocks
    of ``rows`` channel-rate samples as time-major planes (device) or a
    channel-major array (host).  Streaming is block-split invariant (the
    K-1 branch-row carry rides between calls).
    """

    def __init__(self, channels: int, taps_per_branch: int = 8,
                 beta: float = 9.0, cutoff_scale: float = 1.0,
                 oversample: int = 1):
        if oversample not in (1, 2):
            raise ValueError(f"oversample must be 1 or 2, got {oversample}")
        self.channels = int(channels)
        self.taps_per_branch = int(taps_per_branch)
        # oversample=2: hop C/2 (channelize_block_os2) -- each channel
        # comes out at 2*fs/C so occupancy near the +-fs/(2C) band edge
        # survives; pair with ResamplerBank (or sps*2) downstream.
        self.oversample = int(oversample)
        self._taps = jnp.asarray(
            prototype_taps(channels, taps_per_branch, beta=beta,
                           cutoff_scale=cutoff_scale))
        self._carry = self._fresh_carry()
        self._staged: list[np.ndarray] = []
        self._staged_n = 0

    def _fresh_carry(self):
        if self.oversample == 2:
            from ..ops.channelizer import channelizer_os2_init
            return channelizer_os2_init(self.channels, self.taps_per_branch)
        return channelizer_init(self.channels, self.taps_per_branch)

    def push(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.complex64).ravel()
        if x.size:
            self._staged.append(x)
            self._staged_n += x.size

    def available_rows(self) -> int:
        """Channel-rate rows ready to emit."""
        return self._staged_n // self.channels * self.oversample

    def _take(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            s = self._staged[0]
            take = min(s.size, n - got)
            out[got:got + take] = s[:take]
            if take == s.size:
                self._staged.pop(0)
            else:
                self._staged[0] = s[take:]
            got += take
        self._staged_n -= n
        return out

    def _channelize(self, rows: int):
        if rows % self.oversample:
            raise ValueError(f"rows must be a multiple of "
                             f"oversample={self.oversample}")
        x = jnp.asarray(self._take(rows // self.oversample * self.channels))
        if self.oversample == 2:
            from ..ops.channelizer import channelize_block_os2
            self._carry, y = channelize_block_os2(self._taps, self._carry, x)
        else:
            self._carry, y = channelize_block(self._taps, self._carry, x)
        return y

    def step_planes(self, rows: int):
        """(re, im) device float32 planes of shape (rows, C), or None if
        fewer than ``rows`` rows are staged -- plug straight into
        FullKernelBatchEngine.push_planes."""
        if self.available_rows() < rows:
            return None
        y = self._channelize(rows)
        return y.real, y.imag

    def step_block(self, rows: int):
        """Channel-major (C, rows) complex64 host array, or None -- the
        BatchEngine.push_block form (one fetch; the ff pipeline re-uploads
        channel-major anyway)."""
        if self.available_rows() < rows:
            return None
        y = self._channelize(rows)
        re = np.asarray(y.real).T
        im = np.asarray(y.imag).T
        return (re + 1j * im).astype(np.complex64)

    def drain(self, planes: bool = True):
        """Emit every remaining full row at EOS (a trailing partial row --
        fewer than C wideband samples -- cannot form an output sample and
        is dropped, like the reference's sub-symbol tail)."""
        rows = self.available_rows()
        if not rows:
            return None
        return self.step_planes(rows) if planes else self.step_block(rows)

    def reset(self) -> None:
        """Clear staging and filter history (upstream flush semantics)."""
        self._carry = self._fresh_carry()
        self._staged = []
        self._staged_n = 0

    def frequencies(self, xdelta: float) -> np.ndarray:
        """Channel center frequencies for an input sample spacing."""
        return channel_frequencies(self.channels, xdelta)
