"""Wideband capture -> channelize -> demodulate, all on device.

Eight QPSK transmitters occupy eight equal bands of one wideband capture.
The polyphase DFT filterbank (ops/channelizer.py) splits the capture into
the 8-channel bank, and one BatchEngine demodulates every band -- the
pipeline a Redhawk deployment builds from a channelizer component plus
eight psk_soft instances.

Run on CPU:
    JAX_PLATFORMS=cpu python examples/wideband_bank.py
On a GPU just run it plainly.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.channelizer import ChannelizerFrontEnd
from psk_soft_tpu.runtime.engine import BatchEngine
from psk_soft_tpu.runtime.streams import PORT_SOFT, SRI
from psk_soft_tpu.testing.signals import sinc_interp


def main():
    C, sps, S = 8, 8, 300
    fs = 8e6                                  # capture rate
    rng = np.random.default_rng(0)
    n_rows = S * sps                          # per-channel samples
    n = np.arange(n_rows * C)
    wide = np.zeros(n_rows * C, np.complex64)
    sent = []
    for m in range(C):
        pts = np.exp(2j * np.pi * rng.integers(0, 4, S) / 4)
        sent.append(pts)
        up = sinc_interp(np.repeat(pts, sps).astype(np.complex64),
                         np.arange(n_rows * C) / C)
        wide += (up * np.exp(2j * np.pi * m * n / C)).astype(np.complex64)
    wide += (0.005 * rng.standard_normal(wide.size)).astype(np.complex64)

    cfg = DemodConfig(sps=sps, num_avg=50, constellation_size=4,
                      phase_avg=20)
    fe = ChannelizerFrontEnd(C, taps_per_branch=8)
    eng = BatchEngine(cfg, C, block_symbols=64)
    eng.set_input_sri(SRI(stream_id="wideband", xdelta=C / fs, mode=1))
    print("band centers (MHz):",
          np.round(fe.frequencies(1.0 / fs) / 1e6, 3))

    fe.push(wide)                             # arbitrary chunking works too
    softs = []
    while True:
        blk = fe.step_block(64 * sps)
        if blk is None:
            break
        eng.push_block(blk)
        while True:
            pkts = eng.step_packets()
            if pkts is None:
                break
            if pkts:
                softs.append(pkts[PORT_SOFT].data)
    soft = np.concatenate(softs, axis=-1)     # (C, symbols)

    # symbol accuracy per band (fold out the QPSK phase ambiguity)
    ang = np.angle(soft[:, 5:] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    err = np.minimum(ang, np.pi / 2 - ang)
    for m in range(C):
        print(f"band {m}: {soft.shape[1]} symbols, "
              f"p99 angular error {np.percentile(err[m], 99):.4f} rad")
    assert np.percentile(err, 99) < 0.1
    print("OK: every band demodulated from one wideband capture")
    return 0


if __name__ == "__main__":
    sys.exit(main())
