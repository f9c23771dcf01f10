"""Production channel-bank demodulation on the flagship engine.

128 channels through FullKernelBatchEngine: warm-up on the flexible path,
then the time-major steady step (one jitted program per block), with
int8-quantized soft decisions and a mid-stream checkpoint/resume.

Run on CPU:
    JAX_PLATFORMS=cpu python examples/bank_demod.py
On a GPU just run it plainly.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI, PORT_BITS, PORT_SOFT


def main():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C, S = 128, 128
    eng = FullKernelBatchEngine(cfg, C, block_symbols=S,
                                soft_i8=True)          # int8 soft wire format
    eng.set_input_sri(SRI(stream_id="bank", xdelta=1e-6))

    rng = np.random.default_rng(0)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, (C, S * 12)) / 4)
    xs = np.repeat(pts, cfg.sps, axis=1).astype(np.complex64)
    xs *= np.exp(2j * np.pi * 1e-4 * np.arange(xs.shape[1]))[None]
    xs += (0.01 * rng.standard_normal(xs.shape)).astype(np.complex64)

    ckpt = None
    need = S * cfg.sps
    for k, i in enumerate(range(0, xs.shape[1], need)):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        pkts = eng.step_packets()
        if pkts:
            soft = pkts[PORT_SOFT].data              # (C, S) complex64
            print(f"block {k}: steady={eng.steady} "
                  f"soft {soft.shape}, bits {pkts[PORT_BITS].data.shape}")
        if eng.steady and ckpt is None:
            ckpt = eng.full_state                    # snapshot the carry
            print(f"block {k}: checkpointed the steady carry "
                  f"(planes {np.asarray(ckpt.planes).shape})")

    # Resume a fresh engine from the checkpoint: no re-warm-up needed.
    eng2 = FullKernelBatchEngine(cfg, C, block_symbols=S, soft_i8=True)
    eng2.set_input_sri(SRI(stream_id="bank-resumed", xdelta=1e-6))
    eng2.restore_full_state(ckpt)
    print(f"resumed engine is steady={eng2.steady} without warm-up")
    print("metrics:", eng.metrics)


if __name__ == "__main__":
    main()
