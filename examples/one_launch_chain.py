"""The receive chain as ONE device program (models/chain.py).

Where examples/coded_link.py drives the per-stage streaming surface
(engine -> FrameSyncer -> FecFrameDecoder), this is the maximum-throughput
path: demod -> time-major frame sync -> Viterbi -> CRC composed into a
single jitted step with no host round trips -- the body
`bench.py --profile chain` measures and `eval/scaling.chain_scaling_report`
scales over a mesh.

Run on CPU:
    JAX_PLATFORMS=cpu python examples/one_launch_chain.py
On a GPU just run it plainly.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
from psk_soft_tpu.models.chain import (chain_init, chain_msg_bits,
                                       make_chain_fn)
from psk_soft_tpu.models.full import full_from_ff
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT
from psk_soft_tpu.ops.fec import CODE_K7
from psk_soft_tpu.ops.framesync import FrameFormat

C, SPS, S = 128, 8, 512        # channels, samples/symbol, symbols/block
cfg = DemodConfig(sps=SPS, num_avg=40, constellation_size=4, phase_avg=30)
code, crc = CODE_K7, CRC16_CCITT
rng = np.random.default_rng(1)
fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                  threshold=0.7)
n_msg = chain_msg_bits(fmt, code, crc)

# TX: two CRC-protected, K=7-coded frames per block per channel.
rows = [60, 300]                             # detection rows (output grid)
starts = [r - (cfg.num_avg - 1) for r in rows]   # demod output lags input
infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
idx = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                      labeling="gray", seed=2)
x = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx, (C, 1)) / 4 + 0.3)),
              SPS, axis=1).astype(np.complex64)
x += 0.02 * (rng.standard_normal(x.shape)
             + 1j * rng.standard_normal(x.shape)).astype(np.complex64)

# Converge the tracker through the warm-up pipeline, hand off to the
# steady step, then run the WHOLE chain as one jitted step per block.
st_ff = ff_init(cfg, (C,))
warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
st_ff, _ = warm(st_ff, jnp.asarray(x))
state = chain_init(fmt, C, full_from_ff(cfg, st_ff))

step = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
x_re = jnp.asarray(np.ascontiguousarray(x.real.T))
x_im = jnp.asarray(np.ascontiguousarray(x.imag.T))

state, out = step(state, x_re, x_im)         # first block
state, out = step(state, x_re, x_im)         # steady block
found = np.asarray(out.found)
ok = np.asarray(out.ok)
msg = np.asarray(out.msg)
assert found.all() and ok.all()
assert np.array_equal(msg, np.tile(np.stack(infos), (C, 1, 1)))
print(f"one-launch chain: {C} channels x {len(rows)} frames/block -- all "
      f"frames found at rows {np.asarray(out.pos)[0].tolist()}, every CRC "
      f"green, {msg.size} message bits exact")
