"""Multi-device demodulation over a (channel x time) mesh.

One stream's TIME axis shards across devices (halo exchange + prefix
combine at seams) while channels shard communication-free -- the scaling
axes of BASELINE.md.  Runs on a virtual 8-device CPU mesh out of the box;
unchanged on a multi-GPU host.

Run:  JAX_PLATFORMS=cpu \
          XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python examples/sharded_mesh.py
"""

import os
import sys

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.parallel.mesh import make_mesh
from psk_soft_tpu.parallel.sharded import make_sharded_demod


def main():
    n = len(jax.devices())
    chan, time = (2, n // 2) if n % 2 == 0 and n > 1 else (1, n)
    mesh = make_mesh(chan=chan, time=time)
    print(f"devices: {n} ({jax.devices()[0].platform}), "
          f"mesh: chan={chan} x time={time}")

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C, S = 16, 1024          # 16 channels, 1024 symbols split over `time`
    rng = np.random.default_rng(0)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, (C, S)) / 4)
    # Timing-decisive pulses (energy on intra-symbol index 3): rectangular
    # pulses carry no timing information, so the windowed argmax ties and
    # different-but-equally-valid decisions appear across shardings
    # (PARITY.md "tie sensitivity").
    x = np.zeros((C, S * cfg.sps), np.complex64)
    x[:, 3::cfg.sps] = pts * np.exp(
        2j * np.pi * 2e-4 * cfg.sps * np.arange(S))[None]
    x += (0.005 * rng.standard_normal(x.shape)).astype(np.complex64)

    fn = make_sharded_demod(cfg, mesh, total_symbols=S)
    out = jax.device_get(fn(jnp.asarray(x)))
    v = out.valid[0]
    print(f"{int(v.sum())} symbols/channel demodulated across the mesh")

    # Seam invariance: identical to the single-device feed-forward run.
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
    ff = make_ff_demod_fn(cfg, channels=C)
    _, ref = ff(ff_init(cfg, (C,)), jnp.asarray(x))
    ref = jax.device_get(ref)
    err = np.abs(out.soft[:, v] - ref.soft[:, ref.valid[0]]).max()
    print(f"max |sharded - single-device| soft error: {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    main()
