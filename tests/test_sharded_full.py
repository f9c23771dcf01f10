"""Channel-sharded steady-state step on the virtual CPU mesh (inside
shard_map)."""

import numpy as np
import jax
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import full_from_ff, make_full_demod_fn
from psk_soft_tpu.parallel.mesh import make_mesh
from psk_soft_tpu.parallel.sharded_full import (channel_sharding_tm,
                                                make_sharded_full_demod,
                                                shard_full_state)
from psk_soft_tpu.testing.signals import gen_psk_channel

C, NS = 256, 512  # 2 chan shards x 128 channels


def test_sharded_full_matches_single_device():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = np.stack([gen_psk_channel(NS, sps=8, m=4, seed=i, snr_db=25,
                                   freq_offset=1e-4)[0] for i in range(C)])
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    x_re = jnp.asarray(np.ascontiguousarray(run.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(run.imag.T))

    # single-device
    fn1 = make_full_demod_fn(cfg)
    _, out1 = fn1(st, x_re, x_im)

    # channel-sharded over 2 devices
    mesh = make_mesh(chan=2, time=1)
    sh = channel_sharding_tm(mesh)
    st_sh = shard_full_state(st, mesh)
    fn2 = make_sharded_full_demod(cfg, mesh)
    _, out2 = fn2(st_sh, jax.device_put(x_re, sh), jax.device_put(x_im, sh))

    np.testing.assert_allclose(np.asarray(out2.soft_re),
                               np.asarray(out1.soft_re), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out2.bits_packed),
                                  np.asarray(out1.bits_packed))
    np.testing.assert_array_equal(np.asarray(out2.sample_index),
                                  np.asarray(out1.sample_index))


def test_sharded_full_output_profiles():
    """soft_i8 / debug_ports=False / packed outputs shard over the chan
    axis unchanged (the axis is communication-free)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = np.stack([gen_psk_channel(NS, sps=8, m=4, seed=i, snr_db=25,
                                   freq_offset=1e-4)[0] for i in range(C)])
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    x_re = jnp.asarray(np.ascontiguousarray(run.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(run.imag.T))

    fn1 = make_full_demod_fn(cfg)
    _, out1 = fn1(st, x_re, x_im)

    mesh = make_mesh(chan=2, time=1)
    sh = channel_sharding_tm(mesh)
    st_sh = shard_full_state(st, mesh)
    fn2 = make_sharded_full_demod(cfg, mesh,
                                  soft_i8_scale=100.0, debug_ports=False)
    _, out2 = fn2(st_sh, jax.device_put(x_re, sh), jax.device_put(x_im, sh))

    assert out2.phase is None and out2.sample_index is None
    assert np.asarray(out2.soft_re).dtype == np.int8
    np.testing.assert_array_equal(np.asarray(out2.bits_packed),
                                  np.asarray(out1.bits_packed))
    d = np.abs(np.asarray(out2.soft_re).astype(np.float32) / 100.0
               - np.asarray(out1.soft_re))
    assert d.max() <= 0.5 / 100.0 + 1e-6
