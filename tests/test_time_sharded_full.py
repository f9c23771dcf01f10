"""Time+channel-sharded steady-state step vs the jnp sharded reference
and the single-device steady step (CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.parallel.mesh import make_mesh
from psk_soft_tpu.parallel.sharded_full import make_time_sharded_full_demod
from jax.sharding import NamedSharding, PartitionSpec as P

C, NS = 256, 2048  # 128 channels per channel shard


def _signals(m=4, diff=False):
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(NS * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _run_sharded(cfg, xs, meshdims, ns, mixed_params=None):
    chan_ax, time_ax = meshdims
    mesh = make_mesh(chan=chan_ax, time=time_ax)
    run = make_time_sharded_full_demod(cfg, mesh, ns,
                                       mixed_params=mixed_params)
    sh = NamedSharding(mesh, P("time", "chan"))
    x_re = jax.device_put(jnp.asarray(np.ascontiguousarray(xs.real.T)), sh)
    x_im = jax.device_put(jnp.asarray(np.ascontiguousarray(xs.imag.T)), sh)
    return run(x_re, x_im)


@pytest.mark.parametrize("m,diff,meshdims", [(4, False, (2, 4)),
                                             (4, False, (1, 8)),
                                             (8, False, (2, 2)),
                                             (4, True, (2, 4))])
def test_time_sharded_full_matches_ff(m, diff, meshdims):
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=m, phase_avg=20,
                      differential=diff)
    xs = _signals(m=m, diff=diff)
    soft_re, soft_im, phase, packed, idx, valid = _run_sharded(
        cfg, xs, meshdims, NS)
    soft_sh = (np.asarray(soft_re) + 1j * np.asarray(soft_im)).T  # (C, S)
    valid = np.asarray(valid).T
    idx_sh = np.asarray(idx).T

    # Reference: single-device feed-forward over the whole stream.
    fn = make_ff_demod_fn(cfg, channels=C)
    _, out = fn(ff_init(cfg, (C,)), jnp.asarray(xs))
    v_ff = np.asarray(out.valid)
    soft_ff_full = np.zeros((C, NS), np.complex64)
    idx_ff_full = np.zeros((C, NS), np.int32)
    # ff output o (valid) is stream symbol o-(num_avg-1).
    a1 = cfg.num_avg - 1
    soft_ff_full[:, : NS - a1] = np.asarray(out.soft)[:, a1:]
    idx_ff_full[:, : NS - a1] = np.asarray(out.sample_index)[:, a1:]

    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal(idx_sh[valid], idx_ff_full[valid])
    d = soft_sh[valid] - soft_ff_full[valid]
    # Global M-fold rotation ambiguity is legal (like the reference);
    # remove the best rotation before comparing.
    errs = [np.abs(d_r).max() for d_r in
            (soft_sh[valid] * np.exp(2j * np.pi * r / m)
             - soft_ff_full[valid] for r in range(m))]
    assert min(errs) < 5e-3, min(errs)
    # Bits equal modulo the same rotation only when r == 0 wins; check
    # constellation consistency instead: packed bits re-derive from soft.
    from psk_soft_tpu.ops import slicers
    re_sliced = np.asarray(slicers.slice_bits(m, jnp.asarray(soft_sh[valid])))
    got = np.asarray(packed).T[valid]
    vals = (re_sliced[:, 0] + 2 * re_sliced[:, 1] + 4 * re_sliced[:, 2])
    np.testing.assert_array_equal(got, vals)


def _ff_reference(cfg, xs, ns, c):
    """Single-device feed-forward over the whole stream, re-indexed so
    column s is stream symbol s (ff output o is stream symbol o-(numAvg-1))."""
    fn = make_ff_demod_fn(cfg, channels=c)
    _, out = fn(ff_init(cfg, (c,)), jnp.asarray(xs))
    a1 = cfg.num_avg - 1
    soft = np.zeros((c, ns), np.complex64)
    idx = np.zeros((c, ns), np.float32)
    soft[:, : ns - a1] = np.asarray(out.soft)[:, a1:]
    idx[:, : ns - a1] = np.asarray(out.sample_index)[:, a1:]
    return soft, idx


def test_time_sharded_mf_interp_matches_ff():
    """BASELINE config-3 profile (8-PSK + RRC + fractional timing) on the
    time-sharded flagship path: the FIR's (ntaps-1)-sample filtered-timeline
    lag rides the left halo, so the FF symbol grid survives sharding."""
    from psk_soft_tpu.testing.signals import gen_psk_channel

    ns, c = 1024, 256
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    xs = np.stack([
        gen_psk_channel(ns, sps=8, m=8, seed=900 + i, snr_db=25,
                        freq_offset=1e-4, pulse="rrc")[0] for i in range(c)])
    soft_re, soft_im, phase, packed, idx, valid = _run_sharded(
        cfg, xs, (2, 2), ns)
    soft_sh = (np.asarray(soft_re) + 1j * np.asarray(soft_im)).T
    valid = np.asarray(valid).T
    idx_sh = np.asarray(idx).T
    soft_ff, idx_ff = _ff_reference(cfg, xs, ns, c)
    assert valid.any() and (~valid).any()
    np.testing.assert_allclose(idx_sh[valid], idx_ff[valid], atol=1e-3)
    errs = [np.abs(soft_sh[valid] * np.exp(2j * np.pi * r / 8)
                   - soft_ff[valid]).max() for r in range(8)]
    assert min(errs) < 5e-3, min(errs)


def test_time_sharded_boxcar_matches_ff():
    """Boxcar matched filter (odd ntaps-1 halo extension) on sps=10."""
    from psk_soft_tpu.testing.signals import gen_psk_channel

    ns, c = 768, 256
    cfg = DemodConfig(sps=10, num_avg=30, constellation_size=4, phase_avg=16,
                      matched_filter="boxcar")
    xs = np.stack([
        gen_psk_channel(ns, sps=10, m=4, seed=1200 + i, snr_db=25,
                        freq_offset=1e-4, pulse="rect")[0] for i in range(c)])
    soft_re, soft_im, phase, packed, idx, valid = _run_sharded(
        cfg, xs, (2, 3), ns)
    soft_sh = (np.asarray(soft_re) + 1j * np.asarray(soft_im)).T
    valid = np.asarray(valid).T
    soft_ff, idx_ff = _ff_reference(cfg, xs, ns, c)
    np.testing.assert_array_equal(np.asarray(idx).T[valid], idx_ff[valid])
    errs = [np.abs(soft_sh[valid] * np.exp(2j * np.pi * r / 4)
                   - soft_ff[valid]).max() for r in range(4)]
    assert min(errs) < 5e-3, min(errs)


def test_time_sharded_mixed_matches_xla():
    """Per-channel (M, differential) bank time-sharded (BASELINE config 4 on
    the multi-chip flagship path) vs the XLA mixed pipeline."""
    from psk_soft_tpu.models.mixed import (MixedParams, make_mixed_demod_fn,
                                           mixed_init)

    ns, c = 1024, 256
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(7)
    ms = rng.choice([2, 4, 8], c)
    diffs = rng.random(c) < 0.5
    xs = []
    for i in range(c):
        r = np.random.default_rng(1500 + i)
        m = int(ms[i])
        j = r.integers(0, m, ns)
        pts = np.exp(2j * np.pi * j / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(ns * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(ns))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    params = MixedParams.make(ms, diffs)
    soft_re, soft_im, phase, packed, idx, valid = _run_sharded(
        cfg, xs, (2, 2), ns, mixed_params=params)
    soft_sh = (np.asarray(soft_re) + 1j * np.asarray(soft_im)).T
    valid = np.asarray(valid).T
    packed_sh = np.asarray(packed).T

    fn = make_mixed_demod_fn(cfg)
    _, out = fn(params, mixed_init(cfg, c), jnp.asarray(xs))
    a1 = cfg.num_avg - 1
    soft_ref = np.zeros((c, ns), np.complex64)
    soft_ref[:, : ns - a1] = np.asarray(out.soft)[:, a1:]
    bits_ref = np.zeros((c, ns, 3), np.int32)
    bits_ref[:, : ns - a1] = np.asarray(out.bits)[:, a1:]
    idx_ref = np.zeros((c, ns), np.int32)
    idx_ref[:, : ns - a1] = np.asarray(out.sample_index)[:, a1:]

    np.testing.assert_array_equal(np.asarray(idx).T[valid], idx_ref[valid])
    # Shard 0 shares the XLA run's phase origin; later shards are rewound to
    # it by the seam correction, so comparison is direct (no rotation scan).
    assert np.abs(soft_sh[valid] - soft_ref[valid]).max() < 5e-3
    packed_ref = (bits_ref[..., 0] + 2 * bits_ref[..., 1]
                  + 4 * bits_ref[..., 2])
    np.testing.assert_array_equal(packed_sh[valid], packed_ref[valid])


def test_time_sharded_i16_matches_f32():
    """int16 wire planes through the time-sharded path: the halos ppermute
    2-byte planes (half the ICI seam bytes) and each shard's kernel runs in
    int16 mode; outputs must match the f32 run on the dequantized signal."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _signals(m=4, diff=False)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re_w = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im_w = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    xq = ((re_w.astype(np.float32) * scale).T
          + 1j * (im_w.astype(np.float32) * scale).T).astype(np.complex64)

    mesh = make_mesh(chan=2, time=4)
    sh = NamedSharding(mesh, P("time", "chan"))
    run16 = make_time_sharded_full_demod(cfg, mesh, NS,
                                         in_scale=scale)
    o16 = run16(jax.device_put(jnp.asarray(re_w), sh),
                jax.device_put(jnp.asarray(im_w), sh))
    run32 = make_time_sharded_full_demod(cfg, mesh, NS)
    o32 = run32(
        jax.device_put(jnp.asarray(np.ascontiguousarray(xq.real.T)), sh),
        jax.device_put(jnp.asarray(np.ascontiguousarray(xq.imag.T)), sh))
    valid = np.asarray(o16[5])
    np.testing.assert_array_equal(valid, np.asarray(o32[5]))
    np.testing.assert_array_equal(np.asarray(o16[4])[valid],
                                  np.asarray(o32[4])[valid])   # idx
    np.testing.assert_array_equal(np.asarray(o16[3])[valid],
                                  np.asarray(o32[3])[valid])   # bits
    d = np.abs((np.asarray(o16[0]) + 1j * np.asarray(o16[1]))
               - (np.asarray(o32[0]) + 1j * np.asarray(o32[1])))[valid]
    assert d.max() < 1e-5, d.max()


def test_time_sharded_soft_i8_quantizes_after_seam_correction():
    """soft_i8_scale on the time-sharded path: int8 output planes whose
    dequantized values sit within 0.5/scale of the f32 run (quantization
    happens AFTER the seam phase-origin rotation, so bits/idx/valid are
    identical to the f32 run by construction)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _signals(m=4, diff=False)
    mesh = make_mesh(chan=2, time=4)
    sh = NamedSharding(mesh, P("time", "chan"))
    xr = jax.device_put(jnp.asarray(np.ascontiguousarray(xs.real.T)), sh)
    xi = jax.device_put(jnp.asarray(np.ascontiguousarray(xs.imag.T)), sh)
    run32 = make_time_sharded_full_demod(cfg, mesh, NS)
    run8 = make_time_sharded_full_demod(cfg, mesh, NS,
                                        soft_i8_scale=100.0)
    o32 = run32(xr, xi)
    o8 = run8(xr, xi)
    valid = np.asarray(o8[5])
    np.testing.assert_array_equal(valid, np.asarray(o32[5]))
    np.testing.assert_array_equal(np.asarray(o8[3]), np.asarray(o32[3]))
    assert np.asarray(o8[0]).dtype == np.int8
    for q, f in ((o8[0], o32[0]), (o8[1], o32[1])):
        d = np.abs(np.asarray(q).astype(np.float32) / 100.0
                   - np.clip(np.asarray(f), -1.27, 1.27))[valid]
        assert d.max() <= 0.5 / 100.0 + 1e-6, d.max()
