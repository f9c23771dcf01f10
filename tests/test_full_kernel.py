"""Steady-state time-major demod step (models/full) vs the feed-forward
reference (models/blockpsk) on the same converged carry."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (demod_block_full, full_from_ff,
                                      make_full_demod_fn,
                                      make_scanned_full_demod_fn,
                                      to_demod_outputs)

C, NS = 128, 768


def _channels(m=4, diff=False, sps=8, c=C):
    out = []
    for i in range(c):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(NS * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 2e-4 * sps * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


@pytest.mark.parametrize("m,diff", [(4, False), (2, False), (8, False),
                                    (4, True)])
def test_full_kernel_matches_blockpsk_steady(m, diff):
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=m, phase_avg=20,
                      differential=diff)
    xs = _channels(m=m, diff=diff)
    warm, run = np.split(xs, [256 * 8], axis=1)

    # Converge the FF pipeline, then hand the carry to the full kernel.
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st_full = full_from_ff(cfg, st_ff)
    fn_full = make_full_demod_fn(cfg)
    st_full, out_full = fn_full(st_full, jnp.asarray(run.real.T),
                                jnp.asarray(run.imag.T))
    out_full = to_demod_outputs(cfg, out_full)

    st_ff, out_ff = fn_ff(st_ff, jnp.asarray(run))
    assert np.asarray(out_ff.valid).all()
    np.testing.assert_array_equal(np.asarray(out_full.sample_index),
                                  np.asarray(out_ff.sample_index))
    np.testing.assert_allclose(np.asarray(out_full.phase),
                               np.asarray(out_ff.phase), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out_full.soft),
                               np.asarray(out_ff.soft), atol=3e-3)
    nb = cfg.bits_per_symbol
    np.testing.assert_array_equal(np.asarray(out_full.bits)[..., :nb],
                                  np.asarray(out_ff.bits)[..., :nb])


def test_full_kernel_multiblock_carry():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels()
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    fn_full = make_full_demod_fn(cfg)

    st = full_from_ff(cfg, st_ff)
    st1, one = fn_full(st, jnp.asarray(run.real.T), jnp.asarray(run.imag.T))

    st = full_from_ff(cfg, st_ff)
    parts = []
    for blk in np.split(run, 2, axis=1):
        st, o = fn_full(st, jnp.asarray(blk.real.T), jnp.asarray(blk.imag.T))
        parts.append(o)
    soft_parts = np.concatenate([np.asarray(p.soft_re) for p in parts], axis=0)
    np.testing.assert_allclose(soft_parts, np.asarray(one.soft_re), atol=1e-4)
    planes_a = np.asarray(st.planes)
    planes_b = np.asarray(st1.planes)
    np.testing.assert_allclose(planes_a, planes_b, atol=1e-3)


@pytest.mark.parametrize("sps,n_blocks", [(8, 2), (10, 3)])
def test_full_kernel_double_buffer_bitexact(sps, n_blocks):
    """One dispatch scanning the step over a stack of blocks decodes the
    same stream as stepping block by block (sps=10 puts the window at a
    row count that is not a multiple of 8)."""
    cfg = DemodConfig(sps=sps, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels(sps=sps)
    warm, run = np.split(xs, [256 * sps], axis=1)
    run = run[:, :(run.shape[1] // (n_blocks * sps)) * n_blocks * sps]
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st0 = full_from_ff(cfg, st_ff)
    blocks = np.split(run, n_blocks, axis=1)
    xr = jnp.asarray(np.stack([b.real.T for b in blocks]))
    xi = jnp.asarray(np.stack([b.imag.T for b in blocks]))
    st_scan, out_scan = make_scanned_full_demod_fn(cfg)(st0, xr, xi)
    step = make_full_demod_fn(cfg)
    st = st0
    for i in range(n_blocks):
        st, out = step(st, xr[i], xi[i])
        np.testing.assert_array_equal(np.asarray(out.bits_packed),
                                      np.asarray(out_scan.bits_packed[i]))
        np.testing.assert_array_equal(np.asarray(out.sample_index),
                                      np.asarray(out_scan.sample_index[i]))
        np.testing.assert_allclose(np.asarray(out.soft_re),
                                   np.asarray(out_scan.soft_re[i]),
                                   atol=1e-5)
    np.testing.assert_allclose(np.asarray(st.planes),
                               np.asarray(st_scan.planes), atol=1e-4)


def test_full_kernel_guards():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=5)
    with pytest.raises(ValueError, match="phase_avg"):
        from psk_soft_tpu.models.blockpsk import ff_init as fi
        full_from_ff(cfg, fi(cfg, (C,)))


def test_full_kernel_packed_int8_outputs():
    """pack_out=True emits int8 bits/sampleIndex planes bit-identical to the
    int32 ones (and auto mode packs whenever sps fits int8)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20)
    xs = _channels(m=8)
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    xr = jnp.asarray(run.real.T)
    xi = jnp.asarray(run.imag.T)
    _, o32 = demod_block_full(cfg, st, xr, xi, pack_out=False)
    _, o8 = demod_block_full(cfg, st, xr, xi, pack_out=True)
    assert o8.bits_packed.dtype == jnp.int8
    assert o8.sample_index.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(o32.bits_packed),
                                  np.asarray(o8.bits_packed))
    np.testing.assert_array_equal(np.asarray(o32.sample_index),
                                  np.asarray(o8.sample_index))
    np.testing.assert_array_equal(np.asarray(o32.soft_re),
                                  np.asarray(o8.soft_re))
    # Auto mode packs.
    _, oa = demod_block_full(cfg, st, xr, xi)
    assert oa.bits_packed.dtype == jnp.int8
    # Explicit pack with sample indices past the int8 range is rejected,
    # not silently wrapped.
    cfg_w = DemodConfig(sps=130, num_avg=2, constellation_size=4,
                        phase_avg=20)
    stp = full_from_ff(cfg_w, ff_init(cfg_w, (C,)))
    with pytest.raises(ValueError, match="pack_out"):
        demod_block_full(cfg_w, stp,
                         jnp.zeros((4 * 130, C), jnp.float32),
                         jnp.zeros((4 * 130, C), jnp.float32),
                         pack_out=True)


def test_full_kernel_rolling_window_parity():
    """Rolling-window mode (window read in place from the previous block's
    planes) is bit-identical to the window-carry path across a multi-block
    chain, and the planes carry stays bit-identical too."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    from psk_soft_tpu.models.full import demod_block_full_rolling

    xs = _channels()
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    blocks = np.split(run, 4, axis=1)
    planes_blocks = [(jnp.asarray(b.real.T), jnp.asarray(b.imag.T))
                     for b in blocks]

    # Legacy chain.
    st = full_from_ff(cfg, st_ff)
    legacy = []
    for xr, xi in planes_blocks:
        st, o = demod_block_full(cfg, st, xr, xi)
        legacy.append(o)

    # Rolling chain: block 0 legacy (no previous planes), then rolling.
    st2 = full_from_ff(cfg, st_ff)
    st2, o0 = demod_block_full(cfg, st2, *planes_blocks[0])
    rolling = [o0]
    planes = st2.planes
    for i in range(1, 4):
        planes, o = demod_block_full_rolling(
            cfg, planes, *planes_blocks[i - 1], *planes_blocks[i])
        rolling.append(o)

    for a, b in zip(legacy, rolling):
        np.testing.assert_array_equal(np.asarray(a.soft_re),
                                      np.asarray(b.soft_re))
        np.testing.assert_array_equal(np.asarray(a.soft_im),
                                      np.asarray(b.soft_im))
        np.testing.assert_array_equal(np.asarray(a.phase),
                                      np.asarray(b.phase))
        np.testing.assert_array_equal(np.asarray(a.bits_packed),
                                      np.asarray(b.bits_packed))
        np.testing.assert_array_equal(np.asarray(a.sample_index),
                                      np.asarray(b.sample_index))
    np.testing.assert_array_equal(np.asarray(st.planes), np.asarray(planes))


def test_full_kernel_rolling_rejects_mf():
    """Rolling mode requires the split-DMA path: matched-filter configs are
    rejected with a clear error instead of a silent concat."""
    from psk_soft_tpu.models.full import demod_block_full_rolling

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20,
                      matched_filter="rrc")
    z = jnp.zeros((512 * 8, C), jnp.float32)
    with pytest.raises(ValueError, match="rolling"):
        demod_block_full_rolling(cfg, jnp.zeros((56, C), jnp.float32),
                                 z, z, z, z)


def test_full_kernel_debug_ports_off():
    """debug_ports=False drops the phase/sampleIndex planes (None) while
    soft/bits stay bit-identical -- including through the rolling mode."""
    from psk_soft_tpu.models.full import (demod_block_full_rolling,
                                          to_demod_outputs)

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels()
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    xr = jnp.asarray(run.real.T)
    xi = jnp.asarray(run.imag.T)
    st_on, on = demod_block_full(cfg, st, xr, xi)
    st_off, off = demod_block_full(cfg, st, xr, xi, debug_ports=False)
    assert off.phase is None and off.sample_index is None
    np.testing.assert_array_equal(np.asarray(on.soft_re),
                                  np.asarray(off.soft_re))
    np.testing.assert_array_equal(np.asarray(on.bits_packed),
                                  np.asarray(off.bits_packed))
    np.testing.assert_array_equal(np.asarray(st_on.planes),
                                  np.asarray(st_off.planes))
    do = to_demod_outputs(cfg, off)
    assert do.phase is None and do.sample_index is None
    # Rolling x debug-off compose.
    half = run.shape[1] // 2
    p2, o2 = demod_block_full_rolling(
        cfg, st_off.planes,
        jnp.asarray(run[:, :half].real.T), jnp.asarray(run[:, :half].imag.T),
        jnp.asarray(run[:, half:].real.T), jnp.asarray(run[:, half:].imag.T),
        debug_ports=False)
    assert o2.phase is None


@pytest.mark.parametrize("c", [100, 3])
def test_full_step_any_channel_count(c):
    """Channel counts that are not a multiple of 128 run and match the
    feed-forward reference (the step has no lane-tile rule)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels(c=c)
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=c)
    st_ff, _ = fn_ff(ff_init(cfg, (c,)), jnp.asarray(warm))
    st, out = make_full_demod_fn(cfg)(full_from_ff(cfg, st_ff),
                                      jnp.asarray(run.real.T),
                                      jnp.asarray(run.imag.T))
    assert out.soft_re.shape == (run.shape[1] // 8, c)
    assert st.planes.shape[1] == c
    _, out_ff = fn_ff(st_ff, jnp.asarray(run))
    out = to_demod_outputs(cfg, out)
    np.testing.assert_allclose(np.asarray(out.soft),
                               np.asarray(out_ff.soft), atol=3e-3)
    np.testing.assert_array_equal(np.asarray(out.bits)[..., :2],
                                  np.asarray(out_ff.bits)[..., :2])


def test_full_step_rejects_bad_shapes():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st = full_from_ff(cfg, ff_init(cfg, (C,)))
    z = jnp.zeros((64 * 8 + 3, C), jnp.float32)
    with pytest.raises(ValueError, match="multiple of sps"):
        demod_block_full(cfg, st, z, z)
    z = jnp.zeros((64 * 8, C + 1), jnp.float32)
    with pytest.raises(ValueError, match="win planes"):
        demod_block_full(cfg, st, z, z)
