"""Checkpoint/resume: serialize the carry mid-stream, reload, and the
continuation must match the uninterrupted run exactly (the reference would
re-converge only after its numAvg*sps warm-up; SURVEY.md section 5)."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig, demod_init, make_demod_fn
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.utils.checkpoint import load_state, save_state
from psk_soft_tpu.testing.signals import gen_psk_channel


def test_checkpoint_roundtrip(tmp_path):
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    x, _ = gen_psk_channel(600, sps=8, m=4, snr_db=25, seed=0,
                           freq_offset=1e-4)
    fn = make_ff_demod_fn(cfg)

    st = ff_init(cfg)
    st, out1 = fn(st, jnp.asarray(x[:2400]))
    path = os.path.join(tmp_path, "ckpt.npz")
    save_state(path, st, cfg, extra={"stream": "s0", "symbols_done": 300})

    st2, cfg2, extra = load_state(path)
    assert cfg2 == cfg
    assert extra["symbols_done"] == 300
    for a, b in zip(st, st2):
        np.testing.assert_allclose(np.asarray(jnp.real(a)),
                                   np.asarray(jnp.real(b)), atol=0)

    # Resume == uninterrupted.
    st_resume, out_resume = fn(st2, jnp.asarray(x[2400:]))
    st_cont, out_cont = fn(st, jnp.asarray(x[2400:]))
    v = np.asarray(out_cont.valid)
    np.testing.assert_array_equal(np.asarray(out_resume.valid), v)
    np.testing.assert_allclose(np.asarray(out_resume.soft)[v],
                               np.asarray(out_cont.soft)[v], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_resume.bits)[v],
                                  np.asarray(out_cont.bits)[v])


def test_checkpoint_full_kernel_state(tmp_path):
    """FullState (single-kernel pipeline carry) roundtrips and resumes."""
    from psk_soft_tpu.models.blockpsk import make_ff_demod_fn as mkff
    from psk_soft_tpu.models.full import full_from_ff, make_full_demod_fn

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C = 128
    xs = np.stack([gen_psk_channel(512, sps=8, m=4, seed=i, snr_db=25)[0]
                   for i in range(C)])
    fn_ff = mkff(cfg, channels=C)
    from psk_soft_tpu.models.blockpsk import ff_init as ffi
    st_ff, _ = fn_ff(ffi(cfg, (C,)), jnp.asarray(xs))
    st = full_from_ff(cfg, st_ff)
    path = os.path.join(tmp_path, "full.npz")
    save_state(path, st, cfg)
    st2, cfg2, _ = load_state(path)
    assert type(st2).__name__ == "FullState"
    fn = make_full_demod_fn(cfg)
    x2 = np.roll(xs, 1, axis=0)
    _, o1 = fn(st, jnp.asarray(x2.real.T), jnp.asarray(x2.imag.T))
    _, o2 = fn(st2, jnp.asarray(x2.real.T), jnp.asarray(x2.imag.T))
    np.testing.assert_allclose(np.asarray(o2.soft_re), np.asarray(o1.soft_re),
                               atol=1e-6)


def test_checkpoint_exact_state(tmp_path):
    cfg = DemodConfig(sps=8, num_avg=30, constellation_size=8, phase_avg=10,
                      differential=True)
    x, _ = gen_psk_channel(200, sps=8, m=8, snr_db=25, seed=1,
                           differential=True)
    fn = make_demod_fn(cfg)
    st = demod_init(cfg)
    st, _ = fn(st, jnp.asarray(x))
    path = os.path.join(tmp_path, "exact.npz")
    save_state(path, st, cfg)
    st2, cfg2, _ = load_state(path)
    assert type(st2).__name__ == "DemodState"
    np.testing.assert_allclose(np.asarray(st.ring), np.asarray(st2.ring))
    assert int(st2.ring_fill) == int(st.ring_fill)


def test_checkpoint_i16_full_state(tmp_path):
    """An int16-window FullState (wire-format carry, steady-step int16
    mode) roundtrips dtype-exactly and resumes on the i16 kernel."""
    from psk_soft_tpu.models.blockpsk import ff_init as ffi
    from psk_soft_tpu.models.blockpsk import make_ff_demod_fn as mkff
    from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                          quantize_full_state)

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C = 128
    xs = np.stack([gen_psk_channel(512, sps=8, m=4, seed=i, snr_db=25)[0]
                   for i in range(C)])
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    st_ff, _ = mkff(cfg, channels=C)(ffi(cfg, (C,)), jnp.asarray(xs))
    st = quantize_full_state(full_from_ff(cfg, st_ff), scale)
    path = os.path.join(tmp_path, "full_i16.npz")
    save_state(path, st, cfg, extra={"ingest_scale": scale})
    st2, cfg2, extra = load_state(path)
    assert st2.win_re.dtype == jnp.int16
    assert extra["ingest_scale"] == scale
    x2 = np.roll(xs, 1, axis=0)
    ri = np.round(x2.real.T / scale).astype(np.int16)
    ii = np.round(x2.imag.T / scale).astype(np.int16)
    fn = make_full_demod_fn(cfg, in_scale=scale)
    _, o1 = fn(st, jnp.asarray(ri), jnp.asarray(ii))
    _, o2 = fn(st2, jnp.asarray(ri), jnp.asarray(ii))
    np.testing.assert_array_equal(np.asarray(o2.soft_re),
                                  np.asarray(o1.soft_re))


def test_checkpoint_engine_rolling_roundtrip(tmp_path):
    """Engine-level checkpoint/resume across the rolling fast path: save
    eng.full_state mid-stream (window materialized from the rolling
    planes), restore into a FRESH engine, and the resumed engine's outputs
    are bit-identical to the uninterrupted one."""
    from psk_soft_tpu.runtime.engine import FullKernelBatchEngine

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    C = 128
    xs = np.stack([gen_psk_channel(1536, sps=8, m=4, seed=400 + i,
                                   snr_db=25, timing_offset=i % 8)[0]
                   for i in range(C)])
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128)
    need = 128 * cfg.sps
    for i in range(0, 8 * need, need):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        eng.step()
    assert eng.steady and eng._win_stale     # rolling path engaged

    path = os.path.join(tmp_path, "eng.npz")
    save_state(path, eng.full_state, cfg)
    st2, cfg2, _ = load_state(path)
    eng2 = FullKernelBatchEngine(cfg2, C, block_symbols=128)
    eng2.restore_full_state(st2)
    assert eng2.steady

    for i in range(8 * need, 12 * need, need):
        blk = xs[:, i: i + need]
        for c in range(C):
            eng.push(c, blk[c])
            eng2.push(c, blk[c])
        o, o2 = eng.step(), eng2.step()
        np.testing.assert_array_equal(np.asarray(o.soft), np.asarray(o2.soft))
        np.testing.assert_array_equal(np.asarray(o.bits), np.asarray(o2.bits))


def test_checkpoint_equalizer_state(tmp_path):
    """EqState (converged CMA weights + FIR history) saves/resumes exactly:
    the resumed equalizer's output continues bit-identically."""
    import dataclasses
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.ops.equalizer import (EqConfig, eq_init, make_eq_fn,
                                            multipath)

    rng = np.random.default_rng(121)
    eq_cfg = EqConfig(taps=11, mu=5e-4)
    fn = make_eq_fn(eq_cfg)
    x = multipath(np.exp(2j * np.pi * rng.integers(0, 4, (2, 1200)) / 4),
                  [1.0, 0.0, 0.35]).astype(np.complex64)
    st = eq_init(eq_cfg, (2,))
    st, _, _ = fn(st, jnp.asarray(x[:, :800]))

    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=20)
    path = str(tmp_path / "eq.npz")
    save_state(path, st, cfg, extra={"eq_cfg": dataclasses.asdict(eq_cfg)})
    st2, cfg2, extra = load_state(path)
    assert extra["eq_cfg"]["taps"] == 11 and cfg2 == cfg
    _, y_a, _ = fn(st, jnp.asarray(x[:, 800:]))
    _, y_b, _ = fn(st2, jnp.asarray(x[:, 800:]))
    np.testing.assert_array_equal(jax.device_get(y_a), jax.device_get(y_b))


def test_checkpoint_viterbi_stream_state(tmp_path):
    """ViterbiStreamState (path metrics + decision window) resumes the
    streaming decode mid-stream with identical emitted bits."""
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.ops.fec import (CODE_K7, conv_encode, hard_llrs,
                                      viterbi_stream_init,
                                      viterbi_stream_step)

    rng = np.random.default_rng(122)
    bits = rng.integers(0, 2, (2, 900), np.int8)
    llrs = np.asarray(hard_llrs(conv_encode(CODE_K7, bits,
                                            terminate=False)))
    llrs = (llrs + 0.4 * rng.standard_normal(llrs.shape)).astype(np.float32)
    steps = llrs.reshape(2, -1, 2)
    st = viterbi_stream_init(CODE_K7, 2, 70)
    st, _ = viterbi_stream_step(CODE_K7, st, steps[:, :500])

    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=20)
    path = str(tmp_path / "vit.npz")
    save_state(path, st, cfg)
    st2, _, _ = load_state(path)
    _, a = viterbi_stream_step(CODE_K7, st, steps[:, 500:])
    _, b = viterbi_stream_step(CODE_K7, st2, steps[:, 500:])
    np.testing.assert_array_equal(jax.device_get(a), jax.device_get(b))


def test_checkpoint_seam_chain_state(tmp_path):
    """ChainState (nested: FullState + SeamTailState) roundtrips and the
    seam chain resumes EXACTLY -- a frame straddling the checkpoint
    boundary decodes identically to the uninterrupted run."""
    import jax
    from psk_soft_tpu.models.blockpsk import demod_block_ff
    from psk_soft_tpu.models.chain import (chain_init, chain_msg_bits,
                                           make_chain_fn)
    from psk_soft_tpu.models.full import full_from_ff
    from psk_soft_tpu.ops import tx
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.fec import CODE_K7
    from psk_soft_tpu.ops.framesync import FrameFormat

    C, sps, S = 128, 8, 256
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(13)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, CODE_K7, CRC16_CCITT)
    # One frame straddling the block-1/block-2 boundary (checkpoint cut).
    starts = [100, 230]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(fmt, infos, starts, 3 * S, code=CODE_K7,
                              crc=CRC16_CCITT, labeling="gray", seed=14)
    x = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx_row, (C, 1)) / 4
                               + 0.4)), sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)

    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x[:, :S * sps]))
    step = jax.jit(make_chain_fn(cfg, fmt, CODE_K7, 2, crc=CRC16_CCITT))

    def run(state, lo_blk, hi_blk, outs):
        for b in range(lo_blk, hi_blk):
            blk = x[:, b * S * sps:(b + 1) * S * sps]
            state, out = step(
                state, jnp.asarray(np.ascontiguousarray(blk.real.T)),
                jnp.asarray(np.ascontiguousarray(blk.imag.T)))
            outs.append(jax.tree_util.tree_map(np.asarray, out))
        return state

    st0 = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    outs_a = []
    st_mid = run(st0, 0, 1, outs_a)

    path = os.path.join(tmp_path, "chain.npz")
    save_state(path, st_mid, cfg, extra={"blocks_done": 1})
    st_loaded, cfg2, extra = load_state(path)
    assert cfg2 == cfg and extra["blocks_done"] == 1
    assert type(st_loaded).__name__ == "ChainState"

    outs_resume, outs_cont = [], []
    run(st_loaded, 1, 3, outs_resume)
    run(st_mid, 1, 3, outs_cont)
    n_found = 0
    for a, b in zip(outs_resume, outs_cont):
        np.testing.assert_array_equal(a.found, b.found)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.msg, b.msg)
        np.testing.assert_array_equal(a.ok, b.ok)
        n_found += int(a.found.sum())
    assert n_found >= C      # the straddling frame decoded post-resume


def test_checkpoint_front_chain_state(tmp_path):
    """FrontChainState (NCO freq/phase + optional AgcState + nested
    ChainState members) roundtrips, None AGC included."""
    from psk_soft_tpu.models.blockpsk import ff_init as ffi
    from psk_soft_tpu.models.chain import front_chain_init
    from psk_soft_tpu.models.full import full_from_ff
    from psk_soft_tpu.ops.agc import AgcConfig
    from psk_soft_tpu.ops.framesync import FrameFormat

    C = 128
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(15)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4)
    import jax
    from psk_soft_tpu.models.blockpsk import demod_block_ff
    x = (rng.standard_normal((C, 40 * 8 * 4))
         + 1j * rng.standard_normal((C, 40 * 8 * 4))).astype(np.complex64)
    st_ff = ffi(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x))
    freqs = np.linspace(1e-3, 2e-2, C).astype(np.float32)
    for agc_cfg in (None, AgcConfig(alpha=0.1, chunk=8)):
        st = front_chain_init(fmt, C, full_from_ff(cfg, st_ff),
                              agc_cfg=agc_cfg, freq=freqs)
        path = os.path.join(tmp_path, f"front_{agc_cfg is None}.npz")
        save_state(path, st, cfg)
        st2, _, _ = load_state(path)
        assert type(st2).__name__ == "FrontChainState"
        np.testing.assert_array_equal(np.asarray(st2.front.freq), freqs)
        if agc_cfg is None:
            assert st2.front.agc is None
        else:
            np.testing.assert_array_equal(np.asarray(st2.front.agc.power),
                                          np.asarray(st.front.agc.power))
        for a, b in zip(jax.tree_util.tree_leaves(st.demod),
                        jax.tree_util.tree_leaves(st2.demod)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
