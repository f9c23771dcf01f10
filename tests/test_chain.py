"""models/chain.py: the public one-launch receive chain.

The composition itself is equivalence-gated stage by stage elsewhere
(kernel parity, sync vs dense criterion, Viterbi vs oracle, CRC); here we
gate the assembled API end-to-end on a synthetic coded stream: every
planted frame found at its position, every payload decoded to the
transmitted message bits, every CRC green -- the same asserts the chain
benchmark runs before timing (bench.py run_chain).
"""

import numpy as np
import jax
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
from psk_soft_tpu.models.chain import (ChainOutputs, chain_init,
                                       chain_msg_bits, make_chain_fn)
from psk_soft_tpu.models.full import full_from_ff
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT
from psk_soft_tpu.ops.fec import CODE_K7
from psk_soft_tpu.ops.framesync import FrameFormat


import pytest


@pytest.mark.parametrize("m", [4, 8])
def test_chain_fn_decodes_planted_frames(m):
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=m,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(5)
    fmt = FrameFormat(uw=tuple(rng.integers(0, m, 32)), payload=48, m=m,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    a1 = cfg.num_avg - 1
    # Two frames per block, planted so they land fully inside the demod
    # output block (output lags input by num_avg - 1 symbols).
    rows = [60, 300]
    starts = [r - a1 for r in rows]
    assert all(p + fmt.frame_len <= S for p in starts)
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                              labeling="gray", seed=3)
    x_np = np.repeat(np.exp(1j * (2 * np.pi
                                  * np.tile(idx_row, (C, 1)) / m + 0.4)),
                     sps, axis=1).astype(np.complex64)
    x_np += (0.01 * (rng.standard_normal(x_np.shape)
                     + 1j * rng.standard_normal(x_np.shape))
             ).astype(np.complex64)

    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    x_re = jnp.asarray(np.ascontiguousarray(x_np.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(x_np.imag.T))

    step = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    state, out = step(state, x_re, x_im)
    state, out = step(state, x_re, x_im)       # steady block
    assert isinstance(out, ChainOutputs)
    assert np.asarray(out.found).all()
    np.testing.assert_array_equal(np.asarray(out.pos),
                                  np.tile(rows, (C, 1)))
    assert np.asarray(out.ok).all()
    want = np.stack(infos)                      # (k, n_msg)
    np.testing.assert_array_equal(np.asarray(out.msg),
                                  np.tile(want, (C, 1, 1)))


def test_chain_fn_absorbs_cfo():
    # A small carrier offset rides the demod tracker's phase ramp; the
    # sync stage resolves the residual M-fold rotation per frame -- the
    # chain should decode exactly through it.
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(9)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    rows = [80, 320]
    starts = [r - (cfg.num_avg - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                              labeling="gray", seed=6)
    n_samp = S * sps
    cfo = np.exp(2j * np.pi * 2e-5 * np.arange(n_samp))
    x_np = (np.repeat(np.exp(1j * (2 * np.pi
                                   * np.tile(idx_row, (C, 1)) / 4)),
                      sps, axis=1) * cfo[None]).astype(np.complex64)
    x_np += (0.01 * (rng.standard_normal(x_np.shape)
                     + 1j * rng.standard_normal(x_np.shape))
             ).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    step = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    state, out = step(state, jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    assert np.asarray(out.found).all()
    assert np.asarray(out.ok).all()
    assert np.array_equal(np.asarray(out.msg),
                          np.tile(np.stack(infos), (C, 1, 1)))


def test_chain_fn_variable_frame_counts():
    # Blocks carry FEWER frames than the fixed capacity k: the chain must
    # report exactly the planted frames as found (in time order) and
    # garbage rows as not-found, per channel, block after block.
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(11)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    k = 3
    step = jax.jit(make_chain_fn(cfg, fmt, code, k, crc=crc))
    a1 = cfg.num_avg - 1
    state = None
    for blk, n_frames in enumerate([2, 0, 1]):
        rows = [80, 250][:n_frames] if n_frames != 1 else [150]
        starts = [r - a1 for r in rows]
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
        idx_row = tx.frame_stream(fmt, infos, starts, S, code=code,
                                  crc=crc, labeling="gray", seed=20 + blk)
        x_np = np.repeat(np.exp(1j * (2 * np.pi
                                      * np.tile(idx_row, (C, 1)) / 4
                                      + 0.4)),
                         sps, axis=1).astype(np.complex64)
        x_np += (0.01 * (rng.standard_normal(x_np.shape)
                         + 1j * rng.standard_normal(x_np.shape))
                 ).astype(np.complex64)
        if state is None:
            st_ff = ff_init(cfg, (C,))
            warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
            st_ff, _ = warm(st_ff, jnp.asarray(x_np))
            state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
        state, out = step(
            state, jnp.asarray(np.ascontiguousarray(x_np.real.T)),
            jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
        found = np.asarray(out.found)
        assert (found[:, :n_frames]).all(), (blk, n_frames)
        assert not found[:, n_frames:].any(), (blk, n_frames)
        if n_frames:
            np.testing.assert_array_equal(
                np.asarray(out.pos)[:, :n_frames], np.tile(rows, (C, 1)))
            assert np.asarray(out.ok)[:, :n_frames].all()
            np.testing.assert_array_equal(
                np.asarray(out.msg)[:, :n_frames],
                np.tile(np.stack(infos), (C, 1, 1)))


def test_chain_fn_under_awgn():
    # Functional (not just exactness) validation: at Es/N0 ~ 12 dB QPSK
    # with K=7 rate-1/2 coding, the one-launch chain should sync and
    # decode every frame cleanly (raw BER ~1e-4 -> coded ~0; UW=32 at
    # threshold 0.7 has margin at this SNR).
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(17)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    rows = [70, 290]
    starts = [r - (cfg.num_avg - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                              labeling="gray", seed=8)
    x_np = np.repeat(np.exp(1j * (2 * np.pi
                                  * np.tile(idx_row, (C, 1)) / 4 + 0.2)),
                     sps, axis=1).astype(np.complex64)
    # Es/N0 = 12 dB on the symbol decision: per-sample noise sigma such
    # that the numAvg-averaged decision sample sees it directly (rect
    # pulse, decision sample = one sample) -> sigma^2 = 10^(-1.2).
    sigma = np.sqrt(10 ** (-1.2) / 2)
    x_np += (sigma * (rng.standard_normal(x_np.shape)
                      + 1j * rng.standard_normal(x_np.shape))
             ).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    step = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    state, out = step(state,
                      jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    found = np.asarray(out.found)
    ok = np.asarray(out.ok)
    # All frames found and >= 99% of CRCs green at this SNR (the coded
    # operating point); message equality where CRC passes.
    assert found.all()
    assert ok.mean() >= 0.99
    msg = np.asarray(out.msg)
    want = np.tile(np.stack(infos), (C, 1, 1))
    assert (msg[ok] == want[ok]).all()


def test_chain_fn_config3_rrc_8psk():
    # The chain composed with the hardest kernel profile (BASELINE
    # config 3): 8-PSK + RRC matched filter + fractional timing.  RRC
    # TX pulses -> matched filter -> sync -> Viterbi -> CRC, all frames
    # decoding to the transmitted message bits.
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=8,
                      phase_avg=30, matched_filter="rrc", rrc_beta=0.35,
                      rrc_span=8, timing_interp=True)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(23)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 8, 32)), payload=40, m=8,
                      threshold=0.65)
    n_msg = chain_msg_bits(fmt, code, crc)
    rows = [60, 280]
    starts = [r - (cfg.num_avg - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                              labeling="gray", seed=14)
    x_np = np.tile(tx.shape(8, np.asarray(idx_row), sps, pulse="rrc",
                            rrc_beta=0.35, rrc_span=8)[None], (C, 1))
    x_np = (x_np * np.exp(0.25j)).astype(np.complex64)
    x_np += (0.005 * (rng.standard_normal(x_np.shape)
                      + 1j * rng.standard_normal(x_np.shape))
             ).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    keep = (cfg.num_avg - 1) * sps + cfg.mf_ntaps - 1
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff, raw_win=x_np[:, -keep:]))
    step = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    state, out = step(state,
                      jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    state, out = step(state,
                      jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    assert np.asarray(out.found).all()
    assert np.asarray(out.ok).all()
    assert np.array_equal(np.asarray(out.msg),
                          np.tile(np.stack(infos), (C, 1, 1)))
