"""Front-end stages inside the one-launch chain (VERDICT r4 item 8):
NCO derotation + AGC composed ahead of the demod kernel in ONE jitted
program (models/chain.make_front_chain_fn).

Gates:
- ops/agc.agc_block_tm == agc_block (time-major plane form vs the
  channel-major reference, term for term).
- A carrier offset BEYOND the M-th-power tracker's pull-in plus a
  per-channel gain spread: the plain chain fails, the front chain
  decodes every frame exactly (freq from acquisition).
- Equivalence: front chain commits == host-corrected input through the
  plain seam chain.
"""

import numpy as np
import jax
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
from psk_soft_tpu.models.chain import (chain_init, chain_msg_bits,
                                       front_chain_init, make_chain_fn,
                                       make_front_chain_fn)
from psk_soft_tpu.models.full import full_from_ff
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.agc import (AgcConfig, agc_block, agc_block_tm,
                                  agc_init)
from psk_soft_tpu.ops.crc import CRC16_CCITT
from psk_soft_tpu.ops.fec import CODE_K7
from psk_soft_tpu.ops.framesync import FrameFormat
from psk_soft_tpu.ops.mixer import derotate_host


def test_agc_tm_matches_channel_major():
    cfg = AgcConfig(alpha=0.07, chunk=8, squelch_power=1e-6)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 512)) + 1j * rng.standard_normal((5, 512))
         ).astype(np.complex64)
    x *= np.geomspace(0.01, 30.0, 5)[:, None]
    st = agc_init(cfg, (5,))
    st1, y, info1 = jax.jit(lambda s, x: agc_block(cfg, s, x))(st, x)
    st2, yre, yim, info2 = jax.jit(
        lambda s, r, i: agc_block_tm(cfg, s, r, i))(
        st, jnp.asarray(np.ascontiguousarray(x.real.T)),
        jnp.asarray(np.ascontiguousarray(x.imag.T)))
    np.testing.assert_allclose(np.asarray(y.real), np.asarray(yre).T,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(y.imag), np.asarray(yim).T,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(st1.power), np.asarray(st2.power),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(info1["gain"]),
                               np.asarray(info2["gain"]).T, rtol=1e-5)
    # Streaming == one-shot on the tm path.
    stA = agc_init(cfg, (5,))
    re_t = np.ascontiguousarray(x.real.T)
    im_t = np.ascontiguousarray(x.imag.T)
    stA, r1, i1, _ = agc_block_tm(cfg, stA, re_t[:256], im_t[:256])
    stA, r2, i2, _ = agc_block_tm(cfg, stA, re_t[256:], im_t[256:])
    np.testing.assert_allclose(np.concatenate([r1, r2]), np.asarray(yre),
                               atol=1e-5)


def _front_setup():
    C, sps, S = 128, 8, 512
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(41)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    rows = [70, 290]
    starts = [r - (cfg.num_avg - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=code, crc=crc,
                              labeling="gray", seed=42)
    clean = np.repeat(np.exp(1j * (2 * np.pi
                                   * np.tile(idx_row, (C, 1)) / 4 + 0.3)),
                      sps, axis=1)
    # Per-channel carrier offsets BEYOND the tracker's pull-in (the
    # 4th-power per-symbol step 4*2pi*f*sps crosses pi near f ~ 0.0156)
    # plus a 400x amplitude spread.
    freqs = (0.02 + 0.005 * np.arange(C) / C).astype(np.float32)
    gains = np.geomspace(0.05, 20.0, C)[:, None]
    t = np.arange(clean.shape[1])
    x = (clean * gains * np.exp(2j * np.pi * freqs[:, None] * t[None]))
    x = x.astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))
          ).astype(np.complex64)
    return cfg, fmt, code, crc, rows, infos, x, freqs, C


def test_front_chain_closes_beyond_pullin_cfo():
    cfg, fmt, code, crc, rows, infos, x, freqs, C = _front_setup()
    agc_cfg = AgcConfig(alpha=0.1, chunk=cfg.sps, target_rms=1.0)
    # Host-corrected twin (derotate + AGC oracle), used for the warm-up
    # AND as the plain-chain equivalence reference.
    y = derotate_host(x, freqs)
    st0 = agc_init(agc_cfg, (C,))
    _, y_agc, _ = jax.jit(lambda s, v: agc_block(agc_cfg, s, v))(st0, y)
    y_agc = np.asarray(y_agc)

    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(y_agc))
    demod_state = full_from_ff(cfg, st_ff)

    # Plain chain on the RAW capture: the offset defeats the tracker.
    plain = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    st_p = chain_init(fmt, C, demod_state)
    st_p, out_p = plain(st_p,
                        jnp.asarray(np.ascontiguousarray(x.real.T)),
                        jnp.asarray(np.ascontiguousarray(x.imag.T)))
    assert not (np.asarray(out_p.found) & np.asarray(out_p.ok)).all()

    # Front chain on the SAME raw capture: NCO + AGC inside the program.
    front = jax.jit(make_front_chain_fn(cfg, fmt, code, len(rows),
                                        crc=crc, agc_cfg=agc_cfg))
    st_f = front_chain_init(fmt, C, demod_state, agc_cfg=agc_cfg,
                            freq=freqs)
    st_f, out_f = front(st_f,
                        jnp.asarray(np.ascontiguousarray(x.real.T)),
                        jnp.asarray(np.ascontiguousarray(x.imag.T)))
    st_f, out_f = front(st_f,
                        jnp.asarray(np.ascontiguousarray(x.real.T)),
                        jnp.asarray(np.ascontiguousarray(x.imag.T)))
    assert np.asarray(out_f.found).all()
    assert np.asarray(out_f.ok).all()
    np.testing.assert_array_equal(np.asarray(out_f.pos),
                                  np.tile(rows, (C, 1)))
    np.testing.assert_array_equal(
        np.asarray(out_f.msg), np.tile(np.stack(infos), (C, 1, 1)))


def test_front_chain_equals_host_corrected_plain_chain():
    cfg, fmt, code, crc, rows, infos, x, freqs, C = _front_setup()
    agc_cfg = AgcConfig(alpha=0.1, chunk=cfg.sps, target_rms=1.0)
    y = derotate_host(x, freqs)
    st0 = agc_init(agc_cfg, (C,))
    stA, y_agc, _ = jax.jit(lambda s, v: agc_block(agc_cfg, s, v))(st0, y)
    y_agc = np.asarray(y_agc)

    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(y_agc))
    demod_state = full_from_ff(cfg, st_ff)

    front = jax.jit(make_front_chain_fn(cfg, fmt, code, len(rows),
                                        crc=crc, agc_cfg=agc_cfg))
    st_f = front_chain_init(fmt, C, demod_state, agc_cfg=agc_cfg,
                            freq=freqs)
    st_f, out_f = front(st_f,
                        jnp.asarray(np.ascontiguousarray(x.real.T)),
                        jnp.asarray(np.ascontiguousarray(x.imag.T)))

    # Host-corrected twin through the PLAIN seam chain (wrapper stack).
    plain = jax.jit(make_chain_fn(cfg, fmt, code, len(rows), crc=crc))
    st_p = chain_init(fmt, C, demod_state)
    # Phase continuity: the host twin's block 1 correction must match the
    # front chain's carried phase (both start at phase 0).
    st_p, out_p = plain(st_p,
                        jnp.asarray(np.ascontiguousarray(y_agc.real.T)),
                        jnp.asarray(np.ascontiguousarray(y_agc.imag.T)))
    np.testing.assert_array_equal(np.asarray(out_f.found),
                                  np.asarray(out_p.found))
    np.testing.assert_array_equal(np.asarray(out_f.pos),
                                  np.asarray(out_p.pos))
    f = np.asarray(out_f.found)
    np.testing.assert_array_equal(np.asarray(out_f.msg)[f],
                                  np.asarray(out_p.msg)[f])
    np.testing.assert_array_equal(np.asarray(out_f.ok)[f],
                                  np.asarray(out_p.ok)[f])
