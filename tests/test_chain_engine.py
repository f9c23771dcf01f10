"""ChainEngine: the one-launch chain behind the production engine surface.

Parity law: on the same multi-block stream, ChainEngine's frames
(channel, input-symbol start, decoded info bits, CRC verdicts) must
match the per-stage stack (FullKernelBatchEngine + device-tap
FrameSyncer + FecFrameDecoder + FrameCrcChecker) frame for frame, for
every frame past the one-launch warm-up region -- including frames
straddling block seams and the EOS tail (flush finalize).
"""

import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.chain import chain_msg_bits
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT
from psk_soft_tpu.ops.fec import CODE_K7
from psk_soft_tpu.ops.framesync import FrameFormat
from psk_soft_tpu.runtime.chain_engine import ChainEngine
from psk_soft_tpu.runtime.receiver import build_receiver


def _stream(C, total, fmt, code, crc, seed=0):
    rng = np.random.default_rng(seed)
    n_msg = chain_msg_bits(fmt, code, crc)
    sep = fmt.separation
    starts, p = [], 140
    while p + fmt.frame_len <= total - sep:
        starts.append(p)
        p += sep + int(rng.integers(5, 60))
    truth = {}
    rows = []
    for c in range(C):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
        for s0, i in zip(starts, infos):
            truth[(c, s0)] = i
        idx = tx.frame_stream(fmt, infos, starts, total, code=code,
                              crc=crc, labeling="gray", seed=seed + c)
        rows.append(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)))
    x = np.repeat(np.stack(rows), 8, axis=1).astype(np.complex64)
    rng2 = np.random.default_rng(seed + 999)
    x += (0.01 * (rng2.standard_normal(x.shape)
                  + 1j * rng2.standard_normal(x.shape))
          ).astype(np.complex64)
    return x, starts, truth


def test_chain_engine_matches_per_stage_stack():
    C, S = 128, 256
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(51)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    code, crc = CODE_K7, CRC16_CCITT
    total = 6 * S
    x, starts, truth = _stream(C, total, fmt, code, crc, seed=52)
    # Frames must straddle block seams to exercise the seam carry.
    assert any(p // S != (p + fmt.frame_len - 1) // S for p in starts)

    # (a) per-stage stack (device-tap FrameSyncer path).
    rx = build_receiver(cfg, C, engine="full", block_symbols=S,
                        uw=fmt.uw, frame_payload=fmt.payload,
                        uw_threshold=0.7, fec=code, fec_labeling="gray",
                        crc=crc)
    blk = S * cfg.sps
    for pos in range(0, x.shape[1], blk):
        rx.engine.push_planes(
            np.ascontiguousarray(x.real.T[pos:pos + blk]),
            np.ascontiguousarray(x.imag.T[pos:pos + blk]))
        rx.engine.step_packets()
    rx.engine.flush_packets()
    stack_frames = {(f.channel, f.start): f for f in rx.pop_frames()}

    # (b) one-launch ChainEngine.
    eng = ChainEngine(cfg, C, fmt, code, crc, block_symbols=S)
    for pos in range(0, x.shape[1], blk):
        eng.push_block(x[:, pos:pos + blk])
        eng.step()
    eng.flush()
    chain_frames = {(f.channel, f.start): f for f in eng.pop_frames()}

    # Every frame past the one-launch warm-up region must agree.
    post_warm = [k for k in stack_frames if k[1] >= S]
    assert len(post_warm) >= C * (len(starts) - 1)
    for key in post_warm:
        assert key in chain_frames, f"chain missed {key}"
        a, b = stack_frames[key], chain_frames[key]
        assert b.crc_ok and a.crc_ok
        np.testing.assert_array_equal(a.info_bits[:eng.n_msg],
                                      b.info_bits)
        np.testing.assert_array_equal(b.info_bits, truth[key])
    # No spurious chain frames either (post-warm region).
    for key in chain_frames:
        if key[1] >= S:
            assert key in stack_frames, f"chain invented {key}"
    assert eng.overflow_peaks == 0
    assert eng.crc_failures == 0
    assert eng.frames_synced == len(chain_frames)


def test_chain_engine_validation_and_reset():
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    fmt8 = FrameFormat(uw=(0, 1), payload=8, m=8)
    with pytest.raises(ValueError):
        ChainEngine(cfg, 128, fmt8, CODE_K7)       # m mismatch
    cfg_mf = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                         phase_avg=30, matched_filter="rrc")
    fmt = FrameFormat(uw=(0, 1, 2, 3) * 4, payload=16, m=4)
    with pytest.raises(ValueError):
        ChainEngine(cfg_mf, 128, fmt, CODE_K7)     # matched filter
    eng = ChainEngine(cfg, 128, fmt, CODE_K7, block_symbols=128)
    assert eng.step() is None                      # not enough data
    eng.push_block(np.zeros((128, 128 * 8), np.complex64))
    assert eng.step() == []                        # warm block
    eng.reset()
    assert eng._state is None and not eng.frames


def test_build_receiver_chain_engine():
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(61)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    total = 4 * 256
    x, starts, truth = _stream(128, total, fmt, CODE_K7, CRC16_CCITT,
                               seed=62)
    rx = build_receiver(cfg, 128, engine="chain", block_symbols=256,
                        uw=fmt.uw, frame_payload=48, fec=CODE_K7,
                        fec_labeling="gray", crc=CRC16_CCITT)
    assert isinstance(rx.engine, ChainEngine)
    blk = 256 * 8
    for pos in range(0, x.shape[1], blk):
        rx.engine.push_block(x[:, pos:pos + blk])
        rx.engine.step()
    rx.engine.flush()
    got = {(f.channel, f.start): f for f in rx.pop_frames()}
    post_warm = [(c, p) for (c, p) in truth if p >= 256]
    assert post_warm
    for key in post_warm:
        assert key in got
        assert got[key].crc_ok
        np.testing.assert_array_equal(got[key].info_bits, truth[key])
    with pytest.raises(ValueError):
        build_receiver(cfg, 128, engine="chain")            # needs uw+fec
    with pytest.raises(ValueError):
        build_receiver(cfg, 128, engine="chain", uw=fmt.uw,
                       frame_payload=48, fec=CODE_K7,
                       fec_labeling="gray", quality=True)   # no wrappers


def test_chain_engine_checkpoint_resume(tmp_path):
    """ChainEngine checkpointed mid-stream resumes EXACTLY: same frames
    (absolute starts included) as the uninterrupted run."""
    import os
    from psk_soft_tpu.utils.checkpoint import load_state, save_state

    C, S = 128, 256
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(71)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    x, starts, truth = _stream(C, 5 * S, fmt, CODE_K7, CRC16_CCITT,
                               seed=72)
    blk = S * cfg.sps

    def run(eng, lo, hi):
        got = []
        for b in range(lo, hi):
            eng.push_block(x[:, b * blk:(b + 1) * blk])
            got += eng.step() or []
        return got

    a = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S)
    run(a, 0, 3)                                  # warm + 2 chain blocks
    path = os.path.join(tmp_path, "ce.npz")
    save_state(path, a.chain_state, cfg,
               extra={"base": a._base, "blocks": a._blocks})
    st, _, ex = load_state(path)

    b = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S)
    b.restore_chain_state(st, base_symbols=ex["base"],
                          blocks_done=ex["blocks"])
    fa = {(f.channel, f.start): f.info_bits for f in run(a, 3, 5)}
    fb = {(f.channel, f.start): f.info_bits for f in run(b, 3, 5)}
    assert fa.keys() == fb.keys() and len(fa) > 0
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
        np.testing.assert_array_equal(fb[k], truth[k])


def test_chain_engine_planes_and_pipelined_parity():
    """push_planes ingest + pipeline_depth=1 (deferred commit) emits the
    IDENTICAL frame set as channel-major synchronous ingest."""
    C, S = 128, 256
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(81)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    x, starts, truth = _stream(C, 5 * S, fmt, CODE_K7, CRC16_CCITT,
                               seed=82)
    blk = S * cfg.sps

    a = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S)
    b = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S,
                    pipeline_depth=1)
    for pos in range(0, x.shape[1], blk):
        a.push_block(x[:, pos:pos + blk])
        a.step()
        b.push_planes(np.ascontiguousarray(x.real.T[pos:pos + blk]),
                      np.ascontiguousarray(x.imag.T[pos:pos + blk]))
        b.step()
    a.flush()
    b.flush()
    fa = {(f.channel, f.start): f.info_bits for f in a.pop_frames()}
    fb = {(f.channel, f.start): f.info_bits for f in b.pop_frames()}
    assert fa.keys() == fb.keys() and len(fa) >= C * (len(starts) - 1)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


def test_chain_engine_ragged_pushes_and_guards():
    """Ragged per-channel pushes (arbitrary chunk sizes) produce the same
    frames as whole-block pushes; the ingest guards hold."""
    C, S = 128, 256
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(91)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    x, starts, truth = _stream(C, 4 * S, fmt, CODE_K7, CRC16_CCITT,
                               seed=92)
    blk = S * cfg.sps

    a = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S)
    for pos in range(0, x.shape[1], blk):
        a.push_block(x[:, pos:pos + blk])
        a.step()
    a.flush()
    want = {(f.channel, f.start): f.info_bits for f in a.pop_frames()}

    b = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S)
    # Ragged: each channel advances by its own random chunk sizes.
    posn = np.zeros(C, np.int64)
    total = x.shape[1]
    while (posn < total).any():
        for c in range(C):
            if posn[c] < total:
                n = int(rng.integers(500, 4000))
                b.push(c, x[c, posn[c]:posn[c] + n])
                posn[c] = min(posn[c] + n, total)
        while b.step() is not None:
            pass
    b.flush()
    got = {(f.channel, f.start): f.info_bits for f in b.pop_frames()}
    assert want.keys() == got.keys() and len(want) > 0
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])

    # Guards: finalized stream rejects pushes; plane/channel mixing and
    # integer planes reject loudly.
    with pytest.raises(ValueError):
        b.push_block(x[:, :blk])            # finalized
    assert b.flush() == []                  # idempotent
    c_eng = ChainEngine(cfg, C, fmt, CODE_K7, block_symbols=S)
    c_eng.push(0, x[0, :100])
    with pytest.raises(ValueError):
        c_eng.push_planes(np.zeros((8, C), np.float32),
                          np.zeros((8, C), np.float32))   # mixing
    d_eng = ChainEngine(cfg, C, fmt, CODE_K7, block_symbols=S)
    with pytest.raises(ValueError):
        d_eng.push_planes(np.zeros((8, C), np.int16),
                          np.zeros((8, C), np.int16))     # int wire


def test_chain_engine_acquire_cfo_beyond_lock():
    """acquire_cfo=True: per-channel offsets beyond the 4th-power
    tracker's pull-in acquire during warm-up and decode exactly through
    the in-program NCO (the front chain behind the engine surface)."""
    C, S = 128, 256
    cfg = DemodConfig(sps=8, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(95)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    x, starts, truth = _stream(C, 5 * S, fmt, CODE_K7, CRC16_CCITT,
                               seed=96)
    # Beyond-pull-in spread (~0.0156 cyc/sample is the 4th-power limit).
    freqs = (0.018 + 0.006 * np.arange(C) / C).astype(np.float32)
    t = np.arange(x.shape[1])
    x = (x * np.exp(2j * np.pi * freqs[:, None] * t[None])
         ).astype(np.complex64)
    blk = S * cfg.sps

    plain = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT,
                        block_symbols=S)
    acq = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S,
                      acquire_cfo=True)
    for pos in range(0, x.shape[1], blk):
        for eng in (plain, acq):
            eng.push_block(x[:, pos:pos + blk])
            eng.step()
    plain.flush()
    acq.flush()
    got_plain = [f for f in plain.pop_frames() if f.crc_ok]
    got = {(f.channel, f.start): f for f in acq.pop_frames()}
    post_warm = [k for k in truth if k[1] >= S]
    # The offset defeats the plain engine but not the acquiring one.
    assert len(got_plain) < len(post_warm) // 2
    assert acq.cfo_estimates is not None
    np.testing.assert_allclose(acq.cfo_estimates, freqs, atol=1e-4)
    for key in post_warm:
        assert key in got, f"missed {key}"
        assert got[key].crc_ok
        np.testing.assert_array_equal(got[key].info_bits, truth[key])
