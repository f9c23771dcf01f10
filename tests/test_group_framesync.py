"""GroupFrameSyncer: per-channel frame formats over one mixed bank."""

import numpy as np
import pytest

from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.framesync import FrameFormat
from psk_soft_tpu.runtime.framesync import FrameSyncer, GroupFrameSyncer


def _stream(fmt, infos, starts, total, rng, rot_k=0):
    idx = tx.frame_stream(fmt, infos, starts, total, seed=7)
    soft = tx.symbols_to_iq(fmt.m, idx)
    rot = np.exp(2j * np.pi * rot_k / fmt.m)
    return (soft * rot + 0.02 * (rng.standard_normal(total)
                                 + 1j * rng.standard_normal(total))
            ).astype(np.complex64)


def test_mixed_formats_and_group_parity():
    """A 4-channel bank mixing QPSK and 8-PSK frame formats: every frame
    comes back with bank channel indices and payload bits exact, and each
    group's result equals a standalone single-format FrameSyncer run."""
    rng = np.random.default_rng(131)
    fmt_q = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=40, m=4,
                        threshold=0.7)
    fmt_8 = FrameFormat(uw=tuple(rng.integers(0, 8, 32)), payload=30, m=8,
                        threshold=0.6)
    fmts = [fmt_q, fmt_8, fmt_q, fmt_8]           # interleaved groups
    total = 900
    starts = {0: [50, 400], 1: [80, 500], 2: [120, 620], 3: [60, 300]}
    sent, rows = {}, []
    for c, fmt in enumerate(fmts):
        nb = int(np.log2(fmt.m))
        infos = [rng.integers(0, 2, fmt.payload * nb, np.int8)
                 for _ in starts[c]]
        for s0, i in zip(starts[c], infos):
            sent[(c, s0)] = i
        rows.append(_stream(fmt, infos, starts[c], total, rng,
                            rot_k=c % fmt.m))
    bank = np.stack(rows)

    top = GroupFrameSyncer(4, fmts)
    for lo, hi in ((0, 300), (300, 301), (301, 900)):  # uneven splits
        top.observe(bank[:, lo:hi])
    top.finalize()
    frames = top.pop_frames()
    assert len(frames) == 8 and top.frames_synced == 8
    for f in frames:
        assert np.array_equal(f.bits, sent[(f.channel, f.start)])

    # parity per group vs a plain single-format syncer
    for grp_fmt, grp_rows in ((fmt_q, [0, 2]), (fmt_8, [1, 3])):
        ref = FrameSyncer(len(grp_rows), grp_fmt)
        ref.observe(bank[grp_rows])
        ref.finalize()
        ref_frames = sorted(((grp_rows[f.channel], f.start,
                              f.bits.tobytes())
                             for f in ref.pop_frames()))
        got_frames = sorted(((f.channel, f.start, f.bits.tobytes())
                             for f in frames
                             if f.channel in grp_rows))
        assert got_frames == ref_frames


def test_group_framesync_validation_and_reset():
    fmt = FrameFormat(uw=(0, 1, 2, 3, 0, 1, 2, 3), payload=8, m=4)
    with pytest.raises(ValueError):
        GroupFrameSyncer(3, [fmt, fmt])           # wrong count
    g = GroupFrameSyncer(2, [fmt, fmt])
    assert len(g._syncers) == 1                   # shared format -> 1 group
    with pytest.raises(ValueError):
        g.observe(np.zeros((3, 10), np.complex64))
    g.observe(np.zeros((2, 40), np.complex64))
    g.reset_sync()
    assert g.pop_frames() == [] and g.frames_synced == 0


def test_group_framesync_over_mixed_engine():
    """GroupFrameSyncer taps a MixedKernelBatchEngine (heterogeneous M
    bank, one steady program) and recovers every channel's frame with its
    own format."""
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.models.mixed import MixedParams
    from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine
    from psk_soft_tpu.runtime.streams import SRI

    C = 128
    rng = np.random.default_rng(132)
    cfg = DemodConfig(sps=8, num_avg=30, constellation_size=4,
                      phase_avg=20)
    fmt_q = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=24, m=4,
                        threshold=0.7)
    fmt_8 = FrameFormat(uw=tuple(rng.integers(0, 8, 32)), payload=24, m=8,
                        threshold=0.65)
    fmts = [fmt_q if c % 2 == 0 else fmt_8 for c in range(C)]
    params = MixedParams.make([f.m for f in fmts], [False] * C)

    total, s0 = 640, 200
    sent, rows = {}, []
    for c, fmt in enumerate(fmts):
        nb = int(np.log2(fmt.m))
        info = rng.integers(0, 2, fmt.payload * nb, np.int8)
        sent[c] = info
        # fill seeds offset far from the master seed (a collision
        # would embed the UW verbatim in the fill)
        idx = tx.frame_stream(fmt, [info], [s0], total, seed=90000 + c)
        x = np.repeat(tx.symbols_to_iq(fmt.m, idx), cfg.sps)
        x = x * np.exp(1j * (0.1 * c))
        x = x + 0.02 * (rng.standard_normal(x.size)
                        + 1j * rng.standard_normal(x.size))
        rows.append(x.astype(np.complex64))
    bank = np.stack(rows)

    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    eng.set_input_sri(SRI(stream_id="gfs"))
    top = GroupFrameSyncer(eng, fmts)
    blk = 128 * cfg.sps
    for pos in range(0, bank.shape[1], blk):
        for c in range(C):
            top.push(c, bank[c, pos:pos + blk])
        top.step_packets()
    top.flush_packets()
    frames = top.pop_frames()
    assert len(frames) == C, len(frames)
    for f in frames:
        assert f.start == s0
        assert np.array_equal(f.bits, sent[f.channel]), f.channel
