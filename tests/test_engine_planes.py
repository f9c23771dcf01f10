"""FullKernelBatchEngine plane-ingest path: time-major re/im planes from
the native plane bank feed the kernel with zero host transposes; int16 wire
planes ride the steady step's int16 mode end to end."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
from psk_soft_tpu.runtime.native_bank import NativePlaneBank

C = 128


def _bank_signal(S, seed0=0, m=4):
    xs = []
    for i in range(C):
        r = np.random.default_rng(seed0 + i)
        j = r.integers(0, m, S)
        x = np.zeros(S * 8, np.complex64)
        x[3::8] = np.exp(2j * np.pi * j / m) * np.exp(
            2j * np.pi * 1e-4 * 8 * np.arange(S))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs)          # (C, T) channel-major


def _cfg():
    return DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)


def _collect(eng, feed, blocks):
    outs = []
    for b in range(blocks):
        feed(b)
        o = eng.step()
        if o is not None:
            outs.append((np.asarray(o.soft), np.asarray(o.valid),
                         np.asarray(o.bits)))
    return outs


def test_plane_path_matches_push_path():
    cfg = _cfg()
    xs = _bank_signal(1024, seed0=0)
    blocks = np.split(xs, 8, axis=1)          # (C, 1024) per block

    e1 = FullKernelBatchEngine(cfg, C, block_symbols=128)
    e2 = FullKernelBatchEngine(cfg, C, block_symbols=128)

    def feed_push(b):
        for c in range(C):
            e1.push(c, blocks[b][c])

    def feed_planes(b):
        e2.push_planes(np.ascontiguousarray(blocks[b].real.T),
                       np.ascontiguousarray(blocks[b].imag.T))

    o1 = _collect(e1, feed_push, 8)
    o2 = _collect(e2, feed_planes, 8)
    assert e1.steady and e2.steady
    assert len(o1) == len(o2)
    for (s1, v1, b1), (s2, v2, b2) in zip(o1, o2):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(s1, s2)   # identical math, bit-exact
        np.testing.assert_array_equal(b1, b2)


def test_native_plane_bank_to_engine():
    """Interleaved frames -> NativePlaneBank -> push_planes -> kernel."""
    cfg = _cfg()
    xs = _bank_signal(1024, seed0=50)
    frames = np.ascontiguousarray(xs.T)       # (T, C) time-major complex
    bank = NativePlaneBank(C, capacity_samples=1 << 14)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128)
    need = 128 * cfg.sps
    outs = []
    for i in range(0, frames.shape[0], need):
        bank.push_interleaved(frames[i: i + need])
        re, im, fl = bank.pop_planes(need, timeout=0)
        assert not fl
        eng.push_planes(re, im)
        o = eng.step()
        if o is not None:
            outs.append(o)
    assert eng.steady and outs


def test_i16_plane_engine_end_to_end():
    """int16 wire planes: warm-up dequantizes on host, the steady kernel
    reads the 2-byte planes directly, and the carry window stays int16."""
    cfg = _cfg()
    xs = _bank_signal(1024, seed0=100)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re_w = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im_w = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    xq = ((re_w.astype(np.float32) * scale).T
          + 1j * (im_w.astype(np.float32) * scale).T).astype(np.complex64)

    ref = FullKernelBatchEngine(cfg, C, block_symbols=128)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128, ingest_scale=scale)
    need = 128 * cfg.sps
    for i in range(0, 1024 * 8, need):
        for c in range(C):
            ref.push(c, xq[c, i: i + need])
        eng.push_planes(re_w[i: i + need], im_w[i: i + need])
        o_ref, o = ref.step(), eng.step()
        if o is not None and o_ref is not None:
            np.testing.assert_array_equal(np.asarray(o.valid),
                                          np.asarray(o_ref.valid))
            np.testing.assert_allclose(np.asarray(o.soft),
                                       np.asarray(o_ref.soft), atol=1e-5)
    assert eng.steady
    assert eng._full_state.win_re.dtype == jnp.int16


def test_i16_engine_configure_roundtrip():
    """Live reconfigure on an i16 steady engine: the carry dequantizes for
    ff_from_full, re-warms, and re-quantizes at the next handoff."""
    import dataclasses

    cfg = _cfg()
    xs = _bank_signal(1536, seed0=150)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re_w = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im_w = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128, ingest_scale=scale)
    need = 128 * cfg.sps
    pos = 0
    for _ in range(4):
        eng.push_planes(re_w[pos: pos + need], im_w[pos: pos + need])
        eng.step()
        pos += need
    assert eng.steady
    eng.configure(dataclasses.replace(cfg, phase_avg=16))
    assert not eng.steady
    got = 0
    while pos < 1536 * 8:
        eng.push_planes(re_w[pos: pos + need], im_w[pos: pos + need])
        o = eng.step()
        pos += need
        if o is not None:
            got += int(np.asarray(o.valid).sum())
    assert eng.steady and got
    assert eng._full_state.win_re.dtype == jnp.int16


def test_plane_flush_remainder():
    cfg = _cfg()
    xs = _bank_signal(1024 + 64, seed0=200)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128)
    re_p = np.ascontiguousarray(xs.real.T).astype(np.float32)
    im_p = np.ascontiguousarray(xs.imag.T).astype(np.float32)
    need = 128 * cfg.sps
    for i in range(0, 1024 * 8, need):
        eng.push_planes(re_p[i: i + need], im_p[i: i + need])
        eng.step()
    assert eng.steady
    eng.push_planes(re_p[1024 * 8:], im_p[1024 * 8:])    # 64-symbol tail
    out = eng.flush()
    assert out is not None
    v = np.asarray(out.valid)
    assert v.sum() == C * 64                             # tail symbols emit


def test_plane_and_push_cannot_mix():
    cfg = _cfg()
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128)
    eng.push(0, np.zeros(8, np.complex64))
    with pytest.raises(ValueError):
        eng.push_planes(np.zeros((8, C), np.float32),
                        np.zeros((8, C), np.float32))
    eng.reset()
    eng.push_planes(np.zeros((8, C), np.float32),
                    np.zeros((8, C), np.float32))
    with pytest.raises(ValueError):
        eng.push(0, np.zeros(8, np.complex64))


def test_full_engine_guard_nonfinite_steady():
    """Per-channel drop-and-resync on the STEADY kernel path: a poisoned
    channel's carry (window + state planes) resets alone; its neighbors'
    tracking is untouched (bit-identical to an unpoisoned run)."""
    cfg = _cfg()
    xs = _bank_signal(1536, seed0=300)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128,
                                guard_nonfinite=True)
    ref = FullKernelBatchEngine(cfg, C, block_symbols=128)
    need = 128 * cfg.sps
    blocks = [xs[:, i: i + need] for i in range(0, 1536 * 8, need)]
    for blk in blocks[:5]:
        for c in range(C):
            eng.push(c, blk[c])
            ref.push(c, blk[c])
        eng.step()
        ref.step()
    assert eng.steady and ref.steady
    # Poison channel 7 in the next block (steady path).
    bad_blk = blocks[5].copy()
    bad_blk[7, 100:120] = np.nan
    for c in range(C):
        eng.push(c, bad_blk[c])
        ref.push(c, blocks[5][c])
    eng.step()
    ref.step()
    assert eng.channel_resyncs[7] == 1
    assert eng.channel_resyncs.sum() == 1
    # Healthy channels march on identically to the unpoisoned engine.
    for blk in blocks[6:]:
        for c in range(C):
            eng.push(c, blk[c])
            ref.push(c, blk[c])
        o = eng.step()
        o_ref = ref.step()
    s, s_ref = np.asarray(o.soft), np.asarray(o_ref.soft)
    mask = np.ones(C, bool)
    mask[7] = False
    np.testing.assert_array_equal(s[mask], s_ref[mask])
    # The guarded channel re-converged by a few blocks later: near-unit
    # magnitude decisions again (window refilled with real samples).
    assert np.isfinite(s[7]).all()
    assert abs(np.abs(s[7, -64:]).mean() - 1.0) < 0.2


def test_full_engine_guard_nonfinite_warmup():
    """The warm-up (ff) phase guards too, matching BatchEngine semantics."""
    cfg = _cfg()
    xs = _bank_signal(256, seed0=400)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128,
                                guard_nonfinite=True)
    blk = xs[:, : 128 * 8].copy()
    blk[3, :16] = np.inf
    for c in range(C):
        eng.push(c, blk[c])
    eng.step()
    assert eng.channel_resyncs[3] == 1
    assert eng.channel_resyncs.sum() == 1


def test_mixed_engine_guard_keeps_modes():
    """A guarded channel in the mixed engine keeps its (M, diff) mode rows
    (losing them would silently demodulate 8-PSK as BPSK after a resync)."""
    from psk_soft_tpu.models.mixed import MixedParams
    from psk_soft_tpu.ops.phase import UNWRAP_TREND_LEN
    from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine

    cfg = _cfg()
    rng = np.random.default_rng(5)
    ms = rng.choice([2, 4, 8], C)
    params = MixedParams.make(ms, rng.random(C) < 0.5)
    xs = _bank_signal(1024, seed0=500)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128,
                                 guard_nonfinite=True)
    need = 128 * cfg.sps
    for i in range(0, 5 * need, need):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        eng.step()
    assert eng.steady
    blk = xs[:, 5 * need: 6 * need].copy()
    blk[11] = np.nan
    for c in range(C):
        eng.push(c, blk[c])
    eng.step()
    assert eng.channel_resyncs[11] == 1
    misc = (cfg.phase_avg - 1) + 2 * (UNWRAP_TREND_LEN - 1)
    planes = np.asarray(eng._full_state.planes)
    np.testing.assert_array_equal(planes[misc + 6], np.asarray(ms, np.float32))
    assert planes[: misc, 11].max() == 0.0     # tracking itself was cleared


def test_full_engine_rolling_matches_legacy():
    """The engine's rolling-window fast path (window read from the previous
    block's planes) produces bit-identical outputs to the window-carry
    path, and the full_state property materializes an identical carry."""
    cfg = _cfg()
    xs = _bank_signal(2048, seed0=600)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128)
    ref = FullKernelBatchEngine(cfg, C, block_symbols=128)
    ref._roll_ok = False            # force the window-carry path
    need = 128 * cfg.sps
    outs, outs_ref = [], []
    for i in range(0, 12 * need, need):
        blk = xs[:, i: i + need]
        for c in range(C):
            eng.push(c, blk[c])
            ref.push(c, blk[c])
        o, o_ref = eng.step(), ref.step()
        if o is not None:
            outs.append(o)
            outs_ref.append(o_ref)
    assert eng.steady and eng._roll_ok is True and eng._win_stale
    assert ref._win_stale is False
    for o, o_ref in zip(outs, outs_ref):
        np.testing.assert_array_equal(np.asarray(o.soft),
                                      np.asarray(o_ref.soft))
        np.testing.assert_array_equal(np.asarray(o.bits),
                                      np.asarray(o_ref.bits))
        np.testing.assert_array_equal(np.asarray(o.sample_index),
                                      np.asarray(o_ref.sample_index))
    # full_state materializes the window from the kept previous planes.
    st, st_ref = eng.full_state, ref._full_state
    assert not eng._win_stale
    np.testing.assert_array_equal(np.asarray(st.win_re),
                                  np.asarray(st_ref.win_re))
    np.testing.assert_array_equal(np.asarray(st.win_im),
                                  np.asarray(st_ref.win_im))
    np.testing.assert_array_equal(np.asarray(st.planes),
                                  np.asarray(st_ref.planes))
    # And a live reconfigure from the rolling state keeps tracking: both
    # engines converge identically afterwards.
    import dataclasses
    new_cfg = dataclasses.replace(cfg, phase_avg=24)
    eng.configure(new_cfg)
    ref.configure(new_cfg)
    for i in range(12 * need, 16 * need, need):
        blk = xs[:, i: i + need]
        for c in range(C):
            eng.push(c, blk[c])
            ref.push(c, blk[c])
        o, o_ref = eng.step(), ref.step()
    np.testing.assert_array_equal(np.asarray(o.soft), np.asarray(o_ref.soft))


def test_full_engine_debug_ports_off_packets():
    """An engine built with debug_ports=False emits only the soft and bits
    ports (phase/sampleIndex 'unconnected'), with identical soft/bits
    payloads to a full-port engine, through warm-up, steady state and EOS."""
    from psk_soft_tpu.runtime.streams import (SRI, PORT_BITS, PORT_PHASE,
                                              PORT_SAMPLE_INDEX, PORT_SOFT)

    cfg = _cfg()
    xs = _bank_signal(1024, seed0=700)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128, debug_ports=False)
    ref = FullKernelBatchEngine(cfg, C, block_symbols=128)
    sri = SRI(stream_id="dbg", xdelta=1e-6)
    eng.set_input_sri(sri)
    ref.set_input_sri(sri)
    need = 128 * cfg.sps
    for i in range(0, 8 * need, need):
        blk = xs[:, i: i + need]
        for c in range(C):
            eng.push(c, blk[c])
            ref.push(c, blk[c])
        p, p_ref = eng.step_packets(), ref.step_packets()
        if p:
            assert set(p) == {PORT_SOFT, PORT_BITS}
            assert set(p_ref) == {PORT_SOFT, PORT_BITS, PORT_PHASE,
                                  PORT_SAMPLE_INDEX}
            np.testing.assert_array_equal(p[PORT_SOFT].data,
                                          p_ref[PORT_SOFT].data)
            np.testing.assert_array_equal(p[PORT_BITS].data,
                                          p_ref[PORT_BITS].data)
            assert p[PORT_SOFT].t == p_ref[PORT_SOFT].t
    assert eng.steady
    fp = eng.flush_packets()
    assert set(fp) <= {PORT_SOFT, PORT_BITS}


def test_device_resident_planes_match_host_planes():
    """push_planes accepts device (jax) arrays -- the resampler's output --
    without a host round trip; outputs equal the host-numpy plane path."""
    cfg = _cfg()
    xs = _bank_signal(768, seed0=5)
    blocks = np.split(xs, 6, axis=1)

    e1 = FullKernelBatchEngine(cfg, C, block_symbols=128)
    e2 = FullKernelBatchEngine(cfg, C, block_symbols=128)

    def feed_host(b):
        e1.push_planes(np.ascontiguousarray(blocks[b].real.T),
                       np.ascontiguousarray(blocks[b].imag.T))

    def feed_device(b):
        e2.push_planes(jnp.asarray(np.ascontiguousarray(blocks[b].real.T)),
                       jnp.asarray(np.ascontiguousarray(blocks[b].imag.T)))

    o1 = _collect(e1, feed_host, 6)
    o2 = _collect(e2, feed_device, 6)
    assert len(o1) == len(o2) > 0
    for (s1, v1, b1), (s2, v2, b2) in zip(o1, o2):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(b1, b2)
