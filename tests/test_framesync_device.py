"""Device-resident frame sync (round 4): the sparse detection path and the
engine device tap, gated equal to the host reference path.

The syncer's contract is unchanged (streaming == one-shot, gated in
test_framesync.py); here we pin the new machinery itself:

* detect_uw_sparse == correlate_uw + detect_peaks (same criterion, term
  for term) on dense multi-frame banks.
* extract_heads == host derotate + slice.
* FrameSyncer with the engine device tap == FrameSyncer tapping host
  packets (same frames from the same FullKernelBatchEngine stream),
  including the int8-soft kernel profile and the warm-up (channel-major
  DemodOutputs) blocks.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.ops import slicers
from psk_soft_tpu.ops.framesync import (FrameFormat, correlate_uw,
                                        detect_peaks, detect_uw_sparse,
                                        extract_heads, psk_points,
                                        resolve_rotation)
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
from psk_soft_tpu.runtime.framesync import FrameSyncer
from psk_soft_tpu.runtime.streams import SRI


def _soft_bank(C, S, fmt, seed=5, starts=None):
    """Random M-PSK soft plane with UW-led frames planted per channel."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, fmt.m, (C, S))
    if starts is None:
        starts = range(7, S - fmt.frame_len, 3 * fmt.frame_len // 2)
    for c in range(C):
        for s0 in starts:
            idx[c, s0:s0 + fmt.uw_len] = fmt.uw
    soft = psk_points(idx.reshape(-1), fmt.m).reshape(C, S)
    soft = soft + 0.03 * (rng.standard_normal((C, S))
                          + 1j * rng.standard_normal((C, S)))
    return soft.astype(np.complex64)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_sparse_detection_matches_dense(m):
    rng = np.random.default_rng(m)
    fmt = FrameFormat(uw=tuple(rng.integers(0, m, 24)), payload=40, m=m,
                      threshold=0.7)
    soft = _soft_bank(6, 600, fmt, seed=m)
    corr, norm = jax.device_get(correlate_uw(soft, fmt.points))
    dense = detect_peaks(norm, fmt.threshold, fmt.separation)
    cand = detect_uw_sparse(soft, fmt)
    assert cand.idx.dtype == np.int32     # exact at any block length
    got = {}
    for i in range(cand.idx.shape[0]):
        got.setdefault(int(cand.idx[i, 0]), []).append(i)
    for c, ts in enumerate(dense):
        rows = got.get(c, [])
        assert [int(cand.idx[i, 1]) for i in rows] == list(ts)
        for i in rows:
            t = int(cand.idx[i, 1])
            np.testing.assert_allclose(cand.vals[i, 0], norm[c, t],
                                       atol=1e-5)
            # angle parity up to f32 rounding
            d = np.angle(np.exp(1j * (cand.vals[i, 1]
                                      - np.angle(corr[c, t]))))
            assert abs(d) < 1e-4
    assert cand.idx.shape[0] == sum(len(ts) for ts in dense) > 6


def test_extract_heads_matches_host():
    rng = np.random.default_rng(9)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=24, m=4,
                      threshold=0.7)
    soft = _soft_bank(4, 400, fmt)
    corr, norm = jax.device_get(correlate_uw(soft, fmt.points))
    peaks = detect_peaks(norm, fmt.threshold, fmt.separation)
    heads = [(c, int(t)) for c, ts in enumerate(peaks) for t in ts
             if t + fmt.frame_len <= soft.shape[1]]
    assert len(heads) >= 5
    ks = [int(resolve_rotation(corr[c, t], fmt.m)[0]) for c, t in heads]
    pm, bits = extract_heads(soft, fmt, [c for c, _ in heads],
                             [t for _, t in heads], ks)
    nb = 2
    for i, (c, t) in enumerate(heads):
        derot = np.exp(-2j * np.pi * ks[i] / fmt.m).astype(np.complex64)
        want = soft[c, t + fmt.uw_len: t + fmt.frame_len] * derot
        np.testing.assert_allclose(pm[i], want, atol=1e-5)
        wb = np.asarray(slicers.slice_bits(fmt.m, want[None]))[0, :, :nb]
        np.testing.assert_array_equal(bits[i].reshape(-1, nb), wb)


def test_sync_extract_topk_matches_dense():
    from psk_soft_tpu.ops.framesync import sync_extract_topk

    rng = np.random.default_rng(3)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 24)), payload=32, m=4,
                      threshold=0.7)
    soft = _soft_bank(5, 512, fmt, seed=3,
                      starts=[20, 170, 320])         # 3 frames/channel
    k = 4                                            # capacity > frames
    pm, found, pos, ang, count = jax.jit(
        lambda s: sync_extract_topk(s, fmt, k))(jnp.asarray(soft))
    pm, found, pos, count = (jax.device_get(pm), np.asarray(found),
                             np.asarray(pos), np.asarray(count))
    corr, norm = jax.device_get(correlate_uw(soft, fmt.points))
    dense = detect_peaks(norm, fmt.threshold, fmt.separation)
    for c, ts in enumerate(dense):
        ts = ts[ts + fmt.frame_len <= soft.shape[1]]
        assert list(pos[c][found[c]]) == list(ts)
        assert count[c] == len(ts)        # full count, observable cap
        for j, t in enumerate(ts):
            kk, _ = resolve_rotation(corr[c, t], fmt.m)
            derot = np.exp(-2j * np.pi * int(kk) / fmt.m)
            want = soft[c, t + fmt.uw_len: t + fmt.frame_len] * derot
            np.testing.assert_allclose(pm[c, j], want, atol=1e-5)
    assert found.sum() == sum(
        len(ts[ts + fmt.frame_len <= soft.shape[1]]) for ts in dense) >= 15


def _run_engine_sync(device_tap: bool, soft_i8: bool = False,
                     data_ports: bool = True):
    C, sps = 128, 8
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(21)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 24)), payload=24, m=4,
                      threshold=0.7)
    s_total = 1600
    idx = rng.integers(0, 4, (C, s_total))
    starts = list(range(300, s_total - fmt.frame_len - 100, 200))
    for c in range(C):
        for s0 in starts:
            idx[c, s0:s0 + fmt.uw_len] = fmt.uw
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)

    eng = FullKernelBatchEngine(cfg, C, block_symbols=256, soft_i8=soft_i8,
                                data_ports=data_ports)
    eng.set_input_sri(SRI(stream_id="dev-tap"))
    sync = FrameSyncer(eng, fmt, device_tap=device_tap)
    assert sync._tap_device is device_tap
    need = 256 * sps
    for pos in range(0, x.shape[1] - need + 1, need):
        eng.push_block(x[:, pos:pos + need])
        pkts = sync.step_packets()
        if not data_ports:
            assert not pkts        # no plane fetch, no packets
    sync.flush_packets()
    return sync.pop_frames()


@pytest.mark.parametrize("soft_i8", [False, True])
def test_device_tap_matches_packet_tap(soft_i8):
    a = _run_engine_sync(device_tap=True, soft_i8=soft_i8)
    b = _run_engine_sync(device_tap=False, soft_i8=soft_i8)
    assert len(a) == len(b) > 100
    for fa, fb in zip(a, b):
        assert (fa.channel, fa.start, fa.rotation) == \
            (fb.channel, fb.start, fb.rotation)
        np.testing.assert_array_equal(fa.bits, fb.bits)
        np.testing.assert_allclose(fa.soft, fb.soft, atol=1e-6)
        np.testing.assert_allclose(fa.corr, fb.corr, atol=1e-5)


def test_frames_only_engine_same_frames():
    # data_ports=False (soft/bits unconnected -- the reference's
    # connected-port push guard, cpp/psk_soft.cpp:605-615): packet
    # assembly fetches nothing, yet the device-tap syncer produces the
    # IDENTICAL frame stream.
    a = _run_engine_sync(device_tap=True, data_ports=False)
    b = _run_engine_sync(device_tap=True, data_ports=True)
    assert len(a) == len(b) > 100
    for fa, fb in zip(a, b):
        assert (fa.channel, fa.start, fa.rotation) == \
            (fb.channel, fb.start, fb.rotation)
        np.testing.assert_array_equal(fa.bits, fb.bits)


def test_sync_topk_tm_matches_wrapper():
    # The time-major core and the (C, S) wrapper must agree exactly
    # (the wrapper is a transpose; all picks are one-hot-exact).
    from psk_soft_tpu.ops.framesync import (sync_extract_topk,
                                            sync_extract_topk_tm)

    rng = np.random.default_rng(7)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 24)), payload=32, m=4,
                      threshold=0.7)
    soft = _soft_bank(4, 512, fmt, seed=7, starts=[30, 200, 350])
    k = 3
    pm1, f1, p1, a1, n1 = jax.jit(
        lambda s: sync_extract_topk(s, fmt, k))(jnp.asarray(soft))
    re_t = np.ascontiguousarray(soft.real.T)
    im_t = np.ascontiguousarray(soft.imag.T)
    pm2, f2, p2, a2, n2 = jax.jit(
        lambda r, i: sync_extract_topk_tm(r, i, fmt, k))(re_t, im_t)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
    f = np.asarray(f1)
    np.testing.assert_array_equal(np.asarray(a1)[f], np.asarray(a2)[f])
    np.testing.assert_array_equal(jax.device_get(pm1)[f], jax.device_get(pm2)[f])


def test_sync_topk_fuzz_vs_dense():
    # Seeded property fuzz of the time-major sync core against the dense
    # host criterion across random formats and bank shapes, including
    # no-peak channels, more peaks than capacity, and frames whose
    # payload runs past the block edge (containment drop).
    from psk_soft_tpu.ops.framesync import sync_extract_topk

    rng = np.random.default_rng(42)
    for trial in range(8):
        m = int(rng.choice([2, 4, 8]))
        u_len = int(rng.integers(12, 33))
        payload = int(rng.integers(8, 49))
        s = int(rng.integers(2, 5)) * 128
        c = int(rng.integers(2, 6))
        fmt = FrameFormat(uw=tuple(rng.integers(0, m, u_len)),
                          payload=payload, m=m, threshold=0.7)
        if s < fmt.frame_len + 8:
            continue
        idx = rng.integers(0, m, (c, s))
        for ch in range(c):
            n_frames = int(rng.integers(0, 5))
            spots = rng.choice(
                max(1, (s - u_len) // fmt.separation), size=n_frames,
                replace=False) * fmt.separation
            for s0 in spots:          # some payloads intentionally overrun
                idx[ch, s0:s0 + u_len] = fmt.uw
        soft = psk_points(idx.reshape(-1), m).reshape(c, s)
        soft = (soft + 0.05 * (rng.standard_normal((c, s))
                               + 1j * rng.standard_normal((c, s)))
                ).astype(np.complex64)
        k = int(rng.integers(1, 5))
        pm, found, pos, ang, count = jax.jit(
            lambda x, fmt=fmt, k=k: sync_extract_topk(x, fmt, k)
        )(jnp.asarray(soft))
        pm, found, pos, count = (jax.device_get(pm), np.asarray(found),
                                 np.asarray(pos), np.asarray(count))
        corr, norm = jax.device_get(correlate_uw(soft, fmt.points))
        dense = detect_peaks(norm, fmt.threshold, fmt.separation)
        for ch, ts in enumerate(dense):
            ts = ts[ts + fmt.frame_len <= s]
            assert count[ch] == len(ts), (trial, ch)  # full, uncapped
            ts = ts[:k]                               # earliest-k contained
            assert list(pos[ch][found[ch]]) == list(ts), (trial, ch)
            for j, t in enumerate(ts):
                kk, _ = resolve_rotation(corr[ch, t], fmt.m)
                derot = np.exp(-2j * np.pi * int(kk) / fmt.m)
                want = soft[ch, t + fmt.uw_len: t + fmt.frame_len] * derot
                np.testing.assert_allclose(pm[ch, j], want, atol=1e-5)
