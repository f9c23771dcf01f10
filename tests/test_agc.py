"""AGC + squelch front-end (ops/agc.py, runtime/agc.py).

Gates: matmul block form == sequential chunk recurrence (numpy oracle),
streaming == one-shot under any block split, host ragged path == device
batched path, squelch semantics, and demod integration (a scaled input
demodulates to the same constellation as an unscaled one)."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.ops.agc import (AgcConfig, agc_block, agc_init,
                                  agc_reference, make_agc_fn)
from psk_soft_tpu.runtime.agc import AgcFrontEnd


def _sig(c, t, seed=0, amp=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((c, t)) + 1j * rng.standard_normal((c, t))
         ).astype(np.complex64)
    return (amp * x / np.sqrt(2.0)).astype(np.complex64)


def test_block_matches_sequential_oracle():
    cfg = AgcConfig(target_rms=1.0, alpha=0.07, chunk=8)
    x = _sig(4, 1024, amp=3.0)
    st, y, info = agc_block(cfg, agc_init(cfg, (4,)), jnp.asarray(x))
    for c in range(4):
        y_ref, g_ref, p_ref = agc_reference(cfg, x[c])
        np.testing.assert_allclose(np.asarray(info["power"])[c], p_ref,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(info["gain"])[c], g_ref,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(y)[c], y_ref, atol=1e-4)


def test_streaming_equals_oneshot():
    cfg = AgcConfig(alpha=0.1, chunk=4)
    x = _sig(2, 960, seed=3, amp=0.2)
    fn = make_agc_fn(cfg)
    st, y_once, _ = fn(agc_init(cfg, (2,)), jnp.asarray(x))
    st2 = agc_init(cfg, (2,))
    outs = []
    for blk in np.split(x, [64, 320, 448], axis=1):
        st2, y, _ = fn(st2, jnp.asarray(blk))
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.asarray(y_once), atol=2e-5)
    np.testing.assert_allclose(np.asarray(st2.power), np.asarray(st.power),
                               rtol=1e-5)


def test_convergence_to_target():
    cfg = AgcConfig(target_rms=1.0, alpha=0.2, chunk=8)
    x = _sig(1, 4096, seed=5, amp=37.0)
    _, y, info = agc_block(cfg, agc_init(cfg, (1,)), jnp.asarray(x))
    tail = np.asarray(y)[0, 2048:]
    rms = np.sqrt(np.mean(np.abs(tail) ** 2))
    assert abs(rms - 1.0) < 0.1
    # Priming: the very first chunk is already near target (no transient).
    head = np.asarray(y)[0, : cfg.chunk]
    assert abs(np.sqrt(np.mean(np.abs(head) ** 2)) - 1.0) < 0.5


def test_squelch_mutes_and_reopens():
    cfg = AgcConfig(alpha=0.5, chunk=8, squelch_power=1e-2)
    quiet = _sig(1, 512, seed=7, amp=1e-3)[0]
    loud = _sig(1, 512, seed=8, amp=2.0)[0]
    x = np.stack([np.concatenate([quiet, loud]),
                  np.concatenate([loud[:512], loud[:512]])])
    _, y, info = agc_block(cfg, agc_init(cfg, (2,)), jnp.asarray(x))
    act = np.asarray(info["active"])
    assert not act[0, :32].any()          # quiet half muted
    assert act[0, -32:].all()             # reopens on the loud half
    assert act[1].all()                   # loud channel never squelched
    np.testing.assert_array_equal(np.asarray(y)[0, :256], 0)
    assert np.abs(np.asarray(y)[0, -256:]).max() > 0.1


class _SinkEngine:
    """Capture-only stand-in with the bank-engine ingest surface."""

    def __init__(self, channels, sps=8):
        self.cfg = DemodConfig(sps=sps, num_avg=20, phase_avg=10)
        self.channels = channels
        self.got = [[] for _ in range(channels)]
        self.planes = []

    def push(self, c, x):
        self.got[c].append(np.asarray(x))

    def push_planes(self, re, im):
        self.planes.append((re, im))

    def chan(self, c):
        return np.concatenate(self.got[c]) if self.got[c] else \
            np.zeros(0, np.complex64)


def test_host_ragged_equals_device_block():
    cfg = AgcConfig(alpha=0.03, chunk=8, squelch_power=1e-4)
    x = _sig(3, 2048, seed=11, amp=5.0)

    dev_sink = _SinkEngine(3)
    dev = AgcFrontEnd(dev_sink, cfg)
    dev.push_block(x)

    host_sink = _SinkEngine(3)
    host = AgcFrontEnd(host_sink, cfg)
    # Ragged pushes, including sub-chunk remainders.
    for c in range(3):
        pos = 0
        rng = np.random.default_rng(c)
        while pos < x.shape[1]:
            n = min(int(rng.integers(1, 300)), x.shape[1] - pos)
            host.push(c, x[c, pos:pos + n])
            pos += n
    for c in range(3):
        a, b = dev_sink.chan(c), host_sink.chan(c)
        n = min(a.size, b.size)
        assert n >= x.shape[1] - cfg.chunk
        np.testing.assert_allclose(a[:n], b[:n], atol=1e-4)
    np.testing.assert_allclose(dev._power, host._power, rtol=1e-4)


def test_plane_path_matches_block_path():
    cfg = AgcConfig(alpha=0.05, chunk=8)
    x = _sig(4, 1024, seed=13, amp=0.01)
    s1, s2 = _SinkEngine(4), _SinkEngine(4)
    a1, a2 = AgcFrontEnd(s1, cfg), AgcFrontEnd(s2, cfg)
    a1.push_block(x)
    a2.push_planes(x.real.T.astype(np.float32), x.imag.T.astype(np.float32))
    re, im = s2.planes[0]
    y1 = np.stack([s1.chan(c) for c in range(4)])
    np.testing.assert_allclose(y1.real, re.T, atol=1e-5)
    np.testing.assert_allclose(y1.imag, im.T, atol=1e-5)
    assert np.isfinite(a1.gains_db).all()
    assert not a1.squelched.any()


def test_agc_demod_integration():
    """A 40x-scaled bank behind the AGC demodulates to the same soft
    constellation as the unscaled bank (the reference's soft amplitudes
    track input level; the AGC pins them)."""
    from psk_soft_tpu.runtime.engine import BatchEngine

    C, S, sps = 4, 800, 8
    dcfg = DemodConfig(sps=sps, num_avg=50, phase_avg=20)
    rng = np.random.default_rng(17)
    xs = []
    for c in range(C):
        j = rng.integers(0, 4, S)
        x = np.repeat(np.exp(2j * np.pi * j / 4), sps)
        x += (1e-3 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x.astype(np.complex64))
    xs = np.stack(xs)

    ref_eng = BatchEngine(dcfg, C)
    for c in range(C):
        ref_eng.push(c, xs[c])
    ref_out = ref_eng.step()

    agc = AgcFrontEnd(BatchEngine(dcfg, C),
                      AgcConfig(target_rms=1.0, alpha=0.3, chunk=sps))
    agc.push_block(40.0 * xs)
    out = agc.engine.step()

    v = np.asarray(ref_out.valid) & np.asarray(out.valid)
    assert v.sum() > C * 400
    # Same decisions, unit-amplitude soft symbols despite the 40x input.
    np.testing.assert_allclose(np.abs(np.asarray(out.soft)[v]), 1.0,
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(out.soft)[v],
                               np.asarray(ref_out.soft)[v], atol=0.05)


def test_config_validation():
    with pytest.raises(ValueError):
        AgcConfig(alpha=0.0)
    with pytest.raises(ValueError):
        AgcConfig(chunk=0)
    cfg = AgcConfig(chunk=8)
    with pytest.raises(ValueError):
        agc_block(cfg, agc_init(cfg), jnp.zeros(12, jnp.complex64))
