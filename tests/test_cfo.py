"""CFO estimation from the phase port (eval/cfo.py): the phase debug
output's ramp slope recovers the injected carrier offset, per channel,
across re-wraps, in mixed banks, and straight from engine packets."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.eval.cfo import cfo_from_packet, cfo_from_phase
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI, PORT_PHASE

C = 8


def _bank(cfos, m=4, sps=8, ns=1200, seed=0):
    """One channel per requested CFO (cycles/sample)."""
    out = []
    for i, f in enumerate(cfos):
        rng = np.random.default_rng(seed + i)
        j = rng.integers(0, m, ns)
        pts = np.exp(2j * np.pi * j / m)
        x = np.repeat(pts, sps).astype(np.complex64)
        x = x * np.exp(2j * np.pi * f * np.arange(x.size))
        x += (0.003 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x.astype(np.complex64))
    return np.stack(out)


def test_cfo_from_phase_recovers_injected_offsets():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    cfos = np.array([0.0, 1e-4, -2e-4, 3e-4, -5e-5, 2.5e-4, 1.5e-4, -1e-4])
    xs = _bank(cfos)
    fn = make_ff_demod_fn(cfg, channels=len(cfos))
    st, out = fn(ff_init(cfg, (len(cfos),)), jnp.asarray(xs))
    v = np.asarray(out.valid)[0]
    phase = np.asarray(out.phase)[:, v][:, 50:]   # settled tracker region
    got = cfo_from_phase(phase, cfg.constellation_size, cfg.sps)
    np.testing.assert_allclose(got, cfos, atol=1.5e-5)


def test_cfo_handles_m2pi_rewraps():
    """A large offset drives the estimate past M*2pi repeatedly; the
    wrapped-difference slope must not notice the re-wrap jumps."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    f = 8e-4          # M*2pi every ~39 symbols
    xs = _bank([f] * 2, ns=2000)
    fn = make_ff_demod_fn(cfg, channels=2)
    st = ff_init(cfg, (2,))
    chunks = []
    step = 200 * cfg.sps          # rewrap applies between calls
    for i in range(0, xs.shape[1], step):
        st, out = fn(st, jnp.asarray(xs[:, i: i + step]))
        v = np.asarray(out.valid)[0]
        if v.any():
            chunks.append(np.asarray(out.phase)[:, v])
    phase = np.concatenate(chunks, axis=-1)[:, 50:]
    # the raw sequence really does jump (re-wrap happened)
    assert np.abs(np.diff(phase, axis=-1)).max() > np.pi
    got = cfo_from_phase(phase, 4, cfg.sps)
    np.testing.assert_allclose(got, [f, f], atol=2e-5)


def test_cfo_per_channel_m_and_plane_axis():
    """Mixed-bank per-channel M, and kernel-layout (S, C) planes via
    symbol_axis=0, give the same answers."""
    phase_cs = np.cumsum(
        np.array([[0.02], [0.06]]) * np.ones((2, 400)), axis=-1)
    ms = np.array([2.0, 8.0])
    got = cfo_from_phase(phase_cs, ms, sps=8)
    exp = np.array([0.02, 0.06]) / (ms * 2 * np.pi * 8)
    np.testing.assert_allclose(got, exp, rtol=1e-12)
    got_t = cfo_from_phase(phase_cs.T, ms, sps=8, symbol_axis=0)
    np.testing.assert_allclose(got_t, exp, rtol=1e-12)


def test_cfo_from_engine_packet():
    """End to end: flagship engine -> PORT_PHASE packet -> Hz, using the
    packet's own (rate-rescaled) SRI."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    cfos = np.array([1e-4, -2e-4] * 64)            # cycles/sample
    xs = _bank(cfos, ns=1200, seed=3)
    eng = FullKernelBatchEngine(cfg, 128, block_symbols=128)
    fs = 1e6
    eng.set_input_sri(SRI(stream_id="cfo", xdelta=1.0 / fs))
    need = 128 * cfg.sps
    last = None
    for i in range(0, xs.shape[1] - need + 1, need):
        for c in range(128):
            eng.push(c, xs[c, i: i + need])
        p = eng.step_packets()
        if p and eng.steady:
            last = p
    assert last is not None
    got_hz = cfo_from_packet(last[PORT_PHASE], cfg)
    np.testing.assert_allclose(got_hz, cfos * fs, atol=1.5e-5 * fs)


def test_cfo_needs_two_symbols():
    with pytest.raises(ValueError, match="at least 2"):
        cfo_from_phase(np.zeros((4, 1)), 4, sps=8)


def test_acquire_and_derotate_recovers_large_cfo():
    """Closing the loop: a CFO far beyond the phase tracker's lock range
    (per-symbol step M*2pi*f*sps > pi) breaks the bare demod; M-th-power
    acquisition (eval/cfo.acquire_cfo) + NCO derotation (ops/mixer) in
    front recovers the bits."""
    import jax.numpy as jnp
    from psk_soft_tpu import DemodConfig, demod_init, make_demod_fn
    from psk_soft_tpu.eval.cfo import acquire_cfo
    from psk_soft_tpu.ops.mixer import derotate_host
    from psk_soft_tpu.testing.signals import gen_psk_channel

    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    f_big = 0.02          # cycles/sample: step = 4*2pi*0.02*8 = 4.0 rad
    x0, _ = gen_psk_channel(400, sps=8, m=4, seed=3, snr_db=30,
                            timing_offset=1)
    x = derotate_host(x0, -f_big)        # impose the offset
    fn = make_demod_fn(cfg)

    _, out_ref = fn(demod_init(cfg), jnp.asarray(x0))
    _, out_bad = fn(demod_init(cfg), jnp.asarray(x))
    v = np.asarray(out_ref.valid)
    bits_ref = np.asarray(out_ref.bits)[v]
    bits_bad = np.asarray(out_bad.bits)[np.asarray(out_bad.valid)]
    n = min(len(bits_ref), len(bits_bad))
    assert (bits_bad[:n] != bits_ref[:n]).mean() > 0.2, \
        "fixture CFO unexpectedly within lock range"

    est = acquire_cfo(x, 4)
    assert abs(est - f_big) < 1.0 / (4 * 4096) + 1e-4
    x_fix = derotate_host(x, est)
    _, out_fix = fn(demod_init(cfg), jnp.asarray(x_fix))
    # residual CFO < one FFT bin -> tracker locks.  A fixed constellation
    # rotation may remain (absolute-phase M-fold ambiguity is inherent),
    # so compare SYMBOL TRANSITIONS (rotation-invariant) via soft angles.
    n = min(int(v.sum()), int(np.asarray(out_fix.valid).sum())) - 4
    a_ref = np.angle(np.asarray(out_ref.soft)[v])[:n]
    a_fix = np.angle(np.asarray(out_fix.soft)[
        np.asarray(out_fix.valid)])[:n]
    d = (np.diff(a_ref) - np.diff(a_fix) + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() < 0.5, "post-correction symbol transitions differ"


def test_acquire_cfo_per_channel_and_range():
    from psk_soft_tpu.eval.cfo import acquire_cfo
    from psk_soft_tpu.ops.mixer import derotate_host
    from psk_soft_tpu.testing.signals import gen_psk_channel

    fs = [0.01, -0.03, 0.0]
    xs = []
    for i, f in enumerate(fs):
        x, _ = gen_psk_channel(512, sps=8, m=4, seed=i, snr_db=25)
        xs.append(derotate_host(x, -f))
    est = acquire_cfo(np.stack(xs), 4, nfft=8192)
    np.testing.assert_allclose(est, fs, atol=2e-4)
    # Hz conversion
    est_hz = acquire_cfo(np.stack(xs), 4, nfft=8192, xdelta=1e-6)
    np.testing.assert_allclose(est_hz, np.asarray(fs) * 1e6, atol=200)


def test_derotate_planes_matches_host_and_carries_phase():
    import jax.numpy as jnp
    from psk_soft_tpu.ops.mixer import derotate, derotate_host

    rng = np.random.default_rng(2)
    T, C = 96, 3
    x = (rng.standard_normal((C, T))
         + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    freq = np.array([0.01, -0.004, 0.0], np.float32)
    p0 = np.array([0.3, -1.0, 0.0], np.float32)

    y_re, y_im, p_end = derotate(
        jnp.asarray(np.ascontiguousarray(x.real.T)),
        jnp.asarray(np.ascontiguousarray(x.imag.T)),
        jnp.asarray(freq), jnp.asarray(p0))
    want = np.stack([derotate_host(x[c], freq[c], p0[c]) for c in range(C)])
    got = np.asarray(y_re).T + 1j * np.asarray(y_im).T
    np.testing.assert_allclose(got, want, atol=2e-5)

    # streaming: two chained blocks == one long block
    half = T // 2
    y1_re, y1_im, pm = derotate(
        jnp.asarray(np.ascontiguousarray(x.real.T[:half])),
        jnp.asarray(np.ascontiguousarray(x.imag.T[:half])),
        jnp.asarray(freq), jnp.asarray(p0))
    y2_re, y2_im, _ = derotate(
        jnp.asarray(np.ascontiguousarray(x.real.T[half:])),
        jnp.asarray(np.ascontiguousarray(x.imag.T[half:])),
        jnp.asarray(freq), pm)
    got2 = np.concatenate([np.asarray(y1_re), np.asarray(y2_re)]) \
        + 1j * np.concatenate([np.asarray(y1_im), np.asarray(y2_im)])
    np.testing.assert_allclose(got2.T, want, atol=4e-5)
