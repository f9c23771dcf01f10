"""int8-quantized soft-decision outputs (kernel soft_i8_scale / engine
soft_i8): the SDR soft-bit wire format.

The dominant output plane (soft decisions, 8 bytes/symbol/channel float32)
drops to 2 bytes on the steady step's write AND the device->host fetch; the
packet layer dequantizes on the host.  Quantization error is bounded by
0.5/scale per component; bits/phase/sampleIndex are computed from the
full-precision values inside the kernel and must be UNCHANGED.  Explicit
opt-in, like int16 ingest (the error exceeds the golden 1e-3 tolerance).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (QuantSoft, dequantize_soft,
                                      demod_block_full, full_from_ff,
                                      make_full_demod_fn, to_demod_outputs)
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI, PORT_BITS, PORT_SOFT

C, NS = 128, 768
SCALE = 100.0


def _channels(m=4, sps=8):
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        x = np.zeros(NS * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 2e-4 * sps * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _steady_state(cfg, xs):
    warm, run = np.split(xs, [256 * cfg.sps], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    return full_from_ff(cfg, st_ff), run


def test_kernel_soft_i8_quantizes_soft_only():
    """Quantized soft within 0.5/scale of the f32 run; every other output
    plane (bits, phase, sampleIndex) and the carry bit-exact."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st, run = _steady_state(cfg, _channels())
    x_re = jnp.asarray(run.real.T)
    x_im = jnp.asarray(run.imag.T)
    fn32 = make_full_demod_fn(cfg)
    fn8 = make_full_demod_fn(cfg, soft_i8_scale=SCALE)
    st32, o32 = fn32(st, x_re, x_im)
    st8, o8 = fn8(st, x_re, x_im)

    assert o8.soft_re.dtype == jnp.int8 and o8.soft_im.dtype == jnp.int8
    deq_re = np.asarray(o8.soft_re, np.float32) / SCALE
    deq_im = np.asarray(o8.soft_im, np.float32) / SCALE
    np.testing.assert_allclose(deq_re, np.asarray(o32.soft_re),
                               atol=0.5 / SCALE + 1e-6)
    np.testing.assert_allclose(deq_im, np.asarray(o32.soft_im),
                               atol=0.5 / SCALE + 1e-6)
    np.testing.assert_array_equal(np.asarray(o8.bits_packed),
                                  np.asarray(o32.bits_packed))
    np.testing.assert_array_equal(np.asarray(o8.phase),
                                  np.asarray(o32.phase))
    np.testing.assert_array_equal(np.asarray(o8.sample_index),
                                  np.asarray(o32.sample_index))
    np.testing.assert_array_equal(np.asarray(st8.planes),
                                  np.asarray(st32.planes))


def test_kernel_soft_i8_clips_to_int8_range():
    """Values beyond +-127/scale clip instead of wrapping."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = 5.0 * _channels()          # |soft| ~ 5 >> 1.27
    st, run = _steady_state(cfg, xs)
    fn8 = make_full_demod_fn(cfg, soft_i8_scale=SCALE)
    _, o8 = fn8(st, jnp.asarray(run.real.T), jnp.asarray(run.imag.T))
    re = np.asarray(o8.soft_re)
    assert re.min() >= -127 and re.max() <= 127
    assert (np.abs(re) == 127).any()    # saturation actually happened


def test_to_demod_outputs_quant_roundtrip_and_guard():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st, run = _steady_state(cfg, _channels())
    fn8 = make_full_demod_fn(cfg, soft_i8_scale=SCALE)
    _, o8 = fn8(st, jnp.asarray(run.real.T), jnp.asarray(run.imag.T))
    with pytest.raises(ValueError, match="soft_i8_scale"):
        to_demod_outputs(cfg, o8)           # scale not passed
    d = to_demod_outputs(cfg, o8, soft_i8_scale=SCALE)
    assert isinstance(d.soft, QuantSoft)
    soft = dequantize_soft(
        QuantSoft(np.asarray(d.soft.re_q), np.asarray(d.soft.im_q),
                  d.soft.scale))
    assert soft.dtype == np.complex64
    np.testing.assert_allclose(soft.T * SCALE,
                               np.asarray(o8.soft_re, np.float32)
                               + 1j * np.asarray(o8.soft_im, np.float32),
                               atol=1e-6)


def test_engine_soft_i8_packets_match_f32_engine():
    """Production engine with soft_i8: PORT_SOFT packets are grid-snapped
    versions of the f32 engine's (within 0.5/scale), PORT_BITS identical,
    through warm-up, >= 3 steady blocks (exercises the rolling path), and
    the EOS drain."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels()
    kw = dict(block_symbols=128)
    e32 = FullKernelBatchEngine(cfg, C, **kw)
    e8 = FullKernelBatchEngine(cfg, C, soft_i8=True, soft_i8_scale=SCALE,
                               **kw)
    for e in (e32, e8):
        e.set_input_sri(SRI(stream_id="q", xdelta=1e-6))
    need = 128 * cfg.sps
    steady_blocks = 0
    for i in range(0, NS * cfg.sps, need):
        for c in range(C):
            e32.push(c, xs[c, i: i + need])
            e8.push(c, xs[c, i: i + need])
        was_steady = e8.steady
        p32, p8 = e32.step_packets(), e8.step_packets()
        assert (p32 is None) == (p8 is None)
        if p32 is None or not p32:
            continue
        if was_steady:
            steady_blocks += 1
        assert p8[PORT_SOFT].data.dtype == np.complex64
        # complex allclose compares |a-b|: per-component error 0.5/scale
        # combines to sqrt(2)*0.5/scale.
        np.testing.assert_allclose(p8[PORT_SOFT].data, p32[PORT_SOFT].data,
                                   atol=0.7072 / SCALE + 1e-6)
        np.testing.assert_array_equal(p8[PORT_BITS].data,
                                      p32[PORT_BITS].data)
        assert p8[PORT_SOFT].t == p32[PORT_SOFT].t
    assert e8.steady and steady_blocks >= 3
    f32, f8 = e32.flush_packets(), e8.flush_packets()
    assert set(f32) == set(f8)
    if f8.get(PORT_SOFT) is not None and f8[PORT_SOFT].data.size:
        np.testing.assert_allclose(f8[PORT_SOFT].data, f32[PORT_SOFT].data,
                                   atol=0.7072 / SCALE + 1e-6)


def test_engine_soft_i8_reconfigure_keeps_mode():
    """C7 property change on a soft_i8 engine: the rebuilt kernel step still
    quantizes (the _full_kwargs carry the scale through configure)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels()
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128, soft_i8=True)
    eng.set_input_sri(SRI(stream_id="rc", xdelta=1e-6))
    need = 128 * cfg.sps
    for i in range(0, need * 5, need):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        eng.step_packets()
    assert eng.steady
    eng.configure(DemodConfig(sps=8, num_avg=40, constellation_size=4,
                              phase_avg=20))
    assert eng._full_kwargs["soft_i8_scale"] == 100.0
    for i in range(need * 5, need * 8, need):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        p = eng.step_packets()
        if p and eng.steady:
            assert p[PORT_SOFT].data.dtype == np.complex64


def test_soft_i8_guard_mutually_exclusive():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    with pytest.raises(ValueError, match="mutually exclusive"):
        FullKernelBatchEngine(cfg, C, soft_i8=True, guard_nonfinite=True)


def test_soft_i8_requires_aligned_tile():
    """No tile rule is left: a 56-symbol block (not 32-row aligned)
    quantizes exactly like the float32 output of the same block."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st, run = _steady_state(cfg, _channels())
    x_re = jnp.asarray(run.real.T[: 56 * 8])
    x_im = jnp.asarray(run.imag.T[: 56 * 8])
    _, o8 = demod_block_full(cfg, st, x_re, x_im, soft_i8_scale=SCALE)
    _, o32 = demod_block_full(cfg, st, x_re, x_im)
    assert o8.soft_re.dtype == jnp.int8 and o8.soft_re.shape == (56, C)
    want = np.clip(np.round(np.asarray(o32.soft_re) * SCALE), -127, 127)
    np.testing.assert_array_equal(np.asarray(o8.soft_re), want)
    np.testing.assert_array_equal(np.asarray(o8.bits_packed),
                                  np.asarray(o32.bits_packed))
