"""int16 ingest mode of the steady step (the SDR wire format -- REDHAWK
bulkio dataShort, cpp/psk_soft_base.cpp:42-47 family): samples arrive at
2 bytes and dequantize on the device, halving the input bytes.

Parity gate: the i16 step fed the exact wire values must match the f32
step fed the dequantized (i16 * scale) planes -- identical arithmetic
after the dequant, so tolerances are float-noise tight."""

import numpy as np
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                      quantize_full_state)
from psk_soft_tpu.testing.signals import gen_psk_channel

C = 128


def _quantized_bank(cfg, S, seed0=0, pulse="rect"):
    xs = np.stack([
        gen_psk_channel(S, sps=cfg.sps, m=cfg.constellation_size,
                        seed=seed0 + i, snr_db=25, freq_offset=1e-4,
                        pulse=pulse, rrc_beta=cfg.rrc_beta,
                        rrc_span=cfg.rrc_span)[0] for i in range(C)])
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    xi_re = np.round(xs.real / scale).astype(np.int16)
    xi_im = np.round(xs.imag / scale).astype(np.int16)
    xq = (xi_re.astype(np.float32) * scale
          + 1j * xi_im.astype(np.float32) * scale).astype(np.complex64)
    return xq, xi_re, xi_im, scale


def _i16_vs_f32(cfg, S=768, seed0=0, pulse="rect", warm_syms=256):
    xq, xi_re, xi_im, scale = _quantized_bank(cfg, S, seed0, pulse)
    warm_t = warm_syms * cfg.sps
    warm, run = xq[:, :warm_t], xq[:, warm_t:]
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    raw_win = None
    if cfg.matched_filter != "none":
        keep = (cfg.num_avg - 1) * cfg.sps + cfg.mf_ntaps - 1
        raw_win = warm[:, warm.shape[1] - keep:]
    st = full_from_ff(cfg, st_ff, raw_win=raw_win)

    fn32 = make_full_demod_fn(cfg)
    _, out32 = fn32(st, jnp.asarray(np.ascontiguousarray(run.real.T)),
                    jnp.asarray(np.ascontiguousarray(run.imag.T)))

    st16 = quantize_full_state(st, scale)
    fn16 = make_full_demod_fn(cfg, in_scale=scale)
    st16b, out16 = fn16(st16, jnp.asarray(np.ascontiguousarray(
        xi_re[:, warm_t:].T)), jnp.asarray(np.ascontiguousarray(
            xi_im[:, warm_t:].T)))
    assert st16b.win_re.dtype == jnp.int16  # carry stays on the wire format
    np.testing.assert_array_equal(np.asarray(out16.sample_index),
                                  np.asarray(out32.sample_index))
    np.testing.assert_array_equal(np.asarray(out16.bits_packed),
                                  np.asarray(out32.bits_packed))
    np.testing.assert_allclose(np.asarray(out16.soft_re),
                               np.asarray(out32.soft_re), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out16.soft_im),
                               np.asarray(out32.soft_im), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out16.phase),
                               np.asarray(out32.phase), atol=1e-4)


def test_i16_plain_qpsk():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    _i16_vs_f32(cfg)


def test_i16_sps10_concat_path():
    """sps=10: wlen not 16-row aligned, forces the concat DMA path with the
    doubled (16, 128) int16 granule."""
    cfg = DemodConfig(sps=10, num_avg=50, constellation_size=4, phase_avg=20)
    _i16_vs_f32(cfg, S=640, seed0=40)


def test_i16_rrc_interp():
    """Matched filter + fractional timing on the int16 path (the FIR runs
    on the dequantized values)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    _i16_vs_f32(cfg, seed0=80, pulse="rrc")


def test_i16_double_buffer():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xq, xi_re, xi_im, scale = _quantized_bank(cfg, 768, seed0=120)
    warm_t = 256 * cfg.sps
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(xq[:, :warm_t]))
    st16 = quantize_full_state(full_from_ff(cfg, st_ff), scale)
    from psk_soft_tpu.models.full import demod_block_full
    import functools
    outs = []
    for db in (False, True):
        fn = functools.partial(demod_block_full, cfg, in_scale=scale)
        _, o = fn(st16, jnp.asarray(np.ascontiguousarray(
            xi_re[:, warm_t:].T)), jnp.asarray(np.ascontiguousarray(
                xi_im[:, warm_t:].T)))
        outs.append(o)
    np.testing.assert_array_equal(np.asarray(outs[0].soft_re),
                                  np.asarray(outs[1].soft_re))
    np.testing.assert_array_equal(np.asarray(outs[0].bits_packed),
                                  np.asarray(outs[1].bits_packed))


def test_i16_quantization_noise_within_golden_tolerance():
    """End-to-end: int16 quantization keeps soft decisions within the
    reference's 1e-3 integration bound (timing-decisive signals -- on pure
    rectangular pulses the energy argmax is a noise-level tie that any
    perturbation legally flips, see PARITY.md)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = []
    for i in range(C):
        r = np.random.default_rng(160 + i)
        j = r.integers(0, 4, 768)
        x = np.zeros(768 * 8, np.complex64)
        x[3::8] = np.exp(2j * np.pi * j / 4) * np.exp(
            2j * np.pi * 1e-4 * 8 * np.arange(768))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    xi_re = np.round(xs.real / scale).astype(np.int16)
    xi_im = np.round(xs.imag / scale).astype(np.int16)
    # vs the UNQUANTIZED f32 pipeline: error budget = quantization only.
    warm_t = 256 * cfg.sps
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(xs[:, :warm_t]))
    st = full_from_ff(cfg, st_ff)
    fn32 = make_full_demod_fn(cfg)
    _, out32 = fn32(st, jnp.asarray(np.ascontiguousarray(
        xs[:, warm_t:].real.T)), jnp.asarray(np.ascontiguousarray(
            xs[:, warm_t:].imag.T)))
    fn16 = make_full_demod_fn(cfg, in_scale=scale)
    _, out16 = fn16(quantize_full_state(st, scale),
                    jnp.asarray(np.ascontiguousarray(xi_re[:, warm_t:].T)),
                    jnp.asarray(np.ascontiguousarray(xi_im[:, warm_t:].T)))
    err = np.abs((np.asarray(out16.soft_re) + 1j * np.asarray(out16.soft_im))
                 - (np.asarray(out32.soft_re)
                    + 1j * np.asarray(out32.soft_im)))
    assert err.max() < 1e-3, err.max()
