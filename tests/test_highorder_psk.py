"""16/32-PSK extension: generalized power-of-two constellations.

The reference supports M in {2, 4, 8} and warns "unsupported constellation
size" otherwise (cpp/psk_soft.cpp:565-566).  This framework extends the same
generalized mapping the reference's 8-PSK slicer implements -- phase k*2pi/M
-> binary k, LSB-first -- to M = 16 and 32, across every pipeline: the exact
scan, the feed-forward block pipeline, the steady step, and the
mixed-mode bank.  The numpy oracle's recursion (testing/oracle.py) is generic
in M, so parity against the reference *algorithm* is still assertable.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import full_from_ff, make_full_demod_fn, to_demod_outputs
from psk_soft_tpu.models.mixed import MixedParams, make_mixed_demod_fn, mixed_init
from psk_soft_tpu.models.psk import demod_init, make_demod_fn
from psk_soft_tpu.ops import slicers
from psk_soft_tpu.ops.phase import mth_power_phase, mth_power_phase_dynamic
from psk_soft_tpu.testing.oracle import demod_reference
from psk_soft_tpu.testing.signals import gen_psk, gen_psk_channel


def test_config_accepts_high_order():
    assert DemodConfig(constellation_size=16).bits_per_symbol == 4
    assert DemodConfig(constellation_size=32).bits_per_symbol == 5
    with pytest.raises(ValueError):
        DemodConfig(constellation_size=12)
    with pytest.raises(ValueError):
        DemodConfig(constellation_size=64)


@pytest.mark.parametrize("m", [16, 32])
def test_slice_mpsk_mapping(m):
    """Constellation point k must slice to binary k, LSB-first."""
    k = np.arange(m)
    soft = jnp.asarray(np.exp(2j * np.pi * k / m).astype(np.complex64))
    bits = np.asarray(slicers.slice_bits(m, soft))
    nb = int(np.log2(m))
    assert bits.shape == (m, nb)
    got = (bits * (1 << np.arange(nb))).sum(axis=-1)
    np.testing.assert_array_equal(got, k)


def test_slice_mpsk_m8_matches_legacy():
    rng = np.random.default_rng(0)
    soft = jnp.asarray((rng.standard_normal(512)
                        + 1j * rng.standard_normal(512)).astype(np.complex64))
    np.testing.assert_array_equal(np.asarray(slicers.slice_mpsk(8, soft)),
                                  np.asarray(slicers.slice_8psk(soft)))


def test_slice_dynamic_matches_static():
    rng = np.random.default_rng(1)
    ms = np.array([2, 4, 8, 16, 32] * 20, np.int32)
    soft = jnp.asarray((rng.standard_normal(ms.size)
                        + 1j * rng.standard_normal(ms.size)
                        ).astype(np.complex64))
    dyn = np.asarray(slicers.slice_bits_dynamic(jnp.asarray(ms), soft,
                                                max_bits=5))
    assert dyn.shape == (ms.size, 5)
    for m in (2, 4, 8, 16, 32):
        sel = ms == m
        stat = np.asarray(slicers.slice_bits(m, soft[sel]))
        nb = stat.shape[-1]
        np.testing.assert_array_equal(dyn[sel][:, :nb], stat)
        # Planes past log2(m) are zero padding.
        np.testing.assert_array_equal(dyn[sel][:, max(nb, int(np.log2(m))):],
                                      0)


@pytest.mark.parametrize("m", [16, 32])
def test_mth_power_phase_high_order(m):
    rng = np.random.default_rng(2)
    s = (rng.standard_normal(256) + 1j * rng.standard_normal(256)
         ).astype(np.complex64)
    got = np.asarray(mth_power_phase(jnp.asarray(s), m))
    want = np.angle(s.astype(np.complex128) ** m).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-3)
    got_dyn = np.asarray(mth_power_phase_dynamic(
        jnp.asarray(s), jnp.full(s.shape, m, jnp.int32)))
    np.testing.assert_allclose(got_dyn, got, atol=1e-5)


@pytest.mark.parametrize("m", [16, 32])
def test_exact_pipeline_high_order_golden(m):
    """Golden-style check at M=16/32: clean rectangular pulses demodulate to
    the ideal constellation within 1e-3 modulo the M-fold ambiguity
    (tests/test_psk_soft.py:223-238 generalized)."""
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=m, phase_avg=50)
    x, syms = gen_psk(800, 8, m)
    st, out = make_demod_fn(cfg)(demod_init(cfg), jnp.asarray(x))
    out = jax.device_get(out)
    soft = out.soft[out.valid]
    exp = syms[: soft.size]
    best = min(
        np.abs(soft - exp * np.exp(2j * np.pi * r / m)).max()
        for r in range(m))
    assert best < 1e-3


def test_exact_pipeline_matches_oracle_m16():
    """The exact-scan pipeline must equal the reference recursion (numpy
    oracle) run at M=16 -- the oracle's update equations are generic in M.

    Timing-decisive signal (one strong sample per symbol) to keep the
    argmax tie-free, per PARITY.md's tie-sensitivity caveat."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=16, phase_avg=20)
    rng = np.random.default_rng(7)
    j = rng.integers(0, 16, 400)
    x = np.zeros(400 * 8, np.complex64)
    x[5::8] = np.exp(2j * np.pi * j / 16)
    x += (0.02 * rng.standard_normal(x.size)).astype(np.complex64)
    ref = demod_reference(x, sps=8, num_avg=50, m=16, phase_avg=20)
    st, out = make_demod_fn(cfg)(demod_init(cfg), jnp.asarray(x))
    out = jax.device_get(out)
    soft = out.soft[out.valid]
    n = min(soft.size, ref["soft"].size)
    np.testing.assert_allclose(soft[:n], ref["soft"][:n], atol=1e-4)
    np.testing.assert_array_equal(out.sample_index[out.valid][:n],
                                  ref["sample_index"][:n])


@pytest.mark.parametrize("m", [16, 32])
def test_ff_pipeline_high_order(m):
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=m, phase_avg=20)
    x, _ = gen_psk_channel(500, sps=8, m=m, seed=3, freq_offset=5e-5,
                           snr_db=30.0)
    st, out_ff = make_ff_demod_fn(cfg)(ff_init(cfg), jnp.asarray(x))
    st2, out_ex = make_demod_fn(cfg)(demod_init(cfg), jnp.asarray(x))
    v = np.asarray(out_ff.valid)
    ve = np.asarray(out_ex.valid)
    np.testing.assert_array_equal(v, ve)
    np.testing.assert_allclose(np.asarray(out_ff.soft)[v],
                               np.asarray(out_ex.soft)[ve], atol=1e-3)
    nb = cfg.bits_per_symbol
    np.testing.assert_array_equal(np.asarray(out_ff.bits)[v][:, :nb],
                                  np.asarray(out_ex.bits)[ve][:, :nb])


@pytest.mark.parametrize("m", [16, 32])
def test_full_kernel_high_order(m):
    """Steady step at M=16/32 vs the FF pipeline."""
    C, NS, sps = 128, 384, 8
    cfg = DemodConfig(sps=sps, num_avg=50, constellation_size=m,
                      phase_avg=20)
    # Timing-decisive signal (one strong sample per symbol) so the argmax
    # is tie-free across accumulation orders (PARITY.md tie caveat).
    def chan(c):
        rng = np.random.default_rng(10 + c)
        j = rng.integers(0, m, NS)
        x = np.zeros(NS * sps, np.complex64)
        x[2::sps] = np.exp(2j * np.pi * j / m) * np.exp(
            2j * np.pi * 2e-5 * sps * np.arange(NS))
        return x + (0.01 * rng.standard_normal(x.size)).astype(np.complex64)

    xs = np.stack([chan(c) for c in range(C)])
    warm, run = np.split(xs, [128 * sps], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st_full = full_from_ff(cfg, st_ff)
    fn_full = make_full_demod_fn(cfg)
    st_full, out_full = fn_full(st_full, jnp.asarray(run.real.T),
                                jnp.asarray(run.imag.T))
    out_full = to_demod_outputs(cfg, out_full)
    st_ff, out_ff = fn_ff(st_ff, jnp.asarray(run))
    assert np.asarray(out_ff.valid).all()
    np.testing.assert_array_equal(np.asarray(out_full.sample_index),
                                  np.asarray(out_ff.sample_index))
    np.testing.assert_allclose(np.asarray(out_full.soft),
                               np.asarray(out_ff.soft), atol=3e-3)
    nb = cfg.bits_per_symbol
    np.testing.assert_array_equal(np.asarray(out_full.bits)[..., :nb],
                                  np.asarray(out_ff.bits)[..., :nb])


def test_ber_harness_high_order():
    """BER harness at M=16: theoretical curve finite/monotone, and a
    high-SNR measurement lands near-error-free with the documented
    mapping."""
    from psk_soft_tpu.eval.ber import measure_ber, theoretical_ber

    th16 = theoretical_ber(16, np.array([10.0, 15.0, 20.0]))
    th32 = theoretical_ber(32, np.array([15.0, 20.0, 25.0]))
    assert np.all(np.diff(th16) < 0) and np.all(th16 > 0)
    assert np.all(np.diff(th32) < 0) and np.all(th32 > 0)

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=16, phase_avg=20)
    pt = measure_ber(cfg, esn0_db=25.0, num_symbols=4000, seed=1)
    assert pt.n_bits > 10000
    assert pt.ber < 1e-3


def test_mixed_kernel_engine_high_order():
    """MixedKernelBatchEngine with 16/32-PSK channels in the bank: the fused
    kernel's mode planes, the warm-up XLA path, and the packet layer must
    all carry the generalized constellations (5-wide port layout)."""
    from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine

    C, S = 128, 512
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(5)
    ms = rng.choice([2, 4, 8, 16, 32], C)
    diffs = np.zeros(C, bool)
    xs = []
    for c in range(C):
        r = np.random.default_rng(40 + c)
        m = int(ms[c])
        j = r.integers(0, m, S)
        x = np.zeros(S * 8, np.complex64)
        x[3::8] = np.exp(2j * np.pi * j / m)
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    params = MixedParams.make(ms, diffs)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    from psk_soft_tpu.runtime.streams import PORT_BITS, PORT_SOFT, SRI
    eng.set_input_sri(SRI(stream_id="ho", xdelta=1e-6))
    fn = make_mixed_demod_fn(cfg, max_bits=params.max_bits)
    ref_st = mixed_init(cfg, C)
    nbs = np.log2(ms).astype(int)
    for blk in np.split(xs, 4, axis=1):
        for c in range(C):
            eng.push(c, blk[c])
        pkts = eng.step_packets()
        ref_st, ref = fn(params, ref_st, jnp.asarray(blk))
        v = np.asarray(ref.valid)[0]
        if not v.any() or not pkts:
            continue
        soft_pkt = pkts[PORT_SOFT].data
        np.testing.assert_allclose(soft_pkt, np.asarray(ref.soft)[:, v],
                                   atol=3e-3)
        # Bits port: 5-wide layout, per-channel mask to log2(m).
        bits_pkt = pkts[PORT_BITS].data.reshape(C, -1, params.max_bits)
        ref_bits = np.asarray(ref.bits)[:, v]
        for c in [0, 1, 7, 63, C - 1]:
            np.testing.assert_array_equal(bits_pkt[c][:, :nbs[c]],
                                          ref_bits[c][:, :nbs[c]])


def test_mixed_bank_with_high_order_channels():
    """A bank mixing {4, 8, 16, 32} must match homogeneous FF runs
    per channel, with 5-wide zero-padded bit planes."""
    C, NS = 8, 500
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    ms = np.array([4, 8, 16, 32, 16, 2, 32, 4], np.int32)
    diffs = np.zeros(C, bool)
    xs = np.stack([
        gen_psk_channel(NS, sps=8, m=int(ms[c]), seed=20 + c,
                        freq_offset=1e-5, snr_db=35.0)[0] for c in range(C)])
    params = MixedParams.make(ms, diffs)
    assert params.max_bits == 5
    fn = make_mixed_demod_fn(cfg, max_bits=params.max_bits)
    st, out = fn(params, mixed_init(cfg, C), jnp.asarray(xs))
    assert np.asarray(out.bits).shape[-1] == 5
    np.testing.assert_array_equal(
        np.asarray(params.bits_per_symbol), np.log2(ms).astype(np.int32))
    for c in range(C):
        cfg_c = DemodConfig(sps=8, num_avg=50, constellation_size=int(ms[c]),
                            phase_avg=20)
        _, out_c = make_ff_demod_fn(cfg_c)(ff_init(cfg_c), jnp.asarray(xs[c]))
        v = np.asarray(out_c.valid)
        np.testing.assert_array_equal(np.asarray(out.valid)[c], v)
        np.testing.assert_allclose(np.asarray(out.soft)[c][v],
                                   np.asarray(out_c.soft)[v], atol=1e-4)
        nb = cfg_c.bits_per_symbol
        np.testing.assert_array_equal(np.asarray(out.bits)[c][v][:, :nb],
                                      np.asarray(out_c.bits)[v][:, :nb])
