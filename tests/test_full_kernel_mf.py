"""Matched filter + fractional timing on the steady-state flagship path
(BASELINE config 3 -- 8-PSK + RRC + early-late).

The RRC FIR runs inside the steady step on [window | block] (the window
carry holds RAW samples); fractional timing is the circular-centroid
estimate on the bin energies.  Parity gate: the steady step against
models/blockpsk on shaped signals.
"""

import numpy as np
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                      to_demod_outputs)
from psk_soft_tpu.runtime.engine import BatchEngine, FullKernelBatchEngine
from psk_soft_tpu.testing.signals import gen_psk_channel

C = 128


def _bank(cfg, S, seed0=0, m=None, pulse="rrc"):
    m = m or cfg.constellation_size
    return np.stack([
        gen_psk_channel(S, sps=cfg.sps, m=m, seed=seed0 + i, snr_db=25,
                        freq_offset=1e-4, pulse=pulse,
                        rrc_beta=cfg.rrc_beta, rrc_span=cfg.rrc_span)[0]
        for i in range(C)])


def _kernel_vs_ff(cfg, xs, warm_syms=256, index_exact=True):
    warm, run = np.split(xs, [warm_syms * cfg.sps], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    raw_win = None
    if cfg.matched_filter != "none":
        keep = (cfg.num_avg - 1) * cfg.sps + cfg.mf_ntaps - 1
        raw_win = warm[:, warm.shape[1] - keep:]
    st = full_from_ff(cfg, st_ff, raw_win=raw_win)
    fn = make_full_demod_fn(cfg)
    st, out = fn(st, jnp.asarray(np.ascontiguousarray(run.real.T)),
                 jnp.asarray(np.ascontiguousarray(run.imag.T)))
    d = to_demod_outputs(cfg, out)
    _, out_ff = fn_ff(st_ff, jnp.asarray(run))
    if index_exact:
        np.testing.assert_array_equal(np.asarray(d.sample_index),
                                      np.asarray(out_ff.sample_index))
    np.testing.assert_allclose(np.asarray(d.soft), np.asarray(out_ff.soft),
                               atol=3e-3)
    np.testing.assert_allclose(np.asarray(d.phase),
                               np.asarray(out_ff.phase), atol=1e-3)
    return d


def test_config3_rrc_interp_8psk_parity():
    """BASELINE config 3 on the flagship kernel: 8-PSK, RRC, early-late."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    _kernel_vs_ff(cfg, _bank(cfg, 768))


def test_rrc_argmax_parity():
    """Matched filter alone (argmax timing)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=6)
    _kernel_vs_ff(cfg, _bank(cfg, 768, seed0=50))


def test_interp_only_parity():
    """Fractional timing alone on unshaped (decisive-peak) signals."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20,
                      timing_interp=True)
    xs = []
    for i in range(C):
        rng = np.random.default_rng(200 + i)
        j = rng.integers(0, 4, 768)
        x = np.zeros(768 * 8, np.complex64)
        x[3::8] = np.exp(2j * np.pi * j / 4)
        x[4::8] = 0.5 * np.exp(2j * np.pi * j / 4)  # asymmetric peak
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    _kernel_vs_ff(cfg, np.stack(xs))


def test_boxcar_parity_sps10():
    """Boxcar filter (odd halo length) on the default sps=10 grid."""
    cfg = DemodConfig(sps=10, num_avg=50, constellation_size=4, phase_avg=20,
                      matched_filter="boxcar")
    xs = _bank(cfg, 640, seed0=300, pulse="rect")
    _kernel_vs_ff(cfg, xs)


def test_full_engine_rrc_end_to_end():
    """FullKernelBatchEngine reaches steady state under an RRC config and
    matches the ff BatchEngine block for block."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    xs = _bank(cfg, 1024, seed0=400)
    ref = BatchEngine(cfg, channels=C, block_symbols=128)
    eng = FullKernelBatchEngine(cfg, channels=C, block_symbols=128)
    ref_soft, full_soft = [], []
    for blk in np.split(xs, 8, axis=1):
        for c in range(C):
            ref.push(c, blk[c])
            eng.push(c, blk[c])
        o1, o2 = ref.step(), eng.step()
        common = np.asarray(o1.valid) & np.asarray(o2.valid)
        ref_soft.append(np.asarray(o1.soft)[common])
        full_soft.append(np.asarray(o2.soft)[common])
    assert eng.steady
    np.testing.assert_allclose(np.concatenate(full_soft),
                               np.concatenate(ref_soft), atol=5e-3)


def test_full_engine_rrc_reconfigure_roundtrip():
    """Steady RRC engine -> configure -> steady again (ff_from_full carries
    the raw window back; the raw tail is reseeded for the next handoff)."""
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=4)
    xs = _bank(cfg, 1024, seed0=500)
    eng = FullKernelBatchEngine(cfg, channels=C, block_symbols=128)
    blocks = np.split(xs, 8, axis=1)
    for blk in blocks[:3]:
        for c in range(C):
            eng.push(c, blk[c])
        eng.step()
    assert eng.steady
    import dataclasses
    eng.configure(dataclasses.replace(cfg, phase_avg=16))
    assert not eng.steady
    softs = []
    for blk in blocks[3:]:
        for c in range(C):
            eng.push(c, blk[c])
        out = eng.step()
        softs.append(np.asarray(out.soft)[np.asarray(out.valid)])
    assert eng.steady  # handed back with a full raw tail
    soft = np.concatenate(softs)
    assert soft.size == C * 128 * 5  # no re-warm-up gap: carry survived
    ang = np.angle(soft * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    dist = np.minimum(ang, np.pi / 2 - ang)
    # Short-span RRC truncation ISI dominates here; a cleared carry would
    # put p99 near pi/4.
    assert np.percentile(dist, 99) < 0.25


def test_mixed_mode_kernel_parity():
    """Per-channel (M, differential) planes in the steady step (VERDICT
    round-1 item 2: BASELINE config 4 at kernel speed).  Parity vs the XLA
    mixed pipeline on timing-decisive signals."""
    from psk_soft_tpu.models.mixed import (MixedParams, make_mixed_demod_fn,
                                           mixed_init)
    from psk_soft_tpu.models.full import (full_from_ff,
                                          make_mixed_full_demod_fn)

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(0)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = []
    for i in range(C):
        r = np.random.default_rng(700 + i)
        m = int(ms[i])
        j = r.integers(0, m, 768)
        pts = np.exp(2j * np.pi * j / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(768 * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(768))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    params = MixedParams.make(ms, diffs)
    warm, run = np.split(xs, [256 * 8], axis=1)
    fn_mx = make_mixed_demod_fn(cfg)
    st_mx, _ = fn_mx(params, mixed_init(cfg, C), jnp.asarray(warm))
    st = full_from_ff(cfg, st_mx, mixed_params=params)
    fn = make_mixed_full_demod_fn(cfg)
    st, out = fn(st, jnp.asarray(np.ascontiguousarray(run.real.T)),
                 jnp.asarray(np.ascontiguousarray(run.imag.T)))
    from psk_soft_tpu.models.full import to_demod_outputs
    d = to_demod_outputs(cfg, out)
    _, out_mx = fn_mx(params, st_mx, jnp.asarray(run))
    np.testing.assert_array_equal(np.asarray(d.sample_index),
                                  np.asarray(out_mx.sample_index))
    np.testing.assert_allclose(np.asarray(d.soft),
                               np.asarray(out_mx.soft), atol=3e-3)
    np.testing.assert_array_equal(np.asarray(d.bits), np.asarray(out_mx.bits))
    np.testing.assert_allclose(np.asarray(d.phase),
                               np.asarray(out_mx.phase), atol=1e-3)
