"""AutoCfoEngine: coarse acquisition + phase-continuous NCO derotation in
front of the batch engines recovers carriers far beyond the M-th-power
tracker's lock range (which the reference cannot do at all -- its unwrap
slips cycles once ``M*2pi*f*sps`` nears pi, cpp/psk_soft.cpp:474-481)."""

import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.autocfo import AutoCfoEngine
from psk_soft_tpu.runtime.engine import BatchEngine, FullKernelBatchEngine
from psk_soft_tpu.runtime.streams import PORT_PHASE, PORT_SOFT, SRI

C = 4
SPS = 8
M = 4


def _cfg(**kw):
    base = dict(sps=SPS, num_avg=50, constellation_size=M, phase_avg=20)
    base.update(kw)
    return DemodConfig(**base)


def _bank(ns, cfos, seed=0, m=M, sps=SPS, noise=0.002):
    """(C, T) bank, one injected carrier per channel (cycles/sample)."""
    xs, syms = [], []
    for i, f in enumerate(np.broadcast_to(cfos, (C,))):
        rng = np.random.default_rng(seed + i)
        j = rng.integers(0, m, ns)
        x = np.repeat(np.exp(2j * np.pi * j / m), sps)
        x = x * np.exp(2j * np.pi * f * np.arange(x.size))
        x = x + noise * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size))
        xs.append(x.astype(np.complex64))
        syms.append(np.exp(2j * np.pi * j / m))
    return np.stack(xs), np.stack(syms)


def _ser_mod_rotation(soft, expect, m=M, max_delay=60):
    """Symbol error rate of the soft stream vs the expected symbol
    sequence, minimized over the M legal rotations (the inherent M-th-power
    ambiguity, tests/test_psk_soft.py:223-238), the QPSK +pi/4 decision
    rotation, and an alignment delay search (warm-up/pipeline latency)."""
    best = 1.0
    for d in range(max_delay):
        e = expect[d:d + soft.size]
        s = soft[:e.size]
        for k in range(m):
            rot = np.exp(2j * np.pi * k / m) * np.exp(1j * np.pi / 4)
            best = min(best, float(np.mean(np.abs(s - e * rot) > 0.5)))
    return best


def _run(eng, xs, block_samps=None):
    outs = []
    step = block_samps or xs.shape[1]
    for i in range(0, xs.shape[1], step):
        for c in range(C):
            eng.push(c, xs[c, i:i + step])
        while True:
            o = eng.step()
            if o is None:
                break
            outs.append(o)
    return outs


def test_beyond_lock_range_carrier_is_recovered():
    # lock range is 1/(2*M*sps) ~ 0.0156 cyc/samp; inject 3x that.
    f = 3.0 / (2 * M * SPS)
    xs, syms = _bank(1500, [f, -f, 2 * f, 0.5 * f])
    cfg = _cfg()
    eng = AutoCfoEngine(BatchEngine(cfg, C, block_symbols=256),
                        acq_samples=4096)
    outs = _run(eng, xs)
    assert eng.cfo is not None and eng.acquisitions == 1
    np.testing.assert_allclose(eng.cfo, [f, -f, 2 * f, 0.5 * f], atol=2e-4)
    soft = np.concatenate([np.asarray(o.soft) for o in outs], axis=1)
    valid = np.concatenate([np.asarray(o.valid) for o in outs], axis=1)
    # settled region, modulo the inherent M-fold ambiguity
    for c in range(C):
        v = soft[c, valid[c]][200:]
        assert _ser_mod_rotation(v, syms[c, 200:]) < 0.01


def test_without_wrapper_same_carrier_fails():
    """Sanity check the premise: the bare engine cannot demodulate this."""
    f = 3.0 / (2 * M * SPS)
    xs, syms = _bank(1200, f)
    eng = BatchEngine(_cfg(), C, block_symbols=256)
    outs = _run(eng, xs)
    soft = np.concatenate([np.asarray(o.soft) for o in outs], axis=1)
    valid = np.concatenate([np.asarray(o.valid) for o in outs], axis=1)
    v = soft[0, valid[0]][200:]
    assert _ser_mod_rotation(v, syms[0, 200:]) > 0.2


def test_acquisition_replays_staged_data_exactly():
    """Acquisition drops nothing: the wrapper's output equals demodulating
    a one-shot pre-derotated stream with the same engine (phase-continuous
    NCO across the replay/live boundary and across blocks)."""
    f = 0.03
    xs, _ = _bank(1200, f, seed=5)
    cfg = _cfg()
    eng = AutoCfoEngine(BatchEngine(cfg, C, block_symbols=128),
                        acq_samples=2048)
    outs = _run(eng, xs, block_samps=512)     # many small pushes
    got = np.concatenate([np.asarray(o.soft) for o in outs], axis=1)

    fhat = eng.cfo
    t = np.arange(xs.shape[1])
    pre = xs * np.exp(-2j * np.pi * fhat[:, None] * t[None, :])
    ref_eng = BatchEngine(cfg, C, block_symbols=128)
    ref = np.concatenate(
        [np.asarray(o.soft) for o in _run(ref_eng, pre.astype(np.complex64))],
        axis=1)
    np.testing.assert_allclose(got, ref[:, :got.shape[1]], atol=2e-5)


def test_plane_mode_full_kernel():
    f = 0.025
    xs, syms = _bank(1024, f, seed=9)
    xs = np.tile(xs, (32, 1))                 # 128 channels
    cfg = _cfg()
    inner = FullKernelBatchEngine(cfg, 128, block_symbols=128)
    eng = AutoCfoEngine(inner, acq_samples=2048)
    re = np.ascontiguousarray(xs.real.T)
    im = np.ascontiguousarray(xs.imag.T)
    outs = []
    for i in range(0, re.shape[0], 1024):
        eng.push_planes(re[i:i + 1024], im[i:i + 1024])
        while True:
            o = eng.step()
            if o is None:
                break
            outs.append(o)
    assert eng.cfo is not None
    np.testing.assert_allclose(eng.cfo, f, atol=2e-4)
    soft = np.concatenate([np.asarray(o.soft) for o in outs], axis=1)
    valid = np.concatenate([np.asarray(o.valid) for o in outs], axis=1)
    v = soft[0, valid[0]][200:]
    assert _ser_mod_rotation(v, syms[0, 200:]) < 0.01


def test_int16_planes_rejected():
    eng = AutoCfoEngine(FullKernelBatchEngine(_cfg(), 128, block_symbols=128,
                                              ingest_scale=1e-3))
    with pytest.raises(ValueError, match="int16"):
        eng.push_planes(np.zeros((64, 128), np.int16),
                        np.zeros((64, 128), np.int16))


def test_track_folds_drift_back_into_nco():
    """Slow quadratic drift walks the residual toward the lock edge; with
    track=True the wrapper folds it back (phase-continuously) and the
    tracker stays locked; folds are counted."""
    ns = 4000
    cfg = _cfg()
    rng = np.random.default_rng(3)
    t = np.arange(ns * SPS)
    f0, slew = 0.02, 1e-7         # instantaneous f drifts +3.2e-3 by EOS
    xs = []
    for c in range(C):
        j = rng.integers(0, M, ns)
        x = np.repeat(np.exp(2j * np.pi * j / M), SPS)
        phase = 2 * np.pi * (f0 * t + 0.5 * slew * t * t)
        x = x * np.exp(1j * phase)
        xs.append((x + 0.002 * (rng.standard_normal(x.size)
                                + 1j * rng.standard_normal(x.size))
                   ).astype(np.complex64))
    xs = np.stack(xs)
    eng = AutoCfoEngine(BatchEngine(cfg, C, block_symbols=256),
                        acq_samples=2048, track=True, track_guard=0.05)
    eng.set_input_sri(SRI(xdelta=1.0, mode=1, stream_id="trk"), 0.0)
    pkts = []
    for i in range(0, xs.shape[1], 2048):
        for c in range(C):
            eng.push(c, xs[c, i:i + 2048])
        while True:
            p = eng.step_packets()
            if p is None:
                break
            pkts.append(p)
    assert int(eng.folds.sum()) > 0
    # final NCO is near the end-of-stream instantaneous frequency
    f_end = f0 + slew * t[-1]
    np.testing.assert_allclose(eng.cfo, f_end, atol=3e-3)
    # constellation still tight at the end despite the total drift being
    # several times the lock range guard
    soft = np.asarray(pkts[-1][PORT_SOFT].data)
    mag = np.abs(soft)
    np.testing.assert_allclose(mag, 1.0, atol=0.15)


def test_flush_short_stream_acquires_from_what_arrived():
    f = 0.02
    xs, _ = _bank(120, f, seed=2)            # < acq_samples
    cfg = _cfg()
    eng = AutoCfoEngine(BatchEngine(cfg, C, block_symbols=64),
                        acq_samples=65536)
    eng.set_input_sri(SRI(xdelta=1.0, mode=1, stream_id="s"), 0.0)
    for c in range(C):
        eng.push(c, xs[c])
    pkts = eng.flush_packets()
    assert eng.cfo is not None
    np.testing.assert_allclose(eng.cfo, f, atol=1e-3)
    assert PORT_PHASE in pkts


def test_reset_keeps_carrier_reacquire_drops_it():
    f = 0.02
    xs, _ = _bank(600, f)
    eng = AutoCfoEngine(BatchEngine(_cfg(), C, block_symbols=64),
                        acq_samples=1024)
    _run(eng, xs)
    lock = eng.cfo
    assert lock is not None
    eng.reset()
    assert eng.cfo is not None            # queue flush: carrier survives
    np.testing.assert_allclose(eng.cfo, lock)
    eng.reacquire()
    assert eng.cfo is None                # retune: next data re-acquires
    _run(eng, xs)
    np.testing.assert_allclose(eng.cfo, f, atol=2e-4)
