"""Engine lifecycle parity across all four engines (VERDICT round-1 item 3):
FullKernelBatchEngine configure/reset, GroupEngine passthrough, batch-side
SRI/timestamp packet assembly, and the ff<->full carry converters.

Reference anchors: property-change resync cpp/psk_soft.cpp:638-651, the four
conditional pushPackets :605-615, resetState :365-372.
"""

import dataclasses

import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models import full as full_mod
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.runtime.engine import (BatchEngine, FullKernelBatchEngine,
                                         GroupEngine)
from psk_soft_tpu.runtime.streams import (SRI, PORT_BITS, PORT_PHASE,
                                          PORT_SAMPLE_INDEX, PORT_SOFT)
from psk_soft_tpu.testing.signals import gen_psk

CFG = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)


def _decisive_bank(C, S, m=4, seed0=0, sps=8):
    """Timing-decisive signals (energy on intra-symbol index 2; rect pulses
    would tie the argmax and flip between pipelines)."""
    xs = []
    for i in range(C):
        rng = np.random.default_rng(seed0 + i)
        j = rng.integers(0, m, S)
        x = np.zeros(S * sps, np.complex64)
        x[2::sps] = np.exp(2j * np.pi * j / m)
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs)


def _lock_quality(soft, m=4):
    """99th-percentile angular distance to the nearest constellation point."""
    rot = np.exp(-1j * np.pi / 4) if m == 4 else 1.0
    ang = np.angle(soft * rot) % (2 * np.pi / m)
    return np.percentile(np.minimum(ang, 2 * np.pi / m - ang), 99)


def test_ff_full_roundtrip_bitexact_continuation():
    """full_from_ff -> ff_from_full must be the identity for demod purposes:
    continuing on the round-tripped carry matches the original bit-exactly."""
    import jax.numpy as jnp

    C = 128
    xs = _decisive_bank(C, 512)
    fn = make_ff_demod_fn(CFG, channels=C)
    st, _ = fn(ff_init(CFG, (C,)), jnp.asarray(xs[:, : 256 * 8]))
    st_rt = full_mod.ff_from_full(CFG, full_mod.full_from_ff(CFG, st))
    _, out_a = fn(st, jnp.asarray(xs[:, 256 * 8:]))
    _, out_b = fn(st_rt, jnp.asarray(xs[:, 256 * 8:]))
    np.testing.assert_array_equal(np.asarray(out_a.valid),
                                  np.asarray(out_b.valid))
    np.testing.assert_array_equal(np.asarray(out_a.sample_index),
                                  np.asarray(out_b.sample_index))
    np.testing.assert_allclose(np.asarray(out_a.soft),
                               np.asarray(out_b.soft), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_a.phase),
                               np.asarray(out_b.phase), atol=1e-5)


def test_full_engine_configure_keeps_lock():
    """Reconfigure on the steady flagship engine: the carry survives (C7),
    the engine re-warms on the flexible path, and lock is maintained."""
    C = 128
    eng = FullKernelBatchEngine(CFG, channels=C, block_symbols=128)
    xs = _decisive_bank(C, 1024, seed0=10)
    blocks = np.split(xs, 8, axis=1)
    for blk in blocks[:4]:
        for c in range(C):
            eng.push(c, blk[c])
        eng.step()
    assert eng.steady
    cfg1 = dataclasses.replace(CFG, phase_avg=30)
    eng.configure(cfg1)
    assert eng.metrics.reconfigures == 1
    assert not eng.steady  # re-warming through the flexible path
    softs = []
    for blk in blocks[4:]:
        for c in range(C):
            eng.push(c, blk[c])
        out = eng.step()
        v = np.asarray(out.valid)
        softs.append(np.asarray(out.soft)[v])
    assert eng.steady  # handed back to the kernel after re-warm-up
    soft = np.concatenate(softs)
    # Timing/phase carried across the reconfigure: every post-change symbol
    # valid and on-constellation (a cleared carry would re-warm 50+20 syms).
    assert soft.size == C * 512
    assert _lock_quality(soft) < 0.1


def test_full_engine_reset_restarts_warmup():
    C = 128
    eng = FullKernelBatchEngine(CFG, channels=C, block_symbols=128)
    xs = _decisive_bank(C, 256, seed0=20)
    for blk in np.split(xs, 2, axis=1):
        for c in range(C):
            eng.push(c, blk[c])
        eng.step()
    assert eng.steady
    eng.reset()
    assert not eng.steady and eng.metrics.resets == 1
    for c in range(C):
        eng.push(c, xs[c, : 128 * 8])
    out = eng.step()
    v = np.asarray(out.valid)
    assert not v[:, : CFG.num_avg - 1].any()  # warm-up again


def test_batch_step_packets_four_ports():
    eng = BatchEngine(CFG, channels=2, block_symbols=64)
    eng.set_input_sri(SRI(stream_id="bank", xdelta=0.5), t=10.0)
    for c in range(2):
        x, _ = gen_psk(128, 8, 4, seed=40 + c)
        eng.push(c, x)
    pkts = eng.step_packets()
    assert set(pkts) == {PORT_SOFT, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX}
    # SRI rate rescaling (cpp/psk_soft.cpp:392-405).
    assert pkts[PORT_SOFT].sri.xdelta == pytest.approx(0.5 * 8)
    assert pkts[PORT_BITS].sri.xdelta == pytest.approx(0.5 * 8 / 2)
    assert pkts[PORT_SOFT].sri_changed
    # First emitted symbol is stream symbol 0 -> t = origin.
    assert pkts[PORT_SOFT].t == pytest.approx(10.0)
    assert pkts[PORT_SOFT].data.shape[0] == 2
    nb = CFG.bits_per_symbol
    nsym = pkts[PORT_SOFT].data.shape[1]
    assert pkts[PORT_BITS].data.shape == (2, nsym * nb)
    assert pkts[PORT_BITS].data.dtype == np.int16
    # Second batch advances the timestamp by emitted symbols.
    for c in range(2):
        x, _ = gen_psk(64, 8, 4, seed=60 + c)
        eng.push(c, x)
    pkts2 = eng.step_packets()
    assert pkts2[PORT_SOFT].t == pytest.approx(10.0 + 0.5 * 8 * nsym)
    assert not pkts2[PORT_SOFT].sri_changed
    # EOS drain marks every port.
    pkts3 = eng.flush_packets()
    assert pkts3 and all(p.eos for p in pkts3.values())


def test_batch_step_packets_none_vs_empty():
    cfg = dataclasses.replace(CFG, num_avg=100)  # warm-up 99 > block 64
    eng = BatchEngine(cfg, channels=1, block_symbols=64)
    assert eng.step_packets() is None          # nothing staged
    x, _ = gen_psk(64, 8, 4, seed=80)
    eng.push(0, x)
    assert eng.step_packets() == {}            # block ran, all warm-up


def test_group_engine_lifecycle_passthrough():
    cfgs = [
        DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10),
        DemodConfig(sps=10, num_avg=20, constellation_size=2, phase_avg=10),
        DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10),
    ]
    ge = GroupEngine(cfgs, block_symbols=64)
    for ch, cfg in enumerate(cfgs):
        x, _ = gen_psk(100, cfg.sps, cfg.constellation_size, seed=90 + ch)
        ge.push(ch, x)
    ge.step_all()
    # flush_all drains every group's remainder.
    res = ge.flush_all()
    assert set(res) == {0, 1, 2}
    total = {ch: int(np.asarray(o.valid).sum()) for ch, o in res.items()}
    assert all(v > 0 for v in total.values())
    # configure: same-partition change applies per group.
    new = [dataclasses.replace(c, phase_avg=12) for c in cfgs]
    ge.configure(new)
    assert all(eng.cfg.phase_avg == 12 for _, _, eng in ge.groups)
    # partition-splitting configure is rejected explicitly.
    bad = list(new)
    bad[2] = dataclasses.replace(bad[2], sps=10)
    with pytest.raises(ValueError, match="splits group"):
        ge.configure(bad)
    ge.reset()
    assert all(eng.metrics.resets == 1 for _, _, eng in ge.groups)


def test_demod_block_full_rejects_short_block():
    """A block shorter than the timing window (8 symbols << num_avg-1) is
    demodulated from [window | block] and the carried window is the last
    window-length rows of that concatenation -- never a wrapped slice."""
    import jax.numpy as jnp

    rows = (CFG.num_avg - 1) * 8
    win = jnp.arange(rows * 128, dtype=jnp.float32).reshape(rows, 128)
    st = full_mod.FullState(
        win_re=win, win_im=-win,
        planes=jnp.zeros((full_mod.state_rows(CFG.phase_avg), 128),
                         jnp.float32))
    short = jnp.ones((8 * 8, 128), jnp.float32)
    st2, out = full_mod.demod_block_full(CFG, st, short, short)
    assert out.soft_re.shape == (8, 128)
    want = np.concatenate([np.asarray(win), np.ones((64, 128))])[-rows:]
    np.testing.assert_array_equal(np.asarray(st2.win_re), want)
    np.testing.assert_array_equal(np.asarray(st2.win_im)[-64:], 1.0)
