"""Randomized lifecycle soak: interleaved push/reconfigure/flush/SRI-change/
EOS sequences against the production engines, checking structural invariants
only (no golden values -- the point is that NO event ordering can wedge an
engine or desynchronize its ports).

The reference runs one serviceFunction loop per component instance and the
same events arrive in arbitrary order from the Redhawk domain (property
configure during streaming, queue flush, SRI keyword changes, EOS:
cpp/psk_soft.cpp:346-426, :638-651).  These tests are the framework-side
equivalent of soaking that loop.

Invariants checked at every emission:
  - PORT_BITS size == PORT_SOFT size * bits_per_symbol (ports never skew)
  - soft decisions are finite
  - timestamps are finite and non-decreasing within a constant-rate segment
  - metrics.symbols_out equals the total soft symbols actually emitted
"""

import dataclasses

import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import (BatchEngine, FullKernelBatchEngine,
                                         StreamEngine)
from psk_soft_tpu.runtime.streams import (SRI, Packet, PORT_BITS, PORT_PHASE,
                                          PORT_SAMPLE_INDEX, PORT_SOFT)


def _chunk(rng, n, m, sps):
    """n samples of continuing M-PSK-ish content (content is irrelevant to
    the structural invariants; it only has to be complex and non-degenerate).
    """
    syms = int(np.ceil(n / sps)) + 1
    pts = np.exp(2j * np.pi * rng.integers(0, m, syms) / m)
    x = np.repeat(pts, sps)[:n].astype(np.complex64)
    return x + (0.01 * rng.standard_normal(n)).astype(np.complex64)


def _rand_cfg(rng, sps=8):
    return DemodConfig(
        sps=sps,
        num_avg=int(rng.choice([30, 50, 100])),
        constellation_size=int(rng.choice([2, 4, 8])),
        phase_avg=int(rng.choice([10, 20, 50])),
        differential=bool(rng.random() < 0.5),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_engine_event_soak(seed):
    rng = np.random.default_rng(seed)
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    eng = StreamEngine(cfg, block_symbols=64)
    xdelta = 0.01
    t = 0.0
    total_soft = 0
    last_t = {}          # port -> last packet timestamp (reset on SRI change)

    def push(data, **kw):
        nonlocal t, total_soft
        mode = kw.pop("mode", 1)
        pkt = Packet(data=data, sri=SRI(stream_id="soak", xdelta=xdelta,
                                        mode=mode),
                     t=t, **kw)
        t += data.size * xdelta
        out = eng.process(pkt)
        if PORT_SOFT in out:
            soft = out[PORT_SOFT].data
            assert np.isfinite(soft).all()
            assert out[PORT_BITS].data.size == \
                soft.size * eng.cfg.bits_per_symbol
            assert out[PORT_PHASE].data.size == soft.size
            assert out[PORT_SAMPLE_INDEX].data.size == soft.size
            total_soft += soft.size
            for port, p in out.items():
                assert np.isfinite(p.t)
                if port in last_t:
                    assert p.t >= last_t[port] - 1e-9
                last_t[port] = p.t
        return out

    for _ in range(40):
        ev = rng.choice(["push", "push", "push", "push", "reconf",
                         "flush", "rate", "real"])
        if ev == "push":
            push(_chunk(rng, int(rng.integers(100, 3000)),
                        eng.cfg.constellation_size, cfg.sps))
        elif ev == "reconf":
            eng.configure(_rand_cfg(rng))
            last_t.clear()          # warm-up restarts; ports re-anchor
        elif ev == "flush":
            push(_chunk(rng, 800, eng.cfg.constellation_size, cfg.sps),
                 input_queue_flushed=True)
            last_t.clear()
        elif ev == "rate":
            xdelta = float(rng.choice([0.005, 0.01, 0.02]))
            last_t.clear()          # timestamps re-anchor at the new rate
        else:
            out = push(np.ones(160, np.complex64), mode=0)
            assert out == {}        # real-mode data is dropped, not demodded
    # Drain with EOS; every port must mark it.
    out = push(_chunk(rng, 4096, eng.cfg.constellation_size, cfg.sps),
               eos=True)
    for p in out.values():
        assert p.eos
    assert eng.metrics.symbols_out == total_soft
    assert total_soft > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_engine_event_soak(seed):
    rng = np.random.default_rng(100 + seed)
    C = 4
    cfg = DemodConfig(sps=8, num_avg=30, constellation_size=4, phase_avg=10)
    eng = BatchEngine(cfg, C, block_symbols=32)
    eng.set_input_sri(SRI(stream_id="bank", xdelta=0.01))
    total_soft = 0

    def check(pkts):
        nonlocal total_soft
        if not pkts:
            return
        soft = pkts[PORT_SOFT].data
        assert np.isfinite(soft).all()
        assert pkts[PORT_BITS].data.size == \
            soft.size * eng.cfg.bits_per_symbol
        total_soft += soft.size

    for _ in range(30):
        ev = rng.choice(["push", "push", "push", "reconf", "reset", "flush"])
        if ev == "push":
            n = int(rng.integers(1, 4)) * 32 * cfg.sps
            eng.push_block(np.stack(
                [_chunk(rng, n, eng.cfg.constellation_size, cfg.sps)
                 for _ in range(C)]))
            while True:
                pkts = eng.step_packets()
                if pkts is None:
                    break
                check(pkts)
        elif ev == "reconf":
            eng.configure(_rand_cfg(rng))
        elif ev == "reset":
            eng.reset()
        else:
            check(eng.flush_packets())
    check(eng.flush_packets())
    assert eng.metrics.symbols_out == total_soft
    assert total_soft > 0


def test_full_kernel_engine_event_soak():
    """Flagship engine (interpret-mode kernel): warm-up handoff, steady
    blocks, live reconfigure, reset, and EOS drain in one session."""
    rng = np.random.default_rng(7)
    C = 128
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=64)
    eng.set_input_sri(SRI(stream_id="fk", xdelta=0.01))
    total_soft = 0

    def feed(blocks):
        nonlocal total_soft
        for _ in range(blocks):
            n = 64 * cfg.sps
            eng.push_block(np.stack(
                [_chunk(rng, n, eng.cfg.constellation_size, cfg.sps)
                 for _ in range(C)]))
            pkts = eng.step_packets()
            if pkts:
                soft = pkts[PORT_SOFT].data
                assert np.isfinite(soft).all()
                assert pkts[PORT_BITS].data.size == \
                    soft.size * eng.cfg.bits_per_symbol
                total_soft += soft.size

    feed(4)                                   # warm-up -> steady kernel
    assert total_soft > 0
    eng.configure(dataclasses.replace(cfg, phase_avg=10))
    feed(3)                                   # steady under the new config
    eng.reset()
    n_at_reset = total_soft
    feed(2)                                   # warm-up restarted
    pkts = eng.flush_packets()
    if PORT_SOFT in pkts:
        assert pkts[PORT_SOFT].eos
        total_soft += pkts[PORT_SOFT].data.size
    assert eng.metrics.symbols_out == total_soft
    assert total_soft >= n_at_reset
