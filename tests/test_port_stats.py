"""Per-output-port statistics (round 4): the ProvidesPortStatisticsProvider
analog the reference advertises on every port (psk_soft.scd.xml:86-95 --
bulkio supplies rates/bytes per port; here the packet layer counts them)."""

import numpy as np

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import (BatchEngine, FullKernelBatchEngine,
                                         GroupEngine, StreamEngine)
from psk_soft_tpu.runtime.streams import (PORT_BITS, PORT_PHASE,
                                          PORT_SAMPLE_INDEX, PORT_SOFT,
                                          Packet, SRI)


def _sig(n, sps=8, seed=0):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, n)
    x = np.repeat(np.exp(2j * np.pi * sym / 4), sps)
    return (x + 0.01 * rng.standard_normal(x.size)).astype(np.complex64)


def test_stream_engine_port_stats():
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    eng = StreamEngine(cfg, block_symbols=64)
    sri = SRI(stream_id="s")
    x = _sig(400)
    half = x.size // 2
    out1 = eng.process(Packet(data=x[:half], sri=sri))
    out2 = eng.process(Packet(data=x[half:], sri=sri, eos=True))
    st = eng.port_stats
    assert set(st) == {PORT_SOFT, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX}
    want_items = sum(p[PORT_SOFT].data.size for p in (out1, out2)
                     if PORT_SOFT in p)
    assert st[PORT_SOFT].items == want_items == eng.metrics.symbols_out
    assert st[PORT_BITS].items == eng.metrics.bits_out
    assert st[PORT_SOFT].bytes == want_items * 8          # complex64
    assert st[PORT_SOFT].eos_count == 1
    assert st[PORT_SOFT].packets >= 1
    assert st[PORT_SOFT].elements_per_second > 0
    assert st[PORT_SOFT].calls_per_second > 0
    assert st[PORT_SOFT].bits_per_second > 0
    assert st[PORT_SOFT].time_since_last_call >= 0.0


def test_batch_engine_port_stats_pipelined():
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    eng = BatchEngine(cfg, channels=3, block_symbols=64, pipeline_depth=1)
    eng.set_input_sri(SRI(stream_id="b"))
    total = {}
    for i in range(4):
        for c in range(3):
            eng.push(c, _sig(64, seed=10 + c))
        pkts = eng.step_packets()
        if pkts:
            for port, p in pkts.items():
                total[port] = total.get(port, 0) + p.data.size
    pkts = eng.flush_packets()
    for port, p in pkts.items():
        total[port] = total.get(port, 0) + p.data.size
    st = eng.port_stats
    for port, items in total.items():
        assert st[port].items == items, port
    assert st[PORT_SOFT].eos_count == 1


def test_full_engine_and_group_port_stats():
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    eng = FullKernelBatchEngine(cfg, 128, block_symbols=128)
    eng.set_input_sri(SRI(stream_id="f"))
    x = np.stack([_sig(640, seed=c) for c in range(128)])
    got = 0
    for pos in range(0, x.shape[1], 128 * 8):
        eng.push_block(x[:, pos:pos + 128 * 8])
        pkts = eng.step_packets()
        if pkts and PORT_SOFT in pkts:
            got += pkts[PORT_SOFT].data.size
    pkts = eng.flush_packets()
    got += pkts[PORT_SOFT].data.size
    assert eng.port_stats[PORT_SOFT].items == got > 0

    grp = GroupEngine([cfg] * 2 + [DemodConfig(sps=10, num_avg=20,
                                               constellation_size=4,
                                               phase_avg=10)],
                      block_symbols=64)
    grp.set_input_sri(SRI(stream_id="g"))
    for ch in range(3):
        sps = 8 if ch < 2 else 10
        grp.push(ch, _sig(200, sps=sps, seed=ch))
    grp.step_all_packets()
    grp.flush_all_packets()
    st = grp.port_stats
    assert st[PORT_SOFT].items > 0
    # group stats = sum over the two groups
    want = sum(e.port_stats[PORT_SOFT].items for _, _, e in grp.groups)
    assert st[PORT_SOFT].items == want
