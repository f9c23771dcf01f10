"""Deferred-assembly pipelining on the batch engines (SURVEY §7 stage 7:
double-buffered feed).  With pipeline_depth=d the engine dispatches block k
and assembles block k-d, so device compute overlaps host staging; outputs
must be byte-identical to the synchronous engine, just d calls later, and
EOS must drain everything."""

import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import BatchEngine, FullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI, PORT_SOFT, PORT_BITS, \
    PORT_PHASE, PORT_SAMPLE_INDEX

ALL_PORTS = (PORT_SOFT, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX)

CFG = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)


def _bank(C, nsym, seed=0, sps=8):
    rng = np.random.default_rng(seed)
    x = np.stack([
        np.repeat(np.exp(2j * np.pi * rng.integers(0, 4, nsym) / 4), sps)
        + 0.01 * (rng.standard_normal(nsym * sps)
                  + 1j * rng.standard_normal(nsym * sps))
        for _ in range(C)]).astype(np.complex64)
    return x


def _run(eng, x, nblocks, block):
    """Push block-by-block, collecting emitted packet dicts + final flush."""
    eng.set_input_sri(SRI(stream_id="bank", xdelta=1e-6), t=1.0)
    got = []
    for b in range(nblocks):
        for c in range(x.shape[0]):
            eng.push(c, x[c, b * block: (b + 1) * block])
        p = eng.step_packets()
        if p:
            got.append(p)
    got.append(eng.flush_packets())
    return got


def _cat(dicts, port):
    ds = [d[port].data for d in dicts if port in d and d[port].data.size]
    return np.concatenate(ds, axis=-1) if ds else np.zeros((0,))


@pytest.mark.parametrize("depth", [1, 2])
def test_batch_pipelined_matches_sync(depth):
    C, S = 4, 64
    x = _bank(C, 6 * S, seed=3)
    blk = S * CFG.sps
    sync = _run(BatchEngine(CFG, C, block_symbols=S), x, 6, blk)
    pipe = _run(BatchEngine(CFG, C, block_symbols=S, pipeline_depth=depth),
                x, 6, blk)
    for port in ALL_PORTS:
        a, b = _cat(sync, port), _cat(pipe, port)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # Pipelining delays emission by `depth` step calls; flush merges the
    # in-flight blocks into the one EOS packet.
    assert len(pipe) == len(sync) - depth


def test_batch_pipelined_timestamps_and_eos():
    C, S = 2, 64
    x = _bank(C, 4 * S, seed=5)
    blk = S * CFG.sps
    sync = _run(BatchEngine(CFG, C, block_symbols=S), x, 4, blk)
    pipe = _run(BatchEngine(CFG, C, block_symbols=S, pipeline_depth=1),
                x, 4, blk)
    # Every pipelined packet's head timestamp appears in the sync sequence
    # (same symbol clock), and only the last packet carries EOS.
    sync_ts = [d[PORT_SOFT].t for d in sync if PORT_SOFT in d]
    pipe_ts = [d[PORT_SOFT].t for d in pipe if PORT_SOFT in d]
    assert pipe_ts[0] == sync_ts[0]
    for t in pipe_ts[:-1]:
        assert t in sync_ts
    eos_flags = [d[PORT_SOFT].eos for d in pipe if PORT_SOFT in d]
    assert eos_flags[-1] and not any(eos_flags[:-1])


def test_batch_pipelined_metrics_after_flush():
    C, S = 2, 64
    x = _bank(C, 4 * S, seed=7)
    blk = S * CFG.sps
    e0 = BatchEngine(CFG, C, block_symbols=S)
    e1 = BatchEngine(CFG, C, block_symbols=S, pipeline_depth=1)
    _run(e0, x, 4, blk)
    _run(e1, x, 4, blk)
    assert e1.metrics.symbols_out == e0.metrics.symbols_out


def test_guard_and_pipeline_mutually_exclusive():
    with pytest.raises(ValueError):
        BatchEngine(CFG, 2, guard_nonfinite=True, pipeline_depth=1)


def test_configure_drains_old_config_blocks():
    C, S = 2, 64
    x = _bank(C, 4 * S, seed=9)
    blk = S * CFG.sps
    eng = BatchEngine(CFG, C, block_symbols=S, pipeline_depth=1)
    eng.set_input_sri(SRI(stream_id="bank", xdelta=1e-6), t=0.0)
    got = []
    for b in range(2):
        for c in range(C):
            eng.push(c, x[c, b * blk: (b + 1) * blk])
        p = eng.step_packets()
        if p:
            got.append(p)
    import dataclasses
    new_cfg = dataclasses.replace(CFG, phase_avg=12)
    eng.configure(new_cfg)          # one block is in flight under old cfg
    held = eng.step_packets()       # must surface it, old-config SRI
    assert held and held[PORT_BITS].sri.xdelta == pytest.approx(
        1e-6 * CFG.sps / CFG.bits_per_symbol)
    assert eng.metrics.reconfigures == 1


def test_full_kernel_pipelined_matches_sync():
    C, S = 128, 64
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    x = _bank(C, 8 * S, seed=11)
    blk = S * cfg.sps
    sync = _run(FullKernelBatchEngine(cfg, C, block_symbols=S), x, 8, blk)
    pipe = _run(FullKernelBatchEngine(cfg, C, block_symbols=S, pipeline_depth=1),
                x, 8, blk)
    for port in ALL_PORTS:
        np.testing.assert_array_equal(_cat(sync, port), _cat(pipe, port))
