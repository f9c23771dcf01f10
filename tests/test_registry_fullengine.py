"""Multi-stream registry routing and the full-kernel batch engine."""

import numpy as np

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.runtime.engine import (BatchEngine, FullKernelBatchEngine,
                                         StreamRegistry)
from psk_soft_tpu.runtime.streams import SRI, Packet, PORT_SOFT
from psk_soft_tpu.testing.signals import gen_psk

CFG = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)


def test_registry_routes_interleaved_streams():
    reg = StreamRegistry(CFG, block_symbols=64)
    xa, sa = gen_psk(400, 8, 4, seed=100)
    xb, sb = gen_psk(400, 8, 4, seed=200)
    sri_a = SRI(stream_id="A", xdelta=0.01)
    sri_b = SRI(stream_id="B", xdelta=0.01)
    got = {"A": [], "B": []}
    for i in range(4):
        seg = slice(i * 800, (i + 1) * 800)
        for sid, x, sri in (("A", xa, sri_a), ("B", xb, sri_b)):
            out = reg.process(Packet(data=x[seg], sri=sri,
                                     eos=(i == 3)))
            if PORT_SOFT in out:
                got[sid].append(out[PORT_SOFT].data)
    assert not reg.engines  # both retired on EOS
    for sid, syms in (("A", sa), ("B", sb)):
        soft = np.concatenate(got[sid])
        assert soft.size == 400 - 49
        thetas = [0, np.pi / 2, np.pi, 3 * np.pi / 2]
        exp = syms[:soft.size] * np.exp(1j * np.pi / 4)
        err = min(np.abs(soft[1:] * np.exp(1j * t) - exp[1:]).max()
                  for t in thetas)
        assert err < 1e-3, (sid, err)


def test_full_kernel_batch_engine_matches_ff_engine():
    C = 128
    xs = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, 4, 1024)
        x = np.zeros(1024 * 8, np.complex64)
        # Energy concentrated on intra-symbol index 2: the argmax is
        # decisive (rect pulses would tie and flip between implementations).
        x[2::8] = np.exp(2j * np.pi * j / 4) * np.exp(
            2j * np.pi * 1e-4 * 8 * np.arange(1024))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    ref = BatchEngine(CFG, channels=C, block_symbols=128)
    eng = FullKernelBatchEngine(CFG, channels=C, block_symbols=128)
    ref_soft, full_soft = [], []
    for blk in np.split(xs, 8, axis=1):
        for c in range(C):
            ref.push(c, blk[c])
            eng.push(c, blk[c])
        o1 = ref.step()
        o2 = eng.step()
        v1 = np.asarray(o1.valid)
        v2 = np.asarray(o2.valid)
        # Once the engine switches to the kernel, everything is valid.
        common = v1 & v2
        ref_soft.append(np.asarray(o1.soft)[common])
        full_soft.append(np.asarray(o2.soft)[common])
    assert eng.steady
    ref_soft = np.concatenate(ref_soft)
    full_soft = np.concatenate(full_soft)
    np.testing.assert_allclose(full_soft, ref_soft, atol=5e-3)
