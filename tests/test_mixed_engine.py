"""MixedKernelBatchEngine: BASELINE config 4 (heterogeneous M/diff bank)
through the production engine surface -- one steady program per block,
warm-up on the XLA mixed pipeline, per-channel mode planes in the carry."""

import numpy as np
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.mixed import MixedParams, make_mixed_demod_fn, mixed_init
from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI

C = 128


def _cfg():
    return DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)


def _mixed_bank(S, seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = []
    for i in range(C):
        r = np.random.default_rng(seed + 1 + i)
        m = int(ms[i])
        j = r.integers(0, m, S)
        pts = np.exp(2j * np.pi * j / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(S * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(S))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return MixedParams.make(ms, diffs), np.stack(xs)


def test_mixed_engine_matches_xla_pipeline():
    cfg = _cfg()
    params, xs = _mixed_bank(1024, seed=0)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    fn = make_mixed_demod_fn(cfg)
    ref_st = mixed_init(cfg, C)
    for blk in np.split(xs, 8, axis=1):
        for c in range(C):
            eng.push(c, blk[c])
        out = eng.step()
        ref_st, ref = fn(params, ref_st, jnp.asarray(blk))
        common = np.asarray(out.valid) & np.asarray(ref.valid)
        if common.any():
            np.testing.assert_allclose(np.asarray(out.soft)[common],
                                       np.asarray(ref.soft)[common],
                                       atol=5e-3)
            np.testing.assert_array_equal(
                np.asarray(out.sample_index)[common],
                np.asarray(ref.sample_index)[common])
            np.testing.assert_array_equal(np.asarray(out.bits)[common],
                                          np.asarray(ref.bits)[common])
    assert eng.steady  # the steady step took over mid-stream


def test_mixed_engine_packets_three_bit_port():
    cfg = _cfg()
    params, xs = _mixed_bank(1024, seed=40)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    eng.set_input_sri(SRI(stream_id="mixed", xdelta=1e-6))
    got = []
    for blk in np.split(xs, 8, axis=1):
        for c in range(C):
            eng.push(c, blk[c])
        p = eng.step_packets()
        if p:
            got.append(p)
    assert got
    from psk_soft_tpu.runtime.streams import PORT_BITS, PORT_SOFT
    pkt = got[-1][PORT_BITS]
    sv = got[-1][PORT_SOFT].data.shape[1]
    assert pkt.data.shape == (C, sv * 3)       # uniform 3-bit layout
    # bits SRI ticks at a third of the symbol interval (8-PSK port layout)
    assert np.isclose(pkt.sri.xdelta * 3, 1e-6 * cfg.sps)


def test_mixed_engine_set_params_clears_changed_only():
    cfg = _cfg()
    params, xs = _mixed_bank(1536, seed=80)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    blocks = np.split(xs, 12, axis=1)
    for blk in blocks[:6]:
        for c in range(C):
            eng.push(c, blk[c])
        eng.step()
    assert eng.steady
    # Flip the first 8 channels' constellation; keep the rest.
    new_m = np.asarray(params.m).copy()
    new_m[:8] = np.where(new_m[:8] == 8, 4, 8)
    new_diff = np.asarray(params.diff).copy()
    new_diff[:8] = False
    eng.set_params(MixedParams.make(new_m, new_diff))
    assert not eng.steady                      # re-runs the warm gate
    ws = eng._warm_state
    assert np.all(np.asarray(ws.phase_count)[:8] == 0)      # cleared
    assert np.all(np.asarray(ws.phase_count)[8:] > 0)       # carried
    # Signal for the changed channels switches mode too.
    for bi, blk in enumerate(blocks[6:]):
        blk = blk.copy()
        for c in range(8):
            r = np.random.default_rng(900 + 10 * c + bi)
            m = int(new_m[c])
            j = r.integers(0, m, 128)
            x = np.zeros(128 * 8, np.complex64)
            x[3::8] = np.exp(2j * np.pi * j / m)
            x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
            blk[c] = x
        for c in range(C):
            eng.push(c, blk[c])
        out = eng.step()
    assert eng.steady                          # handed back to the kernel
    v = np.asarray(out.valid)
    assert v.all()
    # Unchanged channels keep demodulating their stream cleanly: soft
    # decisions sit near constellation points (QPSK lanes are +pi/4
    # rotated by construction -- derotate before the lattice distance).
    soft = np.asarray(out.soft)[8:]
    m_rest = np.asarray(new_m)[8:, None]
    soft = np.where(m_rest == 4, soft * np.exp(-1j * np.pi / 4), soft)
    ang = np.angle(soft) * m_rest / (2 * np.pi)
    dist = np.abs(ang - np.round(ang)) * (2 * np.pi) / m_rest
    assert np.percentile(dist, 95) < 0.2


def test_mixed_engine_i16_planes():
    """Mixed modes + int16 wire planes compose (mode rows stay f32 in the
    carry; samples ride the 2-byte format)."""
    cfg = _cfg()
    params, xs = _mixed_bank(1024, seed=120)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re_w = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im_w = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    xq = ((re_w.astype(np.float32) * scale).T
          + 1j * (im_w.astype(np.float32) * scale).T).astype(np.complex64)

    ref = MixedKernelBatchEngine(params, cfg, C, block_symbols=128)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128,
                                 ingest_scale=scale)
    need = 128 * cfg.sps
    for i in range(0, 1024 * 8, need):
        for c in range(C):
            ref.push(c, xq[c, i: i + need])
        eng.push_planes(re_w[i: i + need], im_w[i: i + need])
        o_ref, o = ref.step(), eng.step()
        if o is not None and o_ref is not None:
            np.testing.assert_allclose(np.asarray(o.soft),
                                       np.asarray(o_ref.soft), atol=1e-5)
    assert eng.steady
    assert eng._full_state.win_re.dtype == jnp.int16


def test_mixed_engine_debug_ports_off_all_phases():
    """debug_ports=False holds for the MIXED engine through warm-up (ff
    outputs DO carry phase), steady state, and the EOS drain -- the port
    set never flaps (code-review finding: the mixed ctor's assembler
    rebuild must preserve skip_debug)."""
    import numpy as np
    from psk_soft_tpu.models.mixed import MixedParams
    from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine
    from psk_soft_tpu.runtime.streams import SRI, PORT_BITS, PORT_SOFT

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    params, xs = _mixed_bank(1024, seed=9)
    eng = MixedKernelBatchEngine(params, cfg, C, block_symbols=128,
                                 debug_ports=False)
    eng.set_input_sri(SRI(stream_id="mx", xdelta=1e-6))
    need = 128 * cfg.sps
    seen = set()
    for i in range(0, 1024 * 8, need):
        for c in range(C):
            eng.push(c, xs[c, i: i + need])
        p = eng.step_packets()
        if p:
            seen |= set(p)
    assert eng.steady
    fp = eng.flush_packets()
    seen |= set(fp)
    assert seen == {PORT_SOFT, PORT_BITS}
