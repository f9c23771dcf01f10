"""Time-major packet fast path (BankAssembler.assemble_tm / TMOutputs):
the steady engine's packet route fetches the kernel's raw (S, C) planes and
assembles channel-major packets as host views -- no device-side transpose,
complex-combine, or bit-unpack.  These tests pin that the payloads are
BYTE-IDENTICAL to the channel-major DemodOutputs route on every port, for
f32 and soft_i8 planes, full and masked (flush) validity."""

import numpy as np
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                      to_demod_outputs)
from psk_soft_tpu.runtime.engine import BankAssembler, TMOutputs
from psk_soft_tpu.runtime.streams import (SRI, PORT_BITS, PORT_PHASE,
                                          PORT_SAMPLE_INDEX, PORT_SOFT)

C, NS = 128, 640


def _kernel_block(cfg, soft_scale=None):
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, 4, NS)
        x = np.repeat(np.exp(2j * np.pi * j / 4), cfg.sps).astype(np.complex64)
        x *= np.exp(2j * np.pi * 1e-4 * np.arange(x.size))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    xs = np.stack(out)
    warm, run = np.split(xs, [256 * cfg.sps], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    fn = make_full_demod_fn(cfg, soft_i8_scale=soft_scale)
    _, fo = fn(st, jnp.asarray(run.real.T), jnp.asarray(run.imag.T))
    return fo


def _pair_of_assemblers(cfg):
    a1, a2 = BankAssembler(cfg), BankAssembler(cfg)
    sri = SRI(stream_id="tm", xdelta=2e-6)
    a1.set_sri(sri, t=1.5)
    a2.set_sri(sri, t=1.5)
    return a1, a2


def _assert_identical(p_ref, p_tm):
    assert set(p_ref) == set(p_tm)
    for port in p_ref:
        r, t = p_ref[port], p_tm[port]
        assert r.data.dtype == t.data.dtype, port
        assert r.data.shape == t.data.shape, port
        np.testing.assert_array_equal(np.asarray(r.data), np.asarray(t.data),
                                      err_msg=port)
        assert r.t == t.t and r.sri == t.sri and r.eos == t.eos
        assert r.sri_changed == t.sri_changed


def test_tm_packets_identical_f32():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    fo = _kernel_block(cfg)
    a_ref, a_tm = _pair_of_assemblers(cfg)
    p_ref = a_ref.assemble(to_demod_outputs(cfg, fo))
    p_tm = a_tm.assemble_tm(TMOutputs(fo=fo))
    assert set(p_ref) == {PORT_SOFT, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX}
    _assert_identical(p_ref, p_tm)
    # second block: the symbol clock (_k0) must advance identically
    p_ref2 = a_ref.assemble(to_demod_outputs(cfg, fo))
    p_tm2 = a_tm.assemble_tm(TMOutputs(fo=fo))
    assert p_ref2[PORT_SOFT].t == p_tm2[PORT_SOFT].t > p_ref[PORT_SOFT].t


def test_tm_packets_identical_soft_i8():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    fo = _kernel_block(cfg, soft_scale=100.0)
    a_ref, a_tm = _pair_of_assemblers(cfg)
    p_ref = a_ref.assemble(to_demod_outputs(cfg, fo, soft_i8_scale=100.0))
    p_tm = a_tm.assemble_tm(TMOutputs(fo=fo, soft_scale=100.0))
    assert p_tm[PORT_SOFT].data.dtype == np.complex64
    _assert_identical(p_ref, p_tm)


def test_tm_packets_masked_rows_and_empty():
    """Flush-path row mask: only valid rows are emitted, timestamps match;
    an all-False mask degrades to the empty/EOS contract."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    fo = _kernel_block(cfg)
    S = np.asarray(fo.bits_packed).shape[0]
    mask = np.zeros(S, bool)
    mask[: S // 3] = True

    a_ref, a_tm = _pair_of_assemblers(cfg)
    do = to_demod_outputs(cfg, fo)
    do = do._replace(valid=do.valid & jnp.asarray(mask)[None, :])
    p_ref = a_ref.assemble(do, eos=True)
    p_tm = a_tm.assemble_tm(TMOutputs(fo=fo, valid_rows=mask), eos=True)
    _assert_identical(p_ref, p_tm)
    assert p_tm[PORT_SOFT].data.shape == (C, S // 3)

    none = a_tm.assemble_tm(TMOutputs(fo=fo, valid_rows=np.zeros(S, bool)),
                            eos=True)
    assert all(p.eos and p.data.size == 0 for p in none.values())
