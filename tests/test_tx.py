"""Transmit chain (ops/tx.py): exact inverses of the receive conventions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.ops import slicers, tx
from psk_soft_tpu.ops.fec import CODE_K7, info_bits_for
from psk_soft_tpu.ops.framesync import FrameFormat
from psk_soft_tpu.ops.scramble import prbs15
from psk_soft_tpu.runtime.fec import FecFrameDecoder
from psk_soft_tpu.runtime.framesync import FrameSyncer
from psk_soft_tpu.runtime.scramble import FrameDescrambler


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_bits_to_symbols_inverts_slicers(m):
    rng = np.random.default_rng(61)
    nb = int(np.log2(m))
    bits = rng.integers(0, 2, (3, 20 * nb), np.int8)
    idx = tx.bits_to_symbols(m, bits)
    pts = tx.symbols_to_iq(m, idx)
    sliced = np.asarray(slicers.slice_bits(m, pts))[..., :nb]
    assert np.array_equal(sliced.reshape(3, -1), bits)


def test_build_frame_roundtrip_fec_scramble():
    rng = np.random.default_rng(62)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    lf = prbs15()
    n_info = info_bits_for(CODE_K7, fmt.payload * 2)
    infos = [rng.integers(0, 2, n_info, np.int8) for _ in range(2)]
    idx = tx.frame_stream(fmt, infos, [50, 400], 700, code=CODE_K7,
                          lfsr=lf, seed=7)
    soft = tx.symbols_to_iq(4, idx)[None]
    sync = FrameSyncer(1, fmt)
    top = FrameDescrambler(FecFrameDecoder(sync, CODE_K7), lf)
    sync.observe(soft.astype(np.complex64))
    sync.finalize()
    frames = top.pop_frames()
    assert [f.start for f in frames] == [50, 400]
    for f, info in zip(frames, infos):
        assert f.corrected == 0 and not f.suspect
        assert np.array_equal(f.info_bits, info)


def test_frame_stream_validation():
    fmt = FrameFormat(uw=(0, 1, 2, 3), payload=4, m=4)
    bits = np.zeros(8, np.int8)
    with pytest.raises(ValueError):
        tx.frame_stream(fmt, [bits, bits], [10, 12], 100)   # overlap
    with pytest.raises(ValueError):
        tx.frame_stream(fmt, [bits], [95], 100)             # doesn't fit
    with pytest.raises(ValueError):
        tx.build_frame(fmt, np.zeros(7, np.int8))           # wrong count
    fill = tx.frame_stream(fmt, [bits], [4], 40, fill=2)
    assert (fill[:4] == 2).all() and (fill[12:] == 2).all()


def test_rrc_shaping_demodulates():
    """TX RRC + RX RRC matched filter composes to a clean demod."""
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn

    rng = np.random.default_rng(63)
    n_sym, sps = 600, 8
    idx = rng.integers(0, 4, n_sym)
    x = tx.shape(4, idx, sps, pulse="rrc")
    assert x.shape == (n_sym * sps,)
    cfg = DemodConfig(sps=sps, num_avg=50, constellation_size=4,
                      phase_avg=50, matched_filter="rrc")
    st, out = make_ff_demod_fn(cfg, channels=1)(ff_init(cfg, (1,)),
                                                jnp.asarray(x[None]))
    out = jax.device_get(out)
    v = out.valid[0]
    soft = out.soft[0][v][20:]      # skip the tracker-settle symbols
    assert soft.size > 480
    # Decisions sit on the +pi/4 QPSK grid (modulo the M-fold ambiguity):
    # every decision angle is within 0.2 rad of the 45-degree lattice.
    d = np.angle(soft * np.exp(-1j * np.pi / 4))
    frac = np.mod(d, np.pi / 2)
    dist = np.minimum(frac, np.pi / 2 - frac)
    assert dist.max() < 0.2, dist.max()
    assert np.median(dist) < 0.03
