"""Feedback -> feed-forward equivalence gate (SURVEY.md section 7 stage 4).

The block-parallel pipeline (models/blockpsk.py) must reproduce the
exact-scan pipeline (models/psk.py) -- which itself reproduces the reference
recursion -- within FP tolerance, on the golden vectors and under frequency
offset (where the unwrap and the linear-fit slope actually do work).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig, demod_init, make_demod_fn
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.testing.signals import gen_psk, gen_psk_channel


def run_both(cfg, x, num_blocks=1):
    fn_exact = make_demod_fn(cfg)
    fn_ff = make_ff_demod_fn(cfg)
    st_e = demod_init(cfg)
    st_f = ff_init(cfg)
    outs_e, outs_f = [], []
    for blk in np.split(np.asarray(x), num_blocks):
        blk = jnp.asarray(blk)
        st_e, oe = fn_exact(st_e, blk)
        st_f, of = fn_ff(st_f, blk)
        outs_e.append(oe)
        outs_f.append(of)

    def cat(outs, field):
        return np.concatenate([np.asarray(getattr(o, field)) for o in outs])

    return {f: (cat(outs_e, f), cat(outs_f, f))
            for f in ("soft", "bits", "phase", "sample_index", "valid")}


def assert_equiv(res, phase_tol=1e-3, soft_tol=1e-3):
    ve, vf = res["valid"]
    np.testing.assert_array_equal(ve, vf)
    v = ve
    np.testing.assert_allclose(res["phase"][1][v], res["phase"][0][v],
                               atol=phase_tol)
    np.testing.assert_allclose(res["soft"][1][v], res["soft"][0][v],
                               atol=soft_tol)
    np.testing.assert_array_equal(res["sample_index"][1][v],
                                  res["sample_index"][0][v])
    np.testing.assert_array_equal(res["bits"][1][v], res["bits"][0][v])


@pytest.mark.parametrize("m,diff", [(2, False), (4, False), (8, False),
                                    (4, True)])
def test_ff_matches_exact_golden(m, diff):
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=m, phase_avg=50,
                      differential=diff)
    x, _ = gen_psk(1000, 8, m, differential=diff)
    assert_equiv(run_both(cfg, x))


@pytest.mark.parametrize("num_blocks", [1, 4, 10])
def test_ff_matches_exact_blocked(num_blocks):
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
    x, _ = gen_psk(1000, 8, 4)
    assert_equiv(run_both(cfg, x, num_blocks=num_blocks))


@pytest.mark.parametrize("freq_offset", [1e-4, 5e-4, -3e-4])
def test_ff_matches_exact_freq_offset(freq_offset):
    """Frequency offset exercises the unwrap and the fit slope for real
    (BASELINE.json config 2); the M-th-power phase advances 4*M*pi*f per
    symbol and wraps repeatedly."""
    cfg = DemodConfig(sps=10, num_avg=50, constellation_size=4, phase_avg=50)
    x, _ = gen_psk_channel(2000, sps=10, m=4, freq_offset=freq_offset,
                           snr_db=25.0, seed=3)
    res = run_both(cfg, x, num_blocks=5)
    assert_equiv(res, phase_tol=5e-3, soft_tol=5e-3)
    # And the tracker actually locks: soft decisions near constellation pts.
    v = res["valid"][0]
    soft = res["soft"][0][v][200:]
    ang = np.angle(soft * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    dist = np.minimum(ang, np.pi / 2 - ang)
    assert np.percentile(dist, 99) < 0.2


def test_ff_small_first_block_warmup():
    """Blocks smaller than the warm-up window: the first-valid index lands
    mid-block and the dynamic warm-up fix-up must track it."""
    cfg = DemodConfig(sps=8, num_avg=25, constellation_size=4, phase_avg=10)
    x, _ = gen_psk(300, 8, 4)
    for nb in (2, 5, 15):
        assert_equiv(run_both(cfg, x, num_blocks=nb))


def test_ff_phase_avg_one():
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=1)
    x, _ = gen_psk(200, 8, 4)
    assert_equiv(run_both(cfg, x))


def test_scanned_ff_matches_loop():
    """make_scanned_ff_demod_fn (one dispatch for K blocks) == the python
    loop over the carried step."""
    import jax.numpy as jnp
    from psk_soft_tpu.models.blockpsk import (ff_init, make_ff_demod_fn,
                                              make_scanned_ff_demod_fn)

    cfg = DemodConfig(sps=8, num_avg=30, constellation_size=4, phase_avg=10)
    x, _ = gen_psk(400, 8, 4)
    blocks = np.stack(np.split(np.asarray(x), 4))
    fn = make_ff_demod_fn(cfg)
    st = ff_init(cfg)
    outs = []
    for b in blocks:
        st, o = fn(st, jnp.asarray(b))
        outs.append(np.asarray(o.soft))
    st2, so = make_scanned_ff_demod_fn(cfg)(ff_init(cfg), jnp.asarray(blocks))
    np.testing.assert_allclose(np.asarray(so.soft).reshape(-1),
                               np.concatenate(outs), atol=1e-6)
    for a, b in zip(st, st2):
        np.testing.assert_allclose(np.asarray(jnp.real(a)),
                                   np.asarray(jnp.real(b)), atol=1e-6)


def test_scanned_full_matches_loop():
    import jax.numpy as jnp
    from psk_soft_tpu.models.blockpsk import ff_init as ffi
    from psk_soft_tpu.models.blockpsk import make_ff_demod_fn as mkff
    from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                          make_scanned_full_demod_fn)
    from psk_soft_tpu.testing.signals import gen_psk_channel

    C = 128
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = np.stack([gen_psk_channel(512, sps=8, m=4, seed=i, snr_db=25)[0]
                   for i in range(C)])
    st_ff, _ = mkff(cfg, channels=C)(ffi(cfg, (C,)), jnp.asarray(xs))
    st0 = full_from_ff(cfg, st_ff)
    xr = np.stack([np.ascontiguousarray(np.roll(xs, k, axis=0).real.T)
                   for k in range(3)])
    xi = np.stack([np.ascontiguousarray(np.roll(xs, k, axis=0).imag.T)
                   for k in range(3)])
    fn = make_full_demod_fn(cfg)
    st = st0
    parts = []
    for k in range(3):
        st, o = fn(st, jnp.asarray(xr[k]), jnp.asarray(xi[k]))
        parts.append(np.asarray(o.soft_re))
    st2, so = make_scanned_full_demod_fn(cfg)(
        st0, jnp.asarray(xr), jnp.asarray(xi))
    np.testing.assert_allclose(np.asarray(so.soft_re),
                               np.stack(parts), atol=1e-6)
