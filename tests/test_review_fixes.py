"""Regression tests for the code-review findings (see commit message):
default-config (sps=10) kernel alignment, reconfigure_ff history cap,
timing-interp boundary clamp, CLI batch flush, xdelta phase-only reset,
odd-length RRC symmetry, to_host tuple safety."""

import jax
import numpy as np
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                      to_demod_outputs)
from psk_soft_tpu.runtime.engine import StreamEngine, reconfigure_ff
from psk_soft_tpu.runtime.streams import SRI, Packet, PORT_SOFT
from psk_soft_tpu.testing.signals import gen_psk, gen_psk_channel


def test_full_kernel_default_sps10_config():
    """sps=10, num_avg=100 (the PRF defaults): wlen=990 is not 8-aligned, so
    the kernel must take the concat fallback; outputs must match ff."""
    C = 128
    cfg = DemodConfig(sps=10, num_avg=100, constellation_size=4, phase_avg=50)
    xs = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, 4, 768)
        x = np.zeros(768 * 10, np.complex64)
        x[4::10] = np.exp(2j * np.pi * j / 4)
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    warm, run = np.split(xs, [256 * 10], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    st = full_from_ff(cfg, st_ff)
    fn = make_full_demod_fn(cfg)
    st, out = fn(st, jnp.asarray(run.real.T), jnp.asarray(run.imag.T))
    d = to_demod_outputs(cfg, out)
    _, out_ff = fn_ff(st_ff, jnp.asarray(run))
    np.testing.assert_array_equal(np.asarray(d.sample_index),
                                  np.asarray(out_ff.sample_index))
    np.testing.assert_allclose(np.asarray(d.soft), np.asarray(out_ff.soft),
                               atol=3e-3)


def test_reconfigure_ff_growing_phase_avg_no_ghost_history():
    """Growing phase_avg on a saturated tracker must not count a dead slot
    as live history (the fit would ingest a zero among large phases)."""
    cfg0 = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
    cfg1 = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=40)
    # Converge with a frequency offset so unwrapped phases are large.
    x, _ = gen_psk_channel(600, sps=8, m=4, seed=3, snr_db=25,
                           freq_offset=3e-4)
    fn0 = make_ff_demod_fn(cfg0)
    st = ff_init(cfg0)
    st, _ = fn0(st, jnp.asarray(x[:3200]))
    st1 = reconfigure_ff(cfg0, cfg1, st)
    assert int(np.asarray(st1.phase_count)) <= cfg0.phase_avg - 1
    fn1 = make_ff_demod_fn(cfg1)
    st1, out = fn1(st1, jnp.asarray(x[3200:]))
    v = np.asarray(out.valid)
    soft = np.asarray(out.soft)[v]
    # With a ghost zero in the window the first post-reconfigure estimates
    # jump by ~est/p and decisions leave the constellation.
    ang = np.angle(soft * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    dist = np.minimum(ang, np.pi / 2 - ang)
    assert np.percentile(dist, 99) < 0.15, np.percentile(dist, 99)


def test_timing_interp_row0_negative_offset():
    """A peak just below bin 0 must not interpolate row 0 one sample late."""
    from psk_soft_tpu.ops import timing

    sps, A, S = 8, 4, 6
    rng = np.random.default_rng(0)
    # Energy mostly at bin 0 with a slight pull toward bin sps-1 so the
    # centroid lands in [-0.5, 0).
    rows = np.zeros((S + A - 1, sps), np.complex64)
    rows[:, 0] = 4.0
    rows[:, sps - 1] = 3.5
    w = timing.windowed_bin_sums(
        timing.symbol_energy_rows(jnp.asarray(rows)), A)
    flat = jnp.asarray(rows.reshape(-1))
    b, sel = timing.select_decision_samples_interp(flat, w, sps)
    # Row 0 has no sample before flat[0]; the decision must equal flat[0]
    # exactly (frac forced to 0), not a blend of flat[0] and flat[1].
    assert np.asarray(sel)[0] == np.asarray(flat)[0]


def test_cli_demod_batch_flushes_remainder(tmp_path):
    import subprocess, sys, os
    C = 2
    xs = np.stack([gen_psk(200, 8, 4, seed=700 + c)[0] for c in range(C)])
    inter = np.ascontiguousarray(xs.T)
    f = tmp_path / "in.cf32"
    inter.tofile(f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "psk_soft_tpu", "demod-batch",
                    "--in", str(f), "--out-prefix", str(tmp_path / "o"),
                    "--channels", str(C), "--sps", "8", "--num-avg", "50",
                    "-M", "4", "--phase-avg", "20",
                    "--block-symbols", "128"], check=True, env=env,
                   timeout=240)
    soft = np.fromfile(tmp_path / "o.soft.cf32", np.complex64).reshape(-1, C)
    # 200 symbols: one 128-block + 72 remainder; all 151 valid outputs out.
    assert soft.shape[0] == 200 - 49


def test_xdelta_change_keeps_timing_window():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    eng = StreamEngine(cfg, block_symbols=64)
    x, _ = gen_psk(400, 8, 4)
    eng.process(Packet(data=x[:1600], sri=SRI(stream_id="s", xdelta=0.01)))
    seen_before = int(np.asarray(eng._state.seen))
    assert seen_before > 0
    out = eng.process(Packet(data=x[1600:],
                             sri=SRI(stream_id="s", xdelta=0.02)))
    # Timing window survived (no full re-warm-up): output continues.
    assert eng.metrics.resets == 0
    assert PORT_SOFT in out
    # Phase history was cleared per the reference's LinearFit.reset.
    # (phase_count restarted; it regrows within the new packet.)


def test_rrc_taps_odd_length_symmetric():
    from psk_soft_tpu.ops.matched_filter import rrc_taps

    taps = rrc_taps(9, 0.35, 3)  # n = 27, odd
    np.testing.assert_allclose(taps, taps[::-1], atol=1e-7)


def test_to_host_plain_tuples_safe():
    a = jnp.arange(4, dtype=jnp.float32)
    b = jnp.arange(4, dtype=jnp.int32)
    ra, rb = jax.device_get((a, b))
    np.testing.assert_array_equal(ra, np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(rb, np.arange(4, dtype=np.int32))
