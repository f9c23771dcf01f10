"""Fuzz the steady-state step: random (sps, num_avg, phase_avg, m, diff,
mf, interp) configurations, models/full vs the feed-forward pipeline.

Signals are timing-decisive (energy concentrated on one intra-symbol index)
so argmax ties cannot flip between implementations (PARITY.md)."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (demod_block_full, full_from_ff,
                                      to_demod_outputs)
from psk_soft_tpu.testing.signals import gen_psk_channel

C = 128
CASES = []
_rng = np.random.default_rng(20260818)
for _ in range(8):
    sps = int(_rng.integers(4, 11))
    mf = str(_rng.choice(["none", "none", "rrc", "boxcar"]))
    CASES.append(dict(
        sps=sps,
        num_avg=int(_rng.integers(8, 40)),
        constellation_size=int(_rng.choice([2, 4, 8])),
        phase_avg=int(_rng.integers(10, 30)),
        differential=bool(_rng.integers(0, 2)),
        matched_filter=mf,
        rrc_span=int(_rng.integers(3, 7)),
        timing_interp=bool(_rng.integers(0, 2)),
        nsym=int(_rng.choice([256, 384])),
    ))


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"sps{c['sps']}M{c['constellation_size']}A{c['num_avg']}"
         f"P{c['phase_avg']}{c['matched_filter'][0]}"
         f"{'i' if c['timing_interp'] else ''}-{i}"
         for i, c in enumerate(CASES)])
def test_fuzz_full_vs_ff(case):
    cfg = DemodConfig(sps=case["sps"], num_avg=case["num_avg"],
                      constellation_size=case["constellation_size"],
                      phase_avg=case["phase_avg"],
                      differential=case["differential"],
                      matched_filter=case["matched_filter"],
                      rrc_span=case["rrc_span"],
                      timing_interp=case["timing_interp"])
    sps, m, S = cfg.sps, cfg.constellation_size, case["nsym"]
    warm_syms = S // 2
    if cfg.matched_filter != "none":
        xs = np.stack([
            gen_psk_channel(S, sps=sps, m=m, seed=i, snr_db=28,
                            differential=cfg.differential,
                            freq_offset=1e-4, pulse="rrc",
                            rrc_beta=cfg.rrc_beta,
                            rrc_span=cfg.rrc_span)[0] for i in range(C)])
    else:
        xs = []
        for i in range(C):
            r = np.random.default_rng(i)
            j = r.integers(0, m, S)
            pts = np.exp(2j * np.pi * j / m)
            if cfg.differential:
                pts = np.cumprod(pts)
            x = np.zeros(S * sps, np.complex64)
            x[2::sps] = pts * np.exp(2j * np.pi * 1e-4 * sps * np.arange(S))
            x += (0.005 * r.standard_normal(x.size)).astype(np.complex64)
            xs.append(x)
        xs = np.stack(xs)
    # Keep every block long enough for the carry-window slice.
    keep = (cfg.num_avg - 1) * sps + max(cfg.mf_ntaps - 1, 0)
    run_syms = S - warm_syms
    if run_syms * sps < keep:
        pytest.skip("run segment shorter than the carry window")

    warm, run = np.split(xs, [warm_syms * sps], axis=1)
    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    raw_win = (warm[:, warm.shape[1] - keep:]
               if cfg.matched_filter != "none" else None)
    st = full_from_ff(cfg, st_ff, raw_win=raw_win)
    st, out = demod_block_full(
        cfg, st, jnp.asarray(np.ascontiguousarray(run.real.T)),
        jnp.asarray(np.ascontiguousarray(run.imag.T)))
    d = to_demod_outputs(cfg, out)
    _, out_ff = fn_ff(st_ff, jnp.asarray(run))
    np.testing.assert_array_equal(np.asarray(d.sample_index),
                                  np.asarray(out_ff.sample_index),
                                  err_msg=str(case))
    np.testing.assert_allclose(np.asarray(d.soft), np.asarray(out_ff.soft),
                               atol=5e-3, err_msg=str(case))


def test_reconfigure_vectorization_matches_loop_oracle():
    """The vectorized right-aligned history gather (engine.reconfigure_ff)
    must equal the per-channel loop it replaced, across random counts and
    window sizes (VERDICT round-1 item 8)."""
    rng = np.random.default_rng(7)
    for _ in range(50):
        n_old = int(rng.integers(1, 30))
        n_new = int(rng.integers(1, 30))
        Cc = int(rng.integers(1, 6))
        L = max(n_old - 1, 0)
        m = max(n_new - 1, 0)
        hist = rng.standard_normal((Cc, L)).astype(np.float32)
        count = np.minimum(rng.integers(0, n_old + 1, Cc),
                           max(n_old - 1, 1))
        keep = np.minimum(count, m)
        # loop oracle (the replaced code)
        want = np.zeros((Cc, m), np.float32)
        if n_new > 1 and n_old > 1:
            for ch in range(Cc):
                k = int(keep[ch])
                if k > 0:
                    live = hist[ch][L - min(int(count[ch]), L):]
                    nh = live[max(live.size - k, 0):]
                    want[ch][m - nh.size:] = nh
        # vectorized (mirror of reconfigure_ff)
        if m > 0 and L > 0:
            s = np.arange(m)
            src_idx = np.clip(L - m + s, 0, L - 1)
            idx = np.broadcast_to(src_idx, (Cc, m))
            gathered = np.take_along_axis(hist, idx, axis=-1)
            mask = s >= (m - keep[..., None])
            got = np.where(mask, gathered, 0.0).astype(np.float32)
        else:
            got = np.zeros((Cc, m), np.float32)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{n_old}->{n_new}")
