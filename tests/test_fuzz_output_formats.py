"""Fuzz the steady step's OUTPUT/INGEST format options against the plain
f32 run: random configs x {soft_i8, debug_ports off, int16 ingest,
pack_out forced off}.

The directed tests (test_soft_i8, test_int16_ingest, test_debug_modes)
cover each option alone on the default config; this sweep hunts
interaction bugs (e.g. a quantized soft plane mis-tiled when the debug
planes are compiled away, or the int16 dequant disturbing the packed-bits
epilogue).  Invariants, vs the same state stepped with no options:

- bits identical (decisions are made on full-precision values in-kernel;
  int16 ingest quantizes at ~1e-4 relative on these signals, far below
  the decision margins of the timing-decisive fixtures)
- soft within 0.5/scale per component when soft_i8 (plus the ingest
  tolerance when combined with int16)
- phase/sample_index None iff debug_ports=False, bit-exact otherwise
  (f32 ingest) / close (int16 ingest)

Reference anchor: the output ports and their payloads,
/root/reference/cpp/psk_soft.cpp:605-615; the format options are wire-
format extensions documented in docs/API.md.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu.models.full import (QuantSoft, demod_block_full,
                                      dequantize_soft, full_from_ff,
                                      quantize_full_state,
                                      to_demod_outputs)
from psk_soft_tpu.testing.signals import gen_psk_channel

C = 128
SCALE = 100.0

CASES = []
_rng = np.random.default_rng(20260818 + 1)
for _ in range(6):
    CASES.append(dict(
        sps=int(_rng.integers(4, 11)),
        num_avg=int(_rng.integers(8, 40)),
        constellation_size=int(_rng.choice([2, 4, 8])),
        phase_avg=int(_rng.integers(10, 30)),
        differential=bool(_rng.integers(0, 2)),
        matched_filter=str(_rng.choice(["none", "none", "rrc"])),
        soft_i8=bool(_rng.integers(0, 2)),
        debug_ports=bool(_rng.integers(0, 2)),
        i16=bool(_rng.integers(0, 2)),
        pack_out=[None, False][int(_rng.integers(0, 2))],
    ))
# make sure the densest interaction is always in the sweep
CASES.append(dict(sps=8, num_avg=20, constellation_size=4, phase_avg=15,
                  differential=True, matched_filter="none", soft_i8=True,
                  debug_ports=False, i16=True, pack_out=None))


def _signal(cfg, nsym):
    m, sps = cfg.constellation_size, cfg.sps
    if cfg.matched_filter != "none":
        return np.stack([
            gen_psk_channel(nsym, sps=sps, m=m, seed=i, snr_db=28,
                            differential=cfg.differential, freq_offset=1e-4,
                            pulse="rrc", rrc_beta=cfg.rrc_beta,
                            rrc_span=cfg.rrc_span)[0] for i in range(C)])
    xs = []
    for i in range(C):
        r = np.random.default_rng(i)
        j = r.integers(0, m, nsym)
        pts = np.exp(2j * np.pi * j / m)
        if cfg.differential:
            pts = np.cumprod(pts)
        x = np.zeros(nsym * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 1e-4 * sps * np.arange(nsym))
        x += (0.005 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs)


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"sps{c['sps']}M{c['constellation_size']}{c['matched_filter'][0]}"
         f"{'q' if c['soft_i8'] else ''}{'D' if not c['debug_ports'] else ''}"
         f"{'w' if c['i16'] else ''}"
         f"{'u' if c['pack_out'] is False else ''}-{i}"
         for i, c in enumerate(CASES)])
def test_fuzz_output_format_interactions(case):
    cfg = DemodConfig(sps=case["sps"], num_avg=case["num_avg"],
                      constellation_size=case["constellation_size"],
                      phase_avg=case["phase_avg"],
                      differential=case["differential"],
                      matched_filter=case["matched_filter"])
    sps = cfg.sps
    warm_syms, run_syms = 256, 128
    keep = (cfg.num_avg - 1) * sps + max(cfg.mf_ntaps - 1, 0)
    if run_syms * sps < keep:
        run_syms = -(-keep // sps) + 8
    xs = _signal(cfg, warm_syms + run_syms)
    warm, run = np.split(xs, [warm_syms * sps], axis=1)

    fn_ff = make_ff_demod_fn(cfg, channels=C)
    st_ff, _ = fn_ff(ff_init(cfg, (C,)), jnp.asarray(warm))
    raw_win = (warm[:, warm.shape[1] - keep:]
               if cfg.matched_filter != "none" else None)
    st = full_from_ff(cfg, st_ff, raw_win=raw_win)

    base = functools.partial(demod_block_full, cfg)
    x_re = jnp.asarray(np.ascontiguousarray(run.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(run.imag.T))
    _, o_base = base(st, x_re, x_im)
    d_base = to_demod_outputs(cfg, o_base)

    in_scale = 1.0
    st_opt, xo_re, xo_im = st, x_re, x_im
    if case["i16"]:
        in_scale = float(max(np.abs(run.real).max(),
                             np.abs(run.imag).max())) / 32000.0
        st_opt = quantize_full_state(st, in_scale)
        xo_re = jnp.asarray(np.ascontiguousarray(
            np.round(run.real.T / in_scale).astype(np.int16)))
        xo_im = jnp.asarray(np.ascontiguousarray(
            np.round(run.imag.T / in_scale).astype(np.int16)))
    soft_scale = SCALE if case["soft_i8"] else None
    _, o_opt = demod_block_full(
        cfg, st_opt, xo_re, xo_im,
        in_scale=in_scale, pack_out=case["pack_out"],
        soft_i8_scale=soft_scale, debug_ports=case["debug_ports"])
    d_opt = to_demod_outputs(cfg, o_opt, soft_i8_scale=soft_scale)

    np.testing.assert_array_equal(np.asarray(d_opt.bits),
                                  np.asarray(d_base.bits), err_msg=str(case))

    soft_opt = dequantize_soft(
        QuantSoft(np.asarray(d_opt.soft.re_q), np.asarray(d_opt.soft.im_q),
                  d_opt.soft.scale)
        if case["soft_i8"] else np.asarray(d_opt.soft))
    base = np.asarray(d_base.soft)
    exp_re, exp_im = base.real, base.imag
    if case["soft_i8"]:
        # int8 quantization SATURATES symmetrically (clip(round(s*scale),
        # -127, 127), models/full.py): soft values outside the rails
        # (reachable on RRC/8-PSK configs before the magnitude tracker
        # converges) clip rather than wrap.
        exp_re = np.clip(exp_re, -127 / SCALE, 127 / SCALE)
        exp_im = np.clip(exp_im, -127 / SCALE, 127 / SCALE)
    tol = (0.5 / SCALE if case["soft_i8"] else 0.0) + \
          (5e-3 if case["i16"] else 1e-6)
    # per-component bounds (complex assert_allclose would take the complex
    # magnitude and inflate the quantization bound by sqrt(2))
    np.testing.assert_allclose(soft_opt.real, exp_re, atol=tol + 1e-7,
                               err_msg=str(case))
    np.testing.assert_allclose(soft_opt.imag, exp_im, atol=tol + 1e-7,
                               err_msg=str(case))

    if case["debug_ports"]:
        if case["i16"]:
            np.testing.assert_allclose(np.asarray(d_opt.phase),
                                       np.asarray(d_base.phase), atol=5e-3,
                                       err_msg=str(case))
        else:
            np.testing.assert_array_equal(np.asarray(d_opt.phase),
                                          np.asarray(d_base.phase),
                                          err_msg=str(case))
        np.testing.assert_array_equal(np.asarray(d_opt.sample_index),
                                      np.asarray(d_base.sample_index),
                                      err_msg=str(case))
    else:
        assert d_opt.phase is None and d_opt.sample_index is None, str(case)
