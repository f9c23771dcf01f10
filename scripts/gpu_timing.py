#!/usr/bin/env python
"""Hand-written kernels against what XLA makes of the plain versions, on
the GPU, at the bench's chain width (1024 channels, 512-symbol blocks,
4096 decode rows x 64 trellis steps).

    python scripts/gpu_timing.py [--out gpu_timing.json]

1. Viterbi decode alone: the Pallas kernel (row tile x num_warps
   variants) vs the XLA scan decoder with unroll 1 and 8.
2. The one-program chain step (demod -> seam sync -> LLR -> Viterbi ->
   CRC) per block with the kernel vs with the XLA scan.
3. The steady demod step and the feed-forward pipeline per block, and the
   bytes per input sample XLA's cost model counts for the demod step.
4. A profiler trace of a few demod and chain steps: per-kernel device
   time and the device busy share of the window.

Times are the minimum over repetitions of regions that end in
``block_until_ready`` (or a host fetch); each result line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from psk_soft_tpu import DemodConfig  # noqa: E402
from psk_soft_tpu.ops import fec  # noqa: E402
from psk_soft_tpu.ops.pallas import viterbi_kernel as vk  # noqa: E402
from psk_soft_tpu.utils.device_env import (  # noqa: E402
    card_lines, device_tags, enable_compile_cache, require_gpu)

RESULTS: list[dict] = []


def record(name: str, **fields) -> None:
    row = {"name": name, **fields}
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def best_time(fn, *args, reps: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def viterbi_alone(rows: int = 4096) -> None:
    code = fec.CODE_K7
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (rows, 58)).astype(np.int8)
    coded = np.asarray(fec.conv_encode(code, jnp.asarray(bits)))
    llr = jnp.asarray((1.0 - 2.0 * coded)
                      + 0.6 * rng.standard_normal(coded.shape), jnp.float32)
    steps = llr.reshape(rows, -1, code.n)
    exp = jnp.asarray(fec._trellis(code)[1])
    ref = None
    for unroll in (1, 8):
        fn = jax.jit(functools.partial(fec._viterbi, exp_sign=exp, k=code.k,
                                       s_count=code.states, terminate=True,
                                       unroll=unroll))
        out = np.asarray(fn(steps))
        ref = out if ref is None else ref
        assert np.array_equal(out, ref)
        record("viterbi_alone", impl=f"xla_scan_unroll{unroll}",
               rows=rows, steps=steps.shape[1],
               seconds=best_time(fn, steps))
    signs = jnp.asarray(vk.butterfly_signs(code))
    for row_tile, num_warps in ((16, 1), (16, 2), (16, 4), (32, 4),
                                (8, 1)):
        fn = jax.jit(functools.partial(
            vk._decode_steps, signs=signs, k=code.k, n=code.n,
            terminate=True, row_tile=row_tile, num_warps=num_warps))
        assert np.array_equal(np.asarray(fn(steps)), ref)
        record("viterbi_alone", impl=f"kernel_rows{row_tile}_"
               f"warps{num_warps}", rows=rows, steps=steps.shape[1],
               seconds=best_time(fn, steps))


def chain_setup(c: int = 1024, s: int = 512):
    from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
    from psk_soft_tpu.models.chain import chain_init
    from psk_soft_tpu.models.full import full_from_ff
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.framesync import FrameFormat
    from psk_soft_tpu.testing.signals import plant_unaligned_frames

    sps = 8
    cfg = DemodConfig(sps=sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    _, k, _, x, n_info, _ = plant_unaligned_frames(
        c, s, sps, fmt, fec.CODE_K7, CRC16_CCITT, rng)
    warm = jax.jit(jax.vmap(lambda st, b: demod_block_ff(cfg, st, b)))
    st_ff, _ = warm(ff_init(cfg, (c,)), jnp.asarray(x))
    state = chain_init(fmt, c, full_from_ff(cfg, st_ff))
    x_re = jnp.asarray(np.ascontiguousarray(x.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(x.imag.T))
    return SimpleNamespace(cfg=cfg, fmt=fmt, crc=CRC16_CCITT, k=k,
                           n_info=n_info, c=c, s=s, state=state, x_re=x_re,
                           x_im=x_im)


def chain_step_fn(cs, backend: str, unroll: int = 1, blocks: int = 20):
    """(one-block step, scan-of-`blocks` step), both compiled with the
    Viterbi backend forced while tracing."""
    from psk_soft_tpu.models.chain import make_chain_fn

    step = make_chain_fn(cs.cfg, cs.fmt, fec.CODE_K7, cs.k, crc=cs.crc)

    def many(st, x_re, x_im):
        def body(s, _):
            s2, out = step(s, x_re, x_im)
            return s2, out.msg.astype(jnp.int32).sum() + out.found.sum()
        st, chk = jax.lax.scan(body, st, None, length=blocks)
        return st, chk.sum()

    orig_resolve, orig_vit = fec._resolve_backend, fec._viterbi
    fec._resolve_backend = lambda b: backend
    fec._viterbi = functools.partial(orig_vit, unroll=unroll)
    try:
        args = (cs.state, cs.x_re, cs.x_im)
        one = jax.jit(step).lower(*args).compile()
        scan = jax.jit(many).lower(*args).compile()
    finally:
        fec._resolve_backend, fec._viterbi = orig_resolve, orig_vit
    return one, scan


def chain_compare(cs) -> None:
    outs = {}
    for backend, unroll in (("pallas", 1), ("xla", 1), ("xla", 8)):
        one, scan = chain_step_fn(cs, backend, unroll)
        st, out = one(cs.state, cs.x_re, cs.x_im)
        outs[(backend, unroll)] = jax.device_get(out)
        per_dispatch = best_time(lambda: one(cs.state, cs.x_re, cs.x_im)[1],
                                 reps=20)
        scanned = best_time(lambda: scan(cs.state, cs.x_re, cs.x_im)[1],
                            reps=5) / 20
        record("chain_step", viterbi=f"{backend}_unroll{unroll}",
               seconds_per_block_one_dispatch=per_dispatch,
               seconds_per_block_scan20=scanned,
               infobits_per_s_scan20=cs.c * cs.k * cs.n_info / scanned)
    ref = outs[("pallas", 1)]
    for key, out in outs.items():
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(out), jax.tree.leaves(ref))), key


def demod_compare(c: int = 1024, s: int = 512) -> None:
    import bench
    from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
    from psk_soft_tpu.models.full import demod_block_full, full_from_ff

    sps = 8
    cfg = DemodConfig(sps=sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    x = bench._qpsk_block(c, s, sps)
    args = SimpleNamespace(warmup=2, reps=5, iters=100, ingest="f32",
                           soft="f32", no_debug_ports=False)
    for label, fn in (("steady_rolling", bench.run_full),
                      ("ff", bench.run_ff)):
        rate = fn(args, cfg, c, s * sps, x)
        record("demod_step", impl=label, samples_per_s=rate,
               seconds_per_block=c * s * sps / rate)
    warm = jax.jit(jax.vmap(lambda st, b: demod_block_ff(cfg, st, b)))
    st_ff, _ = warm(ff_init(cfg, (c,)), jnp.asarray(x))
    st = full_from_ff(cfg, st_ff)
    x_re = jnp.asarray(np.ascontiguousarray(x.real.T))
    x_im = jnp.asarray(np.ascontiguousarray(x.imag.T))
    for dbg in (True, False):
        comp = jax.jit(functools.partial(demod_block_full, cfg,
                                         debug_ports=dbg)).lower(
            st, x_re, x_im).compile()
        cost = comp.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        nbytes = float(cost.get("bytes accessed", float("nan")))
        record("demod_step_cost_model", debug_ports=dbg,
               bytes_accessed=nbytes,
               bytes_per_input_sample=nbytes / (c * s * sps))


def trace_steps(cs, out_dir: str) -> None:
    from psk_soft_tpu.models.full import demod_block_full

    demod = jax.jit(functools.partial(demod_block_full, cs.cfg,
                                      debug_ports=False))
    chain, _ = chain_step_fn(cs, "pallas", 1, blocks=1)
    st0 = cs.state.demod
    jax.block_until_ready(demod(st0, cs.x_re, cs.x_im))
    jax.block_until_ready(chain(cs.state, cs.x_re, cs.x_im))
    for name, run in (("demod", lambda: demod(st0, cs.x_re, cs.x_im)),
                      ("chain", lambda: chain(cs.state, cs.x_re,
                                              cs.x_im))):
        d = tempfile.mkdtemp(prefix=f"trace_{name}_", dir=out_dir)
        with jax.profiler.trace(d):
            for _ in range(5):
                jax.block_until_ready(run())
        summarize_trace(name, glob.glob(f"{d}/**/*.xplane.pb",
                                        recursive=True)[0])
        shutil.rmtree(d)


def summarize_trace(name: str, path: str, top: int = 15) -> None:
    """Per-kernel device time and busy share over the GPU stream lines."""
    pd = jax.profiler.ProfileData.from_file(path)
    per_kernel, spans = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                t = per_kernel.setdefault(ev.name, [0.0, 0])
                t[0] += ev.duration_ns
                t[1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0] if spans else float("nan")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    record("trace", step=name, steps=5, window_ns=window, busy_ns=busy,
           idle_share=1.0 - busy / window if spans else None,
           kernels=len(per_kernel),
           top=[{"kernel": k[:80], "total_ns": v[0], "count": v[1]}
                for k, v in ranked])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="gpu_timing.json",
                    help="JSON file for every result line (traces are "
                         "written beside it and removed once summarized)")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    print(f"card: {card_lines()[0]}", flush=True)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    viterbi_alone()
    cs = chain_setup()
    chain_compare(cs)
    demod_compare()
    trace_steps(cs, out_dir)
    with open(args.out, "w") as fh:
        json.dump({"device": device_tags(), "results": RESULTS}, fh,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
