#!/usr/bin/env python
"""Smoke run of the receive chain on an NVIDIA GPU.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the multi-card paths only

One card drives the production chain (``build_receiver(engine="chain")``,
the one-program demod -> seam frame sync -> Viterbi -> CRC step) at the
bench's full width -- 1024 channels, QPSK, sps 8, numAvg 100, phaseAvg 50,
512-symbol blocks, K=7 (171,133) + CRC-16 frames with a 32-symbol unique
word and a 64-symbol payload on an unaligned cadence -- and checks every
kernel against its plain reference:

- the Viterbi kernel against the XLA scan decoder (bits equal);
- the steady demod step against the feed-forward pipeline on the same
  carry;
- the chain's frames against the per-stage stack, frame for frame;
- the flagship engine's packets against the batch engine's;
- the CLI's ``gen-frames`` -> ``demod-batch --fused-chain`` loop.

``--cards 4`` runs the channel-sharded chain (4096 channels) and the
time-sharded demod over ``time=4`` against the same data on card 0.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
script exits non-zero without it when the device is not a GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The bench's chain operating point (bench.py run_chain).
WIDTH = dict(channels=1024, symbols=512, sps=8, num_avg=100, phase_avg=50,
             uw_len=32, payload=64)
SOFT_ATOL = 3e-3        # tests/test_full_kernel.py soft tolerance
PHASE_ATOL = 2e-3       # tests/test_full_kernel.py phase tolerance
EDGE = 1e-2             # bits compared where soft is this far from a boundary


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what="") -> None:
    """A phase's pass condition (an explicit raise, so it holds under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _cfg(w):
    from psk_soft_tpu import DemodConfig
    return DemodConfig(sps=w["sps"], num_avg=w["num_avg"],
                       constellation_size=4, phase_avg=w["phase_avg"])


def _decisive_qpsk(c: int, s: int, sps: int, seed: int = 0) -> np.ndarray:
    """QPSK with all energy on intra-symbol index 2, a slow carrier offset
    and 1% noise: the timing argmax is decisive, so two implementations
    cannot pick different samples on a near tie."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, 4, (c, s))
    x = np.zeros((c, s * sps), np.complex64)
    x[:, 2::sps] = np.exp(2j * np.pi * (j / 4 + 1e-4 * sps * np.arange(s)))
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x


def _planes(x):
    import jax.numpy as jnp
    return (jnp.asarray(np.ascontiguousarray(x.real.T)),
            jnp.asarray(np.ascontiguousarray(x.imag.T)))


def _far_from_edges(soft: np.ndarray) -> np.ndarray:
    """QPSK decisions (at (+-1 +- j)/sqrt2) whose soft value is at least
    EDGE away from both decision boundaries (the axes)."""
    return np.minimum(np.abs(soft.real), np.abs(soft.imag)) > EDGE


# -- phases ------------------------------------------------------------------

def phase_viterbi(rows: int = 4096) -> None:
    """Viterbi kernel vs the XLA scan decoder: K=7 at the chain's decode
    shape (rows x 64 trellis steps), plus K=9, puncturing and the
    unterminated mode on a quarter of the rows."""
    import jax.numpy as jnp
    from psk_soft_tpu.ops import fec

    rng = np.random.default_rng(1)
    small = max(1, rows // 4)
    cases = [
        ("K7 r1/2", fec.CODE_K7, True, rows, 58),
        ("K7 r1/2 unterminated", fec.CODE_K7, False, small, 64),
        ("K9 r1/2", fec.CODE_K9, True, small, 56),
        ("K7 r3/4 punctured", fec.ConvCode(7, (0o171, 0o133),
                                           fec.PUNCTURE_3_4), True, small, 57),
    ]
    for name, code, term, n_rows, n_info in cases:
        bits = rng.integers(0, 2, (n_rows, n_info)).astype(np.int8)
        coded = np.asarray(fec.conv_encode(code, jnp.asarray(bits),
                                           terminate=term))
        llr = jnp.asarray((1.0 - 2.0 * coded)
                          + 0.6 * rng.standard_normal(coded.shape),
                          jnp.float32)
        got = np.asarray(fec.viterbi_decode(code, llr, terminate=term,
                                            backend="pallas"))
        ref = np.asarray(fec.viterbi_decode(code, llr, terminate=term,
                                            backend="xla"))
        diff = int((got != ref).sum())
        steps = fec.depuncture(code, llr).shape[-1] // code.n
        log(f"viterbi {name}: {n_rows} rows x {steps} steps, kernel vs XLA "
            f"scan: {diff} of {ref.size} bits differ (tolerance 0)")
        check(diff == 0, name)


def phase_demod(c: int = 1024, s: int = 512, sps: int = 8,
                num_avg: int = 100, phase_avg: int = 50) -> None:
    """Steady demod step vs the feed-forward pipeline on the same carry."""
    import jax
    import jax.numpy as jnp
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                          to_demod_outputs)

    w = dict(sps=sps, num_avg=num_avg, phase_avg=phase_avg)
    cfg = _cfg(w)
    x = _decisive_qpsk(c, 2 * s, sps, seed=2)
    warm, run = np.split(x, 2, axis=1)
    ff = make_ff_demod_fn(cfg, channels=c)
    st_ff, _ = ff(ff_init(cfg, (c,)), jnp.asarray(warm))
    full = make_full_demod_fn(cfg)
    _, out = full(full_from_ff(cfg, st_ff), *_planes(run))
    out = jax.device_get(to_demod_outputs(cfg, out))
    _, ref = jax.device_get(ff(st_ff, jnp.asarray(run)))
    check(np.asarray(ref.valid).all())
    idx_diff = int((out.sample_index != ref.sample_index).sum())
    soft_err = float(np.abs(out.soft - ref.soft).max())
    phase_err = float(np.abs(out.phase - ref.phase).max())
    far = _far_from_edges(ref.soft)
    bit_diff = int((out.bits[..., :2] != ref.bits[..., :2]).any(-1)[far]
                   .sum())
    log(f"demod {c} ch x {s} sym: steady step vs ff on the same carry: "
        f"sample index {idx_diff} differ (tolerance 0); max |soft err| "
        f"{soft_err:.2e} (tolerance {SOFT_ATOL}); max |phase err| "
        f"{phase_err:.2e} (tolerance {PHASE_ATOL}); bits {bit_diff} differ "
        f"of {int(far.sum())} symbols >= {EDGE} from a boundary "
        f"(tolerance 0).  Precision: the steady step has no dot or conv; "
        f"ff's convs run at HIGHEST, so no TF32 enters either side")
    check(idx_diff == 0)
    check(soft_err <= SOFT_ATOL and phase_err <= PHASE_ATOL)
    check(bit_diff == 0)


def _chain_setup(w, seed: int = 12):
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.fec import CODE_K7
    from psk_soft_tpu.ops.framesync import FrameFormat
    from psk_soft_tpu.testing.signals import plant_unaligned_frames

    rng = np.random.default_rng(seed)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, w["uw_len"])),
                      payload=w["payload"], m=4, threshold=0.7)
    starts, k, infos, x, _, n_msg = plant_unaligned_frames(
        w["channels"], w["symbols"], w["sps"], fmt, CODE_K7, CRC16_CCITT,
        rng)
    return fmt, CODE_K7, CRC16_CCITT, starts, k, infos, x, n_msg


def _push_blocks(engine, x, blocks: int, step):
    re = np.ascontiguousarray(x.real.T)
    im = np.ascontiguousarray(x.imag.T)
    out = []
    for _ in range(blocks):
        engine.push_planes(re, im)
        out.append(step())
    return out


def phase_chain(w=WIDTH, blocks: int = 5, expect_kernel: bool = True):
    """The production chain at full width: every planted frame after
    warm-up decoded exactly once, exact bits, CRC green.  Returns the
    frames keyed by (channel, start) and the inputs for phase_stack."""
    import jax
    from psk_soft_tpu.models.chain import make_chain_fn
    from psk_soft_tpu.runtime.receiver import build_receiver

    cfg = _cfg(w)
    fmt, code, crc, starts, k, infos, x, n_msg = _chain_setup(w)
    c, s = w["channels"], w["symbols"]
    rx = build_receiver(cfg, c, engine="chain", block_symbols=s, uw=fmt.uw,
                        frame_payload=fmt.payload, uw_threshold=0.7,
                        fec=code, fec_labeling="gray", crc=crc)
    eng = rx.engine
    per_block = _push_blocks(eng, x, 1, eng.step)          # warm block
    check(per_block == [[]])

    # Compile the chain step on its real carry: time, memory, and the
    # Viterbi kernel inside the one program.
    step = jax.jit(make_chain_fn(cfg, fmt, code, eng.k, crc=crc))
    x_re, x_im = _planes(x)
    t0 = time.perf_counter()
    lowered = step.lower(eng.chain_state, x_re, x_im)
    compiled = lowered.compile()
    log(f"chain step compile: {time.perf_counter() - t0:.1f} s")
    log(f"chain step memory_analysis: {compiled.memory_analysis()}")
    if expect_kernel:
        has = "viterbi_acs_traceback" in lowered.as_text()
        log(f"chain step contains the Viterbi kernel call: {has}")
        check(has)

    per_block += _push_blocks(eng, x, blocks - 1, eng.step)
    per_block.append(eng.flush())
    offsets = {p % s: j for j, p in enumerate(starts)}
    seen = {}
    for b, frames in enumerate(per_block):
        for f in frames:
            key = (f.channel, f.start)
            check(key not in seen, f"frame {key} decoded twice")
            j = offsets.get(f.start % s)
            check(j is not None, f"frame at unplanted offset {key}")
            check(f.crc_ok, f"CRC failed {key}")
            check(np.array_equal(f.info_bits, infos[f.channel, j]), key)
            seen[key] = f
        if 2 <= b < blocks:
            check(len(frames) == k * c, (b, len(frames), k * c))
    log(f"chain {c} ch x {s} sym blocks, {k} frames/block/ch "
        f"({k * c} decode rows x {fmt.payload * 2 // code.n} steps): "
        f"{len(seen)} frames over {blocks} blocks + flush; every block "
        f"after warm-up decoded all {k * c} planted frames exactly once, "
        f"exact info bits, CRC green (tolerance: 0 missing, 0 extra, "
        f"0 bit errors)")
    check(eng.crc_failures == 0 and eng.overflow_peaks == 0)
    return seen, x


def phase_stack(chain_frames, x, w=WIDTH, blocks: int = 5) -> None:
    """Chain frames vs the per-stage stack (full engine + FrameSyncer +
    FecFrameDecoder + FrameCrcChecker) on the same stream, frame for
    frame past the chain's warm-up block."""
    from psk_soft_tpu.runtime.receiver import build_receiver

    cfg = _cfg(w)
    fmt, code, crc = _chain_setup(w)[:3]
    s = w["symbols"]
    rx = build_receiver(cfg, w["channels"], engine="full", block_symbols=s,
                        uw=fmt.uw, frame_payload=fmt.payload,
                        uw_threshold=0.7, fec=code, fec_labeling="gray",
                        crc=crc)
    stack = {}

    def drain():
        # Every block: the syncer's ring holds only max_frames frames.
        stack.update({(f.channel, f.start): f for f in rx.pop_frames()})

    _push_blocks(rx.engine, x, blocks,
                 lambda: (rx.engine.step_packets(), drain()))
    rx.engine.flush_packets()
    drain()
    post = [key for key in stack if key[1] >= s]
    n_msg = len(next(iter(chain_frames.values())).info_bits)
    for key in post:
        check(key in chain_frames, f"chain missed {key}")
        check(stack[key].crc_ok)
        check(np.array_equal(stack[key].info_bits[:n_msg],
                             chain_frames[key].info_bits), key)
    extra = [key for key in chain_frames if key[1] >= s and key not in stack]
    log(f"chain vs per-stage stack: {len(post)} frames past warm-up, "
        f"{len(extra)} only in the chain, 0 bit differences (tolerance: "
        f"frame for frame, exact bits)")
    check(not extra and post)


def phase_engines(c: int = 1024, s: int = 512, sps: int = 8,
                  num_avg: int = 100, phase_avg: int = 50,
                  blocks: int = 4) -> None:
    """build_receiver(engine="full") packets vs engine="batch" packets."""
    from psk_soft_tpu.runtime.receiver import build_receiver
    from psk_soft_tpu.runtime.streams import PORT_BITS, PORT_SOFT

    cfg = _cfg(dict(sps=sps, num_avg=num_avg, phase_avg=phase_avg))
    x = _decisive_qpsk(c, s * blocks, sps, seed=3)
    full = build_receiver(cfg, c, engine="full", block_symbols=s).engine
    batch = build_receiver(cfg, c, engine="batch", block_symbols=s).engine
    soft_err, bit_diff, n_cmp = 0.0, 0, 0
    for b in range(blocks):
        blk = x[:, b * s * sps:(b + 1) * s * sps]
        full.push_planes(np.ascontiguousarray(blk.real.T),
                         np.ascontiguousarray(blk.imag.T))
        batch.push_block(blk)
        pf, pb = full.step_packets(), batch.step_packets()
        if b == 0 or not pf or not pb:
            continue                    # warm block: both run ff
        sf, sb = pf[PORT_SOFT].data, pb[PORT_SOFT].data
        n = min(sf.shape[-1], sb.shape[-1])
        sf, sb = sf[..., -n:], sb[..., -n:]
        soft_err = max(soft_err, float(np.abs(sf - sb).max()))
        far = _far_from_edges(sb)
        bf = pf[PORT_BITS].data[..., -2 * n:].reshape(c, n, 2)
        bb = pb[PORT_BITS].data[..., -2 * n:].reshape(c, n, 2)
        bit_diff += int((bf != bb).any(-1)[far].sum())
        n_cmp += int(far.sum())
    log(f"engines full vs batch: {n_cmp} steady symbols compared, max "
        f"|soft err| {soft_err:.2e} (tolerance {SOFT_ATOL}), {bit_diff} bit "
        f"differences away from decision edges (tolerance 0)")
    check(full.steady and n_cmp and soft_err <= SOFT_ATOL and bit_diff == 0)


def phase_cli(channels: int = 128, symbols: int = 1536) -> None:
    """In-process CLI: gen-frames then demod-batch --fused-chain."""
    from psk_soft_tpu.cli import main as cli

    uw = ",".join(str(v) for v in
                  np.random.default_rng(16).integers(0, 4, 32))
    with tempfile.TemporaryDirectory() as d:
        cap, truth_p, pre = (os.path.join(d, n)
                             for n in ("cap.cf32", "truth.jsonl", "rx"))
        check(cli(["gen-frames", "--out", cap, "--truth", truth_p,
                   "--channels", str(channels), "--symbols", str(symbols),
                   "--sps", "8", "-M", "4", "--uw", uw,
                   "--frame-payload", "48", "--fec", "k7", "--crc",
                   "crc16", "--labeling", "gray", "--frame-interval",
                   "333", "--snr", "25", "--seed", "4"]) == 0)
        check(cli(["demod-batch", "--in", cap, "--channels", str(channels),
                   "--out-prefix", pre, "--sps", "8", "-M", "4",
                   "--num-avg", "40", "--phase-avg", "30",
                   "--block-symbols", "256", "--fused-chain", "--uw", uw,
                   "--frame-payload", "48", "--fec", "k7",
                   "--fec-labeling", "gray", "--crc", "crc16"]) == 0)
        truth = {}
        for line in open(truth_p).read().splitlines():
            r = json.loads(line)
            truth[(r["channel"], r["start"])] = r["info_bits"]
        frames = [json.loads(line) for line in
                  open(pre + ".frames.jsonl").read().splitlines()]
    for f in frames:
        want = truth[(f["channel"], f["start"])]
        check(f["crc_ok"] is True and f["info_bits"][:len(want)] == want)
    log(f"cli gen-frames -> demod-batch --fused-chain: {len(frames)} of "
        f"{len(truth)} planted frames back exact, CRC green (tolerance: "
        f"at most the warm-up block's {channels} missing)")
    check(len(frames) >= len(truth) - channels)


def phase_sharded_chain(n_dev: int = 4, ch_per_dev: int = 1024,
                        w=WIDTH) -> None:
    """Channel-sharded steady step + seam chain tail under shard_map
    (eval/scaling.chain_scaling_report's composition) vs the same data
    on card 0 alone."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu.models.chain import (SeamTailState, make_seam_tail_fn,
                                           seam_tail_init)
    from psk_soft_tpu.models.full import (FullState, demod_block_full,
                                          full_from_ff)

    c = n_dev * ch_per_dev
    wc = dict(w, channels=c)
    cfg = _cfg(wc)
    fmt, code, crc, starts, k, infos, x, n_msg = _chain_setup(wc)
    tail_step = make_seam_tail_fn(fmt, code, k, crc=crc)

    def body(st, tail, x_re, x_im):
        st2, fo = demod_block_full(cfg, st, x_re, x_im, debug_ports=False)
        tail2, out = tail_step(tail, fo.soft_re, fo.soft_im)
        return st2, tail2, fo.soft_re, out.msg, out.found, out.pos, out.ok

    dev0 = jax.devices()[0]
    warm = make_ff_demod_fn(cfg, channels=c)
    st_ff, _ = warm(ff_init(cfg, (c,)), jnp.asarray(x))
    st0 = full_from_ff(cfg, st_ff)
    x_re, x_im = _planes(x)
    put0 = lambda t: jax.tree.map(lambda v: jax.device_put(v, dev0), t)
    one = jax.jit(body)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("chan",))
    spec = P(None, "chan")
    sh = NamedSharding(mesh, spec)
    shard = lambda t: jax.tree.map(lambda v: jax.device_put(v, sh), t)
    many = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(FullState(spec, spec, spec), SeamTailState(spec, spec),
                  spec, spec),
        out_specs=(FullState(spec, spec, spec), SeamTailState(spec, spec),
                   spec, P("chan"), P("chan"), P("chan"), P("chan")),
        check_vma=False))
    a = (put0(st0), put0(seam_tail_init(fmt, c)))
    b = (shard(st0), shard(seam_tail_init(fmt, c)))
    for _ in range(3):
        ra = one(*a, *put0((x_re, x_im)))
        rb = many(*b, *shard((x_re, x_im)))
        a, b = ra[:2], rb[:2]
    ra, rb = jax.device_get((ra[2:], rb[2:]))
    soft_err = float(np.abs(ra[0] - rb[0]).max())
    same = all(np.array_equal(u, v) for u, v in zip(ra[1:], rb[1:]))
    found = int(np.asarray(rb[2]).sum())
    log(f"sharded chain {c} ch over {n_dev} cards vs card 0 alone: max "
        f"|soft err| {soft_err:.2e} (tolerance {SOFT_ATOL}); frame table "
        f"(msg, found, pos, CRC) identical: {same} (tolerance exact); "
        f"{found} frames found in the last block")
    check(soft_err <= SOFT_ATOL and same and found == k * c)
    check(bool(np.asarray(rb[4]).all()))


def phase_time_sharded(n_dev: int = 4, c: int = 1024, total: int = 4096,
                       w=WIDTH) -> None:
    """Time-sharded demod over ``time=n_dev`` (ppermute halos, all_gather
    seams) vs the same function on card 0 alone (``time=1``)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from psk_soft_tpu.parallel.mesh import make_mesh
    from psk_soft_tpu.parallel.sharded_full import make_time_sharded_full_demod

    cfg = _cfg(w)
    x = _decisive_qpsk(c, total, w["sps"], seed=5)
    x_re, x_im = _planes(x)

    def run(devices):
        mesh = make_mesh(chan=1, time=len(devices), devices=devices)
        fn = make_time_sharded_full_demod(cfg, mesh, total)
        sh = NamedSharding(mesh, P("time", "chan"))
        return jax.device_get(fn(jax.device_put(x_re, sh),
                                 jax.device_put(x_im, sh)))

    ref = run(jax.devices()[:1])
    got = run(jax.devices()[:n_dev])
    valid = ref[5] & got[5]
    soft_r = ref[0] + 1j * ref[1]
    soft_g = got[0] + 1j * got[1]
    soft_err = float(np.abs(soft_g - soft_r)[valid].max())
    far = valid & _far_from_edges(soft_r)
    bit_diff = int((got[3] != ref[3])[far].sum())
    log(f"time-sharded demod {c} ch x {total} sym over time={n_dev} vs "
        f"card 0 alone: {int(valid.sum())} valid symbols, max |soft err| "
        f"{soft_err:.2e} (tolerance {SOFT_ATOL}), {bit_diff} bit "
        f"differences away from decision edges (tolerance 0)")
    check(valid.any() and np.array_equal(ref[5], got[5]))
    check(soft_err <= SOFT_ATOL and bit_diff == 0)


# -- main --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax
    from psk_soft_tpu.utils.device_env import card_lines, enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    enable_compile_cache()
    for line in card_lines()[:args.cards]:
        log(f"card: {line}")
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_sharded_chain()
        phase_time_sharded()
    else:
        phase_viterbi()
        phase_demod()
        frames, x = phase_chain()
        phase_stack(frames, x)
        phase_engines()
        phase_cli()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
