"""Headline benchmark: multi-channel QPSK demod and receive-chain
throughput on the GPU.

The default run prints TWO JSON lines: the steady-state demod step
(models/full.py) in input samples/s, then the one-program receive chain
(demod -> seam frame sync -> Viterbi -> CRC) in info bits/s.  Both run at
1024 channels, QPSK, sps=8, numAvg=100, phaseAvg=50 -- the reference's
test operating point (tests/test_psk_soft.py:191-193) at scale.

Every line names the platform, device kind, device count and the cards'
power limit.  On anything but a GPU the bench exits non-zero before it
measures: there is no fallback device.
"""

import argparse
import copy
import functools
import json
import sys
import time

import numpy as np


def _qpsk_block(C, symbols, sps, seed=0):
    """The bench's standard C-channel QPSK block (slow residual CFO, 1%
    noise) -- one deterministic generator so every variant measures the
    same signal content."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, size=(C, symbols))
    pts = np.exp(1j * (2 * np.pi * sym / 4
                       + 2 * np.pi * 1e-4 * np.arange(symbols)))
    x = np.repeat(pts, sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def emit(metric: str, value: float, unit: str) -> int:
    from psk_soft_tpu.utils.device_env import device_tags

    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **device_tags()}))
    return 0


def run_ff(args, cfg, C, T, x_np):
    """XLA feed-forward pipeline; returns the measured rate.

    All iters run inside ONE dispatch (lax.scan) and the timed region ends
    with a host fetch of a checksum that data-depends on every output, so
    asynchronous dispatch cannot inflate the number.
    """
    import jax
    import jax.numpy as jnp
    from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init

    state = ff_init(cfg, (C,))
    x = jnp.asarray(x_np)
    step = jax.vmap(functools.partial(demod_block_ff, cfg))

    @functools.partial(jax.jit, static_argnames=("k",))
    def run_k(state, x, k):
        def body(st, _):
            st2, out = step(st, x)
            chk = (jnp.sum(out.phase) + jnp.sum(out.soft.real)
                   + jnp.sum(out.bits) + jnp.sum(out.sample_index))
            return st2, chk
        st, chks = jax.lax.scan(body, state, None, length=k)
        return st, jnp.sum(chks)

    state, _ = run_k(state, x, args.warmup or 1)
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        state, chk = run_k(state, x, args.iters)
        float(chk)  # host fetch: forces true completion of all work
        best = min(best, time.perf_counter() - t0)
    return C * T * args.iters / best


def run_full(args, cfg, C, T, x_np, raw_tail=False, mixed=None):
    """Flagship: the steady-state time-major step (models/full.py),
    entered after converging through the flexible pipeline.

    raw_tail: pass the raw input tail to the handoff (matched-filter
    configs).  mixed: (ms, diffs) per-channel mode arrays (BASELINE
    config 4 on the carry's mode planes).
    """
    import jax
    import jax.numpy as jnp
    from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
    from psk_soft_tpu.models.full import demod_block_full, full_from_ff

    st_ff = ff_init(cfg, (C,))
    mixed_params = None
    if mixed is not None:
        from psk_soft_tpu.models.mixed import MixedParams, make_mixed_demod_fn
        mixed_params = MixedParams.make(*mixed)
        warm_fn = make_mixed_demod_fn(cfg)
        st_ff, _ = warm_fn(mixed_params, st_ff, jnp.asarray(x_np))
    else:
        warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
        st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    raw = None
    if raw_tail:
        keep = (cfg.num_avg - 1) * cfg.sps + max(cfg.mf_ntaps - 1, 0)
        raw = x_np[:, x_np.shape[1] - keep:]
    state = full_from_ff(cfg, st_ff, raw_win=raw, mixed_params=mixed_params)
    in_scale = 1.0
    if getattr(args, "ingest", "f32") == "i16":
        # SDR wire format: int16 I/Q planes + scale, dequantized on the
        # device -- half the f32 path's input bytes.
        from psk_soft_tpu.models.full import quantize_full_state
        in_scale = float(max(np.abs(x_np.real).max(),
                             np.abs(x_np.imag).max())) / 32000.0
        state = quantize_full_state(state, in_scale)
        x_re = jnp.asarray(np.ascontiguousarray(
            np.round(x_np.real.T / in_scale).astype(np.int16)))
        x_im = jnp.asarray(np.ascontiguousarray(
            np.round(x_np.imag.T / in_scale).astype(np.int16)))
    else:
        x_re = jnp.asarray(np.ascontiguousarray(x_np.real.T))
        x_im = jnp.asarray(np.ascontiguousarray(x_np.imag.T))

    soft_scale = 100.0 if getattr(args, "soft", "f32") == "i8" else None
    debug_ports = not getattr(args, "no_debug_ports", False)
    step = functools.partial(demod_block_full, cfg,
                             mixed=mixed is not None, in_scale=in_scale,
                             soft_i8_scale=soft_scale,
                             debug_ports=debug_ports)

    def chksum(out):
        s = jnp.sum(out.soft_re.astype(jnp.float32)) + jnp.sum(out.bits_packed)
        if out.phase is not None:       # debug planes compiled away otherwise
            s = s + jnp.sum(out.phase) + jnp.sum(out.sample_index)
        return s

    # Rolling-window mode when the config supports it: the step slices its
    # timing window from the previous block's planes (here the repeated
    # bench block -- numerically identical to the window-carry path, which
    # also sees the same block every iteration), exactly as on the
    # production engine's steady path (FullKernelBatchEngine._steady_step).
    if cfg.matched_filter == "none":
        from psk_soft_tpu.models.full import demod_block_full_rolling
        roll_step = functools.partial(demod_block_full_rolling, cfg,
                                      mixed=mixed is not None,
                                      in_scale=in_scale,
                                      soft_i8_scale=soft_scale,
                                      debug_ports=debug_ports)

        @functools.partial(jax.jit, static_argnames=("k",))
        def run_k_roll(planes, x_re, x_im, k):
            def body(p, _):
                p2, out = roll_step(p, x_re, x_im, x_re, x_im)
                return p2, chksum(out)
            p, chks = jax.lax.scan(body, planes, None, length=k)
            return p, jnp.sum(chks)

        return _time_run_k(args, run_k_roll, state.planes, x_re, x_im, C, T)

    @functools.partial(jax.jit, static_argnames=("k",))
    def run_k(state, x_re, x_im, k):
        def body(st, _):
            st2, out = step(st, x_re, x_im)
            return st2, chksum(out)
        st, chks = jax.lax.scan(body, state, None, length=k)
        return st, jnp.sum(chks)

    return _time_run_k(args, run_k, state, x_re, x_im, C, T)


def _time_run_k(args, run_k, carry, x_re, x_im, C, T):
    """Shared warm-then-min-of-reps timing loop (fetch-forced): every
    measured pipeline variant uses THIS methodology so numbers stay
    comparable."""
    carry, _ = run_k(carry, x_re, x_im, args.warmup or 1)
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        carry, chk = run_k(carry, x_re, x_im, args.iters)
        float(chk)  # host fetch: forces true completion of all work
        best = min(best, time.perf_counter() - t0)
    return C * T * args.iters / best


def run_chain(args):
    """One-number receive-chain benchmark: capture -> steady demod ->
    SEAM-CARRYING device frame sync -> Viterbi -> CRC, composed as ONE
    jitted program per block (no host round trips inside the chain),
    info-bits/s with the standard fetch-forced timing.

    The measured path is the seam chain (models/chain.py seam mode) on an
    UNALIGNED cadence -- frames are planted wherever the cadence lands
    them, including straddling the block seam -- and the warm-up asserts
    every planted frame is decoded exactly once per period (exact
    position, exact bits, CRC green) before anything is timed.
    """
    import jax
    import jax.numpy as jnp
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
    from psk_soft_tpu.models.full import demod_block_full, full_from_ff
    from psk_soft_tpu.models.chain import make_seam_tail_fn, seam_tail_init
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.fec import CODE_K7
    from psk_soft_tpu.ops.framesync import FrameFormat
    from psk_soft_tpu.testing.signals import plant_unaligned_frames

    C, sps, S = args.channels, args.sps, args.symbols
    cfg = DemodConfig(sps=sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, args.uw_len)),
                      payload=args.payload, m=4, threshold=0.7)
    a1 = cfg.num_avg - 1
    starts, k_frames, infos, x_np, n_info, n_msg = \
        plant_unaligned_frames(C, S, sps, fmt, code, crc, rng)
    rows = [(p + a1) % S for p in starts]       # detection rows (mod S)

    # Converge the tracker, hand off to the steady step (run_full recipe).
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    state = full_from_ff(cfg, st_ff)
    in_scale = 1.0
    if getattr(args, "ingest", "f32") == "i16":
        # SDR wire format, as in run_full: int16 I/Q planes dequantized on
        # the device -- halves the demod's input bytes.
        from psk_soft_tpu.models.full import quantize_full_state
        in_scale = float(max(np.abs(x_np.real).max(),
                             np.abs(x_np.imag).max())) / 32000.0
        state = quantize_full_state(state, in_scale)
        x_re = jnp.asarray(np.ascontiguousarray(
            np.round(x_np.real.T / in_scale).astype(np.int16)))
        x_im = jnp.asarray(np.ascontiguousarray(
            np.round(x_np.imag.T / in_scale).astype(np.int16)))
    else:
        x_re = jnp.asarray(np.ascontiguousarray(x_np.real.T))
        x_im = jnp.asarray(np.ascontiguousarray(x_np.imag.T))

    step = functools.partial(demod_block_full, cfg, debug_ports=False,
                             in_scale=in_scale)
    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling="gray")
    tail0 = seam_tail_init(fmt, C)

    def chain_body(carry, x_re, x_im):
        st, tail = carry
        st2, fo = step(st, x_re, x_im)
        tail2, out = tail_step(tail, fo.soft_re, fo.soft_im)
        return (st2, tail2), (out.msg, out.found, out.pos, out.ok,
                              out.count)

    def check_steady(msg, found, pos, ok, count):
        """Steady-state gate: exactly the k planted frames per period,
        each at its planted row (mod S), exact bits, CRC green."""
        msg, found, pos, ok, count = map(np.asarray,
                                         (msg, found, pos, ok, count))
        assert found.all(), f"missed {(~found).sum()} frames"
        assert (count == k_frames).all(), "unexpected extra peaks"
        assert ok.all(), f"{(~ok).sum()} CRC failures"
        pos_mod = np.mod(pos, S)
        # Commits come earliest-first; map each to its planted frame.
        order = {r: j for j, r in enumerate(rows)}
        for slot in range(k_frames):
            r = pos_mod[:, slot]
            assert (r == r[0]).all(), "channels disagree on positions"
            j = order.get(int(r[0]))
            assert j is not None, f"commit at unplanted row {int(r[0])}"
            assert (msg[:, slot] == infos[:, j]).all(), "info bits wrong"

    # Warm-up + correctness gate on the steady block, BEFORE timing.
    chain_jit = jax.jit(chain_body)
    carry = (state, tail0)
    carry, outs = chain_jit(carry, x_re, x_im)
    carry, outs = chain_jit(carry, x_re, x_im)
    carry, outs = chain_jit(carry, x_re, x_im)       # steady period
    check_steady(*outs)

    # Steady-state rolling-window mode (same as run_full / the production
    # engine's _steady_step): the window is sliced from the previous
    # block's planes.  Gated with the full frame/CRC/info asserts before
    # replacing the timed body.
    from psk_soft_tpu.models.full import demod_block_full_rolling
    roll_step = functools.partial(demod_block_full_rolling, cfg,
                                  debug_ports=False, in_scale=in_scale)

    def body(carry, x_re, x_im):
        planes, tail = carry
        p2, fo = roll_step(planes, x_re, x_im, x_re, x_im)
        tail2, out = tail_step(tail, fo.soft_re, fo.soft_im)
        return (p2, tail2), (out.msg, out.found, out.pos, out.ok,
                             out.count)

    st, tail = carry
    carry, outs = jax.jit(body)((st.planes, tail), x_re, x_im)
    check_steady(*outs)

    @functools.partial(jax.jit, static_argnames=("k",))
    def run_k(st, x_re, x_im, k):
        def sbody(s, _):
            s2, (m, f, p, o, n) = body(s, x_re, x_im)
            return s2, (m.astype(jnp.int32).sum() + f.sum() + o.sum()
                        + n.sum())
        st, chks = jax.lax.scan(sbody, st, None, length=k)
        return st, jnp.sum(chks)

    carry, _ = run_k(carry, x_re, x_im, args.warmup or 1)
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        carry, chk = run_k(carry, x_re, x_im, args.iters)
        float(chk)   # fetch forces completion of the whole chain
        best = min(best, time.perf_counter() - t0)
    info_rate = C * k_frames * n_info * args.iters / best
    tag = " i16-ingest" if getattr(args, "ingest", "f32") == "i16" else ""
    return emit(f"{C}-channel receive-chain throughput (demod+seam "
                f"sync+Viterbi+CRC one-program{tag}, {k_frames} frames/"
                f"block/ch unaligned cadence)", info_rate, "infobits/s")


def run_mesh(args):
    """Scaling-efficiency reports (eval/scaling.py), one JSON line each."""
    import jax
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.eval.scaling import (chain_scaling_report,
                                           channel_scaling_report,
                                           time_shard_report)

    if args.profile == "config3":
        cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=8,
                          phase_avg=50, matched_filter="rrc", rrc_beta=0.35,
                          rrc_span=8, timing_interp=True)
    else:
        cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=4,
                          phase_avg=50)
    from psk_soft_tpu.utils.device_env import device_tags

    tags = device_tags()
    rep = channel_scaling_report(
        cfg, channels_per_device=min(args.channels, 256),
        symbols=min(args.symbols, 256), iters=max(2, args.iters // 50),
        reps=args.reps, pipeline="full")
    print(json.dumps({**rep, **tags}))
    if args.profile == "chain":
        rep_c = chain_scaling_report(
            cfg, channels_per_device=128, symbols=512,
            iters=max(2, args.iters // 100), reps=args.reps)
        print(json.dumps({**rep_c, **tags}))
    if len(jax.devices()) > 1:
        rep_t = time_shard_report(
            cfg, channels=128, total_symbols=4096,
            iters=max(2, args.iters // 100), reps=args.reps)
        print(json.dumps({**rep_t, **tags}))
    return 0


def run_profile(args):
    """Non-default BASELINE configs on the steady step."""
    from psk_soft_tpu import DemodConfig

    C = args.channels
    if args.profile == "config3":
        cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=8,
                          phase_avg=50, matched_filter="rrc", rrc_beta=0.35,
                          rrc_span=8, timing_interp=True)
        rng = np.random.default_rng(0)
        sym = rng.integers(0, 8, size=(C, args.symbols))
        pts = np.exp(1j * (2 * np.pi * sym / 8 + 2 * np.pi * 1e-4
                           * np.arange(args.symbols)))
        up = np.zeros((C, args.symbols * args.sps), np.complex64)
        up[:, :: args.sps] = pts
        from psk_soft_tpu.ops.matched_filter import rrc_taps
        taps = rrc_taps(args.sps, 0.35, 8)
        x_np = np.stack([np.convolve(u, taps, mode="same") for u in up])
        x_np = x_np.astype(np.complex64)
        x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
        rate = run_full(args, cfg, C, x_np.shape[1], x_np,
                        raw_tail=True)
        return emit(f"{C}-channel config3 8PSK+RRC+interp steady demod "
                    f"throughput", rate, "samples/s")
    # mixed: per-channel constellations/diff on the carry's mode planes
    cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    rng = np.random.default_rng(0)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = []
    for i in range(C):
        r = np.random.default_rng(i)
        m = int(ms[i])
        j = r.integers(0, m, args.symbols)
        pts = np.exp(2j * np.pi * j / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.repeat(pts * np.exp(2j * np.pi * 1e-4
                                   * np.arange(args.symbols)),
                      args.sps).astype(np.complex64)
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    x_np = np.stack(xs)
    rate = run_full(args, cfg, C, x_np.shape[1], x_np, mixed=(ms, diffs))
    return emit(f"{C}-channel mixed-mode steady demod throughput", rate,
                "samples/s")


def run_engine(args):
    """End-to-end PRODUCTION-path throughput: native bank deframe ->
    engine device step -> four-port packet assembly (device->host fetch of
    every output block), at pipeline depths 0 and `--engine-depth`.

    Unlike the device-only benches, this includes all host-side work a
    deployed service does per block; every block's outputs are fetched, so
    deferred execution cannot inflate the number.
    """
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.runtime.engine import FullKernelBatchEngine
    from psk_soft_tpu.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu.runtime.streams import SRI

    cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    C, S = args.channels, args.symbols
    need = S * cfg.sps

    # One block of sample-interleaved frames, pushed repeatedly (the
    # deframe cost per block is identical for any content).
    rng = np.random.default_rng(0)
    pts = np.exp(1j * (2 * np.pi * rng.integers(0, 4, (C, S)) / 4
                       + 2 * np.pi * 1e-4 * np.arange(S)))
    blk = np.repeat(pts, cfg.sps, axis=1).astype(np.complex64)
    blk += (0.01 * rng.standard_normal(blk.shape)).astype(np.complex64)
    frames32 = np.ascontiguousarray(blk.T).view(np.float32).ravel()
    scale = float(np.abs(frames32).max()) / 32000.0
    frames16 = np.round(frames32 / scale).astype(np.int16)

    nblocks = max(10, min(50, args.iters // 10))
    sri = SRI(stream_id="bench", xdelta=1e-6)
    for depth in sorted({0, max(0, args.engine_depth)}):
        i16 = args.ingest == "i16"
        if args.profile == "mixed":
            # Heterogeneous bank through the production mixed engine
            # (BASELINE config 4): one steady program per block.
            from psk_soft_tpu.models.mixed import MixedParams
            from psk_soft_tpu.runtime.engine import MixedKernelBatchEngine
            ms = rng.choice([2, 4, 8], C)
            eng = MixedKernelBatchEngine(
                MixedParams.make(ms, rng.random(C) < 0.5), cfg, C,
                block_symbols=S, pipeline_depth=depth,
                ingest_scale=scale if i16 else None,
                soft_i8=args.soft == "i8")
            label = "mixed-bank engine"
            if i16:
                label += " i16-ingest"
            if args.soft == "i8":
                label += " soft-i8"
            bank = NativePlaneBank(C, capacity_samples=4 * need,
                                   dtype="i16" if i16 else "f32")
            frames = frames16 if i16 else frames32

            def feed_one():
                bank.push_interleaved(frames)
                re, im, _ = bank.pop_planes(need, timeout=0)
                eng.push_planes(re, im)
                return eng.step_packets()
        else:
            # Production path: native plane bank deframes interleaved
            # frames straight to the steady step's (T, C) layout -- no host
            # transposes; i16 additionally halves wire + upload bytes.
            eng = FullKernelBatchEngine(
                cfg, C, block_symbols=S, pipeline_depth=depth,
                ingest_scale=scale if i16 else None,
                soft_i8=args.soft == "i8")
            label = ("full engine i16-ingest" if i16 else "full engine")
            if args.soft == "i8":
                label += " soft-i8"
            bank = NativePlaneBank(C, capacity_samples=4 * need,
                                   dtype="i16" if i16 else "f32")
            frames = frames16 if i16 else frames32

            def feed_one():
                bank.push_interleaved(frames)
                re, im, _ = bank.pop_planes(need, timeout=0)
                eng.push_planes(re, im)
                return eng.step_packets()
        eng.set_input_sri(sri)

        # Warm-up: compile both stages and reach the steady step.
        for _ in range(max(3, (cfg.num_avg + cfg.phase_avg) // S + 2)):
            feed_one()
        emitted = 0
        t0 = time.perf_counter()
        fed = 0
        while emitted < nblocks:
            p = feed_one()
            fed += 1
            if p:
                emitted += 1
            if fed > 4 * nblocks:
                raise RuntimeError("engine starved")
        dt = time.perf_counter() - t0
        emit(f"{C}-channel QPSK end-to-end {label} throughput "
             f"(pipeline_depth={depth})", emitted * C * need / dt,
             "samples/s")
    return 0


def run_receiver(args):
    """End-to-end PRODUCTION STREAMING RECEIVER benchmark (VERDICT r4
    item 2): native plane deframe -> FullKernelBatchEngine (device-tap) ->
    FrameSyncer -> FecFrameDecoder -> FrameCrcChecker -> pop_frames.

    This is the deployed service path -- the analog of the reference's
    complete serviceFunction + ports loop
    (/root/reference/cpp/psk_soft.cpp:346-618) -- with ALL host work a
    deployed receiver does per block: wire-format deframe, packet
    assembly, sparse sync candidate fetches, Viterbi drain, CRC strip,
    and per-frame Python object assembly.  Every popped frame is
    validated (CRC green + exact planted info bits).  Emits infobits/s.
    """
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.ops.crc import CRC16_CCITT
    from psk_soft_tpu.ops.fec import CODE_K7
    from psk_soft_tpu.ops.framesync import FrameFormat
    from psk_soft_tpu.runtime.receiver import build_receiver
    from psk_soft_tpu.runtime.streams import SRI
    from psk_soft_tpu.testing.signals import plant_unaligned_frames

    C, sps, S = args.channels, args.sps, args.symbols
    cfg = DemodConfig(sps=sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, args.uw_len)),
                      payload=args.payload, m=4, threshold=0.7)
    # Same content scheme as run_chain (shared helper): unaligned
    # cadence, wraparound plants -- seam-straddling frames are the
    # streaming FrameSyncer's home turf.
    starts, k_frames, infos, x_np, n_info, n_msg = \
        plant_unaligned_frames(C, S, sps, fmt, code, crc, rng)
    # Planted info bits by detection offset (start mod S): the engine's
    # packet stream is aligned to input symbol indices (warm-up rows are
    # valid-masked, not dropped from the index space), so a frame at
    # input position p + iter*S syncs at start % S == p.
    by_off = {p % S: j for j, p in enumerate(starts)}

    need = S * sps
    frames32 = np.ascontiguousarray(x_np.T).view(np.float32).ravel()

    if getattr(args, "fused_receiver", False):
        # One-launch ChainEngine behind the receiver surface: per block
        # only the decoded-frame table crosses to the host (the
        # per-stage stack fetches planes/candidates/payload rows).
        rx = build_receiver(cfg, C, engine="chain", block_symbols=S, uw=fmt.uw,
                 frame_payload=fmt.payload, uw_threshold=0.7, fec=code,
                 fec_labeling="gray", crc=crc,
                 engine_kwargs={"pipeline_depth": 1})
        pre = np.ascontiguousarray(x_np.real.T)
        pim = np.ascontiguousarray(x_np.imag.T)

        def feed_fused():
            # Native plane ingest + depth-1 deferred commit: the
            # device step overlaps the next block's staging/upload.
            rx.engine.push_planes(pre, pim)
            got = rx.engine.step() or []
            rx.engine.pop_frames()
            return got

        def validate_fused(frames):
            for f in frames:
                j = by_off.get(f.start % S)
                assert j is not None, f"unplanted offset {f.start % S}"
                assert f.crc_ok
                assert np.array_equal(f.info_bits,
                                      infos[f.channel, j][:rx.engine.n_msg])

        warm_blocks = max(4, (cfg.num_avg + cfg.phase_avg) // S + 3)
        for _ in range(warm_blocks):
            validate_fused(feed_fused())
        nblocks = max(10, min(50, args.iters // 10))
        n_frames = 0
        t0 = time.perf_counter()
        for _ in range(nblocks):
            got = feed_fused()
            validate_fused(got)
            n_frames += len(got)
        dt = time.perf_counter() - t0
        assert n_frames >= (nblocks - 2) * k_frames * C, \
            f"fused receiver starved: {n_frames}"
        return emit(f"{C}-channel FUSED receiver throughput (ChainEngine: "
                    f"one-launch demod+sync+Viterbi+CRC, frame-table-only "
                    f"fetch, {k_frames} frames/block/ch)",
                    n_frames * n_info / dt, "infobits/s")
    ekw = {"pipeline_depth": max(0, args.engine_depth)}
    if getattr(args, "frames_only", False):
        # Frames-only consumer: soft/bits ports unconnected, so packet
        # assembly fetches no planes (the reference's connected-port
        # guard, cpp/psk_soft.cpp:605-615); frames flow via the device
        # tap.  Drops the ~6 MB/block output fetch.
        ekw["data_ports"] = False
    rx = build_receiver(cfg, C, engine="full",
                        block_symbols=S, uw=fmt.uw,
                        frame_payload=fmt.payload, uw_threshold=0.7,
                        fec=code, fec_labeling="gray", crc=crc,
                        engine_kwargs=ekw)
    rx.engine.set_input_sri(SRI(stream_id="bench", xdelta=1e-6))
    from psk_soft_tpu.runtime.native_bank import NativePlaneBank
    bank = NativePlaneBank(C, capacity_samples=4 * need)

    def feed_one():
        bank.push_interleaved(frames32)
        re, im, _ = bank.pop_planes(need, timeout=0)
        rx.engine.push_planes(re, im)
        rx.engine.step_packets()
        return rx.pop_frames()

    def validate(frames):
        for f in frames:
            j = by_off.get(f.start % S)
            assert j is not None, f"frame at unplanted offset {f.start % S}"
            assert f.crc_ok, f"CRC failed at ch{f.channel} start {f.start}"
            assert np.array_equal(f.info_bits[:n_msg],
                                  infos[f.channel, j]), "info bits wrong"

    # Warm-up: compile, converge, and reach frame steady state.
    warm_blocks = max(4, (cfg.num_avg + cfg.phase_avg) // S + 3)
    for _ in range(warm_blocks):
        validate(feed_one())
    nblocks = max(10, min(50, args.iters // 10))
    n_frames = 0
    t0 = time.perf_counter()
    for _ in range(nblocks):
        got = feed_one()
        validate(got)
        n_frames += len(got)
    dt = time.perf_counter() - t0
    assert n_frames >= (nblocks - 2) * k_frames * C, \
        f"receiver starved: {n_frames} frames in {nblocks} blocks"
    only = " frames-only" if getattr(args, "frames_only", False) else ""
    return emit(f"{C}-channel production streaming receiver throughput "
                f"(deframe->engine->FrameSyncer->Viterbi->CRC->pop_frames"
                f"{only}, {k_frames} frames/block/ch, depth="
                f"{max(0, args.engine_depth)})", n_frames * n_info / dt,
                "infobits/s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=512, help="symbols per block")
    ap.add_argument("--sps", type=int, default=8)
    ap.add_argument("--payload", type=int, default=64,
                    help="chain profile: payload symbols per frame")
    ap.add_argument("--uw-len", type=int, default=32,
                    help="chain profile: unique-word length in symbols")
    ap.add_argument("--iters", type=int, default=500,
                    help="block steps per timed dispatch")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5,
                    help="timing repetitions; best rep is reported")
    ap.add_argument("--pipeline", choices=["full", "ff"], default="full",
                    help="full = the steady-state step (the engines' hot "
                         "path); ff = the feed-forward warm-up pipeline")
    ap.add_argument("--no-debug-ports", action="store_true",
                    help="omit the phase/sampleIndex output planes "
                         "(unconnected-debug-port production profile); "
                         "full pipeline only")
    ap.add_argument("--soft", choices=["f32", "i8"], default="f32",
                    help="i8 = int8-quantized soft-decision planes "
                         "(round(s*100), the SDR soft-bit wire format): the "
                         "dominant output plane at 2 instead of 8 bytes/"
                         "symbol/channel; full pipeline and --engine")
    ap.add_argument("--ingest", choices=["f32", "i16"], default="f32",
                    help="i16 = int16 I/Q wire-format planes dequantized on "
                         "the device (half the f32 input bytes); full "
                         "pipeline")
    ap.add_argument("--profile",
                    choices=["default", "config3", "mixed", "chain"],
                    default="default",
                    help="config3 = 8-PSK + RRC + fractional timing "
                         "(BASELINE config 3) on the steady step; mixed = "
                         "per-channel modes (BASELINE config 4); chain = "
                         "capture->demod->frame sync->Viterbi->CRC as one "
                         "device program, reported in info-bits/s")
    ap.add_argument("--engine", action="store_true",
                    help="end-to-end production-path bench (native deframe "
                         "-> engine step -> packet assembly), at "
                         "pipeline_depth 0 and --engine-depth")
    ap.add_argument("--engine-depth", type=int, default=1,
                    help="pipeline depth compared against 0 in --engine")
    ap.add_argument("--receiver-fused", dest="fused_receiver",
                    action="store_true",
                    help="--receiver through the one-launch ChainEngine "
                         "(runtime/chain_engine.py): only the decoded "
                         "frame table crosses to the host per block")
    ap.add_argument("--receiver-frames-only", dest="frames_only",
                    action="store_true",
                    help="--receiver with soft/bits ports unconnected "
                         "(frames-only consumer; no plane fetch per "
                         "block, the reference's connected-port guard)")
    ap.add_argument("--receiver", action="store_true",
                    help="production STREAMING receiver bench (native "
                         "deframe -> engine -> FrameSyncer -> Viterbi -> "
                         "CRC -> pop_frames), every frame validated, "
                         "reported in info-bits/s; at --engine-depth")
    ap.add_argument("--mesh", action="store_true",
                    help="scaling-efficiency report over the device mesh "
                         "(eval/scaling.py): one JSON line per report")
    args = ap.parse_args()

    from psk_soft_tpu.utils.device_env import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    if args.receiver:
        return run_receiver(args)
    if args.engine:
        return run_engine(args)
    if args.mesh:
        return run_mesh(args)
    if args.profile == "chain":
        return run_chain(args)
    if args.profile != "default":
        return run_profile(args)

    from psk_soft_tpu import DemodConfig

    cfg = DemodConfig(sps=args.sps, num_avg=100, constellation_size=4,
                      phase_avg=50)
    C, T = args.channels, args.symbols * args.sps
    x_np = _qpsk_block(C, args.symbols, args.sps)
    if args.pipeline == "ff":
        return emit(f"{C}-channel QPSK streaming demod throughput (ff)",
                    run_ff(args, cfg, C, T, x_np), "samples/s")
    label = "steady" + (" i16-ingest" if args.ingest == "i16" else "") \
        + (" soft-i8" if args.soft == "i8" else "") \
        + (" no-debug-ports" if args.no_debug_ports else "")
    emit(f"{C}-channel QPSK streaming demod throughput ({label})",
         run_full(args, cfg, C, T, x_np), "samples/s")
    # The default run also emits the receive-chain line, so every run
    # regression-tests the chain as well.
    ch = copy.copy(args)
    ch.iters = max(20, args.iters // 2)
    return run_chain(ch)


if __name__ == "__main__":
    sys.exit(main())
