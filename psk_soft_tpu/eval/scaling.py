"""Scaling-efficiency harness: the BASELINE.md ">=85% efficiency 1 device
-> N devices" axis, runnable on the virtual CPU mesh and unchanged on a
real multi-device host.

Two reports:

* :func:`channel_scaling_report` -- weak scaling over the communication-free
  ``chan`` axis (constant channels per device).  Efficiency_n = t_1 / t_n:
  with zero communication the ideal is 1.0, so any drop is runtime/dispatch
  overhead, not algorithm.
* :func:`time_shard_report` -- the time-sharded steady-state path
  (parallel/sharded_full.make_time_sharded_full_demod): seam overhead (halo
  ppermute + all_gather origin combine) as a function of the per-shard block
  size.  Efficiency_n = t_1(same total work) / (t_n) for fixed total
  symbols (strong scaling over time).

Timing discipline: every timed region ends in a host fetch of a checksum
that data-depends on every output, so asynchronous dispatch cannot inflate
the numbers.  Reports carry per-point step seconds so run-to-run variance
is visible rather than averaged away.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DemodConfig


def _timed_best(run, reps: int) -> float:
    """Best wall time of `run()` (which must end in a host fetch)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def _gen_bank(C: int, S: int, sps: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    sym = rng.integers(0, m, size=(C, S))
    pts = np.exp(1j * (2 * np.pi * sym / m
                       + 2 * np.pi * 1e-4 * np.arange(S)))
    x = np.repeat(pts, sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def channel_scaling_report(cfg: DemodConfig, *, device_counts=None,
                           channels_per_device: int = 256,
                           symbols: int = 256, iters: int = 10,
                           reps: int = 3, pipeline: str = "ff") -> dict:
    """Weak-scaling report over the chan axis (see module docstring).

    pipeline: "ff" (the feed-forward warm-up pipeline) or "full" (the
    time-major steady step, models/full.py).
    """
    from ..models.blockpsk import demod_block_ff, ff_init

    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    sps = cfg.sps
    T = symbols * sps
    points = []
    for n in device_counts:
        C = channels_per_device * n
        mesh = Mesh(np.asarray(devices[:n]), ("chan",))
        x_np = _gen_bank(C, symbols, sps, cfg.constellation_size)
        if pipeline == "full":
            from ..models.blockpsk import make_ff_demod_fn
            from ..models.full import full_from_ff
            from ..parallel.sharded_full import (make_sharded_full_demod,
                                                 shard_full_state)
            warm = make_ff_demod_fn(cfg, channels=C)
            st_ff, _ = warm(ff_init(cfg, (C,)), jnp.asarray(x_np))
            keep = (cfg.num_avg - 1) * sps + max(cfg.mf_ntaps - 1, 0)
            raw = (x_np[:, x_np.shape[1] - keep:]
                   if cfg.matched_filter != "none" else None)
            state = shard_full_state(
                full_from_ff(cfg, st_ff, raw_win=raw), mesh)
            fn = make_sharded_full_demod(cfg, mesh)
            sh = NamedSharding(mesh, P(None, "chan"))
            x_re = jax.device_put(
                jnp.asarray(np.ascontiguousarray(x_np.real.T)), sh)
            x_im = jax.device_put(
                jnp.asarray(np.ascontiguousarray(x_np.imag.T)), sh)

            @functools.partial(jax.jit, static_argnames=("k",))
            def run_k(state, x_re, x_im, k):
                def body(st, _):
                    st2, out = fn(st, x_re, x_im)
                    return st2, jnp.sum(out.phase) + jnp.sum(out.soft_re)
                st, chks = jax.lax.scan(body, state, None, length=k)
                return st, jnp.sum(chks)

            state, _ = run_k(state, x_re, x_im, 1)  # compile + warm

            def run():
                nonlocal state
                state, chk = run_k(state, x_re, x_im, iters)
                float(chk)
        else:
            sh_state = NamedSharding(mesh, P("chan"))
            state = jax.device_put(ff_init(cfg, (C,)), sh_state)
            x = jax.device_put(jnp.asarray(x_np),
                               NamedSharding(mesh, P("chan", None)))
            step = jax.vmap(functools.partial(demod_block_ff, cfg))

            @functools.partial(jax.jit, static_argnames=("k",))
            def run_k(state, x, k):
                def body(st, _):
                    st2, out = step(st, x)
                    return st2, jnp.sum(out.phase) + jnp.sum(out.soft.real)
                st, chks = jax.lax.scan(body, state, None, length=k)
                return st, jnp.sum(chks)

            state, _ = run_k(state, x, 1)  # compile + warm

            def run():
                nonlocal state
                state, chk = run_k(state, x, iters)
                float(chk)

        t = _timed_best(run, reps) / iters
        points.append({"devices": n, "channels": C, "step_s": t,
                       "throughput_sps": C * T / t})
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / p["step_s"]
    return {"mode": "channel-weak", "pipeline": pipeline,
            "symbols_per_block": symbols, "sps": sps,
            "channels_per_device": channels_per_device, "points": points}


def chain_scaling_report(cfg: DemodConfig, *, device_counts=None,
                         channels_per_device: int = 128,
                         symbols: int = 512, iters: int = 5,
                         reps: int = 3) -> dict:
    """Weak-scaling report for the FULL receive chain per shard: steady
    demod -> fixed-capacity device frame sync -> Viterbi (K=7 rate 1/2)
    -> CRC16, composed INSIDE the shard_map body so the
    chan axis stays communication-free end-to-end (every post-demod stage
    is per-channel independent).  The bench's ``--profile chain`` is the
    single-device twin of this body (bench.py run_chain); here the same
    work scales over the mesh.
    """
    from ..models.blockpsk import make_ff_demod_fn, ff_init
    from ..models.full import FullState, demod_block_full, full_from_ff
    from ..ops.crc import CRC16_CCITT
    from ..ops.fec import CODE_K7, info_bits_for
    from ..ops.framesync import FrameFormat
    from ..ops import tx

    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    sps, m = cfg.sps, cfg.constellation_size
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, m, 32)), payload=64, m=m,
                      threshold=0.7)
    nb = int(np.log2(m))
    n_info = info_bits_for(code, fmt.payload * nb)
    n_msg = n_info - crc.degree
    a1 = cfg.num_avg - 1
    cadence = 128
    starts, p = [], (-a1) % cadence
    while p + a1 + fmt.frame_len <= symbols:
        starts.append(p)
        p += cadence
    k_frames = len(starts)
    if not k_frames:
        raise ValueError("symbols too small for one frame per block")
    # One frame pattern tiled across channels (identical chain work per
    # channel; per-channel noise below keeps the signal non-degenerate).
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(fmt, infos, starts, symbols, code=code,
                              crc=crc, labeling="gray", seed=7)

    from ..models.chain import make_seam_tail_fn

    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling="gray")

    def body(state, tail, x_re, x_im):
        # The public one-launch SEAM composition (models/chain.py) inside
        # the shard_map body -- the bench's --profile chain is its
        # single-device twin (r5: the production streaming contract, not
        # the containment mode).
        st2, fo = demod_block_full(cfg, state, x_re, x_im,
                                   debug_ports=False)
        tail2, out = tail_step(tail, fo.soft_re, fo.soft_im)
        chk = (out.msg.astype(jnp.int32).sum() + out.found.sum()
               + out.ok.sum() + out.pos.sum() + out.count.sum())
        return st2, tail2, chk.astype(jnp.float32)[None]  # (1,) per shard

    points = []
    for n in device_counts:
        C = channels_per_device * n
        mesh = Mesh(np.asarray(devices[:n]), ("chan",))
        x_np = np.repeat(np.exp(1j * (2 * np.pi
                                      * np.tile(idx_row, (C, 1)) / m
                                      + 0.4)), sps, axis=1)
        x_np = (x_np + 0.01 * (np.random.default_rng(n).standard_normal(
            x_np.shape))).astype(np.complex64)
        warm = make_ff_demod_fn(cfg, channels=C)
        st_ff, _ = warm(ff_init(cfg, (C,)), jnp.asarray(x_np))
        state = full_from_ff(cfg, st_ff)
        from ..models.chain import SeamTailState, seam_tail_init
        tail = seam_tail_init(fmt, C)
        spec = P(None, "chan")
        state_specs = FullState(win_re=spec, win_im=spec, planes=spec)
        tail_specs = SeamTailState(tail_re=spec, tail_im=spec)
        sharded = jax.shard_map(
            body, mesh=mesh, in_specs=(state_specs, tail_specs, spec,
                                       spec),
            out_specs=(state_specs, tail_specs, P("chan")),
            check_vma=False)
        sh = NamedSharding(mesh, spec)
        state = jax.tree.map(lambda v: jax.device_put(v, sh), state)
        tail = jax.tree.map(lambda v: jax.device_put(v, sh), tail)
        x_re = jax.device_put(jnp.asarray(
            np.ascontiguousarray(x_np.real.T)), sh)
        x_im = jax.device_put(jnp.asarray(
            np.ascontiguousarray(x_np.imag.T)), sh)

        @functools.partial(jax.jit, static_argnames=("k",))
        def run_k(carry, x_re, x_im, k):
            def step(c, _):
                st2, t2, chk = sharded(c[0], c[1], x_re, x_im)
                return (st2, t2), jnp.sum(chk)
            c, chks = jax.lax.scan(step, carry, None, length=k)
            return c, jnp.sum(chks)

        state, _ = run_k((state, tail), x_re, x_im, 1)   # compile + warm

        def run():
            nonlocal state
            state, chk = run_k(state, x_re, x_im, iters)
            float(chk)

        t = _timed_best(run, reps) / iters
        points.append({
            "devices": n, "channels": C, "step_s": t,
            "throughput_sps": C * symbols * sps / t,
            "infobits_per_s": C * k_frames * n_info / t,
        })
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / p["step_s"]
    return {"mode": "chain-weak (seam)", "symbols_per_block": symbols, "sps": sps,
            "channels_per_device": channels_per_device,
            "frames_per_block_per_channel": k_frames,
            "code": "K7 rate 1/2 + CRC16", "points": points}


def time_shard_report(cfg: DemodConfig, *, time_counts=None,
                      channels: int = 128, total_symbols: int = 4096,
                      iters: int = 5, reps: int = 3) -> dict:
    """Strong-scaling report over the time axis: fixed total symbols split
    across n time shards (chan axis size 1).  Shows the seam overhead (halo
    recompute grows as shards shrink) directly."""
    from ..parallel.sharded_full import make_time_sharded_full_demod

    devices = jax.devices()
    if time_counts is None:
        time_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    sps = cfg.sps
    x_np = _gen_bank(channels, total_symbols, sps, cfg.constellation_size)
    x_re_np = np.ascontiguousarray(x_np.real.T)
    x_im_np = np.ascontiguousarray(x_np.imag.T)
    points = []
    for n in time_counts:
        mesh = Mesh(np.asarray(devices[:n]).reshape(1, n), ("chan", "time"))
        fn = make_time_sharded_full_demod(cfg, mesh, total_symbols)
        sh = NamedSharding(mesh, P("time", "chan"))
        x_re = jax.device_put(jnp.asarray(x_re_np), sh)
        x_im = jax.device_put(jnp.asarray(x_im_np), sh)

        @functools.partial(jax.jit, static_argnames=("k",))
        def run_k(x_re, x_im, k):
            def body(acc, _):
                sr, si_, ph, bits, idx, valid = fn(x_re, x_im)
                return acc + jnp.sum(ph) + jnp.sum(sr), None
            acc, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
            return acc

        float(run_k(x_re, x_im, 1))  # compile + warm

        def run():
            float(run_k(x_re, x_im, iters))

        t = _timed_best(run, reps) / iters
        points.append({
            "time_shards": n,
            "symbols_per_shard": total_symbols // n,
            "step_s": t,
            "throughput_sps": channels * total_symbols * sps / t,
        })
    t1 = points[0]["step_s"]
    for p in points:
        p["efficiency"] = t1 / (p["step_s"] * p["time_shards"])
    return {"mode": "time-strong", "channels": channels,
            "total_symbols": total_symbols, "sps": sps, "points": points}
