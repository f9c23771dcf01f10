"""Multi-device flagship: the steady-state demod step sharded over a mesh.

Two compositions of models/full.py's steady step:

* **Channel sharding** (:func:`make_sharded_full_demod`): communication-free
  (SURVEY.md section 2.5) -- each device runs the step on its channel
  slice with its own carry planes.  Scaling is linear up to ingest
  bandwidth.
* **Time + channel sharding** (:func:`make_time_sharded_full_demod`): one
  stream's time axis is split across devices too (BASELINE.json config 5).
  Each shard runs the step *statelessly* over [left warm-up halo | own |
  right lookahead halo] sample planes (two ``ppermute`` exchanges), discards
  the halo outputs, and the only cross-shard sequential quantity -- the
  absolute phase origin, a per-(shard, channel) multiple of 2pi -- is
  recovered afterwards from overlap outputs by an ``all_gather`` + prefix
  sum, then applied as a constellation-preserving derotation.  The stream's
  very first warm-up region (first shard's discard margin) is masked
  invalid: this path is the steady-streaming performance configuration; use
  parallel/sharded.py for exact head-of-stream warm-up semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DemodConfig
from ..models.full import (FullOutputs, FullState, _static_taps,
                           demod_block_full, demod_full_tm, state_rows)
from ..ops.phase import UNWRAP_TREND_LEN, TWO_PI


def channel_sharding_tm(mesh: Mesh) -> NamedSharding:
    """Time-major planes (T, C): channels on the last axis, sharded."""
    return NamedSharding(mesh, P(None, "chan"))


def shard_full_state(state: FullState, mesh: Mesh) -> FullState:
    sh = channel_sharding_tm(mesh)
    return FullState(
        win_re=jax.device_put(state.win_re, sh),
        win_im=jax.device_put(state.win_im, sh),
        planes=jax.device_put(state.planes, sh),
    )


def make_sharded_full_demod(cfg: DemodConfig, mesh: Mesh, *,
                            in_scale: float = 1.0,
                            soft_i8_scale: float | None = None,
                            debug_ports: bool = True,
                            pack_out: bool | None = None):
    """Returns fn(state, x_re, x_im) -> (state, FullOutputs), with every
    (.., C) plane sharded over the mesh's 'chan' axis (C divisible by the
    axis size).

    The chan axis is communication-free, so every output profile (int8
    soft, packed bits, omitted debug planes) shards through unchanged."""
    body = functools.partial(demod_block_full, cfg, in_scale=in_scale,
                             pack_out=pack_out, soft_i8_scale=soft_i8_scale,
                             debug_ports=debug_ports)
    spec = P(None, "chan")
    state_specs = FullState(win_re=spec, win_im=spec, planes=spec)
    dbg = spec if debug_ports else None   # None prunes with the output leaf
    inner = jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_specs, spec, spec),
        out_specs=(state_specs, FullOutputs(spec, spec, dbg, spec, dbg)),
        check_vma=False,
    )
    return jax.jit(inner)


def _shift_rows(v: jnp.ndarray, from_left: bool) -> jnp.ndarray:
    """ppermute along 'time': receive rows from the left (or right)
    neighbor; edge shards receive zeros."""
    n_sh = jax.lax.psum(1, "time")
    if from_left:
        perm = [(i, i + 1) for i in range(n_sh - 1)]
    else:
        perm = [(i, i - 1) for i in range(1, n_sh)]
    return jax.lax.ppermute(v, "time", perm)


def make_time_sharded_full_demod(cfg: DemodConfig, mesh: Mesh,
                                 total_symbols: int, *,
                                 mixed_params=None, in_scale: float = 1.0,
                                 soft_i8_scale: float | None = None):
    """Time+channel-sharded steady demod (see module docstring).

    Returns fn(x_re, x_im) -> (soft_re, soft_im, phase, bits, idx, valid)
    with (T, C) inputs sharded P('time','chan') and (S, C) outputs likewise.
    The first ``discard`` symbols of the stream and the final numAvg-1
    are masked invalid.  With ``soft_i8_scale`` the soft planes come back
    int8 (quantized after the seam correction -- see the inline note).

    Supports every steady-step profile: matched filter (the streaming FIR's
    filtered timeline lags raw by ``ntaps-1`` samples -- ops/matched_filter
    .streaming_filter overlap-save convention -- so the extra rows extend
    the *left* halo and the FF symbol grid is preserved), fractional
    circular-centroid timing, and per-channel mixed mode.  For mixed mode
    pass ``mixed_params`` (models/mixed.MixedParams with (C,) arrays); the
    static cfg constellation/differential are then ignored, matching
    models/full.make_mixed_full_demod_fn.
    """
    sps, num_avg, m, n = (cfg.sps, cfg.num_avg, cfg.constellation_size,
                          cfg.phase_avg)
    if sps <= 1:
        raise ValueError("time-sharded full demod supports sps > 1 only")
    taps = _static_taps(cfg)
    extra = (len(taps) - 1) if taps else 0
    mixed = mixed_params is not None
    n_time = mesh.shape["time"]
    s_loc = total_symbols // n_time
    if total_symbols % n_time:
        raise ValueError(f"{total_symbols} symbols not divisible by "
                         f"time={n_time}")
    a1 = num_avg - 1
    discard = n + UNWRAP_TREND_LEN + 8        # phase warm-up margin
    rh = a1 * sps                             # window lookahead halo
    # Left halo = warm-up margin + window + the FIR's (ntaps-1) raw tail; a
    # single ppermute only reaches the immediate neighbour, so each shard
    # must own at least the halo it sends.
    lh = (a1 + discard) * sps + extra
    if n_time > 1 and s_loc * sps < max(lh, rh):
        raise ValueError(f"samples per time shard ({s_loc * sps}) must be "
                         f">= {max(lh, rh)}")
    rs = state_rows(n)
    wsplit = a1 * sps + extra                 # steady window-carry rows
    if mixed:
        misc = (n - 1) + 2 * (UNWRAP_TREND_LEN - 1)
        m_arr = jnp.asarray(mixed_params.m, jnp.float32)
        d_arr = jnp.asarray(mixed_params.diff, jnp.float32)

    def body(x_re, x_im, *mode_planes):       # (T_loc, C_loc) each
        c_loc = x_re.shape[1]

        def assemble(v):
            left = _shift_rows(v[v.shape[0] - lh:], from_left=True)
            right = _shift_rows(v[:rh], from_left=False)
            return jnp.concatenate([left, v, right], axis=0)

        ext_re = assemble(x_re)
        ext_im = assemble(x_im)
        win_re, xk_re = ext_re[:wsplit], ext_re[wsplit:]
        win_im, xk_im = ext_im[:wsplit], ext_im[wsplit:]
        planes0 = jnp.zeros((rs, c_loc), jnp.float32)
        if mixed:
            planes0 = planes0.at[misc + 6].set(mode_planes[0])
            planes0 = planes0.at[misc + 7].set(mode_planes[1])
        # pack_out=False: the sharded path reslices bits for the seam
        # phase-origin correction below, so keep a single int32 contract
        # across the differential/mixed/plain branches rather than a
        # per-branch int8/int32 mix.
        soft_re, soft_im, phase, bits, idx, _ = demod_full_tm(
            cfg, win_re, win_im, xk_re, xk_im, planes0, mixed=mixed,
            in_scale=in_scale, pack_out=False)

        # --- recover the absolute phase origin per shard (multiple of 2pi,
        # relative to shard 0) from overlap outputs ---
        # Output row o corresponds to ext symbol o (the window's
        # OLDEST symbol), so own outputs occupy rows [a1+discard,
        # a1+discard+s_loc).
        own0 = a1 + discard
        t_idx = jax.lax.axis_index("time")
        own_last = phase[own0 + s_loc - 1]             # (C_loc,)
        halo_last = phase[own0 - 1]                    # left-neighbor's last
        seam = jnp.stack([own_last, halo_last], axis=0)
        gathered = jax.lax.all_gather(seam, "time")    # (K, 2, C_loc)
        c_seam = TWO_PI * jnp.round(
            (gathered[:-1, 0] - gathered[1:, 1]) / TWO_PI)  # (K-1, C)
        delta_all = jnp.concatenate(
            [jnp.zeros((1, c_loc), jnp.float32),
             jnp.cumsum(c_seam, axis=0)], axis=0)
        delta = jnp.take(delta_all, t_idx, axis=0)     # (C_loc,)

        # own region, origin-corrected
        sl = slice(own0, own0 + s_loc)
        soft = jax.lax.complex(soft_re[sl], soft_im[sl])
        phase_own = phase[sl] + delta[None, :]
        from ..ops import slicers
        if mixed:
            # Per-channel: rotate + re-slice non-differential lanes, keep
            # the step's packed bits on differential lanes.
            rot = -delta / mode_planes[0]
            rot_soft = soft * jax.lax.complex(
                jnp.cos(rot), jnp.sin(rot))[None, :]
            is_diff = mode_planes[1] > 0.5
            soft = jnp.where(is_diff[None, :], soft, rot_soft)
            m_int = mode_planes[0].astype(jnp.int32)
            resliced = slicers.slice_code_dynamic(m_int[:, None], soft.T
                                                  ).T.astype(jnp.int32)
            packed = jnp.where(is_diff[None, :], bits[sl], resliced)
        elif not cfg.differential:
            rot = -delta / float(m)
            soft = soft * jax.lax.complex(jnp.cos(rot), jnp.sin(rot))[None, :]
            # bits follow the corrected constellation
            packed = slicers.slice_code(m, soft.T).T.astype(jnp.int32)
        else:
            packed = bits[sl]
        gsym = t_idx * s_loc + jnp.arange(s_loc, dtype=jnp.int32)
        valid = (gsym >= discard) & (gsym < total_symbols - a1)
        s_re, s_im = soft.real, soft.imag
        if soft_i8_scale is not None:
            # Quantize AFTER the seam correction: the phase-origin recovery
            # above needs the full-precision phase plane and a float soft
            # rotation, so (unlike the single-device step) int8 cannot ride
            # the step's own epilogue here -- but the dominant cost at
            # bank scale, the device->host fetch, still drops to 2 bytes/
            # symbol/channel, matching the wire format exactly.
            s = float(soft_i8_scale)
            s_re = jnp.clip(jnp.round(s_re * s), -127, 127).astype(jnp.int8)
            s_im = jnp.clip(jnp.round(s_im * s), -127, 127).astype(jnp.int8)
        return (s_re, s_im, phase_own, packed, idx[sl],
                jnp.broadcast_to(valid[:, None], (s_loc, c_loc)))

    spec = P("time", "chan")
    mode_spec = (P("chan"), P("chan")) if mixed else ()
    inner = jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec) + mode_spec,
        out_specs=(spec,) * 6, check_vma=False)
    jitted = jax.jit(inner)
    if mixed:
        return lambda x_re, x_im: jitted(x_re, x_im, m_arr, d_arr)
    return jitted
