"""Mesh-sharded batch demodulation: channels x time-blocks with seam exchange.

Implements SURVEY.md section 7 stage 6: the demod of a (C, T) batch is
sharded over a ``Mesh(("chan", "time"))``.  The channel axis is
communication-free.  Splitting one stream's *time* axis turns the reference's
sequential carries into three tiny seam structures:

* **Timing halo** (overlap-save): output symbol k needs the energy window of
  symbols [k, k + numAvg - 1] (cpp/psk_soft.cpp:457-465 emits the oldest
  symbol of the just-full window), so each shard pulls the first
  ``numAvg - 1`` symbol rows of its right neighbor via ``ppermute``.
* **Phase-unwrap prefix**: local unwraps differ from the global unwrap by a
  per-shard constant delta_t that accumulates seam corrections
  c_t = 2pi*round((u_{t-1}[last] - raw_t[0]) / 2pi); an ``all_gather`` of two
  scalars per (shard, channel) and a K-length cumsum recovers every delta --
  the associative-scan recast of the reference's recursion
  (cpp/psk_soft.cpp:477-478).
* **Fit/differential halo**: the FIR phase tracker needs the previous
  ``phaseAvg - 1`` unwrapped phases, and differential decoding the previous
  decision sample -- one left ``ppermute`` each.

Batch semantics match streaming the same array through the carried pipeline:
outputs are emitted for stream symbols [0, N - numAvg + 1) and the tail is
masked invalid (exactly the symbols the reference still holds in its window
when the stream ends).

Shard-size constraints (asserted): symbols per time shard >= numAvg - 1 and
>= phaseAvg - 1, so every halo comes from the immediate neighbor.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DemodConfig
from ..models.psk import DemodOutputs
from ..ops import linear_fit, phase as phase_ops, slicers, timing

TWO_PI = phase_ops.TWO_PI


def _right_halo(rows: jnp.ndarray, k: int, axis_name: str) -> jnp.ndarray:
    """Receive the first rows (axis 1) of the right neighbor; last shard gets
    zeros (its tail windows are invalid anyway)."""
    n_sh = jax.lax.psum(1, axis_name)
    perm = [(i, i - 1) for i in range(1, n_sh)]
    return jax.lax.ppermute(rows[:, :k], axis_name, perm)


def _left_shift(vals: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Receive values from the left neighbor; first shard gets zeros."""
    n_sh = jax.lax.psum(1, axis_name)
    perm = [(i, i + 1) for i in range(n_sh - 1)]
    return jax.lax.ppermute(vals, axis_name, perm)


def _sharded_body(cfg: DemodConfig, total_symbols: int, x: jnp.ndarray):
    """Per-device body under shard_map.  x: (C_loc, S_loc * sps)."""
    sps, num_avg, m, n = (cfg.sps, cfg.num_avg, cfg.constellation_size,
                          cfg.phase_avg)
    c_loc = x.shape[0]
    s_loc = x.shape[1] // sps

    # ---- optional matched filter (left sample halo = overlap-save) ----
    if cfg.matched_filter != "none":
        from ..ops import matched_filter as mf
        taps = jnp.asarray(mf.filter_taps(cfg))
        ntaps = cfg.mf_ntaps
        n_sh = jax.lax.psum(1, "time")
        perm = [(i, i + 1) for i in range(n_sh - 1)]
        halo = jax.lax.ppermute(x[:, x.shape[1] - (ntaps - 1):], "time", perm)
        x = mf.apply_fir(jnp.concatenate([halo, x], axis=1), taps)

    xs = x.reshape(c_loc, s_loc, sps)
    t_idx = jax.lax.axis_index("time")
    n_time = jax.lax.psum(1, "time")
    g0 = t_idx * s_loc                       # global index of first owned symbol
    gsym = g0 + jnp.arange(s_loc, dtype=jnp.int32)
    # Valid outputs: the reference emits symbol k only once symbol
    # k+numAvg-1 exists (cpp/psk_soft.cpp:457).
    valid = gsym < (total_symbols - num_avg + 1)

    # ---- timing: overlap-save right halo + windowed argmax ----
    if sps > 1:
        if s_loc >= num_avg - 1:
            halo = _right_halo(xs, num_avg - 1, "time")
        else:  # only legal single-shard (asserted in make_sharded_demod)
            halo = jnp.zeros((c_loc, num_avg - 1, sps), xs.dtype)
        # Local energies do not depend on the halo: computing them before
        # touching `halo` lets XLA overlap the ppermute with local compute
        # (seam exchange off the critical path, SURVEY.md hard part #3).
        e_local = timing.symbol_energy_rows(xs)
        e_halo = timing.symbol_energy_rows(halo)
        rows = jnp.concatenate([xs, halo], axis=1)       # (C, S+A-1, sps)
        e = jnp.concatenate([e_local, e_halo], axis=1)
        w = timing.windowed_bin_sums(e, num_avg)         # (C, S, sps)
        if cfg.timing_interp:
            sample_index, sel = timing.select_decision_samples_interp(
                rows.reshape(c_loc, -1), w, sps)
        else:
            sample_index, sel = timing.select_decision_samples(xs, w)
    else:
        sel = xs[..., 0]
        sample_index = jnp.zeros((c_loc, s_loc), jnp.int32)

    # ---- phase: trend-robust local unwrap over a raw halo + seam combine ----
    raw = phase_ops.mth_power_phase(sel, m)              # (C, S)
    halo_len = max(n - 1, phase_ops.UNWRAP_TREND_LEN - 1, 1)
    if s_loc >= halo_len:
        halo_raw = _left_shift(raw[:, -halo_len:], "time")  # zeros on shard 0
    else:  # only legal single-shard (asserted in make_sharded_demod)
        halo_raw = jnp.zeros((c_loc, halo_len), raw.dtype)
    ext = jnp.concatenate([halo_raw, raw], axis=1)       # (C, H+S)
    u_ext = phase_ops.robust_block_unwrap(ext, axis=-1)
    # Seam combine: my local chain differs from the global unwrap by a
    # per-shard constant delta (an exact multiple of 2pi).  Each shard
    # publishes (a) its last owned unwrapped value, (b) that same symbol as
    # computed by its *right* neighbor inside the halo, and (c) its local
    # origin correction; deltas are a prefix sum over seam corrections --
    # the associative-scan recast of cpp/psk_soft.cpp:477-478.
    own_last = u_ext[:, -1]
    halo_last = u_ext[:, halo_len - 1]
    origin_fix = TWO_PI * jnp.round((raw[:, 0] - u_ext[:, halo_len]) / TWO_PI)
    seam = jnp.stack([own_last, halo_last, origin_fix], axis=0)   # (3, C)
    gathered = jax.lax.all_gather(seam, "time")          # (K, 3, C)
    c_seam = TWO_PI * jnp.round(
        (gathered[:-1, 0, :] - gathered[1:, 1, :]) / TWO_PI)   # (K-1, C)
    delta_all = jnp.concatenate(
        [jnp.zeros((1, c_loc), jnp.float32), jnp.cumsum(c_seam, axis=0)],
        axis=0) + gathered[0, 2, :][None]
    delta = jnp.take(delta_all, t_idx, axis=0)           # (C,)
    u = u_ext[:, halo_len:] + delta[:, None]

    # ---- FIR tracker (the unwrapped halo doubles as the fit lead-in) ----
    if n > 1:
        cat = u_ext[:, halo_len - (n - 1):] + delta[:, None]  # (C, n-1+S)
        wfir = jnp.asarray(linear_fit.endpoint_fir_weights(n))
        est = _conv_valid(cat, wfir)                     # (C, S)
        # Warm-up (growing window) affects global output indices < n, i.e.
        # the first rows of the first shard(s).
        k = min(n, s_loc)
        p = jnp.minimum(gsym[:k] + 1, n)
        wm = jnp.asarray(linear_fit.warmup_fir_weight_matrix(n))
        idx = jnp.arange(k)[:, None] + jnp.arange(n)[None, :]
        windows = cat[:, idx]                            # (C, k, n)
        w_sel = wm[jnp.clip(p, 1, n) - 1]                # (k, n)
        est_warm = jnp.sum(windows * w_sel[None], axis=-1)
        est = est.at[:, :k].set(jnp.where((p < n)[None, :], est_warm, est[:, :k]))
    else:
        est = u
    phase_seq = jnp.where(valid[None, :], est, 0.0)

    # ---- correction / differential / slicing ----
    prev_last = _left_shift(sel[:, -1], "time")          # (C,)
    shifted = jnp.concatenate([prev_last[:, None], sel[:, :-1]], axis=1)
    prev = jnp.where(gsym[None, :] >= 1, shifted, jnp.complex64(1 + 0j))
    if cfg.differential:
        base = sel / prev
        correction = jnp.zeros_like(phase_seq)
    else:
        base = sel
        correction = -phase_seq / m
    if m == 4:
        correction = correction + jnp.float32(jnp.pi / 4)
    phasor = jax.lax.complex(jnp.cos(correction), jnp.sin(correction))
    soft = (base * phasor).astype(jnp.complex64)
    bits = slicers.slice_bits(m, soft)

    vmask = valid[None, :]
    return (
        jnp.where(vmask, soft, 0),
        jnp.where(vmask[..., None], bits, 0).astype(jnp.int8),
        phase_seq,
        jnp.where(vmask, sample_index, 0),
        jnp.broadcast_to(vmask, soft.shape),
    )


def _conv_valid(cat: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Batched 'valid' correlation: out[c, o] = sum_i cat[c, o+i] * w[i].

    XLA's conv primitive is a cross-correlation (no kernel flip), so the
    weights are passed in window order.
    """
    out = jax.lax.conv_general_dilated(
        cat[:, None, :], w[None, None, :],
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,     # phases are not TF32-exact
    )
    return out[:, 0, :]


def make_sharded_demod(cfg: DemodConfig, mesh: Mesh, total_symbols: int):
    """Build a jitted sharded batch demod: (C, T) -> DemodOutputs arrays.

    T = total_symbols * cfg.sps; C divisible by the 'chan' axis and
    total_symbols by the 'time' axis.
    """
    n_time = mesh.shape["time"]
    if total_symbols % n_time:
        raise ValueError(f"{total_symbols} symbols not divisible by time={n_time}")
    s_loc = total_symbols // n_time
    min_syms = max(cfg.num_avg - 1, cfg.phase_avg - 1,
                   phase_ops.UNWRAP_TREND_LEN - 1,
                   -(-max(cfg.mf_ntaps - 1, 0) // cfg.sps))
    if n_time > 1 and s_loc < min_syms:
        raise ValueError(
            f"symbols per time shard ({s_loc}) must be >= {min_syms} "
            f"(max of num_avg-1, phase_avg-1, mf halo)")

    body = functools.partial(_sharded_body, cfg, total_symbols)
    inner = jax.shard_map(
        body, mesh=mesh,
        in_specs=P("chan", "time"),
        out_specs=(P("chan", "time"), P("chan", "time"), P("chan", "time"),
                   P("chan", "time"), P("chan", "time")),
        check_vma=False,
    )

    @jax.jit
    def run(x):
        soft, bits, phase, sample_index, valid = inner(x)
        return DemodOutputs(soft=soft, bits=bits, phase=phase,
                            sample_index=sample_index, valid=valid)

    return run
