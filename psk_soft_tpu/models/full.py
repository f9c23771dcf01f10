"""Steady-state demod over time-major planes: the engines' hot path.

Usage pattern: run the flexible pipeline (models/blockpsk) through warm-up,
convert the converged carry with :func:`full_from_ff`, then stream blocks
through :func:`demod_block_full`.  Every array is time-major with channels
on the contiguous axis -- the (T, C) sample planes the native plane bank
produces go in untouched, the (S, C) symbol planes the chain's frame sync
eats come out -- and the whole step is plain jnp/lax that XLA fuses.

Unlike models/blockpsk, the steady state assumes a converged tracker and
carries its unwrap trend across blocks (state planes, :func:`state_rows`),
so it never re-derives the trend from the phase history.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DemodConfig
from ..ops import phase as phase_ops, slicers, timing
from ..ops.linear_fit import endpoint_fir_weights
from ..ops.phase import UNWRAP_TREND_LEN
from .psk import DemodOutputs


def state_rows(phase_avg: int, k: int = UNWRAP_TREND_LEN) -> int:
    """Rows of the carry plane: u_hist (phase_avg-1) | 2(k-1) reserved |
    misc(8), padded up to a multiple of 8 (the checkpoint layout).  u_hist
    is the unwrapped-phase history (oldest..newest), misc = [reserved,
    reserved, last_any_re, last_any_im, reserved, reserved, mixed_m,
    mixed_diff]: last_any is the previous decision sample, rows 6-7 the
    per-channel constellation size and differential flag of a mixed-mode
    bank (constant, carried through).  Reserved rows are zero; they keep
    the checkpoint layout and the mode-row indices in place."""
    raw = (phase_avg - 1) + 2 * (k - 1) + 8
    return -(-raw // 8) * 8


class FullState(NamedTuple):
    win_re: jnp.ndarray   # ((num_avg-1)*sps, C) float32
    win_im: jnp.ndarray   # ((num_avg-1)*sps, C) float32
    planes: jnp.ndarray   # (state_rows(phase_avg), C) float32


class FullOutputs(NamedTuple):
    """Time-major symbol-rate planes (S, C); bits are packed LSB-first ints.
    soft_re/soft_im are float32, or int8 when the step ran with
    ``soft_i8_scale`` (dequantize as ``plane / scale``)."""

    soft_re: jnp.ndarray
    soft_im: jnp.ndarray
    phase: jnp.ndarray
    bits_packed: jnp.ndarray
    sample_index: jnp.ndarray


class QuantSoft(NamedTuple):
    """Channel-major int8-quantized soft decisions inside DemodOutputs.soft
    (``soft_i8_scale`` mode): dequantize as ``(re_q + 1j*im_q) /
    scale``.  Kept quantized through the device->host fetch so the dominant
    output plane crosses at 2 bytes/symbol/channel; the packet layer
    dequantizes on the host (BankAssembler)."""

    re_q: jnp.ndarray    # (C, S) int8
    im_q: jnp.ndarray    # (C, S) int8
    scale: float


def full_from_ff(cfg: DemodConfig, ff_state, raw_win=None,
                 mixed_params=None) -> FullState:
    """Convert a *converged* channel-batched FFState (or FusedState) carry.

    Host-side, called once at the warm-up -> steady transition.

    Args:
      raw_win: required when ``cfg.matched_filter != "none"`` -- the last
        ``(num_avg-1)*sps + mf_ntaps-1`` RAW input samples per channel,
        shape (C, that) complex.  The steady step filters [window | block]
        itself, so its
        window carry holds raw samples (the FF carry only keeps filtered
        ones); the engine tracks this tail itself (FullKernelBatchEngine).
      mixed_params: models/mixed.MixedParams (per-channel M + differential)
        for a mixed-mode bank; written into the carry's mode rows so the
        steady step runs branch-free per-lane selects (pass mixed=True to
        demod_block_full).
    """
    k = UNWRAP_TREND_LEN
    n1 = cfg.phase_avg - 1
    if n1 < k:
        raise ValueError(f"full pipeline requires phase_avg >= {k + 1}")
    ff_state = jax.device_get(ff_state)
    hist = np.asarray(ff_state.phase_hist)        # (C, n-1) oldest..newest
    c = hist.shape[0]
    if cfg.matched_filter != "none":
        keep = (cfg.num_avg - 1) * cfg.sps + cfg.mf_ntaps - 1
        if raw_win is None or np.shape(raw_win) != (c, keep):
            raise ValueError(
                f"matched-filter configs need raw_win of shape {(c, keep)} "
                f"(raw input tail; the FF carry only holds filtered samples)")
        raw = np.asarray(raw_win)
        win_re = np.ascontiguousarray(raw.real.T).astype(np.float32)
        win_im = np.ascontiguousarray(raw.imag.T).astype(np.float32)
    elif hasattr(ff_state, "win_re"):             # FusedState (time-major)
        win_re = np.asarray(ff_state.win_re)
        win_im = np.asarray(ff_state.win_im)
    else:                                         # FFState (channel-major)
        win = np.asarray(ff_state.win_samples)    # (C, A-1, sps)
        flat = win.reshape(c, -1)
        win_re = np.ascontiguousarray(flat.real.T).astype(np.float32)
        win_im = np.ascontiguousarray(flat.imag.T).astype(np.float32)

    rs = state_rows(cfg.phase_avg, k)
    planes = np.zeros((rs, c), np.float32)
    planes[:n1] = hist.T
    misc = n1 + 2 * (k - 1)
    last_any = np.asarray(ff_state.last_any)
    planes[misc + 2] = last_any.real
    planes[misc + 3] = last_any.imag
    if mixed_params is not None:
        planes[misc + 6] = np.asarray(mixed_params.m, np.float32)
        planes[misc + 7] = np.asarray(mixed_params.diff, np.float32)
    return FullState(win_re=jnp.asarray(win_re), win_im=jnp.asarray(win_im),
                     planes=jnp.asarray(planes))


def ff_from_full(cfg: DemodConfig, state: FullState):
    """Convert the steady-state carry back to a (converged) FFState.

    The inverse of :func:`full_from_ff`, used for live reconfigure on the
    flagship engine (C7 semantics, cpp/psk_soft.cpp:638-651): the steady
    step's state planes ARE the feed-forward carry in another layout --
    ``planes[:n-1]`` is the unwrapped-phase history (newest == last_phase
    after the end-of-block re-wrap, exactly like blockpsk's
    ``new_hist = cat[S:] - off``), ``planes[misc+2/3]`` the previous
    decision sample.  Host-side, called once per property change.
    """
    from ..models.blockpsk import FFState

    k = UNWRAP_TREND_LEN
    n1 = cfg.phase_avg - 1
    state = jax.device_get(state)
    planes = np.asarray(state.planes)
    win_re = np.asarray(state.win_re)             # ((A-1)*sps, C)
    win_im = np.asarray(state.win_im)
    c = planes.shape[1]
    misc = n1 + 2 * (k - 1)

    raw = (win_re.T + 1j * win_im.T).astype(np.complex64)   # (C, rows)
    if cfg.matched_filter != "none":
        # Steady window rows are RAW; the FF carry wants the FILTERED window
        # plus the raw (ntaps-1) tail.  Filter host-side (valid alignment,
        # ops/matched_filter.apply_fir convention y[t] = sum taps[k] x[t+k]).
        from ..ops.matched_filter import filter_taps

        taps = np.asarray(filter_taps(cfg), np.float64)
        L = taps.size
        sw = np.lib.stride_tricks.sliding_window_view(raw, L, axis=-1)
        filt = (sw @ taps).astype(np.complex64)             # (C, wlen)
        mf_tail = raw[:, raw.shape[1] - (L - 1):]
        win = filt.reshape(c, cfg.num_avg - 1, cfg.sps)
    else:
        mf_tail = np.zeros((c, 0), np.complex64)
        win = raw.reshape(c, cfg.num_avg - 1, cfg.sps)
    hist = np.ascontiguousarray(planes[:n1].T)    # (C, n-1) oldest..newest
    last_any = (planes[misc + 2] + 1j * planes[misc + 3]).astype(np.complex64)
    return FFState(
        win_samples=jnp.asarray(win),
        win_energy=jnp.asarray((win.real ** 2 + win.imag ** 2)
                               .astype(np.float32)),
        seen=jnp.full((c,), cfg.num_avg, jnp.int32),
        phase_hist=jnp.asarray(hist.astype(np.float32)),
        phase_count=jnp.full((c,), cfg.phase_avg, jnp.int32),
        last_phase=jnp.asarray(hist[:, -1].astype(np.float32) if n1 > 0
                               else np.zeros(c, np.float32)),
        last_any=jnp.asarray(last_any),
        mf_tail=jnp.asarray(mf_tail),
    )


def dequantize_full_state(state: FullState, in_scale: float) -> FullState:
    """Inverse of :func:`quantize_full_state`: back to float32 window planes
    (for ff_from_full / checkpoint interchange)."""
    if state.win_re.dtype != jnp.int16:
        return state
    return FullState(
        win_re=state.win_re.astype(jnp.float32) * in_scale,
        win_im=state.win_im.astype(jnp.float32) * in_scale,
        planes=state.planes)


def quantize_full_state(state: FullState, in_scale: float) -> FullState:
    """Quantize the carry's raw-sample window planes to int16 for the int16
    ingest path.  The phase/state planes stay float32 -- only the bulk
    sample window rides the 2-byte format.  When
    the f32 window itself came from dequantized int16 input (the production
    case), round() recovers the exact wire values."""
    q_re = jnp.clip(jnp.round(state.win_re / in_scale), -32768, 32767)
    q_im = jnp.clip(jnp.round(state.win_im / in_scale), -32768, 32767)
    return FullState(win_re=q_re.astype(jnp.int16),
                     win_im=q_im.astype(jnp.int16), planes=state.planes)


def _sliding(x: jnp.ndarray, weights) -> jnp.ndarray:
    """Valid-mode FIR along axis 0 with static weights:
    ``y[o] = sum_i w[i] * x[o + i]``.  A sum of shifted slices in exact
    float32 -- XLA fuses it into one elementwise pass, and no matmul or
    convolution is involved, so no TF32 rounding can enter."""
    n = len(weights)
    s = x.shape[0] - n + 1
    acc = None
    for i, wi in enumerate(weights):
        term = x[i:i + s] if wi == 1.0 else float(wi) * x[i:i + s]
        acc = term if acc is None else acc + term
    return acc


def demod_full_tm(cfg: DemodConfig, win_re, win_im, x_re, x_im, planes, *,
                  mixed: bool = False, in_scale: float = 1.0,
                  pack_out: bool | None = None,
                  soft_i8_scale: float | None = None,
                  debug_ports: bool = True):
    """The steady-state demod over time-major planes, in plain JAX.

    Args:
      win_re/win_im: ((num_avg-1)*sps + mf_ntaps-1, C) window carry -- RAW
        samples when a matched filter is configured (it runs here, on
        [window | block]), plain samples otherwise.
      x_re/x_im: (S*sps, C) block planes (always raw input).  float32, or
        int16 wire planes (window too) dequantized as ``i16 * in_scale``.
      planes: (state_rows(phase_avg), C) tracking carry (see state_rows).
      mixed: per-channel (M, differential) bank read from the carry's mode
        rows; cfg's constellation_size/differential are then ignored.
      pack_out: bits/sampleIndex as int8 planes (values 0..7 and
        0..sps-1); None packs whenever sps <= 128.
      soft_i8_scale: emit soft planes as ``clip(round(s * scale), -127,
        127)`` int8 (the SDR soft-bit wire format); bits and phase come
        from the unquantized values.
      debug_ports: False returns None for the phase and sampleIndex planes.

    Returns (soft_re, soft_im, phase, bits_packed, sample_index, planes')
    with (S, C) symbol-rate planes, channels on the contiguous axis
    throughout (no transpose of the sample-rate planes).
    """
    sps, num_avg, n = cfg.sps, cfg.num_avg, cfg.phase_avg
    k = UNWRAP_TREND_LEN
    n1, k1 = n - 1, k - 1
    misc = n1 + 2 * k1
    if sps <= 1:
        raise ValueError("full pipeline supports sps > 1; use "
                         "models.blockpsk for the sps=1 passthrough")
    if n < k + 1:
        raise ValueError(f"full pipeline requires phase_avg >= {k + 1}")
    if num_avg < 2:
        raise ValueError("full pipeline requires num_avg >= 2")
    taps = _static_taps(cfg)
    keep = (num_avg - 1) * sps + ((len(taps) - 1) if taps else 0)
    t, c = x_re.shape
    if t % sps:
        raise ValueError(f"block length {t} not a multiple of sps={sps}")
    if win_re.shape != (keep, c):
        raise ValueError(f"win planes must be {(keep, c)}, got "
                         f"{win_re.shape}")
    if planes.shape != (state_rows(n, k), c):
        raise ValueError(f"state_planes must be {(state_rows(n, k), c)}, "
                         f"got {planes.shape}")
    in_i16 = x_re.dtype == jnp.int16
    if in_i16 and win_re.dtype != jnp.int16:
        raise ValueError("int16 ingest needs int16 window carry planes "
                         "(quantize with models.full.quantize_full_state)")
    if pack_out is None:
        pack_out = sps <= 128
    elif pack_out and sps > 128:
        raise ValueError(f"pack_out requires sps <= 128 (int8 index "
                         f"range), got sps={sps}")
    s_out = t // sps

    re = jnp.concatenate([win_re, x_re], axis=0)
    im = jnp.concatenate([win_im, x_im], axis=0)
    if in_i16:
        re = re.astype(jnp.float32) * in_scale
        im = im.astype(jnp.float32) * in_scale
    if taps:
        re = _sliding(re, taps)
        im = _sliding(im, taps)

    # --- C2: timing (windowed bin energies, argmax or centroid pick) ---
    r3 = re.reshape(s_out + num_avg - 1, sps, c)
    i3 = im.reshape(s_out + num_avg - 1, sps, c)
    w = timing.windowed_bin_sums(r3 * r3 + i3 * i3, num_avg, axis=0)
    if cfg.timing_interp:
        b, sel = timing.select_decision_samples_interp(
            jax.lax.complex(re, im), w, sps, axis=1)
    else:
        b, sel = timing.select_decision_samples(
            jax.lax.complex(r3[:s_out], i3[:s_out]), w, axis=1)

    # --- C3/C1: M-th power phase, robust unwrap, endpoint-FIR tracker:
    # the converged path of models/blockpsk.symbol_backend, time-major ---
    if mixed:
        mvec = planes[misc + 6]
        m_int = mvec.astype(jnp.int32)[None]
        raw = phase_ops.mth_power_phase_dynamic(sel, m_int)
    else:
        m = cfg.constellation_size
        raw = phase_ops.mth_power_phase(sel, m)
    hist = planes[:n1]                       # newest == the last phase
    u_ext = phase_ops.robust_block_unwrap(
        jnp.concatenate([hist, raw], axis=0), axis=0)
    shift = phase_ops.TWO_PI * jnp.round(
        (hist[-1] - u_ext[n1 - 1]) / phase_ops.TWO_PI)
    cat = jnp.concatenate([hist, u_ext[n1:] + shift], axis=0)
    est = _sliding(cat, endpoint_fir_weights(n))

    # --- C5/C6: derotation or differential decode, slicing ---
    last_any = jax.lax.complex(planes[misc + 2], planes[misc + 3])
    prev = jnp.concatenate([last_any[None], sel[:-1]], axis=0)
    prev = jnp.where(prev == 0, jnp.complex64(1.0), prev)   # zero carry
    if mixed:
        dsel = (planes[misc + 7] > 0.5)[None]
        corr = jnp.where(dsel, 0.0, -est / mvec[None])
        corr = corr + jnp.where(mvec[None] == 4, jnp.float32(jnp.pi / 4),
                                0.0)
        base = jnp.where(dsel, sel / prev, sel)
    else:
        corr = jnp.zeros_like(est) if cfg.differential else -est / m
        if m == 4:
            corr = corr + jnp.float32(jnp.pi / 4)
        base = sel / prev if cfg.differential else sel
    soft = base * jax.lax.complex(jnp.cos(corr), jnp.sin(corr))
    if mixed:
        bits = slicers.slice_code_dynamic(m_int, soft)
    else:
        bits = slicers.slice_code(m, soft)
    if soft_i8_scale is not None:
        q = float(soft_i8_scale)
        soft_re = jnp.clip(jnp.round(soft.real * q), -127, 127
                           ).astype(jnp.int8)
        soft_im = jnp.clip(jnp.round(soft.imag * q), -127, 127
                           ).astype(jnp.int8)
    else:
        soft_re, soft_im = soft.real, soft.imag
    odt = jnp.int8 if pack_out else jnp.int32

    # --- carry update (+ end-of-block M*2pi re-wrap, cpp/psk_soft.cpp:592) --
    off = phase_ops.rewrap_offset(est[-1], mvec if mixed else m)
    new_planes = jnp.concatenate([
        cat[s_out:] - off, planes[n1:misc + 2],
        sel[-1:].real, sel[-1:].imag, planes[misc + 4:]], axis=0)
    return (soft_re, soft_im, est if debug_ports else None,
            bits.astype(odt), b.astype(odt) if debug_ports else None,
            new_planes)


def demod_block_full(cfg: DemodConfig, state: FullState,
                     x_re: jnp.ndarray, x_im: jnp.ndarray, *,
                     mixed: bool = False, in_scale: float = 1.0,
                     pack_out: bool | None = None,
                     soft_i8_scale: float | None = None,
                     debug_ports: bool = True):
    """One steady-state block (see :func:`demod_full_tm` for the options).

    x_re/x_im: (T, C) time-major planes, T = S * sps.  Always raw input;
    the matched filter (when configured) runs on [window | block], and the
    window carry then holds raw samples.  int16 ingest: pass int16 planes
    (+ ``in_scale``) and an int16-window state (:func:`quantize_full_state`).
    """
    soft_re, soft_im, phase, bits, idx, planes = demod_full_tm(
        cfg, state.win_re, state.win_im, x_re, x_im, state.planes,
        mixed=mixed, in_scale=in_scale, pack_out=pack_out,
        soft_i8_scale=soft_i8_scale, debug_ports=debug_ports)
    keep = state.win_re.shape[0]
    new_state = FullState(
        win_re=jnp.concatenate([state.win_re, x_re], axis=0)[-keep:],
        win_im=jnp.concatenate([state.win_im, x_im], axis=0)[-keep:],
        planes=planes,
    )
    return new_state, FullOutputs(soft_re, soft_im, phase, bits, idx)


def demod_block_full_rolling(cfg: DemodConfig, planes: jnp.ndarray,
                             prev_re: jnp.ndarray, prev_im: jnp.ndarray,
                             x_re: jnp.ndarray, x_im: jnp.ndarray, *,
                             mixed: bool = False, in_scale: float = 1.0,
                             pack_out: bool | None = None,
                             soft_i8_scale: float | None = None,
                             debug_ports: bool = True):
    """Steady-state block with the timing window sliced from the previous
    block's input planes instead of a carried window buffer: only the
    ``planes`` tracking carry is threaded, so no window copy is written.

    Requires no matched filter (ValueError otherwise: that window holds
    the filter's raw history too) and prev planes at least one window long.
    Engines fall back to the standard path automatically when unsupported
    (FullKernelBatchEngine._steady_step).

    Returns ``(planes', FullOutputs)``.
    """
    if cfg.matched_filter != "none":
        raise ValueError("rolling-window mode requires matched_filter="
                         "'none' (the MF window carries raw history)")
    keep = (cfg.num_avg - 1) * cfg.sps
    if prev_re.shape[0] < keep:
        raise ValueError(f"prev planes must hold >= {keep} rows")
    off = prev_re.shape[0] - keep
    soft_re, soft_im, phase, bits, idx, planes2 = demod_full_tm(
        cfg, prev_re[off:], prev_im[off:], x_re, x_im, planes,
        mixed=mixed, in_scale=in_scale, pack_out=pack_out,
        soft_i8_scale=soft_i8_scale, debug_ports=debug_ports)
    return planes2, FullOutputs(soft_re, soft_im, phase, bits, idx)


def _static_taps(cfg: DemodConfig):
    """Matched-filter taps as a hashable static tuple (None when disabled)."""
    if cfg.matched_filter == "none":
        return None
    from ..ops.matched_filter import filter_taps

    return tuple(float(t) for t in filter_taps(cfg))


def make_full_demod_fn(cfg: DemodConfig, *, in_scale: float = 1.0,
                       pack_out: bool | None = None,
                       soft_i8_scale: float | None = None):
    return jax.jit(functools.partial(demod_block_full, cfg,
                                     in_scale=in_scale, pack_out=pack_out,
                                     soft_i8_scale=soft_i8_scale))


def make_mixed_full_demod_fn(cfg: DemodConfig):
    """Mixed-mode steady step: per-channel (M, differential) read from the
    carry's mode rows (convert with full_from_ff(..., mixed_params=params);
    warm-up equivalent: models/mixed.make_mixed_demod_fn).  cfg's
    constellation_size/differential are ignored."""
    return jax.jit(functools.partial(demod_block_full, cfg, mixed=True))


def make_scanned_full_demod_fn(cfg: DemodConfig, *, in_scale: float = 1.0,
                               pack_out: bool | None = None,
                               soft_i8_scale: float | None = None):
    """Many block-steps in ONE dispatch: fn(state, xs_re, xs_im) with
    (K, T, C) plane stacks, scanning the steady step over the leading axis
    and returning (state, stacked FullOutputs)."""
    step = functools.partial(demod_block_full, cfg, in_scale=in_scale,
                             pack_out=pack_out, soft_i8_scale=soft_i8_scale)

    def run(state, xs_re, xs_im):
        def body(st, xy):
            st2, out = step(st, xy[0], xy[1])
            return st2, out
        return jax.lax.scan(body, state, (xs_re, xs_im))

    return jax.jit(run)


def to_demod_outputs(cfg: DemodConfig, out: FullOutputs,
                     soft_i8_scale: float | None = None) -> DemodOutputs:
    """Adapter to the standard channel-major DemodOutputs (for tests/tools;
    the packed-bits planes are the production interface).  phase and
    sample_index stay None when the step ran with debug_ports=False (the
    packet layer then omits those ports, like the reference with
    unconnected ports).

    When the step ran with ``soft_i8_scale`` the soft planes are int8;
    pass the same scale here and ``soft`` holds a :class:`QuantSoft` --
    still quantized, so the device->host fetch stays at 2 bytes/symbol/
    channel.  BankAssembler dequantizes on the host; library users call
    ``dequantize_soft``.
    """
    if out.soft_re.dtype == jnp.int8:
        if soft_i8_scale is None:
            raise ValueError("step emitted int8 soft planes; pass the "
                             "soft_i8_scale it ran with")
        soft = QuantSoft(out.soft_re.T, out.soft_im.T, float(soft_i8_scale))
        vshape = soft.re_q.shape
    else:
        soft = jax.lax.complex(out.soft_re.T, out.soft_im.T)
        vshape = soft.shape
    packed = out.bits_packed.T
    bits = jnp.stack([(packed >> i) & 1
                      for i in range(max(3, cfg.bits_per_symbol))],
                     axis=-1).astype(jnp.int8)
    return DemodOutputs(
        soft=soft,
        bits=bits,
        phase=None if out.phase is None else out.phase.T,
        sample_index=(None if out.sample_index is None
                      else out.sample_index.T),
        valid=jnp.ones(vshape, bool),
    )


def dequantize_soft(soft) -> np.ndarray:
    """Host-side complex64 soft decisions from a (host) QuantSoft (identity
    for already-complex arrays)."""
    if isinstance(soft, QuantSoft):
        inv = 1.0 / float(soft.scale)
        out = np.empty(np.shape(soft.re_q), np.complex64)
        out.real = np.asarray(soft.re_q, np.float32) * inv
        out.imag = np.asarray(soft.im_q, np.float32) * inv
        return out
    return np.asarray(soft)
