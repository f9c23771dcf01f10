"""Mixed-mode multi-channel demod: per-channel constellation + differential.

BASELINE.json config 4: "64-channel multi-mode (BPSK/QPSK/8PSK mixed)
batched demod, channels sharded on one chip".  The reference would need one
component process per mode; here the constellation size and differential
flag become *traced per-channel values*, so one compiled program serves a
heterogeneous channel bank (channels still share sps / num_avg / phase_avg
-- the timing cadence; heterogeneous sps requires bucketing channels into
per-sps groups, which the engines do by instantiating one group per sps).

All mode-dependent stages are branch-free selects over the three slicer/
power variants (ops/slicers.slice_bits_dynamic, ops/phase.
mth_power_phase_dynamic), so the program stays a single dense batch -- no
gather/scatter, no per-channel control flow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..models.blockpsk import FFState, _fir_phase_track, ff_init
from ..models.common import timing_frontend
from ..models.psk import DemodOutputs
from ..ops import phase as phase_ops, slicers


class MixedParams(NamedTuple):
    """Per-channel demod mode (traced)."""

    m: jnp.ndarray     # (C,) int32 in {2, 4, 8, 16, 32}
    diff: jnp.ndarray  # (C,) bool

    @classmethod
    def make(cls, m, diff):
        return cls(jnp.asarray(m, jnp.int32), jnp.asarray(diff, bool))

    @property
    def bits_per_symbol(self):
        # log2(m) for power-of-two m: 2->1, 4->2, 8->3, 16->4, 32->5
        # (generalizes cpp/psk_soft.cpp:384-390 beyond the reference's set).
        mi = self.m.astype(jnp.int32)
        b = jnp.zeros_like(mi)
        for k in (2, 4, 8, 16):   # count set high bits: log2 via shifts
            b = b + (mi > k)
        return b + 1

    @property
    def max_bits(self) -> int:
        """Static bit-plane width for this bank (concrete m only)."""
        import numpy as np
        return max(3, int(np.max(np.asarray(self.m))).bit_length() - 1)


def _mixed_chain(cfg: DemodConfig, max_bits: int, m, diff, st: FFState,
                 x: jnp.ndarray):
    """One chain with traced (m, diff); vmapped over channels."""
    sps = cfg.sps
    S = x.shape[0] // sps
    xs = x.reshape(S, sps)
    fe = timing_frontend(cfg, st.win_samples, st.win_energy, st.seen, xs)
    sel, valid = fe["sel"], fe["valid"]

    # Phase chain with traced m.
    raw = phase_ops.mth_power_phase_dynamic(sel, m)
    fv = jnp.argmax(valid)
    first_raw = raw[jnp.clip(fv, 0, S - 1)]
    prev_eff = jnp.where(st.phase_count > 0, st.last_phase, first_raw)
    raw_eff = jnp.where(valid, raw, prev_eff)
    n1 = cfg.phase_avg - 1
    head = st.phase_hist if n1 > 0 else st.last_phase[None]
    h = head.shape[0]
    ext = jnp.concatenate([head, raw_eff])
    u_ext = phase_ops.robust_block_unwrap(ext)
    cont_shift = phase_ops.TWO_PI * jnp.round(
        (st.last_phase - u_ext[h - 1]) / phase_ops.TWO_PI)
    start_shift = phase_ops.TWO_PI * jnp.round(
        (first_raw - u_ext[h + jnp.clip(fv, 0, S - 1)]) / phase_ops.TWO_PI)
    shift = jnp.where(st.phase_count > 0, cont_shift, start_shift)
    unwrapped = u_ext[h:] + shift
    est, new_hist, new_count = _fir_phase_track(
        cfg, st.phase_hist, st.phase_count, unwrapped, valid)
    phase_seq = jnp.where(valid, est, 0.0)

    any_valid = jnp.any(valid)
    last_idx = jnp.where(any_valid, S - 1 - jnp.argmax(valid[::-1]), 0)
    new_last_phase = jnp.where(any_valid, unwrapped[last_idx], st.last_phase)
    last_est = jnp.where(any_valid, est[last_idx], 0.0)
    # Re-wrap about the *per-channel* M*2pi (cpp/psk_soft.cpp:592-595).
    wrap_value = phase_ops.TWO_PI * m.astype(jnp.float32)
    wraps = jnp.round(last_est / wrap_value)
    off = jnp.where(jnp.abs(last_est) > wrap_value, wraps * wrap_value, 0.0)
    new_hist = new_hist - off
    new_last_phase = new_last_phase - off

    # Correction: differential (traced flag) or derotation by -est/m.
    shifted = jnp.concatenate([st.last_any[None], sel[:-1]])
    prev = jnp.where(fe["prev_exists"], shifted, jnp.complex64(1 + 0j))
    mf = m.astype(jnp.float32)
    correction = jnp.where(diff, 0.0, -phase_seq / mf)
    correction = correction + jnp.where(m == 4, jnp.float32(jnp.pi / 4), 0.0)
    phasor = jax.lax.complex(jnp.cos(correction), jnp.sin(correction))
    base = jnp.where(diff, sel / prev, sel)
    soft = (base * phasor).astype(jnp.complex64)
    bits = slicers.slice_bits_dynamic(m, soft, max_bits=max_bits)

    new_state = FFState(
        win_samples=fe["new_win_samples"], win_energy=fe["new_win_energy"],
        seen=fe["seen2"], phase_hist=new_hist, phase_count=new_count,
        last_phase=new_last_phase, last_any=sel[-1], mf_tail=st.mf_tail)
    outputs = DemodOutputs(
        soft=jnp.where(valid, soft, 0),
        bits=jnp.where(valid[:, None], bits, 0).astype(jnp.int8),
        phase=phase_seq,
        sample_index=jnp.where(valid, fe["sample_index"], 0),
        valid=valid,
    )
    return new_state, outputs


def make_mixed_demod_fn(cfg: DemodConfig, jit: bool = True,
                        max_bits: int = 3):
    """Returns fn(params: MixedParams, state: FFState[C], x: (C, T)) ->
    (state, DemodOutputs[C, S]).

    ``max_bits`` is the static bit-plane width: 3 covers {2, 4, 8} banks;
    pass ``params.max_bits`` (4/5) for banks with 16/32-PSK channels.
    """
    chain = functools.partial(_mixed_chain, cfg, max_bits)
    fn = jax.vmap(chain, in_axes=(0, 0, 0, 0))

    def run(params: MixedParams, state: FFState, x: jnp.ndarray):
        return fn(params.m, params.diff, state, x)

    return jax.jit(run) if jit else run


def mixed_init(cfg: DemodConfig, channels: int) -> FFState:
    return ff_init(cfg, (channels,))
