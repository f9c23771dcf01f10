"""Forward error correction: convolutional codes + Viterbi decoding.

Extension beyond the reference: psk_soft emits raw sliced bits
(cpp/psk_soft.cpp:502-566) and leaves FEC to downstream REDHAWK components
(every deployed PSK link runs one -- the classic chain is the K=7 rate-1/2
convolutional code with Viterbi decoding).  This module provides that layer,
designed as batched array programs rather than as a translation of a
sequential decoder:

- **Encoder** -- y_j[t] = parity(g_j & [u[t] .. u[t-K+1]]): K static-shifted
  XORs over the whole bit plane (the branch-FMA pattern in GF(2)), one
  launch for any number of channels/frames.
- **Branch metrics from the constellation** -- :func:`psk_llrs` computes
  max-log per-bit LLRs against the framework's own soft-decision
  conventions (ops/slicers.py labeling, QPSK +pi/4 rotation) as one
  (..., S, M) distance reduction: soft-decision decoding composes directly
  with the demod output, no re-slicing loss.
- **Viterbi ACS as a dense gather/scan** -- the trellis is static: for
  2^(K-1) states the two predecessors and their expected code bits are
  host-precomputed index planes; each time step is two gathers + one
  select over the whole state vector (no data-dependent control flow),
  run under ``jax.lax.scan`` with the path-metric vector as carry.
  Traceback is a second (reverse) scan over the stored decision planes.
  ``vmap`` batches frames/channels; every shape is static.

The per-step state recursion is inherently sequential in time (each ACS
depends on the previous path metrics), so throughput comes from batching:
decode B frames in one launch and the (B, S) metric plane fills the
vector lanes.  On a GPU the frame decode runs in one kernel instead
(ops/pallas/viterbi_kernel.py): the scan's per-step launches dominate
there.  This matches the frame-oriented use here (FrameSyncer payloads);
a streaming sliding-window decoder would trade optimality for latency.

Conventions:

- Polynomials are given as integers (octal literals read naturally:
  ``0o171``); bit (K-1) (MSB) taps the *current* input bit u[t], bit 0
  the oldest u[t-K+1] -- the standard (171, 133) NASA/Voyager code and
  the (7, 5) textbook code come out in their published forms.
- State s_t packs (u[t-1] .. u[t-K+1]) with u[t-1] as the high bit, so
  the transition is ``s' = (u << (K-2)) | (s >> 1)`` and the input bit
  that *entered* state s' is its high bit (used by the traceback).
- Soft values are "positive means bit 0" log-likelihood ratios; hard
  bits b map to LLR 1-2b (:func:`hard_llrs`).
- ``terminate=True`` (default) appends/assumes K-1 zero flush bits so
  the decoder pins the final state (the frame mode); ``terminate=False``
  starts/ends on the best surviving state (truncated decode).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_MAX_K = 10          # 512 states


def _resolve_backend(backend: str) -> str:
    """'auto' -> the Pallas kernel on a GPU, the XLA scan on the CPU.

    The two backends are bit-identical on decoded output (gated in
    tests/test_viterbi_kernel.py); 'pallas' on the CPU runs the kernel in
    the Pallas interpreter, for those tests.
    """
    if backend == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "xla"
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown viterbi backend {backend!r}")
    return backend


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Rate 1/n convolutional code.

    Attributes:
      k: constraint length K (memory K-1).
      polys: n generator polynomials, MSB = current input bit.
      puncture: optional (period, n) 0/1 keep-mask applied to the
        interleaved output stream (rate becomes period / kept).
    """

    k: int = 7
    polys: tuple = (0o171, 0o133)
    puncture: tuple | None = None

    def __post_init__(self):
        if not (2 <= self.k <= _MAX_K):
            raise ValueError(f"constraint length must be in [2, {_MAX_K}]")
        if len(self.polys) < 2:
            raise ValueError("need at least 2 generator polynomials")
        for g in self.polys:
            if not (0 < g < (1 << self.k)):
                raise ValueError(f"polynomial {g:o} out of range for K={self.k}")
        if self.puncture is not None:
            p = np.asarray(self.puncture)
            if p.ndim != 2 or p.shape[1] != len(self.polys):
                raise ValueError("puncture mask must be (period, n)")
            if not p[0].all():
                raise ValueError("puncture mask must keep the first column "
                                 "(decoder alignment)")
            if p.sum() <= p.shape[0]:
                raise ValueError("puncture mask keeps too few bits (rate > 1)")

    @property
    def n(self) -> int:
        return len(self.polys)

    @property
    def states(self) -> int:
        return 1 << (self.k - 1)

    @property
    def rate(self) -> float:
        if self.puncture is None:
            return 1.0 / self.n
        p = np.asarray(self.puncture)
        return p.shape[0] / float(p.sum())


# Presets: the two codes everything in the field interoperates with, plus
# the 4-state textbook code (small enough to check a trellis by hand).
CODE_K7 = ConvCode(7, (0o171, 0o133))
# K=9 has 4x the trellis states of K=7: the coding-gain vs throughput
# trade, documented at the user-facing surfaces (CLI --fec/--fec-stream).
CODE_K9 = ConvCode(9, (0o561, 0o753))
CODE_K3 = ConvCode(3, (0o7, 0o5))
# DVB-S puncturing of the K=7 code.
PUNCTURE_2_3 = ((1, 1), (1, 0))
PUNCTURE_3_4 = ((1, 1), (1, 0), (0, 1))


def _tap_planes(code: ConvCode) -> np.ndarray:
    """(n, K) int8 tap matrix; column i multiplies u[t-i]."""
    taps = np.zeros((code.n, code.k), np.int8)
    for j, g in enumerate(code.polys):
        for i in range(code.k):
            taps[j, i] = (g >> (code.k - 1 - i)) & 1
    return taps


def conv_encode(code: ConvCode, bits, terminate: bool = True) -> jnp.ndarray:
    """Encode a (..., N) 0/1 bit plane -> (..., (N[+K-1]) * n) code bits.

    Output is interleaved [y_0[0], y_1[0], ..., y_0[1], ...]; with
    ``terminate`` the K-1 zero flush bits are appended first.  Puncturing
    (if configured) drops masked positions.  One launch for any batch.
    """
    u = jnp.asarray(bits).astype(jnp.int8)
    if terminate:
        flush = jnp.zeros(u.shape[:-1] + (code.k - 1,), jnp.int8)
        u = jnp.concatenate([u, flush], axis=-1)
    t = u.shape[-1]
    taps = _tap_planes(code)
    # Zero history before the first bit: pad K-1 zeros on the left.
    pad = jnp.zeros(u.shape[:-1] + (code.k - 1,), jnp.int8)
    uu = jnp.concatenate([pad, u], axis=-1)
    outs = []
    for j in range(code.n):
        acc = jnp.zeros_like(u)
        for i in range(code.k):
            if taps[j, i]:
                acc = acc ^ jax.lax.slice_in_dim(
                    uu, code.k - 1 - i, code.k - 1 - i + t, axis=-1)
        outs.append(acc)
    y = jnp.stack(outs, axis=-1)                 # (..., T, n)
    y = y.reshape(y.shape[:-2] + (t * code.n,))
    if code.puncture is not None:
        keep = np.asarray(code.puncture, bool).reshape(-1)
        mask = np.resize(keep, t * code.n)
        y = y[..., np.flatnonzero(mask)]
    return y


def info_bits_for(code: ConvCode, code_bit_count: int,
                  terminate: bool = True) -> int:
    """Information bits carried by ``code_bit_count`` transmitted bits.

    Validates divisibility against the (punctured) code and flush-bit
    room; the shared contract between the TX framer (ops/tx.py) and the
    frame decoder (runtime/fec.py).
    """
    if code.puncture is not None:
        p = np.asarray(code.puncture)
        keep = int(p.sum())
        if code_bit_count % keep:
            raise ValueError(
                f"{code_bit_count} code bits is not a multiple of the "
                f"puncture period's kept count {keep}")
        # Each mask row covers ONE trellis step (n raw bits), so a
        # period of p.shape[0] rows spans p.shape[0] steps.
        steps = (code_bit_count // keep) * p.shape[0]
    else:
        if code_bit_count % code.n:
            raise ValueError(f"{code_bit_count} code bits is not a "
                             f"multiple of n={code.n}")
        steps = code_bit_count // code.n
    if terminate and steps <= code.k - 1:
        raise ValueError(f"{steps} trellis steps cannot carry the "
                         f"K-1={code.k - 1} flush bits")
    return steps - (code.k - 1 if terminate else 0)


def hard_llrs(code_bits) -> jnp.ndarray:
    """Hard 0/1 code bits -> +/-1 soft values (positive = bit 0)."""
    b = jnp.asarray(code_bits)
    return (1 - 2 * b).astype(jnp.float32)


def depuncture(code: ConvCode, llrs) -> jnp.ndarray:
    """Re-insert zero-LLR erasures at punctured positions.

    Input is the punctured (..., L) soft stream; output is the full-rate
    (..., T*n) stream the trellis expects.  The kept-position scatter is a
    static gather (host-precomputed index plane).
    """
    y = jnp.asarray(llrs, jnp.float32)
    if code.puncture is None:
        return y
    keep = np.asarray(code.puncture, bool).reshape(-1)
    l = y.shape[-1]
    period = keep.sum()
    if l % period:
        raise ValueError(f"punctured length {l} not a multiple of the "
                         f"kept-per-period count {period}")
    reps = l // period
    full = reps * keep.size
    # dst[i] = position in the full stream of kept bit i.
    dst = np.flatnonzero(np.resize(keep, full))
    out = jnp.zeros(y.shape[:-1] + (full,), jnp.float32)
    return out.at[..., dst].set(y)


def _trellis(code: ConvCode):
    """Host-precomputed trellis planes.

    Returns (pred, exp_sign):
      pred: (S, 2) int32 -- the two predecessor states of each state
        (differing in the oldest register bit).
      exp_sign: (S, 2, n) float32 -- +/-1 expected code-bit signs on the
        transition pred[s', p] -> s' (sign = 1 - 2*bit, matching the LLR
        convention).
    """
    k, s_count, taps = code.k, code.states, _tap_planes(code)
    s_prime = np.arange(s_count, dtype=np.int64)
    u = s_prime >> (k - 2)                       # input bit entering s'
    pred0 = (s_prime << 1) & (s_count - 1)
    pred = np.stack([pred0, pred0 | 1], axis=1)  # (S, 2)
    exp = np.zeros((s_count, 2, code.n), np.float32)
    for p in range(2):
        # Register at the transition: [u[t], u[t-1], ..., u[t-K+1]].
        reg = (u << (k - 1)) | pred[:, p]
        for j in range(code.n):
            g = code.polys[j]
            bits = np.zeros(s_count, np.int64)
            for i in range(k):
                if (g >> (k - 1 - i)) & 1:
                    bits ^= (reg >> (k - 1 - i)) & 1
            exp[:, p, j] = 1.0 - 2.0 * bits
    return pred.astype(np.int32), exp


def _make_acs(exp_sign):
    # Butterfly structure instead of a gather: states s' and s' + S/2
    # share the predecessor pair {2j, 2j+1} with j = s' mod S/2, so
    # pm[:, pred] == tile(pm.reshape(B, S/2, 2), S-axis x2) -- a pure
    # relayout, no per-step gather.
    s_count = exp_sign.shape[0]

    def acs(pm, r_t):
        # r_t: (B, n).  Branch metric of transition p -> s': correlation
        # of the received LLRs with the expected signs.  HIGHEST: the
        # signs are exact but the LLRs are not in TF32, and the kernel
        # twin sums the same float32 products.
        bm = jnp.einsum("bn,spn->bsp", r_t, exp_sign,
                        precision=jax.lax.Precision.HIGHEST)  # (B, S, 2)
        b = pm.shape[0]
        pairs = pm.reshape(b, s_count // 2, 2)
        cand = jnp.concatenate([pairs, pairs], axis=1) + bm  # (B, S, 2)
        dec = (cand[..., 1] > cand[..., 0])                  # (B, S) bool
        new = jnp.where(dec, cand[..., 1], cand[..., 0])
        # Re-zero against state 0's metric, not the max: any per-row
        # constant bounds the growth (survivor metrics stay within the
        # merge-depth spread of each other) and decisions compare within a
        # row so the reference choice cancels.  The kernel mirrors this
        # term for term (ops/pallas/viterbi_kernel.py) so bit parity is
        # preserved.
        new = new - new[:, 0:1]                              # re-zero
        return new, dec

    return acs


def _make_back(k: int, s_count: int):
    # One-hot contraction instead of a per-row dynamic gather (S <= 512
    # keeps this cheap).
    def back(s, dec_t):
        u = (s >> (k - 2)).astype(jnp.int8)
        onehot = (jnp.arange(s_count, dtype=jnp.int32)[None, :]
                  == s[:, None])
        p = jnp.sum(jnp.where(onehot, dec_t, False).astype(jnp.int32),
                    axis=1)
        s_prev = ((s << 1) & (s_count - 1)) | p
        return s_prev, u

    return back


@functools.partial(jax.jit, static_argnames=("k", "s_count", "terminate",
                                             "unroll"))
def _viterbi(llrs, exp_sign, k: int, s_count: int, terminate: bool,
             unroll: int = 1):
    """(B, T, n) LLRs -> (B, T) decoded bits (incl. flush bits).
    ``unroll`` steps per scan iteration (timing comparisons only)."""
    b = llrs.shape[0]
    neg = jnp.float32(-1e9)
    pm0 = jnp.full((b, s_count), neg).at[:, 0].set(0.0)
    pm, decs = jax.lax.scan(_make_acs(exp_sign), pm0,
                            jnp.swapaxes(llrs, 0, 1), unroll=unroll)
    start = (jnp.zeros(b, jnp.int32) if terminate
             else jnp.argmax(pm, axis=1).astype(jnp.int32))
    # decs stacks per-step decisions time-major: (T, B, S).
    _, bits_rev = jax.lax.scan(_make_back(k, s_count), start, decs[::-1],
                               unroll=unroll)
    return jnp.swapaxes(bits_rev[::-1], 0, 1)                # (B, T)


@functools.partial(jax.jit, static_argnames=("k", "s_count"))
def _viterbi_stream_block(llrs, pm, dec_hist, exp_sign,
                          k: int, s_count: int):
    """One streaming block: ACS over T new steps + windowed traceback.

    Args:
      llrs: (B, T, n) new soft steps.
      pm: (B, S) carried path metrics.
      dec_hist: (D, B, S) carried decision planes (oldest first).

    Returns (pm', dec_hist', bits): the emitted (B, T) bits are the
    OLDEST T of the traceback from the current best state through all
    D+T decisions -- i.e. delayed by the traceback depth D, by which
    point all survivors have merged (the standard windowed-Viterbi
    argument; D ~ 8-10 constraint lengths).
    """
    t = llrs.shape[1]
    d = dec_hist.shape[0]
    pm2, decs = jax.lax.scan(_make_acs(exp_sign), pm,
                             jnp.swapaxes(llrs, 0, 1))
    full = jnp.concatenate([dec_hist, decs], axis=0)         # (D+T, B, S)
    start = jnp.argmax(pm2, axis=1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(_make_back(k, s_count), start, full[::-1])
    bits = jnp.swapaxes(bits_rev[::-1], 0, 1)                # (B, D+T)
    return pm2, full[t:] if d else full[:0], bits[:, :t]


@functools.partial(jax.jit, static_argnames=("k", "s_count"))
def _viterbi_stream_tail(pm, dec_hist, k: int, s_count: int):
    """Flush: traceback of the carried window from the current best state."""
    start = jnp.argmax(pm, axis=1).astype(jnp.int32)
    _, bits_rev = jax.lax.scan(_make_back(k, s_count), start, dec_hist[::-1])
    return jnp.swapaxes(bits_rev[::-1], 0, 1)                # (B, D)


class ViterbiStreamState(NamedTuple):
    """Carry of the windowed streaming decoder (see viterbi_stream_*)."""

    pm: jnp.ndarray        # (B, S) float32 path metrics
    dec: jnp.ndarray       # (D, B, S) bool decision window, oldest first


def viterbi_stream_init(code: ConvCode, batch: int, depth: int,
                        known_start: bool = True) -> ViterbiStreamState:
    """Fresh streaming-decoder carry.

    ``depth`` is the traceback window D in trellis steps (use >= 8-10
    constraint lengths; emitted bits lag the input by D steps and the
    first D emitted bits are pre-stream garbage the caller discards --
    runtime/fec.StreamFecDecoder handles both).  ``known_start`` pins the
    initial state to 0 (encoder reset); False starts uniform (mid-stream
    pickup, converges within the window).
    """
    if depth < code.k:
        raise ValueError(f"traceback depth {depth} below the constraint "
                         f"length {code.k}")
    s_count = code.states
    if known_start:
        pm = np.full((batch, s_count), -1e9, np.float32)
        pm[:, 0] = 0.0
    else:
        pm = np.zeros((batch, s_count), np.float32)
    return ViterbiStreamState(
        pm=jnp.asarray(pm),
        dec=jnp.zeros((depth, batch, s_count), bool))


def viterbi_stream_step(code: ConvCode, state: ViterbiStreamState, llrs):
    """Feed (B, T, n) soft steps; returns (state', (B, T) delayed bits).

    Emitted bit t of this call decodes the trellis step D positions
    before it (D = window depth): the caller sees the stream shifted by
    D steps.  Puncturing: depuncture before calling (period-aligned
    blocks need no phase carry).  The carry is plain arrays, so a stream
    checkpoints and restores on any platform.
    """
    y = jnp.asarray(llrs, jnp.float32)
    if y.ndim != 3 or y.shape[-1] != code.n:
        raise ValueError(f"expected (B, T, {code.n}) LLR steps; "
                         f"got {y.shape}")
    _, exp_sign = _trellis(code)
    pm, dec, bits = _viterbi_stream_block(
        y, state.pm, state.dec, jnp.asarray(exp_sign),
        code.k, code.states)
    return ViterbiStreamState(pm=pm, dec=dec), bits


def viterbi_stream_flush(code: ConvCode, state: ViterbiStreamState):
    """End of stream: decode the bits still inside the window."""
    return _viterbi_stream_tail(state.pm, state.dec, code.k, code.states)


def viterbi_decode_parallel(code: ConvCode, llrs, chunk: int = 512,
                            margin: int | None = None,
                            backend: str = "auto"):
    """Time-parallel Viterbi: overlap-save over the trellis.

    The sequential ACS recursion bounds ``viterbi_decode`` wall time by
    the stream length.  This recast applies the framework's overlap-save
    pattern to the trellis: split the T steps into P chunks, give each a
    ``margin``-step lead-in (path metrics start uniform and converge to
    the true survivors within the survivor-merge depth) and a
    ``margin``-step tail (the traceback from the chunk end converges
    back within the same depth), and run ALL chunks as extra batch rows
    of one short scan -- wall time ~ (chunk + 2*margin) steps instead of
    T, at (1 + 2*margin/chunk)x the FLOPs.  With margin >= ~10
    constraint lengths the output is EXACT vs the sequential decode
    (same argument as the streaming window; gated in tests).

    Args:
      llrs: (..., L) soft code bits (punctured ok), terminate=False
        semantics (truncated decode; frame mode with flush bits wants
        the sequential path, whose T is small anyway).
      chunk: steps decoded per parallel chunk.
      margin: two-sided overlap in steps (default 10 * K).

    Returns:
      (..., T) int8 decoded bits.
    """
    if margin is None:
        margin = 10 * code.k
    y = depuncture(code, jnp.asarray(llrs, jnp.float32))
    l = y.shape[-1]
    if l % code.n:
        raise ValueError(f"LLR length {l} not a multiple of n={code.n}")
    t = l // code.n
    lead = y.shape[:-1]
    steps = y.reshape((-1, t, code.n))
    b = steps.shape[0]
    if chunk < 1 or margin < code.k:
        raise ValueError("need chunk >= 1 and margin >= K")
    if t <= chunk + 2 * margin:
        return viterbi_decode(code, llrs, terminate=False, backend=backend)
    p = -(-t // chunk)                           # chunks
    span = chunk + 2 * margin
    # Window p covers steps [p*chunk - margin, p*chunk + chunk + margin).
    # Leading pad: STRONG bit-0 LLRs -- the all-zero path reproduces the
    # encoder's zero start state exactly (the known-start pin the
    # sequential decode uses).  Trailing pad: zero LLRs (erasures; the
    # truncated decode ends at argmax either way).
    pad_hi = p * chunk + margin - t
    big = jnp.full(steps.shape[:1] + (margin, code.n), 1e4, jnp.float32)
    padded = jnp.concatenate(
        [big, steps, jnp.zeros(steps.shape[:1] + (pad_hi, code.n),
                               jnp.float32)], axis=1)
    starts = np.arange(p) * chunk
    wins = jnp.stack([jax.lax.slice_in_dim(padded, int(s), int(s) + span,
                                           axis=1) for s in starts],
                     axis=1)                     # (B, P, span, n)
    wins = wins.reshape(b * p, span, code.n)
    # _viterbi starts every row pinned at state 0; for windows past the
    # head that pin is wrong, but the margin lead-in re-converges the
    # metrics to the true survivors before the emitted region (the same
    # cold-acquisition property the streaming window relies on) -- so
    # the uniform-vs-pinned distinction washes out within the margin.
    if _resolve_backend(backend) == "pallas":
        from .pallas.viterbi_kernel import _decode_steps, butterfly_signs
        bits = _decode_steps(
            wins, jnp.asarray(butterfly_signs(code)), k=code.k, n=code.n,
            terminate=False)                     # (B*P, span)
    else:
        _, exp_sign = _trellis(code)
        bits = _viterbi(wins, jnp.asarray(exp_sign), code.k, code.states,
                        False)                   # (B*P, span)
    bits = bits.reshape(b, p, span)[:, :, margin:margin + chunk]
    bits = bits.reshape(b, p * chunk)[:, :t]
    return bits.reshape(lead + (t,))


def make_stream_soft_fn(code: ConvCode, m: int, labeling: str = "scd"):
    """fn(state, soft) -> (state', bits): the whole streaming-FEC block
    (constellation LLRs -> depuncture -> ACS scan -> windowed traceback)
    as ONE compiled program.

    Only the (B, S_sym) soft block goes up and the (B, T) int8 bits come
    down -- the intermediate LLR planes never cross the host boundary.
    ``soft`` must carry a whole number of (puncture-period- and
    symbol-aligned) trellis steps; runtime/fec.StreamFecDecoder does the
    chunk bookkeeping.
    """
    _, exp_sign = _trellis(code)
    exp = jnp.asarray(exp_sign)
    k, s_count = code.k, code.states

    @jax.jit
    def step(state: ViterbiStreamState, soft):
        llr = psk_llrs(m, soft, labeling=labeling)       # (B, S_sym, nb)
        wire = llr.reshape(soft.shape[0], -1)
        full = depuncture(code, wire)
        steps = full.reshape(soft.shape[0], -1, code.n)
        pm, dec, bits = _viterbi_stream_block.__wrapped__(
            steps, state.pm, state.dec, exp, k, s_count)
        return ViterbiStreamState(pm=pm, dec=dec), bits

    return step


def viterbi_decode(code: ConvCode, llrs, terminate: bool = True,
                   backend: str = "auto"):
    """Maximum-likelihood decode of (..., L) soft code bits -> (..., N) bits.

    Args:
      code: the convolutional code (puncturing honored via
        :func:`depuncture`).
      llrs: soft values, positive = bit 0 (see :func:`hard_llrs` for hard
        input); length must cover a whole number of trellis steps.
      terminate: the stream ends with K-1 zero flush bits (frame mode):
        the final state is pinned to 0 and flush bits are stripped.
      backend: 'auto' (the Pallas kernel on a GPU, the XLA scan on the
        CPU), 'xla', or 'pallas'; decoded bits are identical either way.

    Returns:
      (..., N) int8 decoded information bits, N = T - (K-1) if terminated.
    """
    if _resolve_backend(backend) == "pallas":
        from .pallas.viterbi_kernel import viterbi_decode_pallas
        return viterbi_decode_pallas(code, llrs, terminate=terminate)
    y = depuncture(code, jnp.asarray(llrs, jnp.float32))
    l = y.shape[-1]
    if l % code.n:
        raise ValueError(f"LLR length {l} not a multiple of n={code.n}")
    t = l // code.n
    if terminate and t <= code.k - 1:
        raise ValueError(f"{t} trellis steps cannot carry K-1="
                         f"{code.k - 1} flush bits")
    lead = y.shape[:-1]
    y = y.reshape((-1, t, code.n))
    _, exp_sign = _trellis(code)
    bits = _viterbi(y, jnp.asarray(exp_sign),
                    code.k, code.states, terminate)
    if terminate:
        bits = bits[:, :t - (code.k - 1)]
    return bits.reshape(lead + (bits.shape[-1],))


def make_viterbi_fn(code: ConvCode, terminate: bool = True,
                    backend: str = "auto"):
    """fn(llrs) -> bits with the code closed over (jit-cached per shape)."""
    return functools.partial(viterbi_decode, code, terminate=terminate,
                             backend=backend)


# -- constellation LLRs -------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("m",))
def _llr_kernel(soft, pts_re, pts_im, bit_mask, m: int):
    # Squared distances to all M ideal points: (..., S, M).
    dr = soft.real[..., None] - pts_re
    di = soft.imag[..., None] - pts_im
    d2 = dr * dr + di * di
    big = jnp.float32(1e30)
    nb = bit_mask.shape[1]
    outs = []
    for i in range(nb):
        keep0 = 1.0 - bit_mask[:, i]
        d0 = jnp.min(d2 + big * bit_mask[:, i], axis=-1)
        d1 = jnp.min(d2 + big * keep0, axis=-1)
        outs.append(d1 - d0)
    return jnp.stack(outs, axis=-1)              # (..., S, nb)


def psk_llrs(m: int, soft, scale: float | None = None,
             labeling: str = "scd") -> jnp.ndarray:
    """Max-log per-bit LLRs for the framework's M-PSK soft decisions.

    Uses the same constellation convention as the demod output (angle
    2*pi*k/M, +pi/4 for QPSK) with the bit labeling selected by
    ``labeling`` (ops/slicers.bit_labels): "scd" = the documented port
    mapping, composing directly with the soft port / FrameSyncer
    payloads; "gray" = binary-reflected Gray, the coded-transmission
    mapping that puts M-PSK on the union bound (eval/coded.py).
    LLR_i = (d1_i - d0_i) * scale with d_b the squared distance to the
    nearest point whose bit i equals b; positive = bit 0.  The default
    scale normalizes by the mean squared magnitude so hard-decision
    magnitudes are O(1); pass 1/(2*sigma^2) for calibrated LLRs when the
    noise variance is known.

    Args:
      m: constellation size (2..32 power of two).
      soft: (..., S) complex soft decisions.
      scale: optional LLR scale.
      labeling: "scd" (default) or "gray".

    Returns:
      (..., S, log2(m)) float32 LLR planes.
    """
    from . import slicers
    from .framesync import psk_points

    if m not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported constellation size {m}")
    pts = psk_points(np.arange(m), m)
    labels = slicers.bit_labels(m, labeling)
    if isinstance(soft, np.ndarray):
        soft = jnp.asarray(soft)
    llr = _llr_kernel(soft,
                      jnp.asarray(np.ascontiguousarray(pts.real, np.float32)),
                      jnp.asarray(np.ascontiguousarray(pts.imag, np.float32)),
                      jnp.asarray(labels.astype(np.float32)), m)
    if scale is None:
        p = jnp.mean(soft.real * soft.real + soft.imag * soft.imag,
                     axis=-1, keepdims=True)
        llr = llr / jnp.maximum(p[..., None], 1e-12)
    else:
        llr = llr * jnp.float32(scale)
    return llr
