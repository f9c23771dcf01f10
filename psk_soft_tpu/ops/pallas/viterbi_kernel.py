"""Viterbi decoder kernel for NVIDIA GPUs (Pallas, Triton route).

The plain decoder (ops/fec._viterbi) runs the add-compare-select recursion
as a T-step ``lax.scan`` and the traceback as a second one; on a GPU every
step is a loop iteration of small launches.  Here one program owns a tile
of ``ROW_TILE`` decode rows and runs the whole trellis:

- **ACS in registers.**  The (rows, S) path-metric plane never leaves the
  program for the whole T loop.  States are held in *bit-reversed* order
  (position q holds state rev(q) over K-1 bits), which makes the butterfly
  a fixed shuffle: the two contiguous halves of the plane are the even and
  odd predecessors of one pair set, and interleaving the two successor
  halves puts the new plane back in bit-reversed order -- a split, a join,
  and no gather, in every step.
- **Bit-packed decisions.**  Each step's S decision bits are packed into
  S/32 int32 words per row (2 for K=7, 8 for K=9) and stored once: 2 MB at
  4096 rows x 64 steps, so they stay in L2.
- **Traceback in the same program** over those words, after a barrier.

Every length of trellis takes the same path: there is no time tiling and
no carry between programs.

Exactness: branch metrics, the strict ``>`` tie-break and the per-step
re-zeroing against state 0 mirror ops/fec._make_acs/_make_back term for
term, so decoded bits equal the XLA scan's (tests/test_viterbi_kernel.py;
ops/fec sets HIGHEST precision on its branch-metric einsum so both sides
sum the same float32 values).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Decode rows per program (4096 rows -> 256 programs for 132 SMs) and
# warps per program: the fastest of the tiles timed on the H100 (PERF.md).
ROW_TILE = 16
NUM_WARPS = 4


def _bit_reverse(q, bits: int):
    """Reverse the low ``bits`` bits of q (numpy or jnp int array)."""
    r = q & 0
    for i in range(bits):
        r = r | (((q >> i) & 1) << (bits - 1 - i))
    return r


def butterfly_signs(code) -> np.ndarray:
    """(2, 2, n, S/2) float32 expected code-bit signs in kernel order.

    Entry [a, p, j, i] is exp_sign[s', p, j] of ops/fec._trellis for the
    transition from the predecessor held in half p, slot i, of the
    bit-reversed plane into successor s' = (a << (K-2)) | rev(i), which the
    step writes to position 2i + a.
    """
    from ..fec import _trellis

    _, exp = _trellis(code)                       # (S, 2, n)
    s_half = exp.shape[0] // 2
    m = code.k - 1
    g = _bit_reverse(np.arange(s_half), m - 1)    # pair index per slot
    out = np.zeros((2, 2, exp.shape[2], s_half), np.float32)
    for a in range(2):
        succ = (a << (m - 1)) | g
        for p in range(2):
            out[a, p] = exp[succ, p].T
    return out


def _kernel(llr_ref, exp_ref, bits_ref, dec_ref, *, t_steps: int, n: int,
            m: int, terminate: bool, barrier: bool):
    """One tile of rows: llr (T, n, R), signs (2, 2, n, S/2) ->
    bits (T, R) int8, with decision words (T, R, W) int32 as scratch."""
    s_count = 1 << m
    half = s_count // 2
    rows = llr_ref.shape[2]
    per_word = min(32, s_count)
    n_words = s_count // per_word
    word_shift = per_word.bit_length() - 1
    signs = [[[exp_ref[a, p, j, :][None, :] for j in range(n)]
              for p in range(2)] for a in range(2)]
    pos = jax.lax.broadcasted_iota(jnp.int32, (rows, s_count), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (rows, half), 1)
    bitpos = jax.lax.broadcasted_iota(jnp.int32, (rows, n_words, per_word), 2)

    def acs(t, pm):
        r = [llr_ref[t, j, :][:, None] for j in range(n)]       # (R, 1)
        lo, hi = jnp.split(pm, 2, axis=1)        # predecessors p = 0 / 1
        new, dec = [], []
        for a in range(2):
            cand = []
            for p, prev in enumerate((lo, hi)):
                bm = signs[a][p][0] * r[0]
                for j in range(1, n):
                    bm = bm + signs[a][p][j] * r[j]
                cand.append(prev + bm)
            d = cand[1] > cand[0]                # strict: fec tie-break
            new.append(jnp.where(d, cand[1], cand[0]))
            dec.append(d)
        # State 0 sits at position 0 = slot 0 of the a=0 half.
        ref0 = jnp.sum(jnp.where(col == 0, new[0], 0.0), axis=1,
                       keepdims=True)
        pm = jnp.stack(new, axis=-1).reshape(rows, s_count) - ref0
        d = jnp.stack(dec, axis=-1).reshape(rows, n_words, per_word)
        words = jnp.sum(d.astype(jnp.int32) << bitpos, axis=2)  # (R, W)
        dec_ref[t, :, :] = words
        return pm

    pm0 = jnp.where(pos == 0, 0.0, -1e9).astype(jnp.float32)
    pm = jax.lax.fori_loop(0, t_steps, acs, pm0)
    if barrier:
        plgpu.debug_barrier()        # decision words visible block-wide
    if terminate:
        s = jnp.zeros((rows,), jnp.int32)
    else:                            # first max in natural state order
        state = _bit_reverse(pos, m)
        best = jnp.max(pm, axis=1, keepdims=True)
        s = jnp.min(jnp.where(pm == best, state, s_count), axis=1)
    widx = jax.lax.broadcasted_iota(jnp.int32, (rows, n_words), 1)

    def back(i, s):
        t = t_steps - 1 - i
        bits_ref[t, :] = (s >> (m - 1)).astype(jnp.int8)
        q = _bit_reverse(s, m)
        words = dec_ref[t, :, :]
        w = jnp.sum(jnp.where(widx == (q >> word_shift)[:, None], words, 0),
                    axis=1)
        p = (w >> (q & (per_word - 1))) & 1
        return ((s << 1) & (s_count - 1)) | p

    jax.lax.fori_loop(0, t_steps, back, s)


@functools.partial(jax.jit, static_argnames=("k", "n", "terminate",
                                             "row_tile", "num_warps"))
def _decode_steps(steps, signs, *, k: int, n: int, terminate: bool,
                  row_tile: int = ROW_TILE, num_warps: int = NUM_WARPS):
    """(B, T, n) LLR steps -> (B, T) int8 bits (flush bits included)."""
    b, t, _ = steps.shape
    m = k - 1
    s_count = 1 << m
    n_words = s_count // min(32, s_count)
    b_pad = -(-b // row_tile) * row_tile
    llr = jnp.transpose(steps, (1, 2, 0))                 # (T, n, B)
    if b_pad != b:
        llr = jnp.pad(llr, ((0, 0), (0, 0), (0, b_pad - b)))
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"the Viterbi kernel runs on a GPU (or the CPU "
                         f"interpreter), not on {platform!r}")
    interpret = platform == "cpu"
    kern = functools.partial(_kernel, t_steps=t, n=n, m=m,
                             terminate=terminate, barrier=not interpret)
    bits, _ = pl.pallas_call(
        kern,
        grid=(b_pad // row_tile,),
        in_specs=[
            pl.BlockSpec((t, n, row_tile), lambda i: (0, 0, i)),
            pl.BlockSpec(signs.shape, lambda i: (0, 0, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((t, row_tile), lambda i: (0, i)),
            pl.BlockSpec((t, row_tile, n_words), lambda i: (0, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((t, b_pad), jnp.int8),
            jax.ShapeDtypeStruct((t, b_pad, n_words), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="viterbi_acs_traceback",
    )(llr, signs)
    return bits[:, :b].T


def viterbi_decode_pallas(code, llrs, terminate: bool = True):
    """Kernel twin of ops/fec.viterbi_decode: same contract (puncturing
    honored, flush bits stripped when ``terminate``), bits equal to the
    XLA scan decoder.  Compiled on a GPU; on the CPU it runs in the Pallas
    interpreter (tests)."""
    from ..fec import depuncture

    y = depuncture(code, jnp.asarray(llrs, jnp.float32))
    l = y.shape[-1]
    if l % code.n:
        raise ValueError(f"LLR length {l} not a multiple of n={code.n}")
    t = l // code.n
    if terminate and t <= code.k - 1:
        raise ValueError(f"{t} trellis steps cannot carry K-1="
                         f"{code.k - 1} flush bits")
    lead = y.shape[:-1]
    steps = y.reshape((-1, t, code.n))
    bits = _decode_steps(steps, jnp.asarray(butterfly_signs(code)),
                         k=code.k, n=code.n, terminate=terminate)
    if terminate:
        bits = bits[:, :t - (code.k - 1)]
    return bits.reshape(lead + (bits.shape[-1],))
