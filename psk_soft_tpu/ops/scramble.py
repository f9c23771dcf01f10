"""Scrambling / energy dispersal: LFSR sequences, array-first.

Extension beyond the reference: deployed PSK links scramble the bit stream
(energy dispersal / DC balance) and the receive chain must descramble it;
the reference emits raw sliced bits and leaves this to downstream REDHAWK
components.  Two standard constructions:

- **Additive (frame-synchronous)**: XOR with an LFSR keystream re-seeded
  at each frame start.  Self-inverse, no error propagation.  The LFSR is
  linear over GF(2), so a length-L keystream is a *linear map* of the
  r-bit seed: ks = seed @ K (mod 2) with a host-precomputed (r, L) basis
  matrix -- on device that is one int8 matmul with a parity reduction,
  i.e. keystream generation for a whole batch of frames is matmul work,
  not a sequential register walk.
- **Multiplicative (self-synchronizing)**: the *descrambler* is
  feed-forward -- y[n] = x[n] ^ x[n-t1] ^ x[n-t2] -- so it is tap-count
  static-shifted XOR planes over the whole stream (one launch, any batch);
  each channel bit error propagates to exactly ``taps`` output errors.
  The matching scrambler is the recursive (IIR-over-GF(2)) side; it lives
  on the transmit path, provided here as a ``lax.scan`` for completeness.

Polynomial convention: taps as an integer mask over state bits
``[x^{-1} .. x^{-r}]`` -- bit (r-1) is the oldest (x^{-r}) tap.  The ITU
O.150 PRBS generators are provided as presets: PRBS7 = x^7+x^6+1,
PRBS15 = x^15+x^14+1, PRBS23 = x^23+x^18+1 (each written as feedback
mask + degree).  Seed all-ones matches test-set convention.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

_MAX_DEGREE = 32
_MAX_BLOCK = 1 << 16     # keystream blocks are per-frame; the basis
#                          precompute is O(r * L) host work, cached


@dataclasses.dataclass(frozen=True)
class Lfsr:
    """Fibonacci LFSR over the output recurrence.

    State s with s_i = a[n+i]: s_0 is the next output bit, s_{r-1} the
    most recently fed-back bit.  Each step outputs s_0, computes the
    feedback a[n+r] = XOR of the masked s_i, and shifts.  For a
    characteristic polynomial x^r + x^k + 1 the recurrence is
    a[n+r] = a[n+k] ^ a[n], i.e. ``taps = (1 << k) | 1``.

    Attributes:
      degree: register length r.
      taps: feedback mask over s_0..s_{r-1} (bit i taps s_i).
      seed: initial state integer, bit i = s_i (default all-ones;
        must be nonzero).
    """

    degree: int
    taps: int
    seed: int | None = None

    def __post_init__(self):
        if not (2 <= self.degree <= _MAX_DEGREE):
            raise ValueError(f"degree must be in [2, {_MAX_DEGREE}]")
        if not (0 < self.taps < (1 << self.degree)):
            raise ValueError("taps mask out of range")
        s = self.seed_value
        if not (0 < s < (1 << self.degree)):
            raise ValueError("seed must be a nonzero r-bit state")

    @property
    def seed_value(self) -> int:
        return ((1 << self.degree) - 1) if self.seed is None else self.seed

    def seed_bits(self) -> np.ndarray:
        """(r,) int8 state bits, newest first."""
        return np.asarray([(self.seed_value >> i) & 1
                           for i in range(self.degree)], np.int8)


def prbs7(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS7: x^7 + x^6 + 1 (period 127)."""
    return Lfsr(7, (1 << 6) | 1, seed)


def prbs15(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS15: x^15 + x^14 + 1 (period 32767)."""
    return Lfsr(15, (1 << 14) | 1, seed)


def prbs23(seed: int | None = None) -> Lfsr:
    """ITU O.150 PRBS23: x^23 + x^18 + 1 (period 8388607)."""
    return Lfsr(23, (1 << 18) | 1, seed)


_PRESETS = {"prbs7": prbs7, "prbs15": prbs15, "prbs23": prbs23}


def lfsr_preset(name: str, seed: int | None = None) -> Lfsr:
    """Look up a named PRBS generator (prbs7 / prbs15 / prbs23)."""
    try:
        return _PRESETS[name](seed)
    except KeyError:
        raise ValueError(f"unknown LFSR preset {name!r}; "
                         f"have {sorted(_PRESETS)}") from None


@functools.lru_cache(maxsize=16)
def _basis_matrix(degree: int, taps: int, length: int) -> np.ndarray:
    """(r, L) GF(2) basis: row i is the keystream from basis seed e_i.

    By linearity, keystream(seed) = seed_bits @ basis (mod 2).  The basis
    row i is the recurrence run from e_i; all r rows extend together via
    the vectorized recurrence a[:, n] = XOR of tapped earlier columns
    (a[:, n+i] holds s_i, so the first r columns are the identity).
    Host precompute, cached per (lfsr, length).
    """
    r = degree
    tap_idx = np.flatnonzero([(taps >> i) & 1 for i in range(r)])
    a = np.zeros((r, length + r), np.int8)
    a[:, :r] = np.eye(r, dtype=np.int8)
    for n in range(length):
        v = a[:, n + tap_idx[0]].copy()
        for i in tap_idx[1:]:
            v ^= a[:, n + i]
        a[:, n + r] = v
    return np.ascontiguousarray(a[:, :length])


def keystream(lfsr: Lfsr, length: int) -> np.ndarray:
    """(length,) int8 keystream for the configured seed (host helper)."""
    k = _basis_matrix(lfsr.degree, lfsr.taps, length)
    return (lfsr.seed_bits() @ k) & 1


@jax.jit
def _xor_keystream(bits, seeds, basis):
    # GF(2) matmul: parity of the integer accumulation.  0/1 operands are
    # exact in TF32 and the sums exact in float32, so default precision
    # is exact here.
    ks = (seeds.astype(jnp.float32) @ basis.astype(jnp.float32))
    ks = ks.astype(jnp.int32) & 1
    return (bits.astype(jnp.int32) ^ ks).astype(jnp.int8)


def additive_scramble(lfsr: Lfsr, bits, seeds=None) -> jnp.ndarray:
    """XOR a (..., L) bit plane with per-row LFSR keystreams.

    Self-inverse: applying it twice (same seeds) returns the input --
    descrambling IS scrambling.  ``seeds`` is an optional (..., r) 0/1
    plane of per-row register states (frame-synchronous operation with
    per-frame seeds); default = the LFSR's configured seed broadcast to
    every row.  Keystream generation is one (rows, r) x (r, L) GF(2)
    matmul from the host-precomputed basis.
    """
    b = jnp.asarray(bits)
    l = b.shape[-1]
    if l > _MAX_BLOCK:
        raise ValueError(f"block of {l} bits exceeds {_MAX_BLOCK}")
    basis = _basis_matrix(lfsr.degree, lfsr.taps, l)
    if seeds is None:
        seeds_arr = jnp.asarray(
            np.broadcast_to(lfsr.seed_bits(), b.shape[:-1] + (lfsr.degree,)))
    else:
        seeds_arr = jnp.asarray(seeds).astype(jnp.int8)
        if seeds_arr.shape != b.shape[:-1] + (lfsr.degree,):
            raise ValueError(
                f"seeds shape {seeds_arr.shape} != {b.shape[:-1] + (lfsr.degree,)}")
    return _xor_keystream(b, seeds_arr, jnp.asarray(basis))


def selfsync_descramble(bits, taps: tuple) -> jnp.ndarray:
    """Self-synchronizing descrambler: y[n] = x[n] ^ x[n-t1] ^ ...

    ``taps`` are the delays (e.g. V.35-style (18, 23)); bits before the
    stream start are taken as 0 (the scrambler's zero preamble -- after
    max(taps) bits the output is correct regardless, that is the
    self-synchronizing property).  Feed-forward: len(taps) static-shifted
    XOR planes, one launch for any batch.
    """
    x = jnp.asarray(bits).astype(jnp.int8)
    t = x.shape[-1]
    d_max = max(taps)
    if min(taps) < 1:
        raise ValueError("tap delays must be >= 1")
    pad = jnp.zeros(x.shape[:-1] + (d_max,), jnp.int8)
    xx = jnp.concatenate([pad, x], axis=-1)
    y = x
    for d in taps:
        y = y ^ jax.lax.slice_in_dim(xx, d_max - d, d_max - d + t, axis=-1)
    return y


def selfsync_scramble(bits, taps: tuple) -> jnp.ndarray:
    """Transmit-side multiplicative scrambler (recursive over GF(2)).

    y[n] = x[n] ^ y[n-t1] ^ ... -- inherently sequential (IIR), run as a
    ``lax.scan`` carrying the last max(taps) outputs.  TX-path tool; the
    receive side uses the feed-forward :func:`selfsync_descramble`.
    """
    x = jnp.asarray(bits).astype(jnp.int8)
    d_max = max(taps)
    if min(taps) < 1:
        raise ValueError("tap delays must be >= 1")
    lead = x.shape[:-1]
    xf = jnp.moveaxis(x, -1, 0)                  # scan over time

    def step(hist, x_t):
        # hist: (..., d_max) last outputs, newest at index -1.
        y_t = x_t
        for d in taps:
            y_t = y_t ^ hist[..., d_max - d]
        hist = jnp.concatenate([hist[..., 1:], y_t[..., None]], axis=-1)
        return hist, y_t

    hist0 = jnp.zeros(lead + (d_max,), jnp.int8)
    _, y = jax.lax.scan(step, hist0, xf)
    return jnp.moveaxis(y, 0, -1)
