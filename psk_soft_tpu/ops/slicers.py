"""Symbol -> bit slicers for BPSK / QPSK / 8-PSK (+ 16/32-PSK extension).

Implements the *documented* sign-based Gray-ish mapping from the reference's
port description (``psk_soft.scd.xml:42-63``), emitting bits LSB-first like
the reference (``cpp/psk_soft.cpp:502-566``).

Deliberate deviation from the reference implementation: the reference QPSK
slicer (``cpp/psk_soft.cpp:523-524``) converts the float real/imag parts to
``bool`` (nonzero -> true) instead of testing their *sign*, so for any nonzero
input it emits all-zero bits.  The reference's own tests never assert on the
bits port, so the bug survives there; we implement the documented quadrant
mapping instead (sign tests), which is what ``psk_soft.scd.xml:47-51``
specifies.

All slicers are branch-free and vectorized over arbitrary leading axes; each
returns an ``(..., 3)`` int8 array padded with zeros past ``bits_per_symbol``
so that mixed-constellation channel batches have a uniform shape.
"""

from __future__ import annotations

import jax.numpy as jnp


def slice_bpsk(soft: jnp.ndarray) -> jnp.ndarray:
    """BPSK: phase 0 -> 0, pi -> 1 (cpp/psk_soft.cpp:503-513)."""
    b0 = (soft.real < 0).astype(jnp.int8)
    z = jnp.zeros_like(b0)
    return jnp.stack([b0, z, z], axis=-1)


def slice_qpsk(soft: jnp.ndarray) -> jnp.ndarray:
    """QPSK quadrants per psk_soft.scd.xml:47-51, LSB-first.

    Quadrant (+,+) -> 00, (-,+) -> 01, (-,-) -> 10, (+,-) -> 11 where the
    value is ``b0 + 2*b1`` and bits are emitted [b0, b1].
    """
    sr = (soft.real < 0).astype(jnp.int8)
    si = (soft.imag < 0).astype(jnp.int8)
    b0 = sr ^ si
    b1 = si
    return jnp.stack([b0, b1, jnp.zeros_like(b0)], axis=-1)


def slice_8psk(soft: jnp.ndarray) -> jnp.ndarray:
    """8-PSK: phase k*pi/4 -> binary k, LSB-first (cpp/psk_soft.cpp:528-564).

    theta in (-pi, pi] -> softsym = theta/pi*4 in (-4, 4]; wrap values below
    -0.5 up by +8; round to nearest (ties toward +inf, matching C ``round``
    for the positive range) and keep the 3 LSBs so that 8 aliases to 0.
    """
    theta = jnp.arctan2(soft.imag, soft.real)
    softsym = theta / jnp.pi * 4.0
    softsym = jnp.where(softsym < -0.5, softsym + 8.0, softsym)
    sym = jnp.floor(softsym + 0.5).astype(jnp.int32) & 7
    b0 = (sym & 1).astype(jnp.int8)
    b1 = ((sym >> 1) & 1).astype(jnp.int8)
    b2 = ((sym >> 2) & 1).astype(jnp.int8)
    return jnp.stack([b0, b1, b2], axis=-1)


def mpsk_code(m: int, soft: jnp.ndarray) -> jnp.ndarray:
    """Generalized M-PSK symbol index for power-of-two m >= 8.

    The same mapping the reference's 8-PSK slicer implements
    (cpp/psk_soft.cpp:528-564) with 8 replaced by m: phase k*2pi/M -> binary
    k.  ``theta/(2pi/m)`` lands symbol k near k; values below -0.5 wrap up by
    +m; round to nearest; m aliases to 0 via the low-bits mask.  16/32-PSK
    are an extension beyond the reference (which warns "unsupported M",
    cpp/psk_soft.cpp:565-566).
    """
    theta = jnp.arctan2(soft.imag, soft.real)
    softsym = theta * (m / (2.0 * jnp.pi))
    softsym = jnp.where(softsym < -0.5, softsym + m, softsym)
    return jnp.floor(softsym + 0.5).astype(jnp.int32) & (m - 1)


def slice_mpsk(m: int, soft: jnp.ndarray) -> jnp.ndarray:
    """Generalized M-PSK slicer (power-of-two m >= 8), LSB-first bit planes.

    Returns ``(..., max(3, log2 m))`` int8 to stay layout-compatible with the
    3-wide planes of the {2, 4, 8} slicers.
    """
    nb = max(3, (m - 1).bit_length())
    sym = mpsk_code(m, soft)
    return jnp.stack([((sym >> i) & 1).astype(jnp.int8) for i in range(nb)],
                     axis=-1)


def slice_bits(constellation_size: int, soft: jnp.ndarray) -> jnp.ndarray:
    """Dispatch on the (static) constellation size.

    Output width is 3 for M in {2, 4, 8} (zero-padded past bits_per_symbol)
    and log2(M) for the 16/32-PSK extension.
    """
    if constellation_size == 2:
        return slice_bpsk(soft)
    if constellation_size == 4:
        return slice_qpsk(soft)
    if constellation_size in (8, 16, 32):
        return slice_mpsk(constellation_size, soft)
    raise ValueError(f"unsupported constellation size {constellation_size}")


def slice_code(constellation_size: int, soft: jnp.ndarray) -> jnp.ndarray:
    """Packed (LSB-first) symbol code for a static M."""
    if constellation_size == 2:
        return (soft.real < 0).astype(jnp.int32)
    if constellation_size == 4:
        sr = (soft.real < 0).astype(jnp.int32)
        si = (soft.imag < 0).astype(jnp.int32)
        return (sr ^ si) + 2 * si
    if constellation_size in (8, 16, 32):
        return mpsk_code(constellation_size, soft)
    raise ValueError(f"unsupported constellation size {constellation_size}")


def slice_code_dynamic(m_size: jnp.ndarray, soft: jnp.ndarray) -> jnp.ndarray:
    """Packed symbol code with a *traced* per-element constellation size.

    Branch-free: each branch produces a packed symbol code and the traced M
    selects (the mixed-mode steady step uses it, models/full.py).
    ``m_size`` broadcasts against ``soft``.
    """
    m = jnp.broadcast_to(m_size, soft.shape)
    code2 = (soft.real < 0).astype(jnp.int32)
    sr = (soft.real < 0).astype(jnp.int32)
    si = (soft.imag < 0).astype(jnp.int32)
    code4 = (sr ^ si) + 2 * si
    # Generalized m >= 8 code with the traced m: theta*m/(2pi), wrap below
    # -0.5 up by +m, round, alias m -> 0.
    theta = jnp.arctan2(soft.imag, soft.real)
    mf = m.astype(jnp.float32)
    ss = theta * (mf / (2.0 * jnp.pi))
    ss = jnp.where(ss < -0.5, ss + mf, ss)
    codem = jnp.floor(ss + 0.5).astype(jnp.int32)
    mi = m.astype(jnp.int32)
    codem = jnp.where(codem >= mi, codem - mi, codem)
    return jnp.where(m == 2, code2, jnp.where(m == 4, code4, codem))


def slice_bits_dynamic(m_size: jnp.ndarray, soft: jnp.ndarray,
                       max_bits: int = 3) -> jnp.ndarray:
    """Slicer with a *traced* per-element constellation size.

    Used by the mixed-mode multi-channel path (BASELINE.json config 4), where
    each channel carries its own M.  ``m_size`` broadcasts against ``soft``.
    ``max_bits`` is the (static) output plane width: 3 covers banks of
    {2, 4, 8}; pass 4/5 (e.g. ``MixedParams.max_bits``) when the bank
    contains 16/32-PSK channels.
    """
    code = slice_code_dynamic(m_size, soft)
    return jnp.stack([((code >> i) & 1).astype(jnp.int8)
                      for i in range(max_bits)], axis=-1)


def bit_labels(m: int, labeling: str = "scd"):
    """(m, log2 m) int8 bit labels of symbol index k, LSB-first.

    labeling="scd": the documented port mapping above (the framework's
    wire contract).  labeling="gray": binary-reflected Gray code
    (label = k ^ (k >> 1)) -- adjacent constellation points differ in
    exactly one bit, which makes M-PSK behave as independent binary
    channels for soft-decision FEC (eval/coded.py measures the SCD
    quadrant mapping ~1-2 dB right of the union bound and the Gray
    mapping ON it; the coded TX/RX paths therefore default to taking a
    ``labeling`` argument).  Host numpy table; import-cycle-free.
    """
    import numpy as np

    if m not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported constellation size {m}")
    nb = max(int(np.log2(m)), 1)
    k = np.arange(m)
    if labeling == "gray":
        code = k ^ (k >> 1)
    elif labeling == "scd":
        # Pure-numpy replica of slice_code (this helper is called while
        # building constants inside jit traces, where eager jnp ops
        # would produce tracers).
        from .framesync import psk_points
        pts = psk_points(k, m)
        if m == 2:
            code = (pts.real < 0).astype(np.int64)
        elif m == 4:
            sr = (pts.real < 0).astype(np.int64)
            si = (pts.imag < 0).astype(np.int64)
            code = (sr ^ si) + 2 * si
        else:
            softsym = np.angle(pts) * (m / (2.0 * np.pi))
            softsym = np.where(softsym < -0.5, softsym + m, softsym)
            code = np.floor(softsym + 0.5).astype(np.int64) & (m - 1)
    else:
        raise ValueError(f"unknown labeling {labeling!r}")
    return ((code[:, None] >> np.arange(nb)) & 1).astype(np.int8)
