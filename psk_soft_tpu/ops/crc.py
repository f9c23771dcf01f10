"""Frame integrity: CRC computation/checking as GF(2) matmuls.

Extension beyond the reference: deployed framed links protect payloads
with a CRC; the reference emits raw bits and leaves integrity to
downstream components.  Like the LFSR keystream (ops/scramble.py), a CRC
is *linear* over GF(2) up to a constant:

    crc(m) = m @ G  ^  c0(len)        (all arithmetic mod 2)

with G a host-precomputed (L, d) basis (column j of row i = CRC of the
unit message e_i with zero init) and c0 the CRC of the zero message of
the same length under the real init/xorout.  So checking a whole batch
of frame payloads is ONE (rows, L) x (L, d) matmul with a parity
reduction -- matmul work, no serial register walk on the data path.

Bit-serial convention (non-reflected): message bits enter MSB-of-the-
polynomial first; ``crc_serial`` is the definitional register walk used
to build the basis and as the test oracle.  Presets:

- CRC-16/CCITT-FALSE: poly 0x1021, init 0xFFFF ("123456789" MSB-first
  bytes -> 0x29B1).
- CRC-32/MPEG-2: poly 0x04C11DB7, init 0xFFFFFFFF ("123456789" ->
  0x0376E6E7).

TX appends the CRC MSB-first (ops/tx.py / gen-frames --crc); RX checks
per drained frame batch (runtime/crc.FrameCrcChecker, demod-batch
--crc).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

_MAX_DEGREE = 32
_MAX_MSG = 1 << 16


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """Bit-serial (non-reflected) CRC parameters."""

    degree: int
    poly: int                # without the implicit x^degree term
    init: int = 0
    xorout: int = 0

    def __post_init__(self):
        if not (1 <= self.degree <= _MAX_DEGREE):
            raise ValueError(f"degree must be in [1, {_MAX_DEGREE}]")
        for name in ("poly", "init", "xorout"):
            v = getattr(self, name)
            if not (0 <= v < (1 << self.degree)):
                raise ValueError(f"{name} out of range for degree "
                                 f"{self.degree}")
        if self.poly % 2 == 0:
            raise ValueError("poly must have the x^0 term (odd integer)")


CRC16_CCITT = CrcSpec(16, 0x1021, init=0xFFFF)
CRC32_MPEG2 = CrcSpec(32, 0x04C11DB7, init=0xFFFFFFFF)
_PRESETS = {"crc16": CRC16_CCITT, "crc32": CRC32_MPEG2}


def crc_preset(name: str) -> CrcSpec:
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown CRC preset {name!r}; "
                         f"have {sorted(_PRESETS)}") from None


def crc_serial(spec: CrcSpec, bits, init: int | None = None) -> int:
    """Definitional register walk (host oracle / basis builder).

    Returns the CRC as an integer (xorout applied).
    """
    crc = spec.init if init is None else init
    top = 1 << (spec.degree - 1)
    mask = (1 << spec.degree) - 1
    for b in np.asarray(bits).reshape(-1):
        fb = ((crc & top) != 0) ^ (int(b) & 1)
        crc = (crc << 1) & mask
        if fb:
            crc ^= spec.poly
    return crc ^ spec.xorout


def _int_to_bits(v: int, d: int) -> np.ndarray:
    """Integer -> (d,) int8 bit plane, MSB first."""
    return np.asarray([(v >> (d - 1 - i)) & 1 for i in range(d)], np.int8)


@functools.lru_cache(maxsize=16)
def _crc_matrix(spec: CrcSpec, length: int):
    """((L, d) basis, (d,) const): crc_bits = bits @ G ^ const (mod 2).

    The basis is built in one vectorized register walk over L parallel
    unit messages (numpy bit-plane ops, host precompute, cached).
    """
    d = spec.degree
    # State: (L, d) int8 CRC registers, one per unit message, init 0.
    reg = np.zeros((length, d), np.int8)
    poly_bits = _int_to_bits(spec.poly, d)
    for n in range(length):
        # Entering bit of message e_i at step n is 1 iff i == n.
        fb = reg[:, 0].copy()
        fb[n] ^= 1
        reg[:, :-1] = reg[:, 1:]
        reg[:, -1] = 0
        reg ^= fb[:, None] * poly_bits
    c0 = crc_serial(spec, np.zeros(length, np.int8))
    return np.ascontiguousarray(reg), _int_to_bits(c0, d)


@jax.jit
def _crc_matmul(bits, basis, const):
    # 0/1 operands are exact in TF32 and the integer sums (< 2^24) are
    # exact in float32, so default precision is exact here.
    acc = bits.astype(jnp.float32) @ basis.astype(jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8) ^ const


def crc_bits(spec: CrcSpec, bits) -> jnp.ndarray:
    """(..., L) message bits -> (..., degree) CRC bit planes (MSB first).

    One GF(2) matmul for any batch; equals :func:`crc_serial` bitwise.
    """
    b = jnp.asarray(bits)
    l = b.shape[-1]
    if not (0 < l <= _MAX_MSG):
        raise ValueError(f"message length must be in [1, {_MAX_MSG}]")
    basis, const = _crc_matrix(spec, l)
    return _crc_matmul(b, jnp.asarray(basis), jnp.asarray(const))


def append_crc(spec: CrcSpec, bits) -> np.ndarray:
    """TX helper: message || CRC(message), MSB-first CRC field."""
    b = np.asarray(bits, np.int8)
    crc = np.asarray(crc_bits(spec, b), np.int8)
    return np.concatenate([b, crc], axis=-1)


def check_crc(spec: CrcSpec, bits):
    """(..., L+degree) received bits -> ((..., L) message, (...,) ok).

    Splits the trailing CRC field, recomputes over the message part in
    one batched matmul, and compares.
    """
    b = np.asarray(bits, np.int8)
    d = spec.degree
    if b.shape[-1] <= d:
        raise ValueError(f"need more than {d} bits (message + CRC)")
    msg, field = b[..., :-d], b[..., -d:]
    got = np.asarray(crc_bits(spec, msg), np.int8)
    ok = np.all(got == field, axis=-1)
    return msg, ok
