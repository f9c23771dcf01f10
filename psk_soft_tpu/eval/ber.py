"""BER / SER measurement under real AWGN, frequency offset, and pulse shaping.

The reference never measures error rate (its tests use noise amplitude 1e-4,
tests/test_psk_soft.py:116); BASELINE.json config 3 calls for an Es/N0 BER
sweep.  This module runs the feed-forward pipeline over generated channels,
resolves the M-fold phase ambiguity of M-th-power carrier recovery and any
group delay (matched filter / timing) by a short probe-prefix search -- the
same role as the reference test helper ``getDelay``
(tests/test_psk_soft.py:43-57) -- then counts symbol and bit errors against
the documented slicer mapping.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig
from ..models.blockpsk import ff_init, make_ff_demod_fn
from ..ops import slicers
from ..testing.signals import gen_psk_channel


def qfunc(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return 0.5 * np.array([math.erfc(v / math.sqrt(2.0)) for v in x.ravel()]
                          ).reshape(x.shape)


def theoretical_ber(m: int, esn0_db: np.ndarray) -> np.ndarray:
    """Gray-coded coherent M-PSK bit-error probability (standard approximations).

    Es/N0 is per *decision sample* (for unfiltered rectangular pulses each
    sample carries the full symbol amplitude, so per-sample SNR is Es/N0; a
    matched filter adds its processing gain on top).
    """
    esn0 = 10 ** (np.asarray(esn0_db, np.float64) / 10)
    if m == 2:
        return qfunc(np.sqrt(2 * esn0))
    if m == 4:
        return qfunc(np.sqrt(esn0))
    if m in (8, 16, 32):
        # Standard high-SNR M-PSK approximation P_s ~ 2Q(sqrt(2 Es/N0)
        # sin(pi/M)), one bit flip per adjacent-symbol error (Gray-style
        # lower bound; the documented M>=8 natural-binary mapping averages
        # slightly more flips, so measured BER sits a little above this).
        nb = int(np.log2(m))
        return (2.0 / nb) * qfunc(np.sqrt(2 * esn0) * np.sin(np.pi / m))
    raise ValueError(m)


def _bit_map(m: int) -> np.ndarray:
    """(m, bits_per_symbol) mapping of constellation index -> bits, from the
    documented slicers (psk_soft.scd.xml:42-63; generalized for M=16/32)."""
    idx = np.arange(m)
    theta = 2 * np.pi * idx / m + (np.pi / 4 if m == 4 else 0.0)
    pts = jnp.asarray(np.exp(1j * theta).astype(np.complex64))
    bits = np.asarray(slicers.slice_bits(m, pts))
    nb = {2: 1, 4: 2, 8: 3, 16: 4, 32: 5}[m]
    return bits[:, :nb]


def decide_indices(soft: np.ndarray, m: int) -> np.ndarray:
    """Hard constellation index from a soft decision (0..m-1), undoing the
    QPSK +pi/4 presentation rotation."""
    ang = np.angle(soft)
    if m == 4:
        ang = ang - np.pi / 4
    return np.round(ang * m / (2 * np.pi)).astype(int) % m


@dataclasses.dataclass
class BerPoint:
    esn0_db: float
    n_symbols: int
    n_bits: int
    symbol_errors: int
    bit_errors: int
    rotation: int
    delay: int
    slips: int = 0

    @property
    def ser(self) -> float:
        return self.symbol_errors / max(self.n_symbols, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.n_bits, 1)


def measure_ber(cfg: DemodConfig, esn0_db: float, num_symbols: int = 20000,
                seed: int = 0, freq_offset: float = 0.0,
                pulse: str = "rect", skip: int = 500,
                max_delay: int | None = None) -> BerPoint:
    """Demodulate one AWGN channel realization and count errors.

    skip: symbols discarded at the head (tracker convergence + filter
    transients) before counting.  max_delay (probe search width, symbols):
    defaults to 8 plus the worst-case pulse-shaping + matched-filter group
    delay, so wide RRC spans (rrc_span > 16) cannot silently mis-align.
    """
    if max_delay is None:
        span = 0
        if pulse == "rrc":
            span += cfg.rrc_span          # tx shaping group delay ~span/2
        if cfg.matched_filter == "rrc":
            span += cfg.rrc_span          # rx matched filter adds its own
        max_delay = 8 + span
    if skip <= max_delay:
        raise ValueError(
            f"skip ({skip}) must exceed max_delay ({max_delay}) so the "
            f"probe window never indexes before the transmitted stream")
    m = cfg.constellation_size
    x, tx_idx = gen_psk_channel(
        num_symbols, sps=cfg.sps, m=m, differential=cfg.differential,
        seed=seed, freq_offset=freq_offset, snr_db=esn0_db, pulse=pulse,
        rrc_beta=cfg.rrc_beta, rrc_span=cfg.rrc_span)
    fn = make_ff_demod_fn(cfg)
    _, out = fn(ff_init(cfg), jnp.asarray(x))
    out = jax.device_get(out)
    soft = out.soft[out.valid]
    rx_idx = decide_indices(soft, m)

    # Resolve (delay, rotation) on a probe prefix, like getDelay + the
    # rotation search in tests/test_psk_soft.py:223-238.
    probe = slice(skip, min(skip + 2000, rx_idx.size))
    best = (1.1, 0, 0)
    rotations = [0] if cfg.differential else range(m)
    for d in range(max_delay + 1):
        for r in rotations:
            tx = (tx_idx[probe.start - d: probe.stop - d] + r) % m
            rx = rx_idx[probe]
            nn = min(len(tx), len(rx))
            if nn <= 0:
                continue
            ser = np.mean(tx[:nn] != rx[:nn])
            if ser < best[0]:
                best = (ser, d, r)
    _, delay, rot = best

    n = min(rx_idx.size, tx_idx.size + delay) - skip
    rx = rx_idx[skip: skip + n]
    tx = tx_idx[skip - delay: skip - delay + n]
    bm = _bit_map(m)

    # Non-differential M-th-power carrier recovery has an m-fold phase
    # ambiguity that can CYCLE-SLIP mid-stream at low SNR (a property of the
    # algorithm family, shared with the reference's arg(sample^M) recovery,
    # cpp/psk_soft.cpp:474).  Counting against one fixed rotation would book
    # every post-slip symbol as an error; instead track the rotation over
    # windows (with hysteresis so exact ties never register as slips) and
    # report the slip count as its own figure of merit.
    slips = 0
    if cfg.differential or n <= 0:
        tx_r = (tx + rot) % m
        sym_err = int(np.sum(rx != tx_r))
        bit_err = int(np.sum(bm[rx] != bm[tx_r]))
    else:
        W = 250
        err_by_rot = np.stack([rx != (tx + r) % m for r in range(m)])
        sym_err = bit_err = 0
        cur = rot
        for s in range(0, n, W):
            e = slice(s, min(s + W, n))
            werr = err_by_rot[:, e].sum(axis=1)
            best_r = int(np.argmin(werr))
            if werr[best_r] < werr[cur]:      # hysteresis: strict improvement
                slips += 1
                cur = best_r
            tx_r = (tx[e] + cur) % m
            sym_err += int(werr[cur])
            bit_err += int(np.sum(bm[rx[e]] != bm[tx_r]))
    return BerPoint(
        esn0_db=esn0_db,
        n_symbols=n,
        n_bits=n * bm.shape[1],
        symbol_errors=sym_err,
        bit_errors=bit_err,
        rotation=rot,
        delay=delay,
        slips=slips,
    )


def ber_sweep(cfg: DemodConfig, esn0_dbs, **kw) -> list[BerPoint]:
    """BASELINE.json config 3: sweep Es/N0, return measured points."""
    return [measure_ber(cfg, e, **kw) for e in esn0_dbs]
