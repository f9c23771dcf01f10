"""Seam-correct one-launch chain (VERDICT r4 item 1): the streaming
contract of models/chain.py.

The law under test: the chain carries a soft tail across blocks and
commits every stream position in EXACTLY one step, with full local-max
context -- so a frame planted at ANY start offset relative to the block
grid is decoded exactly once (never dropped at a seam, never duplicated
at the overlap).  The reference's analog is demod state carried across
getPacket boundaries (/root/reference/cpp/psk_soft.cpp:349, 442-467).

Also gated here: the per-channel total peak ``count`` that makes the
fixed frame capacity observable (VERDICT r4 weak #2) -- k+1 planted
frames yield count = k+1 with the earliest k decoded.
"""

import numpy as np
import jax
import jax.numpy as jnp

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.models.blockpsk import demod_block_ff, ff_init
from psk_soft_tpu.models.chain import (chain_init, chain_msg_bits,
                                       commit_bounds, make_chain_fn,
                                       make_seam_tail_fn, seam_lead,
                                       seam_tail_init)
from psk_soft_tpu.models.full import full_from_ff
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT
from psk_soft_tpu.ops.fec import CODE_K7, info_bits_for
from psk_soft_tpu.ops.framesync import FrameFormat, psk_points


def _soft_stream(fmt, infos, starts, length, channels, seed=0,
                 noise=0.02):
    """(C, length) complex soft stream with coded frames planted at
    ``starts`` (identical frames per channel, independent fill+noise)."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(channels):
        idx = tx.frame_stream(fmt, infos, starts, length, code=CODE_K7,
                              crc=None, labeling="gray",
                              seed=seed + 101 * c)
        rows.append(psk_points(idx, fmt.m))
    soft = np.stack(rows)
    soft += (noise * (rng.standard_normal(soft.shape)
                      + 1j * rng.standard_normal(soft.shape)))
    return soft.astype(np.complex64)


def _run_seam_blocks(fmt, k, soft, s_block, crc=None):
    """Scan the seam tail over ``soft`` cut into s_block-sized blocks;
    returns the stacked ChainOutputs (n_blocks leading axis)."""
    c, total = soft.shape
    n_blocks = total // s_block
    assert n_blocks * s_block == total
    re = np.ascontiguousarray(soft.real.T).reshape(n_blocks, s_block, c)
    im = np.ascontiguousarray(soft.imag.T).reshape(n_blocks, s_block, c)
    step = make_seam_tail_fn(fmt, CODE_K7, k, crc=crc, labeling="gray")

    @jax.jit
    def run(tail, re, im):
        return jax.lax.scan(lambda t, xs: step(t, xs[0], xs[1]), tail,
                            (re, im))

    _, outs = run(seam_tail_init(fmt, c), jnp.asarray(re), jnp.asarray(im))
    return jax.tree_util.tree_map(np.asarray, outs)


def _commits(outs, s_block):
    """{channel: [(abs_pos, msg bits)]} from stacked seam ChainOutputs."""
    n_blocks, c_dim, k = outs.found.shape
    got = {c: [] for c in range(c_dim)}
    for b in range(n_blocks):
        for c in range(c_dim):
            for j in range(k):
                if outs.found[b, c, j]:
                    got[c].append((b * s_block + int(outs.pos[b, c, j]),
                                   outs.msg[b, c, j].copy()))
    return got


def test_every_offset_decoded_exactly_once():
    # One frame planted at EVERY start offset mod the block length
    # (spacing S+1 walks the offset by +1 per frame), fed through the
    # jitted seam scan: each must be decoded exactly once, at its exact
    # position, with exact message bits -- including every frame that
    # straddles a block seam.
    rng = np.random.default_rng(1)
    s_block = 48
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4,
                      threshold=0.8)
    n_msg = info_bits_for(CODE_K7, fmt.payload * 2)
    starts = [j * (s_block + 1) for j in range(s_block)]
    assert sorted(p % s_block for p in starts) == list(range(s_block))
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    total = ((starts[-1] + fmt.frame_len) // s_block + 2) * s_block
    soft = _soft_stream(fmt, infos, starts, total, channels=3, seed=2)
    outs = _run_seam_blocks(fmt, 3, soft, s_block)
    got = _commits(outs, s_block)
    for c in range(3):
        assert [p for p, _ in got[c]] == starts, f"channel {c}"
        for (p, msg), want in zip(got[c], infos):
            np.testing.assert_array_equal(msg, want)


def test_block_split_invariance():
    # The same stream cut into 48- and 96-symbol blocks commits the
    # identical (position, bits) set: the commit-window tiling is
    # independent of the block grid.
    rng = np.random.default_rng(3)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4,
                      threshold=0.8)
    n_msg = info_bits_for(CODE_K7, fmt.payload * 2)
    starts = [11, 90, 141, 200, 333, 420]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    total = 480
    soft = _soft_stream(fmt, infos, starts, total, channels=2, seed=4)
    got_a = _commits(_run_seam_blocks(fmt, 3, soft, 48), 48)
    got_b = _commits(_run_seam_blocks(fmt, 5, soft, 96), 96)
    for c in range(2):
        assert [p for p, _ in got_a[c]] == [p for p, _ in got_b[c]] \
            == starts
        for (_, ma), (_, mb) in zip(got_a[c], got_b[c]):
            np.testing.assert_array_equal(ma, mb)


def test_overflow_count_observable():
    # k+1 frames inside one block's commit window: count reports k+1
    # (the cap is observable), the earliest k decode.
    rng = np.random.default_rng(5)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4,
                      threshold=0.8)
    n_msg = info_bits_for(CODE_K7, fmt.payload * 2)
    s_block = 192
    k = 3
    lead = seam_lead(fmt)
    lo, hi = commit_bounds(fmt, s_block)
    # Block 1's commit window in absolute coords (block b covers
    # [b*S + lo - lead, b*S + hi - lead]); plant k+1 frames inside it.
    w0 = s_block + lo - lead
    starts = [w0 + 10 + j * fmt.separation for j in range(k + 1)]
    assert starts[-1] <= s_block + hi - lead
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    soft = _soft_stream(fmt, infos, starts, 3 * s_block, channels=2,
                        seed=6)
    outs = _run_seam_blocks(fmt, k, soft, s_block)
    assert (outs.count[1] == k + 1).all()        # overflow visible
    assert outs.found[1].all()                   # capacity filled
    got = _commits(outs, s_block)
    for c in range(2):
        assert [p for p, _ in got[c]] == starts[:k]
        for (_, msg), want in zip(got[c], infos[:k]):
            np.testing.assert_array_equal(msg, want)
    # Other blocks commit nothing and count zero peaks.
    assert outs.count[0].max() == 0 and outs.count[2].max() == 0


def test_seam_fuzz_random_formats_and_splits():
    # Seeded property fuzz of the seam law across random frame formats,
    # constellations, frame placements, and block sizes: every planted
    # frame decodes exactly once at its exact position with exact bits,
    # and no unplanted position ever commits.
    rng = np.random.default_rng(77)
    for trial in range(6):
        m = int(rng.choice([2, 4, 8]))
        u_len = int(rng.integers(12, 25))
        payload = int(rng.integers(8, 33))
        nb = int(np.log2(m))
        payload = max(payload, -(-14 // nb))   # room for K-1 flush bits
        if (payload * nb) % 2:          # K7 is rate 1/2: even code bits
            payload += 1
        fmt = FrameFormat(uw=tuple(rng.integers(0, m, u_len)),
                          payload=payload, m=m, threshold=0.8)
        n_msg = info_bits_for(CODE_K7, fmt.payload * nb)
        s_block = int(rng.integers(5, 14)) * 8
        n_blocks = int(rng.integers(6, 12))
        total = s_block * n_blocks
        # Random placements with legal spacing, crossing seams freely.
        starts, p = [], int(rng.integers(0, fmt.separation))
        while p + fmt.frame_len <= total - (fmt.separation + u_len):
            starts.append(p)
            p += fmt.separation + int(rng.integers(1, 40))
        if not starts:
            continue
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
        soft = _soft_stream(fmt, infos, starts, total, channels=2,
                            seed=700 + trial, noise=0.02)
        k = max(2, -(-s_block // fmt.separation))
        outs = _run_seam_blocks(fmt, k, soft, s_block)
        got = _commits(outs, s_block)
        for c in range(2):
            assert [p for p, _ in got[c]] == starts, (trial, c)
            for (_, msg), want in zip(got[c], infos):
                np.testing.assert_array_equal(msg, want)
        # counts total exactly the planted frames over the stream
        assert int(outs.count.sum()) == 2 * len(starts), trial


def test_full_chain_decodes_straddling_frames():
    # The COMPLETE one-launch chain (demod kernel in the loop): frames
    # planted mid-stream so several straddle input-block seams; each
    # decoded exactly once with CRC green and exact bits, no matter where
    # its symbols fall on the block grid.
    C, sps, S = 128, 8, 256
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    code, crc = CODE_K7, CRC16_CCITT
    rng = np.random.default_rng(7)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, code, crc)
    n_blocks = 4
    total = n_blocks * S
    # Frame starts straddling the 256-symbol block grid (span 80 syms).
    starts = [100, 230, 500, 740]
    assert any(p // S != (p + fmt.frame_len - 1) // S for p in starts)
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(fmt, infos, starts, total, code=code,
                              crc=crc, labeling="gray", seed=8)
    x_np = np.repeat(np.exp(1j * (2 * np.pi
                                  * np.tile(idx_row, (C, 1)) / 4 + 0.4)),
                     sps, axis=1).astype(np.complex64)
    x_np += (0.01 * (rng.standard_normal(x_np.shape)
                     + 1j * rng.standard_normal(x_np.shape))
             ).astype(np.complex64)

    # Converge the tracker on fill (same stream statistics), then run the
    # planted stream through the seam chain block by block.
    warm_idx = tx.frame_stream(fmt, [], [], S, code=code, crc=crc,
                               labeling="gray", seed=99)
    warm_x = np.repeat(np.exp(1j * (2 * np.pi
                                    * np.tile(warm_idx, (C, 1)) / 4
                                    + 0.4)),
                       sps, axis=1).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(warm_x))
    k = 2
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    step = jax.jit(make_chain_fn(cfg, fmt, code, k, crc=crc))
    commits = {c: [] for c in range(C)}
    for b in range(n_blocks):
        blk = x_np[:, b * S * sps:(b + 1) * S * sps]
        state, out = step(
            state, jnp.asarray(np.ascontiguousarray(blk.real.T)),
            jnp.asarray(np.ascontiguousarray(blk.imag.T)))
        found = np.asarray(out.found)
        pos = np.asarray(out.pos)
        ok = np.asarray(out.ok)
        msg = np.asarray(out.msg)
        for c in range(C):
            for j in range(k):
                if found[c, j]:
                    assert ok[c, j]
                    commits[c].append((b * S + int(pos[c, j]),
                                       msg[c, j].copy()))
    # Every planted frame decoded exactly once per channel; consecutive
    # commit spacing matches the planted spacing (absolute alignment to
    # the demod's output-row coordinate is covered by the tail-only
    # tests; here the demod lag shifts all rows equally).
    want_gaps = np.diff(starts)
    for c in range(C):
        assert len(commits[c]) == len(starts), f"channel {c}"
        ps = [p for p, _ in commits[c]]
        np.testing.assert_array_equal(np.diff(ps), want_gaps)
        for (_, msg), want in zip(commits[c], infos):
            np.testing.assert_array_equal(msg, want)


def test_one_shot_mode_still_available():
    # seam=False pins the legacy one-shot contract: bare FullState carry,
    # containment rule (a frame past the block edge is NOT seen).
    C, sps, S = 128, 8, 256
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30)
    rng = np.random.default_rng(9)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, CODE_K7, None)
    rows = [60]
    starts = [r - (cfg.num_avg - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8)]
    idx_row = tx.frame_stream(fmt, infos, starts, S, code=CODE_K7,
                              crc=None, labeling="gray", seed=10)
    x_np = np.repeat(np.exp(1j * (2 * np.pi
                                  * np.tile(idx_row, (C, 1)) / 4 + 0.4)),
                     sps, axis=1).astype(np.complex64)
    x_np += (0.01 * rng.standard_normal(x_np.shape)).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(x_np))
    state = full_from_ff(cfg, st_ff)         # bare FullState
    step = jax.jit(make_chain_fn(cfg, fmt, CODE_K7, 1, seam=False))
    state, out = step(state,
                      jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    state, out = step(state,
                      jnp.asarray(np.ascontiguousarray(x_np.real.T)),
                      jnp.asarray(np.ascontiguousarray(x_np.imag.T)))
    assert np.asarray(out.found).all()
    assert (np.asarray(out.pos) == rows[0]).all()
    np.testing.assert_array_equal(
        np.asarray(out.msg)[:, 0], np.tile(infos[0], (C, 1)))


def test_seam_chain_16psk():
    # The seam tail at M=16 (the high-order extension beyond the
    # reference's {2,4,8}): 4 bits/symbol payloads, exact decode through
    # sync + Viterbi + CRC across a seam.
    rng = np.random.default_rng(21)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 16, 16)), payload=16,
                      m=16, threshold=0.8)
    n_info = info_bits_for(CODE_K7, fmt.payload * 4)
    n_msg = n_info - CRC16_CCITT.degree
    s_block = 64
    starts = [20, 100, 150]           # 150..181 straddles block 2/3
    assert any(p // s_block != (p + fmt.frame_len - 1) // s_block
               for p in starts)
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    rows = []
    for c in range(2):
        idx = tx.frame_stream(fmt, infos, starts, 4 * s_block,
                              code=CODE_K7, crc=CRC16_CCITT,
                              labeling="gray", seed=30 + c)
        rows.append(psk_points(idx, 16))
    soft = np.stack(rows)
    soft += (0.01 * (rng.standard_normal(soft.shape)
                     + 1j * rng.standard_normal(soft.shape)))
    outs = _run_seam_blocks(fmt, 2, soft.astype(np.complex64), s_block,
                            crc=CRC16_CCITT)
    assert outs.ok[outs.found].all()
    got = _commits(outs, s_block)
    for c in range(2):
        assert [p for p, _ in got[c]] == starts
        for (_, msg), want in zip(got[c], infos):
            np.testing.assert_array_equal(msg, want)


def test_seam_chain_differential_mode():
    # Differential decoding (C5): the UW/payload live in DECODED-symbol
    # space (the soft port's stream); the wire accumulates them.  The
    # seam chain must decode a straddling frame exactly through the
    # differential demod path.
    C, sps, S = 128, 8, 256
    cfg = DemodConfig(sps=sps, num_avg=40, constellation_size=4,
                      phase_avg=30, differential=True)
    rng = np.random.default_rng(33)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                      threshold=0.7)
    n_msg = chain_msg_bits(fmt, CODE_K7, CRC16_CCITT)
    starts = [100, 230]                    # 230..309 straddles 256
    assert any(p // S != (p + fmt.frame_len - 1) // S for p in starts)
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    total = 3 * S
    dec_idx = tx.frame_stream(fmt, infos, starts, total, code=CODE_K7,
                              crc=CRC16_CCITT, labeling="gray", seed=34)
    wire_idx = np.cumsum(dec_idx) % 4      # differential accumulation
    x = np.repeat(np.exp(2j * np.pi
                         * np.tile(wire_idx, (C, 1)) / 4),
                  sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)

    # Converge on frame-free fill (replaying the planted block through
    # the warm-up would leave a half-UW discontinuity artifact that the
    # chain rightly flags as a CRC failure).
    warm_idx = np.cumsum(tx.frame_stream(fmt, [], [], S, seed=99)) % 4
    warm_x = np.repeat(np.exp(2j * np.pi
                              * np.tile(warm_idx, (C, 1)) / 4),
                       sps, axis=1).astype(np.complex64)
    st_ff = ff_init(cfg, (C,))
    warm = jax.jit(jax.vmap(lambda s, b: demod_block_ff(cfg, s, b)))
    st_ff, _ = warm(st_ff, jnp.asarray(warm_x))
    state = chain_init(fmt, C, full_from_ff(cfg, st_ff))
    step = jax.jit(make_chain_fn(cfg, fmt, CODE_K7, 2, crc=CRC16_CCITT))
    commits = {c: [] for c in range(C)}
    for b in range(3):
        blk = x[:, b * S * sps:(b + 1) * S * sps]
        state, out = step(
            state, jnp.asarray(np.ascontiguousarray(blk.real.T)),
            jnp.asarray(np.ascontiguousarray(blk.imag.T)))
        found = np.asarray(out.found)
        msg = np.asarray(out.msg)
        ok = np.asarray(out.ok)
        for c, j in zip(*np.nonzero(found)):
            assert ok[c, j]
            commits[c].append(msg[c, j].copy())
    for c in range(C):
        assert len(commits[c]) == len(starts), c
        for got, want in zip(commits[c], infos):
            np.testing.assert_array_equal(got, want)
