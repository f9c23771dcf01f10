"""Per-channel polyphase resampler (ops/resample.py + runtime ResamplerBank).

Accuracy against the continuous reconstruction, block-split invariance of
the streaming wrapper, and the heterogeneous-rate end-to-end: a channel at
NATIVE fractional sps (e.g. 7.3) resampled to the bank's common sps and
demodulated must produce the same bits as a channel generated at the
common rate directly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig, demod_init, make_demod_fn
from psk_soft_tpu.ops.matched_filter import rrc_taps
from psk_soft_tpu.ops.resample import (kaiser_sinc_table, resample_block,
                                       resample_positions_valid)
from psk_soft_tpu.runtime.resampler import ResamplerBank
from psk_soft_tpu.testing.signals import sinc_interp as _sinc_interp

K, P = 8, 128


def _bandlimited_qpsk(nsym, sps=8, seed=0, beta=0.35, span=8):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, nsym)
    pts = np.exp(2j * np.pi * sym / 4 + 1j * np.pi / 4)
    up = np.zeros(nsym * sps, np.complex128)
    up[::sps] = pts
    x = np.convolve(up, rrc_taps(sps, beta, span).astype(np.float64),
                    mode="same")
    return x.astype(np.complex64), sym


def test_table_phase0_is_identity():
    tab = kaiser_sinc_table(P, K)
    assert tab.shape == (P + 1, K)
    want = np.zeros(K, np.float32)
    want[K // 2 - 1] = 1.0
    np.testing.assert_allclose(tab[0], want, atol=1e-7)
    np.testing.assert_allclose(tab[P], np.roll(want, 1), atol=1e-7)
    np.testing.assert_allclose(tab.sum(axis=1), 1.0, atol=1e-6)


def test_integer_ratio_one_is_passthrough():
    x = (np.random.default_rng(0).standard_normal((64, 3))
         .astype(np.float32))
    tab = jnp.asarray(kaiser_sinc_table(P, K))
    pos0 = jnp.full(3, float(K // 2 - 1), jnp.float32)
    y_re, y_im, pos_end = resample_block(
        jnp.asarray(x), jnp.asarray(x), pos0, jnp.ones(3, jnp.float32),
        tab, 32)
    np.testing.assert_allclose(np.asarray(y_re),
                               x[K // 2 - 1: K // 2 - 1 + 32], atol=1e-6)
    np.testing.assert_allclose(np.asarray(pos_end), K // 2 - 1 + 32)


@pytest.mark.parametrize("ratio", [0.8, 1.0, 1.25, 7.3 / 8])
def test_tone_accuracy(ratio):
    """Resampled complex exponential matches its continuous form."""
    f = 0.11  # cycles per INPUT sample, well inside the table's passband
    T_in, n_out = 512, 300
    m = np.arange(T_in)
    x = np.exp(2j * np.pi * f * m).astype(np.complex64)
    pos0 = np.full(1, float(K // 2 - 1), np.float32)
    r = np.full(1, ratio, np.float32)
    assert resample_positions_valid(pos0, r, n_out, T_in, K)
    tab = jnp.asarray(kaiser_sinc_table(P, K,
                                        cutoff=min(1.0, 1.0 / ratio)))
    y_re, y_im, _ = resample_block(
        jnp.asarray(x.real[:, None]), jnp.asarray(x.imag[:, None]),
        jnp.asarray(pos0), jnp.asarray(r), tab, n_out)
    y = np.asarray(y_re)[:, 0] + 1j * np.asarray(y_im)[:, 0]
    t = pos0[0] + np.arange(n_out) * ratio
    want = np.exp(2j * np.pi * f * t)
    err = np.abs(y - want).max()
    assert err < 4e-3, err


def test_per_channel_ratios_match_single_channel_runs():
    """One (T, C) call with mixed ratios == per-channel individual calls."""
    rng = np.random.default_rng(3)
    ratios = np.array([0.8, 1.0, 1.25, 7.3 / 8], np.float32)
    T_in, n_out = 400, 256
    xs = (rng.standard_normal((T_in, 4)) +
          1j * rng.standard_normal((T_in, 4))).astype(np.complex64)
    tab = jnp.asarray(kaiser_sinc_table(P, K, cutoff=1.0 / 1.25))
    pos0 = np.full(4, float(K // 2 - 1), np.float32)
    y_re, y_im, _ = resample_block(
        jnp.asarray(xs.real.copy()), jnp.asarray(xs.imag.copy()),
        jnp.asarray(pos0), jnp.asarray(ratios), tab, n_out)
    for c in range(4):
        yr, yi, _ = resample_block(
            jnp.asarray(np.ascontiguousarray(xs.real[:, c:c + 1])),
            jnp.asarray(np.ascontiguousarray(xs.imag[:, c:c + 1])),
            jnp.asarray(pos0[c:c + 1]), jnp.asarray(ratios[c:c + 1]),
            tab, n_out)
        # ULP-level differences only (XLA fuses the two shapes differently)
        np.testing.assert_allclose(np.asarray(y_re)[:, c],
                                   np.asarray(yr)[:, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(y_im)[:, c],
                                   np.asarray(yi)[:, 0], atol=1e-6)


def test_bank_streaming_matches_oneshot():
    """Feeding the bank in ragged pushes must equal one big device call."""
    rng = np.random.default_rng(7)
    ratios = [0.9, 1.0, 1.2]
    C, B = len(ratios), 64
    n_blocks = 5
    total_need = int(np.ceil(B * n_blocks * max(ratios))) + 4 * K
    xs = [(rng.standard_normal(total_need)
           + 1j * rng.standard_normal(total_need)).astype(np.complex64)
          for _ in range(C)]

    bank = ResamplerBank(ratios, block_out=B, n_phases=P, taps_per_phase=K,
                         uniform=False)   # this test gates the gather path
    outs, fed = [], [0] * C
    chunk = 37
    while len(outs) < n_blocks:
        got = bank.step()
        if got is not None:
            outs.append(got)
            continue
        for c in range(C):
            bank.push(c, xs[c][fed[c]:fed[c] + chunk])
            fed[c] += chunk
    stream = np.concatenate(outs, axis=1)       # (C, B*n_blocks)

    # one-shot oracle: same table, same positions, single device call
    tab = jnp.asarray(kaiser_sinc_table(P, K, cutoff=1.0 / max(ratios)))
    T_in = max(len(x) for x in xs)
    x_re = np.zeros((T_in, C), np.float32)
    x_im = np.zeros((T_in, C), np.float32)
    for c, x in enumerate(xs):
        x_re[:len(x), c] = x.real
        x_im[:len(x), c] = x.imag
    pos0 = np.full(C, float(K // 2 - 1), np.float32)
    y_re, y_im, _ = resample_block(
        jnp.asarray(x_re), jnp.asarray(x_im), jnp.asarray(pos0),
        jnp.asarray(np.asarray(ratios, np.float32)), tab, B * n_blocks)
    want = (np.asarray(y_re).T + 1j * np.asarray(y_im).T)
    # the one-shot oracle accumulates positions as float32 n*ratio (rounds
    # at ~1e-5 by n=320); the bank rebases per block in float64 host math
    # and is the MORE accurate of the two.  A carry/rebase bug would be a
    # tap-scale (>1e-1) error, far above this tolerance.
    np.testing.assert_allclose(stream, want, atol=5e-4)


def test_bank_pending_and_ready():
    bank = ResamplerBank([1.0, 1.5], block_out=32)
    assert not bank.ready()
    p = bank.pending()
    assert p.shape == (2,) and (p > 0).all() and p[1] > p[0]
    assert bank.step() is None
    bank.push(0, np.zeros(int(p[0]), np.complex64))
    bank.push(1, np.zeros(int(p[1]), np.complex64))
    assert bank.ready() and bank.step() is not None


def test_bank_rejects_bad_args():
    with pytest.raises(ValueError):
        ResamplerBank([1.0, -0.5], block_out=32)
    with pytest.raises(ValueError):
        ResamplerBank([1.0], block_out=32, taps_per_phase=7)
    bank = ResamplerBank([1.0], block_out=32)
    with pytest.raises(ValueError):
        bank.push(0, np.zeros((2, 2), np.complex64))


def test_fractional_native_sps_demod_end_to_end():
    """Native sps 7.3 channel -> ResamplerBank at ratio 7.3/8 -> demod at
    sps 8: bits equal a channel generated at sps 8 directly."""
    sps, nsym = 8, 320
    ratio = 7.3 / 8.0   # native samples per common-rate sample
    x8, _ = _bandlimited_qpsk(nsym + 16, sps=sps, seed=11)
    # synthesize the native-rate stream: one native sample advances
    # 1/ratio common-rate samples of time (sps 7.3 has FEWER samples per
    # symbol than the common sps 8)
    need = int(np.ceil(nsym * sps * ratio)) + 8 * K
    t_native = np.arange(need) / ratio
    x_native = _sinc_interp(x8.astype(np.complex128), t_native
                            ).astype(np.complex64)

    bank = ResamplerBank([ratio], block_out=64 * sps, n_phases=P,
                         taps_per_phase=K)
    bank.push(0, x_native)
    blocks = []
    while bank.ready():
        blocks.append(bank.step()[0])
    y = np.concatenate(blocks)
    assert y.size >= 256 * sps

    # the resampled stream reproduces the common-rate signal: output n sits
    # at native position pos0 + n*ratio == common-rate time pos0/ratio + n
    t0 = (K // 2 - 1) / ratio
    ref_full = _sinc_interp(x8.astype(np.complex128),
                            t0 + np.arange(y.size)).astype(np.complex64)
    span = slice(4 * sps, y.size - 4 * sps)
    assert np.abs(y[span] - ref_full[span]).max() < 5e-3

    cfg = DemodConfig(sps=sps, num_avg=20, constellation_size=4,
                      phase_avg=10, matched_filter="rrc")
    fn = make_demod_fn(cfg)
    n_use = (y.size // sps) * sps
    _, out_r = fn(demod_init(cfg), jnp.asarray(y[:n_use]))
    _, out_d = fn(demod_init(cfg), jnp.asarray(ref_full[:n_use]))
    vr, vd = np.asarray(out_r.valid), np.asarray(out_d.valid)
    np.testing.assert_array_equal(vr, vd)
    bits_r = np.asarray(out_r.bits)[vr]
    bits_d = np.asarray(out_d.bits)[vd]
    # ignore the last few symbols where the truncated-sinc fixture itself
    # (not the resampler) degrades at the stream tail
    n = bits_r.shape[0] - 8
    np.testing.assert_array_equal(bits_r[:n], bits_d[:n])


def test_bank_drain_consumes_all_real_samples():
    """drain(): zero-pads to finish blocks until every REAL queued sample
    has been consumed, then stops (no infinite padding loop)."""
    ratios = [0.85, 1.3]
    B = 48
    bank = ResamplerBank(ratios, block_out=B, taps_per_phase=K)
    rng = np.random.default_rng(1)
    # enough for ~2 blocks on ch0, ~1.2 blocks on ch1
    n0 = int(2.4 * B * ratios[0])
    n1 = int(1.2 * B * ratios[1])
    bank.push(0, (rng.standard_normal(n0)
                  + 1j * rng.standard_normal(n0)).astype(np.complex64))
    bank.push(1, (rng.standard_normal(n1)
                  + 1j * rng.standard_normal(n1)).astype(np.complex64))
    n_live = 0
    while bank.ready():
        assert bank.step() is not None
        n_live += 1
    tail = bank.drain(planes=False)
    assert len(tail) >= 1
    assert (bank._real <= bank.K).all()
    assert not bank.ready() or bank.pending().max() == 0
    # a fresh drain on the spent bank yields nothing
    assert bank.drain(planes=False) == []
    total = (n_live + len(tail)) * B
    # every real sample's output position was produced: outputs cover at
    # least n_c/ratio_c common-rate samples per channel
    for c, (n, r) in enumerate(zip((n0, n1), ratios)):
        assert total >= (n - bank.K) / r


def test_bank_rejects_ratio_beyond_tap_span():
    """ratio > taps_per_phase/2 must be rejected: no anti-alias stopband
    AND the row-drop would outrun the buffered window (review finding)."""
    with pytest.raises(ValueError, match="taps_per_phase"):
        ResamplerBank([10.0], block_out=32, taps_per_phase=8)
    # boundary: exactly K/2 is allowed
    ResamplerBank([4.0], block_out=32, taps_per_phase=8)
    # and a wider tap span re-admits the ratio
    ResamplerBank([10.0], block_out=32, taps_per_phase=24)


def test_bank_live_ratio_change_tracks_tone():
    """set_ratio mid-stream (doppler/baud-drift reactor): the channel
    continues from its current position at the new rate, positions stay
    continuous, and a resampled tone stays accurate through the change."""
    f = 0.07                       # cycles per input sample
    B = 64
    r1, r2 = 1.0, 1.05
    # construct at the maximum ratio the channel may reach (sizes the
    # static window + cutoff), then retune downward/within it freely
    bank = ResamplerBank([r2], block_out=B, taps_per_phase=K,
                         uniform=False)   # retuning needs the gather path
    with pytest.raises(ValueError):
        bank.set_ratio(0, 1.2)     # above the construction-time max
    with pytest.raises(ValueError):
        bank.set_ratio(0, 0.0)
    bank.set_ratio(0, r1)

    n_in = 800
    x = np.exp(2j * np.pi * f * np.arange(n_in)).astype(np.complex64)
    bank.push(0, x)
    pos = float(bank._pos[0])      # absolute position of next output
    outs, times = [], []
    abs_pos = pos
    for blk_i in range(6):
        r = r1 if blk_i < 3 else r2
        if blk_i == 3:
            bank.set_ratio(0, r2)
        got = bank.step()
        assert got is not None
        outs.append(got[0])
        times.append(abs_pos + np.arange(B) * r)
        abs_pos += B * r
    y = np.concatenate(outs)
    t = np.concatenate(times)
    want = np.exp(2j * np.pi * f * t)
    assert np.abs(y - want).max() < 4e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bank_fuzz_streaming_equals_oneshot(seed):
    """Property fuzz: random ratios / block sizes / ragged chunk patterns --
    the streamed bank always equals the one-shot device call."""
    rng = np.random.default_rng(100 + seed)
    C = int(rng.integers(1, 5))
    ratios = rng.uniform(0.6, 2.5, C)
    B = int(rng.choice([32, 48, 80]))
    n_blocks = int(rng.integers(2, 5))
    total_need = int(np.ceil(B * n_blocks * ratios.max())) + 4 * K
    xs = [(rng.standard_normal(total_need)
           + 1j * rng.standard_normal(total_need)).astype(np.complex64)
          for _ in range(C)]

    bank = ResamplerBank(ratios, block_out=B, n_phases=P, taps_per_phase=K)
    outs, fed = [], [0] * C
    while len(outs) < n_blocks:
        got = bank.step()
        if got is not None:
            outs.append(got)
            continue
        for c in range(C):
            chunk = int(rng.integers(1, 64))
            bank.push(c, xs[c][fed[c]:fed[c] + chunk])
            fed[c] += chunk
    stream = np.concatenate(outs, axis=1)

    tab = jnp.asarray(kaiser_sinc_table(
        P, K, cutoff=min(1.0, 1.0 / ratios.max())))
    T_in = max(len(x) for x in xs)
    x_re = np.zeros((T_in, C), np.float32)
    x_im = np.zeros((T_in, C), np.float32)
    for c, x in enumerate(xs):
        x_re[:len(x), c] = x.real
        x_im[:len(x), c] = x.imag
    pos0 = np.full(C, float(K // 2 - 1), np.float32)
    y_re, y_im, _ = resample_block(
        jnp.asarray(x_re), jnp.asarray(x_im), jnp.asarray(pos0),
        jnp.asarray(ratios.astype(np.float32)), tab, B * n_blocks)
    want = (np.asarray(y_re).T + 1j * np.asarray(y_im).T)
    # tolerance: float32 position accumulation in the one-shot oracle (the
    # bank's rebased f64 positions are the more accurate side)
    np.testing.assert_allclose(stream, want, atol=5e-4, err_msg=str(ratios))


def test_uniform_matrix_matches_gather_path():
    """The banded-matmul uniform-ratio form equals the gather path
    on the same signal (within the gather path's phase-table lerp error:
    the matrix holds EXACT tap phases)."""
    from psk_soft_tpu.ops.resample import (resample_block_uniform,
                                           uniform_poly_matrix)
    num, den = 73, 80          # ratio 7.3/8 exactly
    rng = np.random.default_rng(5)
    C = 4
    Q = 6
    T_in = Q * num + K
    xs = (rng.standard_normal((T_in, C))
          + 1j * rng.standard_normal((T_in, C))).astype(np.complex64)
    S = uniform_poly_matrix(num, den, K)
    yu_re, yu_im = resample_block_uniform(
        jnp.asarray(xs.real.copy()), jnp.asarray(xs.imag.copy()),
        jnp.asarray(S), num, den)
    assert yu_re.shape == (Q * den, C)

    tab = jnp.asarray(kaiser_sinc_table(P, K))
    pos0 = np.full(C, float(K // 2 - 1), np.float32)
    ratio = np.full(C, num / den, np.float32)
    yg_re, yg_im, _ = resample_block(
        jnp.asarray(xs.real.copy()), jnp.asarray(xs.imag.copy()),
        jnp.asarray(pos0), jnp.asarray(ratio), tab, Q * den)
    np.testing.assert_allclose(np.asarray(yu_re), np.asarray(yg_re),
                               atol=3e-4)
    np.testing.assert_allclose(np.asarray(yu_im), np.asarray(yg_im),
                               atol=3e-4)


@pytest.mark.parametrize("num,den,kt", [(1, 4, 8), (4, 1, 64),
                                         (73, 80, 8), (5, 4, 8)])
def test_uniform_tone_accuracy(num, den, kt):
    """Exact-phase banded form reconstructs a tone on any rational grid,
    including strong upsampling (num < taps) via the multi-shift windows.
    Decimation needs taps proportional to the factor (kt=64 at 4x: the
    same physics behind the gather path's ratio <= K/2 bound)."""
    from psk_soft_tpu.ops.resample import (resample_block_uniform,
                                           uniform_poly_matrix)
    ratio = num / den
    f = 0.09
    Q = max(4, 256 // den)
    T_in = Q * num + kt
    m = np.arange(T_in)
    x = np.exp(2j * np.pi * f * m).astype(np.complex64)
    S = uniform_poly_matrix(num, den, kt, cutoff=min(1.0, 1.0 / ratio))
    y_re, y_im = resample_block_uniform(
        jnp.asarray(x.real[:, None].copy()),
        jnp.asarray(x.imag[:, None].copy()), jnp.asarray(S), num, den)
    y = np.asarray(y_re)[:, 0] + 1j * np.asarray(y_im)[:, 0]
    t = (kt // 2 - 1) + np.arange(Q * den) * ratio
    keep = t < T_in - kt // 2         # tail rows read past the tap span
    want = np.exp(2j * np.pi * f * t)
    assert keep.sum() > Q * den - den - kt
    assert np.abs(y[keep] - want[keep]).max() < 4e-3


def test_uniform_streaming_carry_is_row_tail():
    """Two chained uniform calls (keeping the T_in - Q*num row tail) equal
    one big call -- the rational grid restarts exactly each cycle."""
    from psk_soft_tpu.ops.resample import (resample_block_uniform,
                                           uniform_poly_matrix)
    num, den = 5, 4
    rng = np.random.default_rng(9)
    Q1, Q2 = 7, 9
    T_in = (Q1 + Q2) * num + K
    x = rng.standard_normal((T_in, 3)).astype(np.float32)
    S = jnp.asarray(uniform_poly_matrix(num, den, K, cutoff=4 / 5))

    y_all, _ = resample_block_uniform(jnp.asarray(x), jnp.asarray(x),
                                      S, num, den)
    y1, _ = resample_block_uniform(jnp.asarray(x[:Q1 * num + K]),
                                   jnp.asarray(x[:Q1 * num + K]),
                                   S, num, den)
    y2, _ = resample_block_uniform(jnp.asarray(x[Q1 * num:]),
                                   jnp.asarray(x[Q1 * num:]), S, num, den)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    np.testing.assert_allclose(got, np.asarray(y_all), atol=1e-6)


def test_bank_uniform_fast_path_detection_and_parity():
    """One shared rational ratio auto-selects the banded-matmul path; the
    streamed output matches the gather-path bank within the gather path's
    phase-table quantization."""
    ratio = 7.3 / 8.0
    B = 96
    fast = ResamplerBank([ratio, ratio], block_out=B, taps_per_phase=K)
    slow = ResamplerBank([ratio, ratio], block_out=B, taps_per_phase=K,
                         uniform=False)
    assert fast._uniform == (73, 80) and slow._uniform is None
    with pytest.raises(ValueError):
        ResamplerBank([0.9, 1.1], block_out=B, uniform=True)

    rng = np.random.default_rng(21)
    n = int(4 * B * ratio) + 8 * K
    xs = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64) for _ in range(2)]
    for bank in (fast, slow):
        for c in (0, 1):
            bank.push(c, xs[c])
    outs_f, outs_s = [], []
    while fast.ready():
        outs_f.append(fast.step())
    while slow.ready():
        outs_s.append(slow.step())
    # the FIFO decouples cycles from blocks: same number of full blocks
    assert len(outs_f) == len(outs_s) > 1
    np.testing.assert_allclose(np.concatenate(outs_f, axis=1),
                               np.concatenate(outs_s, axis=1), atol=3e-4)
    # EOS drain on the uniform path consumes the real tail too
    tail_f = fast.drain(planes=False)
    tail_s = slow.drain(planes=False)
    assert len(tail_f) == len(tail_s) >= 0
    assert (fast._real <= fast.K).all()


def test_bank_grouped_uniform_decomposition():
    """Few distinct rational ratios -> one banded-matmul sub-bank per
    ratio, outputs scattered back to bank columns; matches the gather-path
    bank within phase-table quantization.  Channels of the same ratio are
    interleaved to exercise the column scatter."""
    ratios = [73 / 80, 1.0, 73 / 80, 37 / 32]     # interleaved groups
    B = 96
    # explicit shared cutoff so both banks run the SAME filter on every
    # channel (by default the grouped path gives each group its own
    # cutoff, deliberately different from the gather bank's shared table)
    co = 32 / 37
    fast = ResamplerBank(ratios, block_out=B, taps_per_phase=K, cutoff=co)
    slow = ResamplerBank(ratios, block_out=B, taps_per_phase=K,
                         cutoff=co, uniform=False)
    assert fast._groups is not None and len(fast._groups) == 3
    assert slow._groups is None
    with pytest.raises(ValueError):
        fast.set_ratio(0, 1.0)

    rng = np.random.default_rng(31)
    n = int(4 * B * max(ratios)) + 8 * K
    xs = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64) for _ in ratios]
    for bank in (fast, slow):
        for c in range(len(ratios)):
            bank.push(c, xs[c])
    outs_f, outs_s = [], []
    while fast.ready():
        outs_f.append(fast.step())
    while slow.ready():
        outs_s.append(slow.step())
    assert len(outs_f) == len(outs_s) > 1
    got = np.concatenate(outs_f, axis=1)
    want = np.concatenate(outs_s, axis=1)
    # identical filters -> only the gather path's phase-table lerp differs
    np.testing.assert_allclose(got, want, atol=3e-4)
    tail = fast.drain(planes=False)
    assert isinstance(tail, list)


def test_resampled_bank_engine_surface():
    """ResampledBankEngine: native-rate push -> standard engine surface,
    packets equal the manual ResamplerBank+engine composition, packet
    clock rescaled by the (uniform) ratio."""
    from psk_soft_tpu.runtime.engine import BatchEngine
    from psk_soft_tpu.runtime.resampler import ResampledBankEngine
    from psk_soft_tpu.runtime.streams import SRI, PORT_SOFT

    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    C, B = 2, 64
    native = 7.3
    rng = np.random.default_rng(17)
    n = int(6 * B * 8 * (native / 8)) + 64
    xs = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64) for _ in range(C)]

    eng = ResampledBankEngine(cfg, C, native, block_symbols=B,
                              pipeline="ff")
    eng.set_input_sri(SRI(stream_id="t", xdelta=1.0), 0.0)
    assert eng.engine.assembler.sri.xdelta == pytest.approx(native / 8)
    for c in range(C):
        eng.push(c, xs[c])
    got = []
    while True:
        pkts = eng.step_packets()
        if pkts is None:
            break
        got.append(pkts)
    got.extend(p for p in eng.flush_packets() if p)
    assert eng.metrics.symbols_out > 0

    # manual composition oracle
    rs = ResamplerBank([native / 8] * C, block_out=B * 8)
    ref_eng = BatchEngine(cfg, C, block_symbols=B)
    ref_eng.set_input_sri(SRI(stream_id="t", xdelta=native / 8), 0.0)
    for c in range(C):
        rs.push(c, xs[c])
    ref = []
    while True:
        blk = rs.step()
        if blk is None:
            break
        ref_eng.push_block(blk)
        while True:
            pkts = ref_eng.step_packets()
            if pkts is None:
                break
            ref.append(pkts)
    for blk in rs.drain(planes=False):
        ref_eng.push_block(blk)
    while True:
        pkts = ref_eng.step_packets()
        if pkts is None:
            break
        ref.append(pkts)
    ref.append(ref_eng.flush_packets())
    ref = [p for p in ref if p]

    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[PORT_SOFT].data, b[PORT_SOFT].data)
        assert a[PORT_SOFT].sri.xdelta == b[PORT_SOFT].sri.xdelta
        assert a[PORT_SOFT].t == b[PORT_SOFT].t


def test_resampled_bank_engine_configure_guard():
    from psk_soft_tpu.runtime.resampler import ResampledBankEngine
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    eng = ResampledBankEngine(cfg, 1, 7.3, block_symbols=32, pipeline="ff")
    import dataclasses
    with pytest.raises(ValueError):
        eng.configure(dataclasses.replace(cfg, sps=10))
    eng.configure(dataclasses.replace(cfg, constellation_size=8))
    eng.reset()
