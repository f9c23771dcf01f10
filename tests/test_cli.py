"""End-to-end CLI tests: drive ``python -m psk_soft_tpu`` as a subprocess
through real files, the way a user would (reference analogue: the component
is driven through its deployed entry point, cpp/main.cpp:24-29).

These cover the CLI layer itself -- argparse wiring, chunked file ingest,
EOS flush, output-port file plumbing, channel interleaving -- by comparing
against the in-process engines the rest of the suite already gates.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"   # conftest does this in-process;
    return env                     # subprocesses need it via the environment


def _run(args, expect_fail=False):
    proc = subprocess.run(
        [sys.executable, "-m", "psk_soft_tpu", *args],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=600)
    if expect_fail:
        assert proc.returncode != 0, proc.stdout
    else:
        assert proc.returncode == 0, proc.stderr
    return proc


def _cfg():
    from psk_soft_tpu import DemodConfig
    return DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)


def _signal(channels=1, symbols=384, seed=0):
    from psk_soft_tpu.testing.signals import gen_psk_channel
    out = []
    for c in range(channels):
        x, _ = gen_psk_channel(symbols, 8, 4, snr_db=25.0,
                               freq_offset=1e-4, seed=seed + c)
        out.append(x.astype(np.complex64))
    return np.stack(out)


def test_cli_demod_matches_in_process_engine(tmp_path):
    """demod: file in -> four port files out, chunked reads + EOS, identical
    to one in-process StreamEngine pass over the same samples."""
    x = _signal()[0]
    infile = tmp_path / "iq.cf32"
    infile.write_bytes(x.tobytes())
    prefix = tmp_path / "out"

    proc = _run(["demod", "--in", str(infile), "--out-prefix", str(prefix),
                 "--sps", "8", "-M", "4", "--num-avg", "20",
                 "--phase-avg", "10", "--block-symbols", "64",
                 "--chunk-samples", "1000"])  # non-block-multiple chunks
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])
    assert metrics["samples_in"] == x.size

    soft = np.fromfile(prefix.with_suffix(".soft.cf32"), np.complex64)
    bits = np.fromfile(prefix.with_suffix(".bits.i16"), np.int16)
    phase = np.fromfile(prefix.with_suffix(".phase.f32"), np.float32)
    idx = np.fromfile(prefix.with_suffix(".index.i16"), np.int16)

    # In-process reference: same engine, same config, one packet.
    from psk_soft_tpu.runtime.engine import StreamEngine
    from psk_soft_tpu.runtime.streams import (Packet, SRI, PORT_BITS,
                                              PORT_PHASE, PORT_SAMPLE_INDEX,
                                              PORT_SOFT)
    eng = StreamEngine(_cfg(), block_symbols=64)
    outs = eng.process(Packet(data=x, sri=SRI(stream_id="t", xdelta=1.0,
                                              mode=1), t=0.0, eos=True))
    ref_soft = np.asarray(outs[PORT_SOFT].data)
    ref_bits = np.asarray(outs[PORT_BITS].data)
    ref_phase = np.asarray(outs[PORT_PHASE].data)
    ref_idx = np.asarray(outs[PORT_SAMPLE_INDEX].data)

    assert soft.shape == ref_soft.shape
    np.testing.assert_allclose(soft, ref_soft, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_allclose(phase, ref_phase, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(idx, ref_idx)
    assert metrics["symbols_out"] == soft.size
    assert metrics["bits_out"] == bits.size


def test_cli_demod_batch_interleaved_channels(tmp_path):
    """demod-batch: sample-interleaved multichannel ingest de-interleaves
    correctly -- each channel's soft stream matches a single-channel CLI run
    on that channel alone."""
    C = 2
    xs = _signal(channels=C, symbols=320, seed=7)
    interleaved = np.ascontiguousarray(xs.T)  # (samples, C) row-major
    infile = tmp_path / "batch.cf32"
    infile.write_bytes(interleaved.tobytes())
    prefix = tmp_path / "batch_out"

    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--out-prefix", str(prefix), "--sps", "8", "-M", "4",
                 "--num-avg", "20", "--phase-avg", "10",
                 "--block-symbols", "64", "--chunk-samples", "512"])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])
    assert metrics["samples_in"] == xs.size

    soft = np.fromfile(prefix.with_suffix(".soft.cf32"),
                       np.complex64).reshape(-1, C)
    bits = np.fromfile(prefix.with_suffix(".bits.i16"),
                       np.int16).reshape(-1, C, 2)
    assert soft.shape[0] == bits.shape[0] > 0
    assert np.all(np.isfinite(soft))
    assert np.all((bits == 0) | (bits == 1))

    # Per-channel single-stream reference through the same batch engine
    # semantics (BatchEngine vs StreamEngine equivalence is gated in
    # test_engine_groups.py; here we check the file interleave specifically).
    from psk_soft_tpu.runtime.engine import BatchEngine
    eng = BatchEngine(_cfg(), channels=C, block_symbols=64)
    for c in range(C):
        eng.push(c, xs[c])
    ref_soft = []
    while True:
        out = eng.step()
        if out is None:
            break
        out = jax.device_get(out)
        ref_soft.append(out.soft[:, out.valid[0]])
    ref_soft = np.concatenate(ref_soft, axis=1)  # (C, symbols)
    n = min(soft.shape[0], ref_soft.shape[1])
    assert n > 100
    np.testing.assert_allclose(soft[:n], ref_soft[:, :n].T, rtol=0,
                               atol=1e-5)


def test_cli_gen_writes_expected_sample_count(tmp_path):
    out = tmp_path / "gen.cf32"
    _run(["gen", "--symbols", "100", "--sps", "8", "-M", "4",
          "--seed", "3", "--out", str(out)])
    x = np.fromfile(out, np.complex64)
    assert x.size == 100 * 8
    assert np.all(np.isfinite(x))


def test_cli_demod_batch_ci16_wire_format(tmp_path):
    """demod-batch --in-format ci16: int16 I/Q interleaved frames (the SDR
    ADC wire format) produce the same soft stream as the cf32 run on the
    dequantized signal."""
    C = 2
    xs = _signal(channels=C, symbols=320, seed=11)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    inter = np.ascontiguousarray(xs.T)                 # (samples, C)
    wire = np.empty((inter.shape[0], C, 2), np.int16)
    wire[..., 0] = np.round(inter.real / scale)
    wire[..., 1] = np.round(inter.imag / scale)
    deq = ((wire[..., 0].astype(np.float32) * scale)
           + 1j * (wire[..., 1].astype(np.float32) * scale)).astype(
               np.complex64)

    f16 = tmp_path / "wire.ci16"
    f16.write_bytes(wire.tobytes())
    f32 = tmp_path / "wire.cf32"
    f32.write_bytes(np.ascontiguousarray(deq).tobytes())

    common = ["--channels", str(C), "--sps", "8", "-M", "4",
              "--num-avg", "20", "--phase-avg", "10",
              "--block-symbols", "64", "--chunk-samples", "512"]
    p16 = tmp_path / "out16"
    p32 = tmp_path / "out32"
    _run(["demod-batch", "--in", str(f16), "--in-format", "ci16",
          "--in-scale", repr(scale), "--out-prefix", str(p16), *common])
    _run(["demod-batch", "--in", str(f32), "--out-prefix", str(p32),
          *common])

    s16 = np.fromfile(p16.with_suffix(".soft.cf32"), np.complex64)
    s32 = np.fromfile(p32.with_suffix(".soft.cf32"), np.complex64)
    assert s16.size == s32.size > 0
    np.testing.assert_allclose(s16, s32, rtol=0, atol=1e-5)
    b16 = np.fromfile(p16.with_suffix(".bits.i16"), np.int16)
    b32 = np.fromfile(p32.with_suffix(".bits.i16"), np.int16)
    np.testing.assert_array_equal(b16, b32)


def test_cli_demod_batch_full_pipeline_soft_i8(tmp_path):
    """demod-batch --pipeline full --soft-i8: the steady-step CLI path.
    The int8-quantized run's .soft.cf32 file holds grid-snapped values
    within 0.5/scale per component of the f32 run; the bits file is identical (bits are sliced from the
    full-precision values inside the step)."""
    C, S, sps = 128, 384, 8
    rng = np.random.default_rng(3)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, (C, S)) / 4
                 + 2j * np.pi * 1e-4 * np.arange(S))
    xs = np.repeat(pts, sps, axis=1).astype(np.complex64)
    xs += (0.01 * rng.standard_normal(xs.shape)).astype(np.complex64)
    infile = tmp_path / "bank.cf32"
    infile.write_bytes(np.ascontiguousarray(xs.T).tobytes())

    base = ["demod-batch", "--in", str(infile), "--channels", str(C),
            "--sps", str(sps), "-M", "4", "--num-avg", "50",
            "--phase-avg", "20", "--block-symbols", "128",
            "--pipeline", "full"]
    _run(base + ["--out-prefix", str(tmp_path / "f32")])
    _run(base + ["--out-prefix", str(tmp_path / "i8"), "--soft-i8"])

    a = np.fromfile(tmp_path / "f32.soft.cf32", np.complex64)
    b = np.fromfile(tmp_path / "i8.soft.cf32", np.complex64)
    assert a.size == b.size > 0
    # complex |a-b| combines two 0.5/100 per-component quantization errors.
    assert np.abs(a - b).max() <= 0.7072 / 100.0 + 1e-6
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "f32.bits.i16", np.int16),
        np.fromfile(tmp_path / "i8.bits.i16", np.int16))


def test_cli_demod_batch_native_sps_resampling(tmp_path):
    """demod-batch --native-sps: per-channel fractional native rates are
    resampled to the bank sps before demod.  The CLI plumbing (dequant ->
    ResamplerBank -> engine -> files, incl. the EOS drain) must match the
    same in-process chain; the resampler's DSP correctness itself is gated
    in test_resample.py."""
    from psk_soft_tpu.ops.matched_filter import rrc_taps
    from psk_soft_tpu.runtime.resampler import ResamplerBank

    C, sps, nsym = 2, 8, 420
    native = [7.3, 8.0]

    def bandlimited(seed):
        rng = np.random.default_rng(seed)
        up = np.zeros((nsym + 16) * sps, np.complex128)
        up[::sps] = np.exp(2j * np.pi * rng.integers(0, 4, nsym + 16) / 4
                           + 1j * np.pi / 4)
        return np.convolve(up, rrc_taps(sps, 0.35, 8).astype(np.float64),
                           mode="same")

    from psk_soft_tpu.testing.signals import sinc_interp as sinc_at

    n_capture = nsym * sps  # same capture-sample count on every channel
    # native sample m of channel c sits at common-rate time m / ratio_c
    xs = np.stack([
        sinc_at(bandlimited(20 + c),
                np.arange(n_capture) / (native[c] / sps))
        for c in range(C)]).astype(np.complex64)

    infile = tmp_path / "hetero.cf32"
    infile.write_bytes(np.ascontiguousarray(xs.T).tobytes())
    prefix = tmp_path / "hetero_out"
    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--out-prefix", str(prefix), "--sps", str(sps), "-M", "4",
                 "--num-avg", "20", "--phase-avg", "10",
                 "--block-symbols", "64", "--chunk-samples", "333",
                 "--native-sps", ",".join(str(v) for v in native)])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])
    soft = np.fromfile(prefix.with_suffix(".soft.cf32"),
                       np.complex64).reshape(-1, C)
    assert soft.shape[0] > 300
    assert metrics["symbols_out"] == soft.shape[0] * C
    # samples_in keeps wire semantics (capture samples read); the engine's
    # post-resample count is reported separately (review finding)
    assert metrics["samples_in"] == xs.size
    assert metrics["resampled_in"] > 0

    # in-process oracle: identical chain
    from psk_soft_tpu.runtime.engine import BatchEngine
    rs = ResamplerBank([v / sps for v in native], block_out=64 * sps)
    eng = BatchEngine(_cfg(), channels=C, block_symbols=64)
    for c in range(C):
        rs.push(c, xs[c])
    ref = []

    def pump():
        while True:
            out = eng.step()
            if out is None:
                return
            out = jax.device_get(out)
            ref.append(out.soft[:, out.valid[0]])

    while True:
        blk = rs.step()
        if blk is None:
            break
        eng.push_block(blk)
    for blk in rs.drain(planes=False):
        eng.push_block(blk)
    pump()
    ref = np.concatenate(ref, axis=1)
    n = min(soft.shape[0], ref.shape[1])
    assert n > 300
    np.testing.assert_allclose(soft[:n], ref[:, :n].T, rtol=0, atol=1e-5)


def test_cli_demod_batch_native_sps_full_pipeline(tmp_path):
    """--native-sps with --pipeline full: the resampler's plane-output
    branch (step_planes -> push_planes) and its EOS drain; every channel
    at ratio != 1."""
    from psk_soft_tpu.ops.matched_filter import rrc_taps

    C, sps, nsym = 128, 8, 384
    rng = np.random.default_rng(5)
    native = np.round(rng.uniform(7.0, 9.5, C), 2)

    # band-limited QPSK at the common rate, sampled at each native rate
    taps = rrc_taps(sps, 0.35, 8).astype(np.float64)

    def channel(c):
        r = np.random.default_rng(100 + c)
        up = np.zeros((nsym + 16) * sps, np.complex128)
        up[::sps] = np.exp(2j * np.pi * r.integers(0, 4, nsym + 16) / 4)
        x8 = np.convolve(up, taps, mode="same")
        ratio = native[c] / sps
        t = np.arange(nsym * sps) / ratio
        base = np.floor(t).astype(np.int64)
        # cheap linear interpolation is enough here: the CLI test gates
        # PLUMBING equality against the in-process chain, which sees the
        # identical input
        b1 = np.minimum(base + 1, x8.size - 1)
        fr = t - base
        return ((1 - fr) * x8[np.minimum(base, x8.size - 1)]
                + fr * x8[b1]).astype(np.complex64)

    xs = np.stack([channel(c) for c in range(C)])
    infile = tmp_path / "hetero_full.cf32"
    infile.write_bytes(np.ascontiguousarray(xs.T).tobytes())
    prefix = tmp_path / "hetero_full_out"
    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--out-prefix", str(prefix), "--sps", str(sps), "-M", "4",
                 "--num-avg", "20", "--phase-avg", "10",
                 "--matched-filter", "rrc",
                 "--block-symbols", "64", "--pipeline", "full",
                 "--native-sps", ",".join(str(v) for v in native)])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])
    soft = np.fromfile(prefix.with_suffix(".soft.cf32"),
                       np.complex64).reshape(-1, C)
    assert soft.shape[0] > 200
    assert metrics["symbols_out"] == soft.shape[0] * C
    assert np.all(np.isfinite(soft))
    # every channel demodulates: mid-stream soft decisions near the QPSK
    # circle (|s| ~ 1) once tracking converges
    mags = np.abs(soft[64:-32])
    assert np.median(mags) > 0.7
    assert (np.abs(np.median(mags, axis=0) - 1.0) < 0.35).all()


def test_cli_demod_batch_native_sps_ci16_wire(tmp_path):
    """--native-sps composes with --in-format ci16: the host dequant feeds
    the resampler (the engine's device-side ingest_scale must NOT also be
    applied).  Plumbing-parity vs the cf32 run on the dequantized wire."""
    C = 2
    native = [7.5, 8.25]
    xs = _signal(channels=C, symbols=300, seed=13)  # capture-rate streams
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    inter = np.ascontiguousarray(xs.T)
    wire = np.empty((inter.shape[0], C, 2), np.int16)
    wire[..., 0] = np.round(inter.real / scale)
    wire[..., 1] = np.round(inter.imag / scale)
    deq = ((wire[..., 0].astype(np.float32) * scale)
           + 1j * (wire[..., 1].astype(np.float32) * scale)).astype(
               np.complex64)

    f16 = tmp_path / "rs.ci16"
    f16.write_bytes(wire.tobytes())
    f32 = tmp_path / "rs.cf32"
    f32.write_bytes(np.ascontiguousarray(deq).tobytes())

    common = ["--channels", str(C), "--sps", "8", "-M", "4",
              "--num-avg", "20", "--phase-avg", "10",
              "--block-symbols", "64",
              "--native-sps", ",".join(str(v) for v in native)]
    p16 = tmp_path / "rs16"
    p32 = tmp_path / "rs32"
    _run(["demod-batch", "--in", str(f16), "--in-format", "ci16",
          "--in-scale", repr(scale), "--out-prefix", str(p16), *common])
    _run(["demod-batch", "--in", str(f32), "--out-prefix", str(p32),
          *common])

    s16 = np.fromfile(p16.with_suffix(".soft.cf32"), np.complex64)
    s32 = np.fromfile(p32.with_suffix(".soft.cf32"), np.complex64)
    assert s16.size == s32.size > 0
    np.testing.assert_allclose(s16, s32, rtol=0, atol=1e-5)


def test_cli_demod_batch_acquire_cfo(tmp_path):
    """--acquire-cfo: a carrier 3x beyond the tracker's 1/(2*M*sps) lock
    range demodulates through the CLI (acquisition + NCO in front of the
    engine, runtime/autocfo.py); without the flag the same file fails."""
    C = 2
    sps, m, ns = 8, 4, 1400
    f = 3.0 / (2 * m * sps)
    rng = np.random.default_rng(21)
    xs, syms = [], []
    for c in range(C):
        j = rng.integers(0, m, ns)
        x = np.repeat(np.exp(2j * np.pi * j / m), sps)
        x = x * np.exp(2j * np.pi * (f if c == 0 else -f)
                       * np.arange(x.size))
        x = x + 0.002 * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size))
        xs.append(x.astype(np.complex64))
        syms.append(np.exp(2j * np.pi * j / m))
    xs = np.stack(xs)
    infile = tmp_path / "cfo.cf32"
    infile.write_bytes(np.ascontiguousarray(xs.T).tobytes())

    common = ["--in", str(infile), "--channels", str(C), "--sps", str(sps),
              "-M", str(m), "--num-avg", "20", "--phase-avg", "10",
              "--block-symbols", "64"]

    def _ser(prefix, c):
        soft = np.fromfile(prefix.with_suffix(".soft.cf32"),
                           np.complex64).reshape(-1, C)[200:, c]
        best = 1.0
        for d in range(60):
            e = syms[c][200 + d:200 + d + soft.size]
            s = soft[:e.size]
            for k in range(m):
                rot = np.exp(2j * np.pi * k / m) * np.exp(1j * np.pi / 4)
                best = min(best,
                           float(np.mean(np.abs(s - e * rot) > 0.5)))
        return best

    p_on = tmp_path / "on"
    _run(["demod-batch", *common, "--out-prefix", str(p_on),
          "--acquire-cfo", "--acq-samples", "4096"])
    p_off = tmp_path / "off"
    _run(["demod-batch", *common, "--out-prefix", str(p_off)])

    for c in range(C):
        assert _ser(p_on, c) < 0.01
    assert _ser(p_off, 0) > 0.2


def test_cli_demod_batch_channelize(tmp_path):
    """--channelize: ONE wideband capture -> polyphase filterbank -> bank
    demod.  Soft output must match the in-process ChannelizerFrontEnd +
    BatchEngine pipeline byte-for-byte, and every band must lock."""
    C, K, sps, S = 8, 8, 8, 220
    rng = np.random.default_rng(11)
    n_rows = S * sps
    from psk_soft_tpu.testing.signals import sinc_interp
    n = np.arange(n_rows * C)
    wide = np.zeros(n_rows * C, np.complex64)
    for m in range(C):
        pts = np.exp(2j * np.pi * rng.integers(0, 4, S) / 4)
        up = sinc_interp(np.repeat(pts, sps).astype(np.complex64),
                         np.arange(n_rows * C) / C)
        wide += (up * np.exp(2j * np.pi * m * n / C)).astype(np.complex64)
    infile = tmp_path / "wide.cf32"
    infile.write_bytes(wide.astype(np.complex64).tobytes())
    prefix = tmp_path / "wb_out"

    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--channelize", "--chan-taps", str(K),
                 "--out-prefix", str(prefix), "--sps", str(sps), "-M", "4",
                 "--num-avg", "20", "--phase-avg", "10",
                 "--block-symbols", "64", "--chunk-samples", "1000"])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])
    assert metrics["samples_in"] == wide.size

    soft = np.fromfile(prefix.with_suffix(".soft.cf32"),
                       np.complex64).reshape(-1, C)
    assert soft.shape[0] > 100 and np.isfinite(soft).all()
    # every band locks: soft decisions on the QPSK grid (phase ambiguity
    # folded out)
    ang = np.angle(soft[5:] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    err = np.minimum(ang, np.pi / 2 - ang)
    assert np.percentile(err, 99) < 0.1

    # byte-identical to the in-process pipeline (streaming the filterbank
    # in CLI chunks must not change a single sample)
    from psk_soft_tpu import DemodConfig
    from psk_soft_tpu.runtime.channelizer import ChannelizerFrontEnd
    from psk_soft_tpu.runtime.engine import BatchEngine
    from psk_soft_tpu.runtime.streams import PORT_SOFT, SRI
    cfg = DemodConfig(sps=sps, num_avg=20, constellation_size=4,
                      phase_avg=10)
    fe = ChannelizerFrontEnd(C, taps_per_branch=K)
    fe.push(wide)
    eng = BatchEngine(cfg, C, block_symbols=64)
    eng.set_input_sri(SRI(stream_id="ref", xdelta=1.0))
    ref = []
    while True:
        blk = fe.step_block(64 * sps)
        if blk is None:
            break
        eng.push_block(blk)
        while True:
            pkts = eng.step_packets()
            if pkts is None:
                break
            if pkts:
                ref.append(pkts[PORT_SOFT].data)
    blk = fe.drain(planes=False)
    if blk is not None:
        eng.push_block(blk)
    pkts = eng.flush_packets()
    if pkts and pkts[PORT_SOFT].data.size:
        ref.append(pkts[PORT_SOFT].data)
    ref = np.concatenate(ref, axis=1).T        # (Sv, C)
    np.testing.assert_array_equal(soft, ref.astype(np.complex64))


def test_cli_demod_batch_equalize_uw_quality(tmp_path):
    """demod-batch --equalize --uw --quality-report: the receiver-chain
    flags compose -- CMA equalization in front, UW frame sync + quality
    snapshot behind the packet stream.  Payload bits in frames.jsonl come
    out in the transmitted labeling despite a one-symbol echo plus an
    ambiguity-inducing carrier phase offset."""
    from psk_soft_tpu.ops import slicers
    from psk_soft_tpu.ops.framesync import uw_points

    C, sps = 2, 8
    rng = np.random.default_rng(11)
    uw = rng.integers(0, 4, 32)
    payload = 24
    s_total = 4096
    idx = rng.integers(0, 4, (C, s_total))
    sent = {}
    for c in range(C):
        for i, s0 in enumerate(range(1200, 3800, 400)):
            pl = rng.integers(0, 4, payload)
            idx[c, s0:s0 + 32] = uw
            idx[c, s0 + 32:s0 + 32 + payload] = pl
            sent[(c, i)] = pl
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 2.2)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)
    # One-symbol echo: defeats the raw demod, inverted by --equalize.
    rx = np.zeros_like(x)
    rx[:, :] = x
    rx[:, sps:] += 0.5j * x[:, :-sps]

    infile = tmp_path / "eq_uw.cf32"
    infile.write_bytes(np.ascontiguousarray(rx.T).tobytes())
    prefix = tmp_path / "eq_uw_out"
    qfile = tmp_path / "quality.json"

    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--out-prefix", str(prefix), "--sps", str(sps), "-M", "4",
                 "--num-avg", "50", "--phase-avg", "50",
                 "--block-symbols", "256",
                 "--equalize", "--eq-taps", "33", "--eq-mu", "5e-5",
                 "--uw", ",".join(str(v) for v in uw),
                 "--frame-payload", str(payload), "--uw-threshold", "0.7",
                 "--quality-report", str(qfile)])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])

    frames = [json.loads(line) for line in
              open(f"{prefix}.frames.jsonl").read().splitlines()]
    assert metrics["frames_synced"] == len(frames)
    # The equalizer needs ~1200 symbols to converge; every frame after
    # that must be detected with exact payload bits.
    assert len(frames) >= 5 * C, len(frames)

    def ideal_bits(pl):
        pts = uw_points(pl, 4)
        return np.asarray(slicers.slice_bits(4, pts))[:, :2].reshape(-1)

    per_chan = {c: sorted([f for f in frames if f["channel"] == c],
                          key=lambda f: f["start"]) for c in range(C)}
    exact = total = 0
    for c in range(C):
        for f in per_chan[c]:
            # match to the transmitted frame grid by payload comparison
            best = min(abs(np.asarray(f["bits"]) - ideal_bits(sent[(c, i)])
                           ).sum() for i in range(7))
            total += 1
            exact += best == 0
    assert exact == total, (exact, total)

    q = json.loads(qfile.read_text())
    assert len(q["snr_db"]) == C
    # Steady-state through the converged equalizer: ~20-25% residual EVM
    # (CMA excess error at this mu/echo), lock ~0.75 -- assert the
    # composition works, not a convergence benchmark.
    assert all(v > 0.6 for v in q["lock"]), q
    assert all(v > 8.0 for v in q["snr_db"]), q
    assert all(v < 35.0 for v in q["evm_pct"]), q


def test_cli_demod_batch_fec(tmp_path):
    """demod-batch --uw --fec k7: frame payloads carry the K=7 rate-1/2
    code; frames.jsonl gains exact info_bits with corrected/suspect
    accounting, and the stderr metrics line reports the FEC counters."""
    from psk_soft_tpu.ops import slicers
    from psk_soft_tpu.ops.fec import CODE_K7, conv_encode
    from psk_soft_tpu.ops.framesync import psk_points

    C, sps = 2, 8
    rng = np.random.default_rng(12)
    uw = rng.integers(0, 4, 32)
    payload = 64                               # 128 code bits -> 58 info
    s_total = 2048
    idx = rng.integers(0, 4, (C, s_total))

    pts = psk_points(np.arange(4), 4)
    labels = np.asarray(slicers.slice_bits(4, pts))[:, :2]
    lut = np.zeros(4, np.int64)
    for sym, (b0, b1) in enumerate(labels):
        lut[b0 + 2 * b1] = sym

    sent = {}
    starts = list(range(300, 1800, 300))
    for c in range(C):
        for i, s0 in enumerate(starts):
            info = rng.integers(0, 2, 58)
            coded = np.asarray(conv_encode(CODE_K7, info)).reshape(-1, 2)
            idx[c, s0:s0 + 32] = uw
            idx[c, s0 + 32:s0 + 32 + payload] = \
                lut[coded[:, 0] + 2 * coded[:, 1]]
            sent[(c, i)] = info
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.9)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)

    infile = tmp_path / "fec.cf32"
    infile.write_bytes(np.ascontiguousarray(x.T).tobytes())
    prefix = tmp_path / "fec_out"

    proc = _run(["demod-batch", "--in", str(infile), "--channels", str(C),
                 "--out-prefix", str(prefix), "--sps", str(sps), "-M", "4",
                 "--num-avg", "20", "--phase-avg", "20",
                 "--block-symbols", "256",
                 "--uw", ",".join(str(v) for v in uw),
                 "--frame-payload", str(payload),
                 "--fec", "k7"])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])

    frames = [json.loads(line) for line in
              open(f"{prefix}.frames.jsonl").read().splitlines()]
    assert metrics["frames_synced"] == len(frames)
    assert metrics["frames_decoded"] == len(frames)
    assert metrics["suspect_frames"] == 0
    assert len(frames) == len(starts) * C
    for f in frames:
        i = starts.index(f["start"])
        want = sent[(f["channel"], i)]
        assert np.array_equal(np.asarray(f["info_bits"]), want)
        assert not f["suspect"]
    assert metrics["errors_corrected"] == sum(f["corrected"]
                                              for f in frames)


def test_cli_fec_requires_uw_and_validates(tmp_path):
    infile = tmp_path / "x.cf32"
    infile.write_bytes(np.zeros(1024, np.complex64).tobytes())
    proc = subprocess.run(
        [sys.executable, "-m", "psk_soft_tpu", "demod-batch",
         "--in", str(infile), "--channels", "1",
         "--out-prefix", str(tmp_path / "o"), "--fec", "k7"],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "requires --uw" in proc.stderr
    # payload too short for the flush bits -> clean SystemExit, not a trace
    proc = subprocess.run(
        [sys.executable, "-m", "psk_soft_tpu", "demod-batch",
         "--in", str(infile), "--channels", "1",
         "--out-prefix", str(tmp_path / "o"), "--uw", "0,1,2,3",
         "--frame-payload", "3", "--fec", "k7"],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "--fec:" in proc.stderr


def test_cli_demod_batch_descramble(tmp_path):
    """--uw --descramble prbs15: frame payload bits were additively
    scrambled at TX; frames.jsonl carries the descrambled originals.
    --descramble-selfsync: the continuous bits port equals the in-process
    StreamDescrambler applied to the undescrambled run's bits."""
    from psk_soft_tpu.ops import slicers
    from psk_soft_tpu.ops.framesync import psk_points
    from psk_soft_tpu.ops.scramble import additive_scramble, prbs15
    from psk_soft_tpu.runtime.scramble import StreamDescrambler

    C, sps = 1, 8
    rng = np.random.default_rng(13)
    uw = rng.integers(0, 4, 32)
    payload = 40
    s_total = 1500
    idx = rng.integers(0, 4, (C, s_total))

    pts = psk_points(np.arange(4), 4)
    labels = np.asarray(slicers.slice_bits(4, pts))[:, :2]
    lut = np.zeros(4, np.int64)
    for sym, (b0, b1) in enumerate(labels):
        lut[b0 + 2 * b1] = sym

    lf = prbs15()
    sent = {}
    starts = list(range(200, 1300, 250))
    for i, s0 in enumerate(starts):
        info = rng.integers(0, 2, payload * 2, np.int8)
        wire = np.asarray(additive_scramble(lf, info)).reshape(-1, 2)
        idx[0, s0:s0 + 32] = uw
        idx[0, s0 + 32:s0 + 32 + payload] = lut[wire[:, 0] + 2 * wire[:, 1]]
        sent[i] = info
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)

    infile = tmp_path / "scr.cf32"
    infile.write_bytes(np.ascontiguousarray(x.T).tobytes())

    base = ["demod-batch", "--in", str(infile), "--channels", str(C),
            "--sps", str(sps), "-M", "4", "--num-avg", "20",
            "--phase-avg", "20", "--block-symbols", "256",
            "--uw", ",".join(str(v) for v in uw),
            "--frame-payload", str(payload)]

    p1 = tmp_path / "scr_a"
    _run(base + ["--out-prefix", str(p1), "--descramble", "prbs15"])
    frames = [json.loads(line) for line in
              open(f"{p1}.frames.jsonl").read().splitlines()]
    assert len(frames) == len(starts)
    for f in frames:
        want = sent[starts.index(f["start"])]
        assert np.array_equal(np.asarray(f["bits"]), want)

    # Self-sync plumbing: CLI output == in-process descramble of the
    # plain run's bits port.
    p2 = tmp_path / "scr_b"
    p3 = tmp_path / "scr_c"
    _run(base + ["--out-prefix", str(p2)])
    _run(base + ["--out-prefix", str(p3), "--descramble-selfsync", "18,23"])
    plain = np.fromfile(f"{p2}.bits.i16", np.int16)
    got = np.fromfile(f"{p3}.bits.i16", np.int16)
    want = StreamDescrambler(C, (18, 23)).observe(
        plain.reshape(1, -1).astype(np.int8)).reshape(-1)
    assert np.array_equal(got, want.astype(np.int16))

    # validation: bad preset / missing --uw exit cleanly
    proc = subprocess.run(
        [sys.executable, "-m", "psk_soft_tpu", *base[:9],
         "--out-prefix", str(tmp_path / "o"), "--descramble", "prbs9"],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and "--descramble" in proc.stderr


def test_cli_probe(tmp_path):
    """probe: blind per-channel baud / order / CFO survey of a capture."""
    rng = np.random.default_rng(14)

    def rect(m, cfo, sps=8, n_sym=2000):
        idx = rng.integers(0, m, n_sym)
        x = np.repeat(np.exp(2j * np.pi * idx / m), sps)
        x = x * np.exp(2j * np.pi * cfo * np.arange(x.size))
        x = x + 0.05 * (rng.standard_normal(x.size)
                        + 1j * rng.standard_normal(x.size))
        return x.astype(np.complex64)

    a = rect(4, 0.012)
    b = rect(8, -0.004)
    infile = tmp_path / "probe.cf32"
    infile.write_bytes(
        np.ascontiguousarray(np.stack([a, b]).T).tobytes())

    proc = _run(["probe", "--in", str(infile), "--channels", "2"])
    rows = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [r["m"] for r in rows] == [4, 8]
    assert abs(rows[0]["sps"] - 8) < 0.05 and abs(rows[1]["sps"] - 8) < 0.05
    assert abs(rows[0]["cfo"] - 0.012) < 3e-4
    assert abs(rows[1]["cfo"] + 0.004) < 3e-4
    assert all(r["baud_confidence"] > 5 and r["line_confidence"] > 8
               for r in rows)


def test_cli_gen_frames_full_loop(tmp_path):
    """gen-frames -> demod-batch closes the loop: a coded + scrambled
    framed capture generated by the TX CLI demodulates back to the exact
    ground-truth info bits through --uw --fec --descramble."""
    uw = ",".join(str(v) for v in
                  np.random.default_rng(15).integers(0, 4, 32))
    cap = tmp_path / "link.cf32"
    truth_path = tmp_path / "truth.jsonl"
    gen = _run(["gen-frames", "--out", str(cap), "--truth", str(truth_path),
                "--channels", "2", "--symbols", "2200", "--sps", "8",
                "-M", "4", "--uw", uw, "--frame-payload", "64",
                "--fec", "k7", "--scramble", "prbs15", "--crc", "crc16",
                "--labeling", "gray", "--interleave", "8",
                "--frame-interval", "300",
                "--snr", "18", "--freq-offset", "2e-4", "--seed", "3"])
    assert "info bits/frame" in gen.stderr

    prefix = tmp_path / "rx"
    rx = _run(["demod-batch", "--in", str(cap), "--channels", "2",
               "--out-prefix", str(prefix), "--sps", "8", "-M", "4",
               "--num-avg", "20", "--phase-avg", "30",
               "--block-symbols", "256",
               "--uw", uw, "--frame-payload", "64",
               "--fec", "k7", "--descramble", "prbs15", "--crc", "crc16",
               "--fec-labeling", "gray", "--fec-interleave", "8"])
    metrics = json.loads(rx.stderr.strip().splitlines()[-1])
    assert metrics["crc_failures"] == 0

    truth = {}
    for line in open(truth_path).read().splitlines():
        r = json.loads(line)
        truth[(r["channel"], r["start"])] = np.asarray(r["info_bits"])
    frames = [json.loads(line) for line in
              open(f"{prefix}.frames.jsonl").read().splitlines()]
    # Every transmitted frame past warm-up must come back exact.
    assert len(frames) >= len(truth) - 2, (len(frames), len(truth))
    for f in frames:
        want = truth[(f["channel"], f["start"])]
        assert not f["suspect"]
        assert f["crc_ok"] is True
        assert np.array_equal(np.asarray(f["info_bits"]), want), \
            (f["channel"], f["start"])


def test_cli_fec_stream(tmp_path):
    """--fec-stream: the CLI's decoded continuous bit stream equals the
    in-process StreamFecDecoder run over the same soft port output."""
    from psk_soft_tpu.runtime.fec import StreamFecDecoder

    C = 2
    x = _signal(channels=C, symbols=900, seed=4)
    infile = tmp_path / "sf.cf32"
    infile.write_bytes(np.ascontiguousarray(x.T).tobytes())

    base = ["demod-batch", "--in", str(infile), "--channels", str(C),
            "--sps", "8", "-M", "4", "--num-avg", "20", "--phase-avg",
            "20", "--block-symbols", "128"]
    p1 = tmp_path / "sf_a"
    p2 = tmp_path / "sf_b"
    _run(base + ["--out-prefix", str(p1)])
    proc = _run(base + ["--out-prefix", str(p2), "--fec-stream", "k7"])
    metrics = json.loads(proc.stderr.strip().splitlines()[-1])

    soft = np.fromfile(f"{p1}.soft.cf32", np.complex64).reshape(-1, C).T
    dec = StreamFecDecoder(C, code=__import__(
        "psk_soft_tpu.ops.fec", fromlist=["CODE_K7"]).CODE_K7, m=4)
    dec.observe(np.ascontiguousarray(soft))
    dec.finalize()
    want = dec.pop_bits()

    got = np.fromfile(f"{p2}.fecstream.i8", np.int8).reshape(-1, C).T
    assert metrics["fec_stream_bits"] == want.shape[1]
    assert np.array_equal(got, want)


def test_cli_demod_batch_auto(tmp_path):
    """--auto: the bank self-configures (sps, M) from a blind probe of the
    capture head, replays the head, and produces output byte-identical to
    an explicitly configured run."""
    C, sps, m = 2, 8, 8
    rng = np.random.default_rng(16)
    n_sym = 2600
    idx = rng.integers(0, m, (C, n_sym))
    x = np.repeat(np.exp(2j * np.pi * (idx / m + 0.03)), sps, axis=1)
    x = (x + 0.03 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)
    infile = tmp_path / "auto.cf32"
    infile.write_bytes(np.ascontiguousarray(x.T).tobytes())

    base = ["demod-batch", "--in", str(infile), "--channels", str(C),
            "--num-avg", "20", "--phase-avg", "20",
            "--block-symbols", "128"]
    pa = tmp_path / "auto_a"
    pb = tmp_path / "auto_b"
    # deliberately wrong defaults (--sps 10, -M 4) + --auto
    proc = _run(base + ["--out-prefix", str(pa), "--auto",
                        "--auto-samples", "8192"])
    auto_line = json.loads(proc.stderr.strip().splitlines()[-2])
    assert auto_line["auto"]["sps"] == sps
    assert auto_line["auto"]["m"] == m
    _run(base + ["--out-prefix", str(pb), "--sps", str(sps),
                 "-M", str(m)])
    for ext in (".soft.cf32", ".bits.i16", ".phase.f32", ".index.i16"):
        assert (pa.parent / (pa.name + ext)).read_bytes() == \
            (pb.parent / (pb.name + ext)).read_bytes(), ext

    # graceful failure on noise
    noise = tmp_path / "noise.cf32"
    noise.write_bytes((0.1 * (rng.standard_normal(40000)
                              + 1j * rng.standard_normal(40000))
                       ).astype(np.complex64).tobytes())
    proc = subprocess.run(
        [sys.executable, "-m", "psk_soft_tpu", "demod-batch",
         "--in", str(noise), "--channels", "1",
         "--out-prefix", str(tmp_path / "o"), "--auto"],
        cwd=REPO, env=_cpu_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode != 0 and "--auto" in proc.stderr


def test_cli_fused_chain_loop(tmp_path):
    """demod-batch --fused-chain: the one-launch ChainEngine behind the
    CLI closes the gen-frames loop -- every planted frame (past warm-up)
    back exact with CRC green, plus validation of the flag contract."""
    uw = ",".join(str(v) for v in
                  np.random.default_rng(16).integers(0, 4, 32))
    cap = tmp_path / "fused.cf32"
    truth_path = tmp_path / "truth.jsonl"
    _run(["gen-frames", "--out", str(cap), "--truth", str(truth_path),
          "--channels", "128", "--symbols", "1536", "--sps", "8",
          "-M", "4", "--uw", uw, "--frame-payload", "48",
          "--fec", "k7", "--crc", "crc16", "--labeling", "gray",
          "--frame-interval", "333", "--snr", "25", "--seed", "4"])
    prefix = tmp_path / "rx"
    rx = _run(["demod-batch", "--in", str(cap), "--channels", "128",
               "--out-prefix", str(prefix), "--sps", "8", "-M", "4",
               "--num-avg", "40", "--phase-avg", "30",
               "--block-symbols", "256", "--fused-chain",
               "--uw", uw, "--frame-payload", "48",
               "--fec", "k7", "--fec-labeling", "gray", "--crc", "crc16"])
    metrics = json.loads(rx.stderr.strip().splitlines()[-1])
    assert metrics["crc_failures"] == 0
    assert metrics["overflow_peaks"] == 0
    truth = {}
    for line in open(truth_path).read().splitlines():
        r = json.loads(line)
        truth[(r["channel"], r["start"])] = r["info_bits"]
    frames = [json.loads(line) for line in
              open(f"{prefix}.frames.jsonl").read().splitlines()]
    n_ok = 0
    for f in frames:
        want = truth.get((f["channel"], f["start"]))
        assert want is not None, (f["channel"], f["start"])
        assert f["crc_ok"] is True
        assert f["info_bits"][:len(want)] == want
        n_ok += 1
    # all planted frames except (at most) the warm-up block's own
    assert n_ok >= len(truth) - 128, (n_ok, len(truth))
    # contract validation: wrappers and missing flags rejected loudly
    bad = _run(["demod-batch", "--in", str(cap), "--channels", "128",
                "--out-prefix", str(prefix), "--fused-chain"],
               expect_fail=True)
    assert "requires --uw and --fec" in bad.stderr
    bad = _run(["demod-batch", "--in", str(cap), "--channels", "128",
                "--out-prefix", str(prefix), "--fused-chain",
                "--uw", uw, "--frame-payload", "48", "--fec", "k7",
                "--fec-labeling", "gray", "--agc"], expect_fail=True)
    assert "per-stage stack" in bad.stderr
