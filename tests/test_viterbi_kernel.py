"""Viterbi kernel == XLA scan decoder, bit for bit.

The kernel (ops/pallas/viterbi_kernel.py) runs in the Pallas interpreter on
the CPU; the XLA scan decoder is itself oracle-gated in test_fec.py, so
equality here chains the kernel to the numpy register-walk reference.
Shapes are deliberately awkward (row counts off the row tile, odd trellis
lengths) to exercise the padding paths.  The compiled kernel is compared
with the scan on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu.ops.fec import (CODE_K3, CODE_K7, CODE_K9, PUNCTURE_2_3,
                                  PUNCTURE_3_4, ConvCode, _resolve_backend,
                                  conv_encode, hard_llrs, viterbi_decode,
                                  viterbi_decode_parallel)
from psk_soft_tpu.ops.pallas.viterbi_kernel import (ROW_TILE, _bit_reverse,
                                                    butterfly_signs,
                                                    viterbi_decode_pallas)
from test_fec import oracle_viterbi


def _noisy_llrs(code, bits, sigma, rng, terminate=True):
    enc = np.asarray(conv_encode(code, jnp.asarray(bits),
                                 terminate=terminate))
    return (np.asarray(hard_llrs(enc))
            + sigma * rng.standard_normal(enc.shape).astype(np.float32))


@pytest.mark.parametrize("code,n_info", [(CODE_K3, 61), (CODE_K7, 97)])
@pytest.mark.parametrize("terminate", [True, False])
def test_decode_parity(code, n_info, terminate):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, n_info)).astype(np.int8)
    llr = _noisy_llrs(code, bits, 0.4, rng)
    ref = np.asarray(viterbi_decode(code, llr, terminate=terminate,
                                    backend="xla"))
    out = np.asarray(viterbi_decode_pallas(code, llr, terminate=terminate))
    np.testing.assert_array_equal(out, ref)
    if terminate:
        np.testing.assert_array_equal(ref, bits)   # sigma small enough


def test_decode_parity_k9_and_puncture():
    rng = np.random.default_rng(1)
    code = CODE_K9
    bits = rng.integers(0, 2, (2, 40)).astype(np.int8)
    llr = _noisy_llrs(code, bits, 0.3, rng)
    np.testing.assert_array_equal(
        np.asarray(viterbi_decode(code, llr, backend="pallas")),
        np.asarray(viterbi_decode(code, llr, backend="xla")))

    punct = ConvCode(7, (0o171, 0o133), PUNCTURE_2_3)
    bits = rng.integers(0, 2, (2, 64)).astype(np.int8)
    llr = _noisy_llrs(punct, bits, 0.2, rng)
    np.testing.assert_array_equal(
        np.asarray(viterbi_decode(punct, llr, backend="pallas")),
        np.asarray(viterbi_decode(punct, llr, backend="xla")))


def test_parallel_decode_backend_parity():
    code = CODE_K3
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 160)).astype(np.int8)
    llr = _noisy_llrs(code, bits, 0.2, rng, terminate=False)
    ref = np.asarray(viterbi_decode_parallel(code, llr, chunk=32, margin=14,
                                             backend="xla"))
    out = np.asarray(viterbi_decode_parallel(code, llr, chunk=32, margin=14,
                                             backend="pallas"))
    np.testing.assert_array_equal(out, ref)


def test_butterfly_signs_layout():
    """Entry [a, p, :, i] carries exp[s', p] for s' = (a << (K-2)) | rev(i),
    the successor the kernel writes at bit-reversed position 2i + a."""
    from psk_soft_tpu.ops.fec import _trellis

    for code in (CODE_K3, CODE_K7, CODE_K9):
        _, exp = _trellis(code)
        signs = butterfly_signs(code)
        m = code.k - 1
        half = code.states // 2
        assert signs.shape == (2, 2, code.n, half)
        for i in [0, 1, half // 2, half - 1]:
            for a in range(2):
                sp = (a << (m - 1)) | int(_bit_reverse(i, m - 1))
                assert _bit_reverse(2 * i + a, m) == sp
                for p in range(2):
                    np.testing.assert_array_equal(signs[a, p, :, i],
                                                  exp[sp, p])


def test_backend_validation():
    with pytest.raises(ValueError):
        viterbi_decode(CODE_K3, np.zeros(16, np.float32), backend="cuda")


def test_decode_parity_fuzz():
    # Seeded property fuzz: random constraint lengths, polynomials,
    # frame lengths, batch sizes, modes -- the kernel must equal the XLA
    # scan decoder bit for bit.
    rng = np.random.default_rng(99)
    for trial in range(6):
        k = int(rng.choice([3, 4, 5, 7]))
        polys = tuple(int(p) | (1 << (k - 1)) | 1
                      for p in rng.integers(1, 1 << k, 2))
        if polys[0] == polys[1]:
            continue
        code = ConvCode(k, polys)
        t = int(rng.integers(20, 300))
        b = int(rng.integers(1, 8))
        terminate = bool(rng.integers(0, 2))
        bits = rng.integers(0, 2, (b, t)).astype(np.int8)
        enc = np.asarray(hard_llrs(conv_encode(code, bits,
                                               terminate=terminate)))
        llr = (enc + 0.35 * rng.standard_normal(enc.shape)
               ).astype(np.float32)
        ref = np.asarray(viterbi_decode(code, llr, terminate=terminate,
                                        backend="xla"))
        out = np.asarray(viterbi_decode_pallas(code, llr,
                                               terminate=terminate))
        np.testing.assert_array_equal(out, ref, err_msg=str(
            (trial, k, polys, t, b, terminate)))


_CODES = {"k7": CODE_K7, "k9": CODE_K9,
          "k7p34": ConvCode(7, (0o171, 0o133), PUNCTURE_3_4)}


@pytest.mark.parametrize("name", sorted(_CODES))
@pytest.mark.parametrize("terminate", [True, False])
@pytest.mark.parametrize("rows", [1, ROW_TILE + 3])
def test_kernel_matches_scan_and_oracle(name, terminate, rows):
    """K=7, K=9 and punctured K=7, both termination modes, row counts off
    the row tile: kernel == XLA scan == numpy oracle."""
    code = _CODES[name]
    rng = np.random.default_rng(rows + 7 * terminate)
    n_info = 48 if code.puncture is None else 51
    bits = rng.integers(0, 2, (rows, n_info)).astype(np.int8)
    llr = _noisy_llrs(code, bits, 0.5, rng, terminate=terminate)
    ref = np.asarray(viterbi_decode(code, llr, terminate=terminate,
                                    backend="xla"))
    out = np.asarray(viterbi_decode_pallas(code, llr, terminate=terminate))
    np.testing.assert_array_equal(out, ref)
    from psk_soft_tpu.ops.fec import depuncture
    full = np.asarray(depuncture(code, llr))
    for r in (0, rows - 1):
        np.testing.assert_array_equal(
            out[r], oracle_viterbi(code, full[r], terminate=terminate))


def test_auto_backend_by_platform(monkeypatch):
    """auto takes the kernel on a GPU and the XLA scan on the CPU."""
    import jax

    assert _resolve_backend("auto") == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve_backend("auto") == "pallas"
    assert _resolve_backend("xla") == "xla"
