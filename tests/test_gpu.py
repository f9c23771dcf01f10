"""Tests that need the card: the compiled Viterbi kernel and the steady
step on the GPU against their plain references.  They skip elsewhere (the
``gpu`` fixture decides at run time); run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import numpy as np
import jax.numpy as jnp
import pytest

from psk_soft_tpu import DemodConfig
from psk_soft_tpu.ops import fec

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("code", [fec.CODE_K7, fec.CODE_K9])
def test_compiled_viterbi_matches_scan(gpu, code):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (1000, 60)).astype(np.int8)
    coded = np.asarray(fec.conv_encode(code, jnp.asarray(bits)))
    llr = jnp.asarray((1.0 - 2.0 * coded)
                      + 0.6 * rng.standard_normal(coded.shape), jnp.float32)
    got = np.asarray(fec.viterbi_decode(code, llr))        # auto: kernel
    ref = np.asarray(fec.viterbi_decode(code, llr, backend="xla"))
    np.testing.assert_array_equal(got, ref)


def test_steady_step_matches_ff_on_gpu(gpu):
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu.models.full import (full_from_ff, make_full_demod_fn,
                                          to_demod_outputs)

    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    c, s = 300, 256
    rng = np.random.default_rng(1)
    j = rng.integers(0, 4, (c, 2 * s))
    x = np.zeros((c, 2 * s * 8), np.complex64)
    x[:, 2::8] = np.exp(2j * np.pi * (j / 4 + 8e-4 * np.arange(2 * s)))
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    warm, run = np.split(x, 2, axis=1)
    ff = make_ff_demod_fn(cfg, channels=c)
    st_ff, _ = ff(ff_init(cfg, (c,)), jnp.asarray(warm))
    _, out = make_full_demod_fn(cfg)(full_from_ff(cfg, st_ff),
                                     jnp.asarray(run.real.T),
                                     jnp.asarray(run.imag.T))
    out = to_demod_outputs(cfg, out)
    _, ref = ff(st_ff, jnp.asarray(run))
    np.testing.assert_array_equal(np.asarray(out.sample_index),
                                  np.asarray(ref.sample_index))
    np.testing.assert_allclose(np.asarray(out.soft), np.asarray(ref.soft),
                               atol=3e-3)
