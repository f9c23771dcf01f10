"""chip_smoke.py: the refusal off the card, and every phase at tiny size on
the CPU (the Viterbi kernel in the Pallas interpreter, the 8-device
virtual mesh for the multi-card phases)."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(channels=8, symbols=256, sps=8, num_avg=20, phase_avg=12,
            uw_len=16, payload=32)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_refuses_cpu(smoke, capsys):
    assert smoke.main([]) != 0
    assert smoke.main(["--cards", "4"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_viterbi_tiny(smoke):
    smoke.phase_viterbi(rows=8)


def test_phase_demod_tiny(smoke):
    smoke.phase_demod(c=8, s=128, sps=8, num_avg=20, phase_avg=12)


def test_phase_chain_and_stack_tiny(smoke):
    frames, x = smoke.phase_chain(TINY, blocks=5, expect_kernel=False)
    assert frames
    smoke.phase_stack(frames, x, TINY, blocks=5)


def test_phase_engines_tiny(smoke):
    smoke.phase_engines(c=8, s=128, sps=8, num_avg=20, phase_avg=12,
                        blocks=3)


def test_phase_cli_tiny(smoke):
    smoke.phase_cli(channels=4, symbols=1536)


def test_phase_sharded_chain_tiny(smoke):
    smoke.phase_sharded_chain(n_dev=4, ch_per_dev=2, w=TINY)


def test_phase_time_sharded_tiny(smoke):
    smoke.phase_time_sharded(n_dev=4, c=4, total=256, w=TINY)
