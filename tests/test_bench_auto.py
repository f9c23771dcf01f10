"""bench.py plumbing (measurement functions stubbed): it refuses any
device but a GPU, runs one demod path per invocation, and tags every JSON
line with the platform, device kind, device count and power limit."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from psk_soft_tpu.utils import device_env

ROOT = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture()
def bench(monkeypatch):
    spec = importlib.util.spec_from_file_location("bench_mod",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def fake_gpu(monkeypatch):
    """Pretend the CPU is the card: skip the platform gate and the compile
    cache, and answer nvidia-smi with a fixed line."""
    monkeypatch.setattr(device_env, "require_gpu", lambda: None)
    monkeypatch.setattr(device_env, "enable_compile_cache", lambda: "")
    monkeypatch.setattr(device_env, "card_lines", lambda: [CARD])


def _main(bench, monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    assert bench.main() == 0
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def _stub(bench, monkeypatch, calls):
    monkeypatch.setattr(
        bench, "run_full",
        lambda args, cfg, C, T, x_np, raw_tail=False, mixed=None:
        calls.append("full") or 5e9)
    monkeypatch.setattr(
        bench, "run_ff",
        lambda args, cfg, C, T, x_np: calls.append("ff") or 1e9)
    monkeypatch.setattr(
        bench, "run_chain",
        lambda args: calls.append("chain")
        or bench.emit("chain", 1e8, "infobits/s"))


def test_bench_refuses_cpu_device(bench, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)
    assert "GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_default_run_emits_demod_then_chain(bench, monkeypatch, capsys,
                                            fake_gpu):
    calls = []
    _stub(bench, monkeypatch, calls)
    lines = _main(bench, monkeypatch, capsys, [])
    assert calls == ["full", "chain"]          # one demod path, no race
    assert [o["unit"] for o in lines] == ["samples/s", "infobits/s"]
    assert "steady" in lines[0]["metric"]
    assert lines[0]["value"] == 5e9


def test_every_line_names_the_device(bench, monkeypatch, capsys, fake_gpu):
    _stub(bench, monkeypatch, [])
    for o in _main(bench, monkeypatch, capsys, []):
        assert o["platform"] == "cpu"
        assert o["device_count"] >= 1
        assert o["device_kind"]
        assert o["power_limit"] == ["700.00 W"]
        assert "vs_baseline" not in o


def test_pipeline_ff_emits_one_line(bench, monkeypatch, capsys, fake_gpu):
    calls = []
    _stub(bench, monkeypatch, calls)
    lines = _main(bench, monkeypatch, capsys, ["--pipeline", "ff"])
    assert calls == ["ff"]
    assert len(lines) == 1 and "(ff)" in lines[0]["metric"]


@pytest.mark.parametrize("flags,label", [
    (["--ingest", "i16"], "i16-ingest"),
    (["--soft", "i8"], "soft-i8"),
    (["--no-debug-ports"], "no-debug-ports"),
])
def test_demod_label_names_the_profile(bench, monkeypatch, capsys, fake_gpu,
                                       flags, label):
    _stub(bench, monkeypatch, [])
    lines = _main(bench, monkeypatch, capsys, flags)
    assert label in lines[0]["metric"]


def test_chain_profile_runs_chain_only(bench, monkeypatch, capsys,
                                       fake_gpu):
    calls = []
    _stub(bench, monkeypatch, calls)
    _main(bench, monkeypatch, capsys, ["--profile", "chain"])
    assert calls == ["chain"]


def test_bench_checks_device_before_compiling(bench, monkeypatch):
    """The platform gate runs before the compile cache is touched and
    before any measurement."""
    order = []
    monkeypatch.setattr(device_env, "require_gpu",
                        lambda: order.append("gpu"))
    monkeypatch.setattr(device_env, "enable_compile_cache",
                        lambda: order.append("cache") or "")
    monkeypatch.setattr(bench, "run_chain",
                        lambda args: order.append("chain") or 0)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--profile", "chain"])
    bench.main()
    assert order == ["gpu", "cache", "chain"]
