"""Entry-point set-up helpers (psk_soft_tpu/utils/device_env.py)."""

import jax
import pytest

from psk_soft_tpu.utils import device_env


@pytest.fixture()
def cache_config():
    """Restore JAX's cache directory after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_wins(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device_env.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # untouched


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device_env.enable_compile_cache()
    assert path == str(device_env.CHECKOUT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert (device_env.CHECKOUT / "pyproject.toml").exists()
    # Fixed path: a second call (another process) lands in the same place.
    assert device_env.enable_compile_cache() == path


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        device_env.require_gpu()


def test_device_tags_parse_power_limits(monkeypatch):
    monkeypatch.setattr(device_env, "card_lines", lambda: [
        "NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3, 500.00 W"])
    tags = device_env.device_tags()
    assert tags["power_limit"] == ["700.00 W", "500.00 W"]
    assert tags["platform"] == jax.devices()[0].platform
    assert tags["device_count"] == len(jax.devices())
