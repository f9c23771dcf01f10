"""Test configuration: run on a virtual 8-device CPU mesh by default.

Multi-device sharding tests follow SURVEY.md section 4's implication (c):
sharded output must equal single-device output, runnable on CPU with
``--xla_force_host_platform_device_count=N``.  JAX_PLATFORMS defaults to
the CPU here; tests marked ``gpu`` need the card and run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (they skip
elsewhere, decided inside the ``gpu`` fixture at run time).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (checked per test, never
    at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
    return jax.devices()[0]
