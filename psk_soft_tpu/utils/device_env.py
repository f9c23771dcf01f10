"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compile cache, and what the measuring tools say about the
card they ran on."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is overridden here.  Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` -- a stable path, so a later process finds
    what an earlier one compiled.  Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU (SystemExit otherwise): a
    measurement taken on any other device is not a measurement of this
    system's target, so there is no fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")
    return dev


def card_lines() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card (a
    card below its maximum power limit runs slower under load, so every
    kept number carries this)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_tags() -> dict:
    """Platform, device kind, device count and power limit(s) of this run,
    for every printed result."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "power_limit": [line.split(",")[-1].strip()
                            for line in card_lines()]}
