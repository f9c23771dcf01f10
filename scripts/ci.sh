#!/usr/bin/env bash
# CI entry point (the reference's .gitlab-ci.yml analog: build + test with
# static analysis; coverage optional).  Runs on CPU with a virtual 8-device
# mesh; the GPU run is a separate stage (chip_smoke.py, bench.py).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native build =="
make -C native

echo "== native static analysis (gcc -fanalyzer; cppcheck-stage analog) =="
make -C native analyze

echo "== version attestation + jax API-surface probe =="
# The reference CI pins its toolchain matrix (.gitlab-ci.yml:88-116); this
# env cannot install alternate jax versions, so drift fails loudly instead
# (TESTED_VERSIONS.txt) and the semi-private surfaces the repo leans on
# (Pallas Triton interpret, shard_map collectives, sized nonzero, ...) are probed
# in seconds rather than mid-suite.
env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python scripts/jax_compat_probe.py

echo "== static checks =="
python -m compileall -q psk_soft_tpu tests bench.py __graft_entry__.py
python scripts/pylint_lite.py

echo "== unit + integration tests (virtual 8-device CPU mesh, coverage) =="
# pycov (sys.monitoring) gates line coverage of psk_soft_tpu/ -- the
# reference CI's gcov/gcovr stage analog.  Subprocess (CLI) tests are not
# traced.  Floor ratcheted to the round-4 measurement (83.0%) minus a
# small variance margin; ratchet again when the measured figure rises.
python scripts/pycov.py --min 82 -m pytest tests/ -q

echo "== CLI selftest =="
env JAX_PLATFORMS=cpu python -m psk_soft_tpu selftest

echo "== package-artifact validation (wheel build + offline install) =="
bash scripts/wheel_smoke.sh

echo "== runnable examples =="
for ex in examples/*.py; do
    echo "-- $ex"
    env JAX_PLATFORMS=cpu \
        XLA_FLAGS="--xla_force_host_platform_device_count=8" \
        python "$ex" > /dev/null
done

echo "== graft entry dry runs =="
env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python __graft_entry__.py

echo "CI OK"
