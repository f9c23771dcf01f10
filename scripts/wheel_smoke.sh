#!/usr/bin/env bash
# Package-artifact validation (the reference validates its deployable: RPM
# spec install layout rh.psk_soft.spec:88-95, tests launched from the
# installed SPD tests/test_psk_soft.py:276).  Here: build the wheel, install
# it into a scratch prefix (offline, no deps), and run the selftest + CLI
# from the INSTALLED package -- not the source tree.
set -euo pipefail
cd "$(dirname "$0")/.."

TMP="$(mktemp -d)"
trap 'rm -rf "$TMP"' EXIT

echo "-- build wheel"
python -m pip wheel . --no-deps --no-build-isolation --no-index -q -w "$TMP/dist"
WHL=("$TMP"/dist/psk_soft_tpu-*.whl)
echo "   ${WHL[0]##*/}"

echo "-- offline install into scratch prefix"
python -m pip install --no-index --no-deps --quiet --target "$TMP/site" "${WHL[0]}"

echo "-- console-script entry point present in metadata"
grep -q "psk-soft-tpu = psk_soft_tpu.cli:main" "$TMP"/site/psk_soft_tpu-*.dist-info/entry_points.txt

echo "-- selftest from the installed wheel (source tree shadowed)"
cd "$TMP"
env JAX_PLATFORMS=cpu PYTHONPATH="$TMP/site" \
    python -m psk_soft_tpu selftest

echo "-- gen|demod pipe from the installed wheel"
env JAX_PLATFORMS=cpu PYTHONPATH="$TMP/site" \
    python -m psk_soft_tpu gen --symbols 400 --sps 8 -M 4 |
env JAX_PLATFORMS=cpu PYTHONPATH="$TMP/site" \
    python -m psk_soft_tpu demod --sps 8 -M 4 --num-avg 50 > /dev/null

echo "wheel smoke OK"
