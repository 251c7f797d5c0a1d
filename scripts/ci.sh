#!/usr/bin/env bash
# CI driver (rebuild of the reference's `cargo xtask ci`,
# xtask/src/main.rs:43-112: fmt + lint + test + doc index).
set -euo pipefail
cd "$(dirname "$0")/.."

# Pin the CPU backend BEFORE any process imports jax: installed pytest
# plugins (jaxtyping) import jax before tests/conftest.py runs.
export JAX_PLATFORMS=cpu
export JAX_ENABLE_X64=1
case "${XLA_FLAGS:-}" in
  *xla_force_host_platform_device_count*) ;;
  *) export XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8" ;;
esac

echo "== lint (pyflakes via compileall + warnings) =="
python -m compileall -q tensor4all_tpu tests benchmarks tools

echo "== capi build =="
make -C tensor4all_tpu/capi >/dev/null

echo "== native kernels build =="
make -C tensor4all_tpu/native >/dev/null

echo "== tests =="
if [ "${1:-}" = "--coverage" ]; then
  # reference parity: coverage gate (scripts/coverage-thresholds.json,
  # ref scripts/check-coverage.py + CI_rs.yml:88-110)
  python scripts/coverage_gate.py tests/ -q
else
  python -m pytest tests/ -q
fi

echo "== api dump (drift check) =="
python tools/api_dump.py docs/api.md

echo "CI OK"
