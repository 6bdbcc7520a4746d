#!/usr/bin/env bash
# CI gate — one command reproducing the repo's evidence set
# (the reference wires its MRR-bar tests into CI, .travis.yml:1-10).
#
#   scripts/ci.sh          # unit suite + quickstart + multichip dryrun (CPU)
#   scripts/ci.sh --gpu    # + chip_smoke.py and bench.py on one GPU
#
# Fails on the first regression. From any cwd.

set -euo pipefail
cd "$(dirname "$0")/.."

echo "== unit suite (CPU, 8 virtual devices; includes the 2-process"
echo "   jax.distributed test and the sharded parity tests)"
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "== quickstart example (the reference doc-tests its README example,"
echo "   src/lib.rs:22-58)"
JAX_PLATFORMS=cpu python examples/quickstart.py

echo "== multichip dryrun (8 virtual CPU devices)"
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

if [[ "${1:-}" == "--gpu" ]]; then
    echo "== main path and kernels on the card"
    python chip_smoke.py

    echo "== headline bench"
    python bench.py
fi

echo "CI gate: ALL GREEN"
