#!/bin/bash
# Full validation sweep: tests (CPU, 8 virtual devices), driver hooks
# (multi-device dry run), and the single-card benchmark.
set -e
cd "$(dirname "$0")/.."
echo "=== tests (full, incl. slow) ==="
python3 -m pytest tests/ -q -m ""
echo "=== driver hooks (virtual 8-device mesh) ==="
JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" python3 -c "
import jax
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
print('entry OK:', [o.shape for o in out])
g.dryrun_multichip(8)
"
echo "=== benchmark (one card) ==="
python3 bench.py
