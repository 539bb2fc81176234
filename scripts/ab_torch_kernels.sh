#!/usr/bin/env bash
# Same-call A/B of the port's CUDA kernels on one card: a baseline tree
# against this one, in the order baseline, this, this, baseline, each run
# through chip_smoke.py's phases (the kernel checks once per tree, the
# timing phase twice). Both trees are built first, in parallel.
#
#   bash scripts/ab_torch_kernels.sh <baseline tree, e.g. an unpacked git archive> [log dir]
#
# Run from the repo root on a machine with the card. Logs go to the log
# dir (default build/ab_logs) as ab_*.log; the timing lines are printed at
# the end.
set -euo pipefail
BASE=$(cd "$1" && pwd)
OUT=$(mkdir -p "${2:-build/ab_logs}" && cd "${2:-build/ab_logs}" && pwd)
PY='import sys; sys.path.insert(0, "."); import torch; torch.backends.cuda.matmul.allow_tf32 = False; import chip_smoke as c'
(cd "$BASE" && python3 -c "$PY; c.phase_build()" > "$OUT/ab_build_before.log" 2>&1) &
python3 -c "$PY; c.phase_build()" > "$OUT/ab_build_after.log" 2>&1
wait
(cd "$BASE" && python3 -c "$PY; c.phase_kernels(); c.phase_timing()") > "$OUT/ab_1_before.log" 2>&1
python3 -c "$PY; c.phase_kernels(); c.phase_timing()" > "$OUT/ab_2_after.log" 2>&1
python3 -c "$PY; c.phase_timing()" > "$OUT/ab_3_after.log" 2>&1
(cd "$BASE" && python3 -c "$PY; c.phase_timing()") > "$OUT/ab_4_before.log" 2>&1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for f in "$OUT"/ab_[1-4]_*.log; do
  echo "== $(basename "$f")"
  grep -h '"phase": "timing"' "$f" | cut -c1-160
done
