#!/usr/bin/env bash
# Same-call A/B of the port's CUDA kernels on one card: a baseline tree
# against this one, in the order baseline, this, this, baseline. Each tree's
# own chip_smoke.py checks its kernels once; the timing phase runs twice per
# tree, always from THIS tree's chip_smoke.py (the same shapes, rows and
# yardsticks) over that tree's package; after each timing, the tree's own
# llama-3.2-1b serve phases (bf16, then int8 with the CPU tier) give its
# serve walls.
# Both trees are built first, in parallel.
#
#   bash scripts/ab_torch_kernels.sh <baseline tree, e.g. an unpacked git archive> [log dir]
#
# Run from the repo root on a machine with the card. Logs go to the log
# dir (default build/ab_logs) as ab_*.log; the timing lines are printed at
# the end.
set -euo pipefail
BASE=$(cd "$1" && pwd)
HERE=$(pwd)
OUT=$(mkdir -p "${2:-build/ab_logs}" && cd "${2:-build/ab_logs}" && pwd)
PRE='import sys; sys.path.insert(0, "."); import torch; torch.backends.cuda.matmul.allow_tf32 = False'
OWN="$PRE; import chip_smoke as c"
# this tree's chip_smoke.py, over the package of the directory it runs in
TIMER="$PRE; import importlib.util as u; s = u.spec_from_file_location('cs', '$HERE/chip_smoke.py'); c = u.module_from_spec(s); s.loader.exec_module(c)"
(cd "$BASE" && python3 -c "$OWN; c.phase_build()" > "$OUT/ab_build_before.log" 2>&1) &
python3 -c "$OWN; c.phase_build()" > "$OUT/ab_build_after.log" 2>&1
wait
SERVE="$OWN; c.phase_serve('llama-3.2-1b', dict(model='llama-3.2-1b')); c.phase_serve('llama-3.2-1b, int8', dict(model='llama-3.2-1b', **c.INT8_SERVE))"
(cd "$BASE" && python3 -c "$OWN; c.phase_kernels()" && python3 -c "$TIMER; c.phase_timing()" && python3 -c "$SERVE") \
  > "$OUT/ab_1_before.log" 2>&1
(python3 -c "$OWN; c.phase_kernels(); c.phase_timing()" && python3 -c "$SERVE") > "$OUT/ab_2_after.log" 2>&1
(python3 -c "$OWN; c.phase_timing()" && python3 -c "$SERVE") > "$OUT/ab_3_after.log" 2>&1
(cd "$BASE" && python3 -c "$TIMER; c.phase_timing()" && python3 -c "$SERVE") > "$OUT/ab_4_before.log" 2>&1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for f in "$OUT"/ab_[1-4]_*.log; do
  echo "== $(basename "$f")"
  grep -h '"phase": "timing"\|"phase": "serve"' "$f" | python3 -c '
import json, sys
for line in sys.stdin:
    r = json.loads(line)
    if r["phase"] == "serve":
        print("serve", r["kv_cache_dtype"], "seconds", r["seconds"], "with startup", r["seconds_with_startup"])
    else:
        fused = " launch %s, with the write %s" % (r["attention_ms"], r["fused_ms"]) if "fused_ms" in r else ""
        print(r["kernel"], r.get("case", "main"), "ms", r["ms"], "sdpa", r["library_ms"], "bound", r["bound_ms"], fused)'
done
