#!/usr/bin/env python3
"""Where a tile's time goes inside the bf16 prefill kernel, on one GPU.

    python3 scripts/prefill_phase_clocks.py

Builds csrc/prefill_attention.cu with its tile loop's step marks
(PHASE_LOOP_BEGIN, PHASE_MARK(k), PHASE_LOOP_END, empty in the served
build) defined as clock64() probes, into build/torch_kernels/phase_clocks/,
and runs it on chip_smoke.py's main-path prefill case (a 512-token chunk
after 1,536 tokens of history), bf16 pools and then int8 pools. Thread 0
of each warpgroup sums the clocks between marks over every tile of every
block; the script prints, per pool mode and warpgroup, SM clocks per tile
for each step, and the probed kernel's time (the probes cost a little of
it), then the card's name and power limit. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the step that ends at PHASE_MARK(k), for k = 0, 1, ...
STEPS = ("wait + barrier", "copy issue (warpgroup 1)", "S issue", "rescale + P.V issue", "S wait", "softmax",
         "copy issue (warpgroup 0)", "int8 convert + P.V wait", "pack")
N = len(STEPS)

# the marks as probes, and a C entry point that takes and zeroes the sums
PROBES = f"""
__device__ unsigned long long g_clk[{2 * (N + 1)}];
#define PHASE_LOOP_BEGIN \\
  const bool clk_on = (threadIdx.x & 127) == 0; \\
  long long clk_last = clock64(), clk[{N + 1}] = {{}};
#define PHASE_MARK(k) \\
  if (clk_on) {{ const long long t_ = clock64(); clk[k] += t_ - clk_last; clk_last = t_; if (k == {N - 1}) ++clk[{N}]; }}
#define PHASE_LOOP_END \\
  if (clk_on) for (int k_ = 0; k_ <= {N}; ++k_) atomicAdd(&g_clk[k_ + {N + 1} * (threadIdx.x >> 7)], (unsigned long long)clk[k_]);
"""
TAKE = f"""
extern "C" int phase_clocks_take(unsigned long long* out) {{
  const unsigned long long zero[{2 * (N + 1)}] = {{}};
  cudaMemcpyFromSymbol(out, g_clk, sizeof(zero));
  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefill_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from production_stack_tpu_torch.ops.kernels import _build

    out_dir = ROOT / "build/torch_kernels/phase_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "prefill_probed.cu", out_dir / "prefill_probed.so"
    cu.write_text(PROBES + (ROOT / "production_stack_tpu_torch/csrc/prefill_attention.cu").read_text() + TAKE)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prefill_attention_launch.argtypes = [I, I, I] + [P] * 12 + [I] * 10 + [F, F, P]
    lib.phase_clocks_take.argtypes = [P]
    buf = (ctypes.c_ulonglong * (2 * (N + 1)))()
    for quant in (False, True):
        case = dict(dict(c.PREFILL_CASES)[c.MAIN_PREFILL], dtype=torch.bfloat16, quant=quant)
        args, kw = c.prefill_case(case.pop("seed"), **case)
        q, kp, vp, pt, pos, lens, kc, vc, cl = args
        out = torch.empty_like(q)
        B, Tn, NH, D = q.shape
        _, n_pages, page, KH, _ = kp.shape
        scales = [kw["k_scales"].data_ptr(), kw["v_scales"].data_ptr()] if quant else [None, None]

        def run():
            err = lib.prefill_attention_launch(
                1, int(quant), D, q.data_ptr(), pos.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
                kc.data_ptr(), vc.data_ptr(), pt.data_ptr(), lens.data_ptr(), cl.data_ptr(), out.data_ptr(),
                B, Tn, NH, KH, n_pages, page, pt.shape[1], 0, 1, 1 << 30, float(D**-0.5), 0.0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probed kernel launch failed: cudaError {err}")

        ms = c._time_ms(run)
        torch.cuda.synchronize()
        lib.phase_clocks_take(buf)
        run()
        torch.cuda.synchronize()
        lib.phase_clocks_take(buf)
        per_wg = {}
        for w in range(2):
            tiles = max(buf[w * (N + 1) + N], 1)
            per_wg[f"warpgroup{w}"] = {name: round(buf[w * (N + 1) + k] / tiles, 1) for k, name in enumerate(STEPS)}
        print(json.dumps({"pools": "int8" if quant else "bf16", "case": c.MAIN_PREFILL, "probed_ms": ms,
                          "sm_clocks_per_tile": per_wg}), flush=True)
    print(c.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
