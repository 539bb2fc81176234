#!/usr/bin/env python3
"""How far each tanh the attention kernels could cap scores with is from
tanh, on one GPU.

    python3 scripts/softcap_tanh_error.py [--upto 3.0] [--step-log2 16] [--kernels]

Builds a small CUDA kernel (nvcc, the kernels' -gencode flags, into
build/torch_kernels/) that takes tanh three ways on every y of a grid over
[0, upto) with step 2^-step_log2: ``tanh_sfu`` of csrc/attention_common.cuh
(the prefill kernel's softcap at D = 256), the SFU's ``tanh.approx.f32``,
and CUDA's ``tanhf`` (the decode kernel's softcap, and the prefill kernel's
at D = 64 and 128). Prints one JSON line per way: the largest absolute and
relative error against float64 tanh, the y where the absolute one lies, the
mean signed error, and the largest shift of a score under gemma-2's softcap
of 50 (50 times the absolute error).

With --kernels it also builds the prefill kernel a second time with
tanh.approx.f32 in place of tanh_sfu and runs both builds in one process,
in the order tanh_sfu, approx, approx, tanh_sfu: on chip_smoke.py's
capped-score case (q x 1, 10, 20, 40; bf16 and int8 pools) each build's
largest and mean error against the plain version and its ratio to
chip_smoke.py's TOL_CAPPED; and chip_smoke.py's gemma-2-2b prefill timing
case (softcap 50), median ms per build (chip_smoke._time_ms). Then the
card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "attention_common.cuh"

__global__ void tanh_ways(const float* y, float* sfu, float* approx, float* lib, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sfu[i] = pst::tanh_sfu(y[i]);
  float a;
  asm("tanh.approx.f32 %0, %1;" : "=f"(a) : "f"(y[i]));
  approx[i] = a;
  lib[i] = tanhf(y[i]);
}

extern "C" int tanh_ways_launch(const float* y, float* sfu, float* approx, float* lib, int n) {
  tanh_ways<<<(n + 255) / 256, 256>>>(y, sfu, approx, lib, n);
  return (int)cudaDeviceSynchronize();
}
"""
CAP = 50.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--upto", type=float, default=3.0)
    ap.add_argument("--step-log2", type=int, default=16)
    ap.add_argument("--kernels", action="store_true", help="also compare the prefill kernel built with each tanh")
    args = ap.parse_args()

    import torch

    from production_stack_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "softcap_tanh_error.cu"
    lib_path = src.with_suffix(".so")
    src.write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-I", str(_build.CSRC), "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))

    steps = int(args.upto * 2**args.step_log2)
    y = (torch.arange(steps, dtype=torch.float64) / 2**args.step_log2).float().cuda()
    outs = {name: torch.empty_like(y) for name in ("tanh_sfu", "tanh.approx.f32", "tanhf")}
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in [y, *outs.values()]]
    rc = lib.tanh_ways_launch(*ptrs, ctypes.c_int(steps))
    if rc != 0:
        raise SystemExit(f"launch failed: cudaError {rc}")
    ref = torch.tanh(y.double()).cpu()
    for name, out in outs.items():
        err = out.double().cpu() - ref
        i = int(err.abs().argmax())
        print(json.dumps({
            "tanh": name, "y_range": [0.0, args.upto], "step": 2.0**-args.step_log2,
            "max_abs_err": float(err.abs().max()), "at_y": float(y[i]),
            "max_rel_err": float((err.abs()[1:] / ref.abs()[1:]).max()),
            "mean_signed_err": float(err.mean()),
            "max_score_shift_at_softcap_50": CAP * float(err.abs().max()),
        }))
    if args.kernels:
        compare_builds(flags)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


def compare_builds(flags) -> None:
    """The prefill kernel with tanh_sfu (as built) and with tanh.approx.f32,
    on the capped-score case and the gemma-2-2b timing case."""
    import torch

    import chip_smoke as cs
    from production_stack_tpu_torch.ops.kernels import _build
    from production_stack_tpu_torch.ops.kernels import prefill_attention as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    src = (_build.CSRC / "prefill_attention.cu").read_text()
    anchor = "tanh_sfu(x * inv_cap)"
    if src.count(anchor) != 1:
        raise SystemExit(f"prefill_attention.cu no longer holds {anchor!r} once")
    edited = _build.BUILD_DIR / "prefill_attention_tanh_approx.cu"
    edited.write_text(src.replace(anchor, "tanh_approx_(x * inv_cap)").replace(
        '#include "attention_common.cuh"\n',
        '#include "attention_common.cuh"\n__device__ __forceinline__ float tanh_approx_(float x) {\n'
        '  float y;\n  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n', 1))
    so = edited.with_suffix(".so")
    nvcc = subprocess.Popen([_build.nvcc_path(), *flags, "-I", str(_build.CSRC), "-o", str(so), str(edited)])
    served = _build.load("prefill_attention")  # built beside the edited copy
    if nvcc.wait() != 0:
        raise SystemExit("nvcc failed on the tanh.approx.f32 copy")
    libs = {"tanh_sfu": served, "tanh.approx.f32": ctypes.CDLL(str(so))}

    def use(name):
        _build._libs["prefill_attention"] = libs[name]
        pm._bound = False  # set the new library's argument types

    case = dict(cs.PREFILL_CASES)[cs.GEMMA_CAPPED]
    tol = cs.TOL_CAPPED
    for q_scale in (1.0, 10.0, 20.0, 40.0):
        for quant in (False, True):
            args, kw = cs.prefill_case(2, **dict(case, q_scale=q_scale, quant=quant, dtype=torch.bfloat16))
            ref = pm.prefill_attention_ref(*args, **kw)
            row = {"case": (cs.INT8 if quant else "") + cs.GEMMA_CAPPED, "q_scale": q_scale, "tol": tol["bfloat16"]}
            for name in libs:
                use(name)
                out = pm.prefill_attention(*args, **kw)
                torch.cuda.synchronize()
                row[name] = {"max_abs_err": cs._err(out, ref),
                             "mean_abs_err": float((out.float() - ref.float()).abs().mean()),
                             "ratio_to_bound": cs._judge(out, ref, torch.bfloat16, tol)["ratio_to_bound"]}
            print(json.dumps(row), flush=True)
    for quant in (False, True):
        case = dict(dict(cs.PREFILL_CASES)[cs.GEMMA_PREFILL], dtype=torch.bfloat16, quant=quant)
        args, kw = cs.prefill_case(case.pop("seed"), **case)
        ms = {name: [] for name in libs}
        for name in ("tanh_sfu", "tanh.approx.f32", "tanh.approx.f32", "tanh_sfu"):
            use(name)
            ms[name].append(cs._time_ms(lambda: pm.prefill_attention(*args, **kw), iters=50))
        print(json.dumps({"timing": (cs.INT8 if quant else "") + cs.GEMMA_PREFILL, "ms": ms}), flush=True)
    use("tanh_sfu")


if __name__ == "__main__":
    sys.exit(main())
