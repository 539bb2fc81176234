#!/usr/bin/env python3
"""Time edited copies of the decode kernel against each other on one GPU.

    python3 scripts/decode_variants.py [--splits N] [--cases main,b1_2k,...] VARIANT [VARIANT ...]

A VARIANT is a preset below, one text edit of this tree's
production_stack_tpu_torch/csrc/decode_attention.cu, or the path of another
copy of that file (say one unpacked from an older commit with git archive):

  base        the source as it is
  nofold      every tile copied, none folded: the copies' own time
  nocopy      every tile folded, none copied: the fold's own time
  stages=N    an N-stage ring for every mode
  l2=128B     the tile copies with an L2 prefetch hint (or l2=256B)
  nopdl       the merge launched after the split kernel, not under it

Each variant is built with ops/kernels/_build.py's nvcc flags into
build/decode_variants/, all at once, and launched through the wrapper
(ops/kernels/decode_attention.py) in one process, so the variants share the
card and the inputs. Prints, per case and pool mode (bf16, int8), each
variant's median ms (chip_smoke._time_ms: L2 flushed, 50 launches) and its
ratio to chip_smoke's TOL bound against the plain version (nofold and nocopy
fail it by design); with --splits N the plan's split count is replaced by N.
Then the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = ROOT / "production_stack_tpu_torch" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "decode_variants"

_HINT = """__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::%s [%%0], [%%1], 16, %%2;\\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(ok ? 16 : 0));
}

"""
_COPIES = ("        cp_async16_or_zero(st_k + r * ROWB + pc * 16, k_pages + off + c * 16, ok);\n"
           "        cp_async16_or_zero(st_v + r * ROWB + pc * 16, v_pages + off + c * 16, ok);")


def preset(name: str) -> list[tuple[str, str]]:
    """The (old, new) text edits of a preset."""
    if name == "base":
        return []
    if name == "nofold":
        return [("    if (kb >= n) continue;", "    if (kb >= 0) continue;")]
    if name == "nocopy":
        return [("    if (i < n_tiles) {\n      unsigned char* st_k", "    if (i < 0) {\n      unsigned char* st_k")]
    if name.startswith("stages="):
        return [("static constexpr int NS = QUANT || D == 128 ? 3 : 4;",
                 f"static constexpr int NS = {int(name[7:])};")]
    if name.startswith("l2="):
        return [("template <typename KV, int D>\nstruct MmaSmem {", _HINT % name[3:] + "template <typename KV, int D>\nstruct MmaSmem {"),
                (_COPIES, _COPIES.replace("cp_async16_or_zero", "cp_async16_hint"))]
    if name == "nopdl":
        return [("attr.val.programmaticStreamSerializationAllowed = 1;",
                 "attr.val.programmaticStreamSerializationAllowed = 0;")]
    raise SystemExit(f"unknown variant {name!r}")


# name: a case of chip_smoke.DECODE_CASES, or inline decode_case kwargs
CASES = {
    "main": "main_path_b32_ctx1024_c8_bf16",
    "b1_2k": "small_batch_b1_ctx2048_c8_bf16",
    "b8_1k": "small_batch_b8_ctx1024_c8_bf16",
    "b1_8k": "small_batch_b1_ctx8192_c8_bf16",
    # the main case's bytes with one KV head: every 64-slot page contiguous
    "kh1_b256": dict(seed=7, B=256, NH=8, KH=1, D=64, page=64, maxp=16, L=1, lens=[1024] * 256, C=8,
                     cur_lens=[8] * 256),
}


def build(variants: list[str]) -> dict[str, Path]:
    from production_stack_tpu_torch.ops.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for v in variants:
        if Path(v).is_file():
            text = Path(v).read_text()
        else:
            text = base
            for old, new in preset(v):
                if text.count(old) != 1:
                    raise SystemExit(f"variant {v}: its anchor is not in the source once:\n{old}")
                text = text.replace(old, new)
        tag = v.replace("/", "_").replace("=", "_")
        cu, lib = OUT / f"{tag}.cu", OUT / f"{tag}.so"
        cu.write_text(text)
        log = open(OUT / f"{tag}.log", "w")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        procs[v] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), lib, log)
    libs = {}
    for v, (proc, lib, log) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"variant {v}: nvcc failed, see {log.name}")
        log.close()
        libs[v] = lib
    return libs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variants", nargs="+")
    p.add_argument("--cases", default="main,b1_2k,b8_1k,b1_8k")
    p.add_argument("--splits", type=int, default=0)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from production_stack_tpu_torch.ops.kernels import decode_attention as dmod

    libs = build(args.variants)
    loaded = {}
    for v, path in libs.items():
        lib = ctypes.CDLL(str(path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_launch.argtypes = [I] * 3 + [P] * 11 + [I] * 9 + [F, F, I, P, P]
        lib.decode_attention_launch.restype = I
        loaded[v] = lib
    plan = dmod.split_plan
    if args.splits:
        dmod.split_plan = lambda *a: plan(*a)._replace(splits=args.splits)
    dmod._bound = True  # the argtypes are set above
    for name in args.cases.split(","):
        spec = CASES[name]
        for quant in (False, True):
            case = dict(dict(cs.DECODE_CASES)[spec] if isinstance(spec, str) else spec, dtype=torch.bfloat16,
                        quant=quant)
            inputs, kw = cs.decode_case(case.pop("seed"), **case)
            ref = dmod.decode_attention_ref(*inputs, **kw)
            cells = []
            for v, lib in loaded.items():
                dmod._lib = lambda lib=lib: lib
                out = dmod.decode_attention(*inputs, **kw)
                torch.cuda.synchronize()
                ratio = cs._judge(out, ref, torch.bfloat16)["ratio_to_bound"]
                ms = cs._time_ms(lambda: dmod.decode_attention(*inputs, **kw), iters=50)
                cells.append(f"{v}={ms:.4f} (ratio {ratio:.2f})")
            print(name, "int8" if quant else "bf16", " ".join(cells), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
