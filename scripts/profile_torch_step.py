#!/usr/bin/env python3
"""Where a serving step's device time goes in the PyTorch port, on one GPU.

    python3 scripts/profile_torch_step.py [--model llama-3.2-1b|gemma-2-2b] [--batch 8] [--context 1024]
                                          [--kv-cache-dtype auto|int8]

Builds the preset (any preset of the port's model modules) with seeded random weights and a ModelRunner on the card
(bf16 pools, or int8 pools with their scales), prefills ``--batch`` rows of
``--context`` tokens in 512-token chunks, then profiles (torch.profiler, CPU
+ CUDA activity) the last prefill chunk, one 8-token decode burst, and the
burst's commit on its own (the post-burst scatter, or the quantizing commit
for int8 pools: torch ops, counted as "other" inside the burst). Prints one
JSON line per profiled step: host wall ms (ending in a synchronize), device
busy ms, the device's idle share of the wall time, and device ms by kernel
family (decode attention, prefill attention with the chunk's KV write in
its launch, GEMM, other); then the card's name and power limit. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAMILIES = (
    ("decode_attention", ("decode_attention_",)),  # the split kernels and their merge
    ("prefill_attention", ("prefill_attention_mma_kernel", "prefill_attention_f32_kernel")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_family: dict[str, float] = {}
    launches: dict[str, int] = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = family(evt.key)
        by_family[fam] = by_family.get(fam, 0.0) + dev_us / 1e3
        launches[fam] = launches.get(fam, 0) + evt.count
    busy = sum(by_family.values())
    return {
        "host_wall_ms": round(wall, 3),
        "device_busy_ms": round(busy, 3),
        "device_idle_share": round(1.0 - busy / wall, 4) if wall > 0 else None,
        "device_ms_by_family": {k: round(v, 3) for k, v in sorted(by_family.items())},
        "launches_by_family": dict(sorted(launches.items())),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llama-3.2-1b", help="a preset of the port, e.g. llama-3.2-1b or gemma-2-2b")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--context", type=int, default=1024, help="tokens per row before the profiled decode burst")
    p.add_argument("--kv-cache-dtype", default="auto", choices=("auto", "int8"))
    args = p.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
    from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
    from production_stack_tpu_torch.ops.quant import write_kv_pages_all_layers_quant

    chunk, burst, page = 512, 8, 64
    B, ctx = args.batch, args.context
    if ctx % chunk:
        print("profile_torch_step: --context must be a multiple of 512", file=sys.stderr)
        return 2
    _, cfg, model = load_model(args.model, seed=0, device="cuda")
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache_dtype)
    maxp = -(-(ctx + burst) // page)
    runner = ModelRunner(model, num_pages=B * maxp, page_size=page, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (B, ctx)).astype(np.int32)
    pt = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)

    def inp(input_ids, pos, lens, limits=None):
        return StepInput(
            input_ids=input_ids, positions=pos, page_table=pt, kv_lens=lens,
            temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
            kv_limits=limits,
        )

    def prefill(c):
        pos = np.tile(np.arange(c * chunk, (c + 1) * chunk, dtype=np.int32), (B, 1))
        return runner.step(inp(ids[:, c * chunk:(c + 1) * chunk], pos, np.full(B, (c + 1) * chunk, np.int32)))[0]

    n_chunks = ctx // chunk
    with torch.no_grad():
        for c in range(n_chunks - 1):
            prefill(c)
        first = {}
        res = profile(lambda: first.setdefault("ids", prefill(n_chunks - 1)))
        tags = {"model": args.model, "kv_cache_dtype": args.kv_cache_dtype, "rows": B}
        print(json.dumps({"step": "prefill_chunk", **tags, "chunk": chunk, "history": ctx - chunk, **res}),
              flush=True)
        nxt = first["ids"].cpu().numpy().astype(np.int32)[:, None]
        dec = inp(nxt, np.full((B, 1), ctx, np.int32), np.full(B, ctx + 1, np.int32),
                  np.full(B, ctx + burst, np.int32))
        runner.step_multi(dec, burst)  # warm-up: same shapes as the profiled burst
        res = profile(lambda: runner.step_multi(dec, burst))
        print(json.dumps({"step": "decode_burst", **tags, "context": ctx, "burst": burst, **res}), flush=True)
        # the burst's commit alone, same shapes: B rows x 8 tokens into slots ctx..ctx+7
        L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        gen = torch.Generator(device="cuda").manual_seed(0)
        k_acc = torch.randn((L, B, burst, KH, D), generator=gen, device="cuda").to(cfg.dtype)
        v_acc = torch.randn((L, B, burst, KH, D), generator=gen, device="cuda").to(cfg.dtype)
        pos = torch.arange(ctx, ctx + burst, dtype=torch.int32, device="cuda").repeat(B, 1)
        ptt = torch.from_numpy(pt).cuda()
        if runner.kv_quant:
            commit = lambda: write_kv_pages_all_layers_quant(  # noqa: E731
                runner.k_pages, runner.v_pages, runner.k_scales, runner.v_scales, k_acc, v_acc, ptt, pos)
        else:
            commit = lambda: write_kv_pages_all_layers(runner.k_pages, runner.v_pages, k_acc, v_acc, ptt, pos)  # noqa: E731
        commit()  # warm-up
        res = profile(commit)
        print(json.dumps({"step": "burst_commit", **tags, "context": ctx, "burst": burst, **res}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
