#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (production_stack_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase ends the run with a
non-zero exit (nothing is caught):

1. build    -- nvcc builds every kernel library from production_stack_tpu_torch/
               csrc/ (one nvcc per source, all started together).
2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
               fp pools and int8 pools (per-page scales): ragged,
               burst-window, stacked-layer, window+softcap, bf16/f32,
               D=64/128 and NaN-poisoned stale-slot (or stale-scale) cases,
               the decode kernel's split-KV edges (rows with empty splits,
               a deep window start, the burst on a row whose last split is
               empty, G = 1 / 8, page 48, one row at 8,192; each decode call
               made twice and held to the same bytes), and the timing
               phase's inputs, each held to a
               bound scaled to its output (TOL); the KV writes (fp, and
               the quantizing write) must leave pools and scales
               byte-identical to their plain versions, in the quantizing
               write's four cases too (aligned chunk, chunk ending
               mid-page, unaligned head page, other layers untouched).
3. forward  -- llama-3.2-1b at full width and depth (bf16, seeded random
               weights): two 512-token prefill chunks and one 8-step decode
               burst, with the kernels and with the plain versions, into
               bf16 pools and then into int8 pools (layer 0's int8 pages
               and scales byte-identical between the two).
4. serve    -- the port's OpenAI server in-process on localhost, twice
               (bf16 pools; then int8 pools with the CPU offload tier and a
               pool small enough to evict): concurrent /v1/completions (one
               streaming) and /v1/chat/completions; a greedy request
               repeats exactly (with int8, after its prefix pages were
               spilled to the CPU tier and restored); the launch counters
               show each run went through its mode's kernels and no plain
               version; the int8 run's /metrics carry the quant and offload
               series.
5. timing   -- each kernel (six rows: three fp, three int8), its plain
               version and a PyTorch yardstick at the main path's shapes,
               with CUDA events, beside its bound; then the decode kernel
               at small batch (1 x 2,048, 8 x 1,024, 1 x 8,192), both modes,
               as rows of their own.

Then the kernel table line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. With no CUDA device, or run
from a directory without the package, it exits non-zero and prints no
result. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16
# tensor-core FLOP/s. A card set below 700 W runs slower than these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# A kernel's output passes where every element holds
#     |out - ref| <= rtol * |ref| + k * mean|ref|,
# ref being the plain version on the same inputs, as (rtol, k) by dtype:
# - bf16: rtol 2^-6 is 2 to 4 bf16 ulps of the value (both sides round f32
#   sums, made in another order, to bf16); k * mean|ref| covers the prefill
#   kernel's rounding of the softmax weights to bf16 before P @ V, which the
#   plain version keeps in f32, and values near 0.
# - f32 (TF32 off): the card sums in another order.
# Scaled to the output, the bound stays tight at long context, where
# outputs are averages over thousands of keys and typically ~0.03. On the
# main-path cases the plain version with one key fewer per row (an
# off-by-one in the history bound) must fail the same check.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0**-6, 0.05)}

# Where each TPU kernel's launch sits in the JAX package.
REPLACES = {
    "decode_attention": "production_stack_tpu/ops/pallas/paged_attention.py:67",
    "prefill_attention": "production_stack_tpu/ops/pallas/prefill_attention.py:72",
    "kv_page_write": "production_stack_tpu/ops/pallas/prefill_attention.py:396",
    "decode_attention[int8]": "production_stack_tpu/ops/pallas/paged_attention.py:97",
    "prefill_attention[int8]": "production_stack_tpu/ops/pallas/prefill_attention.py:112",
    "kv_page_write_quant": "production_stack_tpu/ops/pallas/prefill_attention.py:304",
}
SOURCES = {
    "decode_attention": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "decode_attention[int8]": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention[int8]": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write_quant": "production_stack_tpu_torch/csrc/prefill_attention.cu",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs


def _rand(gen, shape, dtype, device, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen) * scale).to(dtype).to(device)


def _page_table(gen, B, maxp, P, device):
    import torch

    return torch.randperm(P, generator=gen)[: B * maxp].reshape(B, maxp).to(torch.int32).to(device)


def _pools(gen, shape, dtype, device, quant):
    """(k_pages, v_pages, scales kwargs): random pools in ``dtype``, or with
    ``quant`` random int8 pools and per-page, per-KV-head scales of a
    typical size (amax / 127 of unit-normal KV is ~0.025)."""
    import torch

    if not quant:
        return _rand(gen, shape, dtype, device), _rand(gen, shape, dtype, device), {}
    L, P, _, KH, _ = shape
    pools = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device) for _ in range(2)]
    scales = [(0.01 + 0.03 * torch.rand((L, P, KH), generator=gen)).to(device) for _ in range(2)]
    return pools[0], pools[1], dict(k_scales=scales[0], v_scales=scales[1])


def _poison_scales(kw, layer, pt, B, first_stale_page):
    """NaN scales on every page wholly past row b's live history: a kernel
    that reads a stale page's scale turns its output NaN."""
    for b in range(B):
        for lp in range(first_stale_page[b], pt.shape[1]):
            kw["k_scales"][layer, int(pt[b, lp])] = float("nan")
            kw["v_scales"][layer, int(pt[b, lp])] = float("nan")


def decode_case(seed, *, B, NH, KH, D, page, maxp, L, lens, cur_lens=None, C=0, dtype, window=None,
                softcap=None, layer=0, poison=False, quant=False):
    """Inputs of one decode-kernel call: pools [L, P, page, KH, D] (int8
    with scales for ``quant``); with C > 0 a burst window k_cur/v_cur
    [B, C, KH, D] and its cur_lens."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant)
    pt = _page_table(gen, B, maxp, P, device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, layer=layer, **skw)
    if C:
        kw["k_cur"] = _rand(gen, (B, C, KH, D), dtype, device)
        kw["v_cur"] = _rand(gen, (B, C, KH, D), dtype, device)
        kw["cur_lens"] = torch.tensor(cur_lens, dtype=torch.int32, device=device)
    if poison and quant:  # int8 holds no NaN: the stale pages' scales do
        cl = cur_lens if C else [0] * B
        _poison_scales(kw, layer, pt, B, [-(-max(lens[b] - cl[b], 0) // page) for b in range(B)])
    elif poison:  # stale and out-of-range pool slots of every row hold NaN
        cl = cur_lens if C else [0] * B
        for b in range(B):
            s = torch.arange(max(lens[b] - cl[b], 0), maxp * page, device=device)
            pid = pt[b, s // page].long()
            kp[layer, pid, s % page] = float("nan")
            vp[layer, pid, s % page] = float("nan")
    q = _rand(gen, (B, NH, D), dtype, device)
    return (q, kp, vp, pt, lens_t), kw


def prefill_case(seed, *, B, T, NH, KH, D, page, maxp, L, computed, chunks, dtype, window=None,
                 softcap=None, layer=0, poison=False, quant=False):
    """Inputs of one prefill-kernel call: row b has computed[b] tokens in
    the pool (int8 with scales for ``quant``) and a chunk of chunks[b]
    tokens (0 = padded row)."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant)
    pt = _page_table(gen, B, maxp, P, device)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    for b in range(B):
        pos[b, : chunks[b]] = torch.arange(computed[b], computed[b] + chunks[b])
    kv_lens = torch.tensor([c + n for c, n in zip(computed, chunks)], dtype=torch.int32, device=device)
    cur_lens = torch.tensor(chunks, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, layer=layer, **skw)
    if poison and quant:  # the scales of pages wholly past each chunk start
        _poison_scales(kw, layer, pt, B, [-(-computed[b] // page) for b in range(B)])
    elif poison:  # every slot at or after each row's chunk start holds NaN
        for b in range(B):
            for s in range(computed[b], maxp * page):
                pid = int(pt[b, s // page])
                kp[layer, pid, s % page] = float("nan")
                vp[layer, pid, s % page] = float("nan")
    q = _rand(gen, (B, T, NH, D), dtype, device)
    kc = _rand(gen, (B, T, KH, D), dtype, device)
    vc = _rand(gen, (B, T, KH, D), dtype, device)
    args = (q, kp, vp, pt, pos.to(device), kv_lens, kc, vc, cur_lens)
    return args, kw


def _same_bytes(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def _pool_err(a, b) -> float:
    """Max |a - b| over two pools; slots NaN in both count as equal, a NaN
    in one only as infinite."""
    import torch

    d = (a.float() - b.float()).abs()
    d = torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)
    return float(d.nan_to_num(nan=float("inf")).max())


def _judge(out, ref, dtype) -> dict:
    """The TOL check: ``ratio`` is the largest |out - ref| over its allowed
    bound, so the output passes when ratio <= 1."""
    import torch

    rtol, k = TOL[str(dtype).split(".")[-1]]
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    mean = float(r.mean())
    allowed = rtol * r + k * mean
    ratio = float((d / allowed).max()) if mean > 0 else (0.0 if float(d.max()) == 0 else float("inf"))
    return {"max_abs_err": _err(out, ref), "mean_abs_ref": mean, "rtol": rtol, "k_mean": k,
            "ratio_to_bound": ratio, "finite": bool(torch.isfinite(out.float()).all())}


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from production_stack_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 2),
        "per_source_seconds": {k: round(v, 2) for k, v in secs.items()},
        "nvcc_flags": " ".join(_build.NVCC_FLAGS),
        "card": nvidia_smi_line(),
    })
    for name in _build.SOURCES:
        keep = ("Compiling entry function", "registers", "spill")
        report = [l.strip() for l in _build.ptxas_report(name).splitlines() if any(k in l for k in keep)]
        emit({"phase": "build", "ptxas": name, "lines": report[:24]})


MAIN_DECODE = "main_path_b32_ctx1024_c8_bf16"
DECODE_B1_8K = "small_batch_b1_ctx8192_c8_bf16"
DECODE_B1_2K = "small_batch_b1_ctx2048_c8_bf16"
DECODE_B8_1K = "small_batch_b8_ctx1024_c8_bf16"
MAIN_PREFILL = "main_path_t512_h1536_bf16"
INT8 = "int8_"  # the int8 pool twin of a case: same shapes, int8 pools and scales

DECODE_CASES = [
    # name, kwargs
    ("ragged+empty_row_bf16_d64", dict(B=4, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                        lens=[5, 0, 77, 128], dtype="bfloat16")),
    ("burst_c8_ragged_layer2_bf16", dict(B=5, NH=32, KH=8, D=64, page=64, maxp=4, L=3, layer=2,
                                         lens=[9, 70, 200, 256, 1], C=8, cur_lens=[8, 3, 5, 8, 1],
                                         dtype="bfloat16")),
    ("window+softcap_f32_d128", dict(B=3, NH=8, KH=2, D=128, page=16, maxp=6, L=2, layer=1,
                                     lens=[5, 50, 96], C=1, cur_lens=[1, 1, 1], window=20,
                                     softcap=30.0, dtype="float32")),
    ("burst_f32_d64", dict(B=3, NH=12, KH=4, D=64, page=8, maxp=6, L=1, lens=[3, 24, 48], C=8,
                           cur_lens=[2, 8, 6], dtype="float32")),
    ("gqa1_bf16_d128", dict(B=2, NH=4, KH=4, D=128, page=32, maxp=3, L=1, lens=[31, 96],
                            dtype="bfloat16")),
    ("nan_stale_slots_bf16", dict(B=3, NH=32, KH=8, D=64, page=16, maxp=6, L=2, layer=1,
                                  lens=[20, 41, 90], C=8, cur_lens=[4, 8, 1], poison=True,
                                  dtype="bfloat16")),
    # the split-KV edges (split_plan: about 264 blocks of (split, KV head,
    # row)): ragged rows of 0, under one tile and ~5,000 slots, so most
    # splits of the short rows are empty
    ("splits_ragged_0_40_5000_nan_bf16", dict(B=3, NH=32, KH=8, D=64, page=16, maxp=320, L=1,
                                              lens=[0, 40, 5000], poison=True, dtype="bfloat16")),
    # a window whose first visible slot lies thousands of slots in (the
    # shares start there), with softcap
    ("splits_deep_window+softcap_bf16", dict(B=2, NH=32, KH=8, D=64, page=16, maxp=188, L=1,
                                             lens=[3000, 700], C=1, cur_lens=[1, 1], window=256,
                                             softcap=30.0, dtype="bfloat16")),
    ("splits_window+softcap_f32_d128", dict(B=2, NH=8, KH=2, D=128, page=16, maxp=130, L=1,
                                            lens=[2050, 900], C=2, cur_lens=[2, 1], window=700,
                                            softcap=30.0, dtype="float32")),
    # the burst window (cur_len < C) on rows whose last split, which folds
    # it, has no pool slot
    ("splits_burst_last_split_empty_nan_bf16", dict(B=3, NH=32, KH=8, D=64, page=64, maxp=24, L=2, layer=1,
                                                    lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                    poison=True, dtype="bfloat16")),
    ("splits_g1_d128_bf16", dict(B=2, NH=4, KH=4, D=128, page=32, maxp=63, L=1, lens=[2000, 77], C=4,
                                 cur_lens=[2, 4], dtype="bfloat16")),
    ("splits_g8_bf16", dict(B=2, NH=32, KH=4, D=64, page=16, maxp=113, L=1, lens=[1800, 333], C=8,
                            cur_lens=[8, 1], dtype="bfloat16")),
    ("splits_page48_nan_bf16", dict(B=2, NH=32, KH=8, D=64, page=48, maxp=47, L=1, lens=[1000, 2222], C=8,
                                    cur_lens=[8, 6], poison=True, dtype="bfloat16")),
    # the small-batch timing shapes: one row at 8,192 and 2,048, eight rows
    # at 1,024 (the step profile's rows), each with a full 8-entry window
    (DECODE_B1_8K, dict(seed=10, B=1, NH=32, KH=8, D=64, page=64, maxp=129, L=1, lens=[8192], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    (DECODE_B1_2K, dict(seed=11, B=1, NH=32, KH=8, D=64, page=64, maxp=33, L=1, lens=[2048], C=8,
                        cur_lens=[8], dtype="bfloat16")),
    (DECODE_B8_1K, dict(seed=12, B=8, NH=32, KH=8, D=64, page=64, maxp=17, L=1, lens=[1024] * 8, C=8,
                        cur_lens=[8] * 8, dtype="bfloat16")),
    # the timing phase's inputs: a decode burst step of the served model
    (MAIN_DECODE, dict(seed=7, B=32, NH=32, KH=8, D=64, page=64, maxp=16, L=1, lens=[1024] * 32, C=8,
                       cur_lens=[8] * 32, dtype="bfloat16")),
]
DECODE_CASES += [(INT8 + name, dict(kw, quant=True)) for name, kw in DECODE_CASES]

PREFILL_CASES = [
    ("history+unaligned+tail_bf16", dict(B=3, T=64, NH=32, KH=8, D=64, page=16, maxp=10, L=2, layer=1,
                                         computed=[37, 64, 5], chunks=[64, 59, 51], dtype="bfloat16")),
    ("first_chunk+padded_row_bf16", dict(B=3, T=48, NH=32, KH=8, D=64, page=64, maxp=2, L=1,
                                         computed=[0, 0, 0], chunks=[48, 17, 0], dtype="bfloat16")),
    ("window+softcap_f32_d128", dict(B=2, T=32, NH=8, KH=2, D=128, page=8, maxp=16, L=1,
                                     computed=[40, 64], chunks=[32, 28], window=20, softcap=30.0,
                                     dtype="float32")),
    ("window+softcap_bf16_d128_g2", dict(B=2, T=40, NH=8, KH=4, D=128, page=16, maxp=8, L=1,
                                         computed=[30, 7], chunks=[40, 33], window=25, softcap=20.0,
                                         dtype="bfloat16")),
    ("history_f32_d64", dict(B=2, T=80, NH=12, KH=4, D=64, page=16, maxp=12, L=3, layer=2,
                             computed=[100, 13], chunks=[80, 77], dtype="float32")),
    ("nan_stale_slots_bf16", dict(B=2, T=32, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                  computed=[24, 8], chunks=[32, 20], poison=True, dtype="bfloat16")),
    # the bf16 kernel's tile edges: a warpgroup holds 64 // G tokens x G heads
    ("g1_d128_bf16", dict(B=2, T=150, NH=4, KH=4, D=128, page=16, maxp=16, L=1,
                          computed=[70, 3], chunks=[150, 131], dtype="bfloat16")),
    ("g7_d128_nan_stale_slots_bf16", dict(B=2, T=50, NH=28, KH=4, D=128, page=16, maxp=8, L=1,
                                          computed=[45, 16], chunks=[50, 37], poison=True, dtype="bfloat16")),
    ("g8_bf16", dict(B=2, T=40, NH=32, KH=4, D=64, page=16, maxp=8, L=1,
                     computed=[20, 0], chunks=[40, 33], dtype="bfloat16")),
    ("chunk_not_multiple_of_tpw_bf16", dict(B=2, T=80, NH=32, KH=8, D=64, page=64, maxp=4, L=1,
                                            computed=[100, 64], chunks=[77, 45], dtype="bfloat16")),
    ("window_unaligned_first_slot_bf16", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=16, L=1,
                                              computed=[150, 99], chunks=[64, 50], window=45,
                                              dtype="bfloat16")),
    # page sizes the kernel looks up by division: 48 slots (history not
    # page-aligned, so 64-key tiles span pages), and 8,300 tokens of
    # history over 1,038 pages of 8
    ("page48_unaligned_history_bf16", dict(B=2, T=96, NH=32, KH=8, D=64, page=48, maxp=8, L=1,
                                           computed=[101, 29], chunks=[96, 70], dtype="bfloat16")),
    ("long_history_page8_bf16", dict(B=1, T=64, NH=32, KH=8, D=64, page=8, maxp=1048, L=1,
                                     computed=[8300], chunks=[64], dtype="bfloat16")),
    # the step profile's multi-row chunk: 8 rows of 512 tokens after 512
    ("multi_row_b8_t512_h512_bf16", dict(seed=9, B=8, T=512, NH=32, KH=8, D=64, page=64, maxp=16, L=1,
                                         computed=[512] * 8, chunks=[512] * 8, dtype="bfloat16")),
    # the timing phase's inputs: a 512-token chunk after 1,536 tokens
    (MAIN_PREFILL, dict(seed=8, B=1, T=512, NH=32, KH=8, D=64, page=64, maxp=32, L=1,
                        computed=[1536], chunks=[512], dtype="bfloat16")),
]
PREFILL_CASES += [(INT8 + name, dict(kw, quant=True)) for name, kw in PREFILL_CASES]

# the quantizing KV write alone: pools byte-identical and scales bitwise
# equal to its plain version
QWRITE_CASES = [
    ("aligned_chunk_bf16", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                computed=[32, 0], chunks=[64, 64], dtype="bfloat16")),
    ("chunk_ends_mid_page_bf16", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1,
                                      computed=[32, 16], chunks=[50, 37], dtype="bfloat16")),
    ("unaligned_head_page_f32_d128", dict(B=2, T=64, NH=8, KH=2, D=128, page=16, maxp=8, L=1,
                                          computed=[37, 5], chunks=[64, 40], dtype="float32")),
    ("other_layers_untouched_bf16", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=3, layer=1,
                                         computed=[21, 0], chunks=[60, 33], dtype="bfloat16")),
]


def _kernel_name(base: str, quant: bool) -> str:
    return base + "[int8]" if quant else base


def _clone_pools(args, kw):
    """Copies of a case's pools (and scales): (kp, vp, scales kwargs)."""
    skw = {k: kw[k].clone() for k in ("k_scales", "v_scales") if k in kw}
    return args[1].clone(), args[2].clone(), skw


def phase_kernels():
    import torch

    from production_stack_tpu_torch.ops.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        split_plan,
    )
    from production_stack_tpu_torch.ops.kernels.prefill_attention import (
        kv_page_write,
        kv_page_write_quant,
        kv_page_write_quant_ref,
        kv_page_write_ref,
        prefill_attention,
        prefill_attention_ref,
    )

    worst = {name: 0.0 for name in REPLACES}

    def judged(kernel, name, out, ref, dtype, control=None, **extra):
        res = _judge(out, ref, dtype)
        line = {"phase": "kernels", "kernel": kernel, "case": name, **res, **extra}
        if control is not None:
            # the plain version with one history key fewer per row, held to
            # the same bound: the check must reject it
            line["one_key_fewer_ratio_to_bound"] = _judge(control, ref, dtype)["ratio_to_bound"]
        emit(line)
        check(res["finite"], f"{kernel} {name}: non-finite output")
        check(res["ratio_to_bound"] <= 1.0, f"{kernel} {name}: error {res['max_abs_err']} exceeds its bound "
                                            f"(ratio {res['ratio_to_bound']})")
        if control is not None:
            check(line["one_key_fewer_ratio_to_bound"] > 1.0,
                  f"{kernel} {name}: the bound does not reject a one-key-fewer output")
        worst[kernel] = max(worst[kernel], res["max_abs_err"])

    def pools_same(a, b, skw_a, skw_b):
        """Byte-identical pools and bitwise-equal scales (NaN bytes too)."""
        return (_same_bytes(a[0], b[0]) and _same_bytes(a[1], b[1])
                and all(_same_bytes(skw_a[k], skw_b[k]) for k in skw_a))

    for name, kw in DECODE_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        seed = kw.pop("seed", 1)
        kernel = _kernel_name("decode_attention", kw.get("quant", False))
        args, call_kw = decode_case(seed, **kw)
        out = decode_attention(*args, **call_kw)
        again = decode_attention(*args, **call_kw)
        torch.cuda.synchronize()
        check(_same_bytes(out, again), f"decode {name}: two calls on the same inputs gave different bytes")
        ref = decode_attention_ref(*args, **call_kw)
        if kw.get("poison"):
            # the plain version on clean inputs: poisoned slots must be skipped
            clean, clean_kw = decode_case(seed, **dict(kw, poison=False))
            ref = decode_attention_ref(*clean, **clean_kw)
        control = None
        if name in (MAIN_DECODE, INT8 + MAIN_DECODE):
            q, kp, vp, pt, lens = args
            control = decode_attention_ref(q, kp, vp, pt, lens - 1, **call_kw)
        plan = split_plan(kw["B"], kw["KH"], kw["maxp"], kw["page"], kw["D"], kw.get("quant", False))
        judged(kernel, name, out, ref, kw["dtype"], control, splits=plan.splits, byte_identical_rerun=True)
        if 0 in kw["lens"]:
            check(float(out[kw["lens"].index(0)].float().abs().max()) == 0.0, f"decode {name}: empty row not 0")

    for name, kw in PREFILL_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        seed = kw.pop("seed", 2)
        quant = kw.get("quant", False)
        kernel = _kernel_name("prefill_attention", quant)
        args, call_kw = prefill_case(seed, **kw)
        q, kp, vp, pt, pos, lens, kc, vc, cl = args
        kp_k, vp_k, skw_k = _clone_pools(args, call_kw)
        kp_r, vp_r, skw_r = _clone_pools(args, call_kw)
        out = prefill_attention(q, kp_k, vp_k, pt, pos, lens, kc, vc, cl, fused_write=True,
                                **dict(call_kw, **skw_k))
        torch.cuda.synchronize()
        ref = prefill_attention_ref(q, kp_r, vp_r, pt, pos, lens, kc, vc, cl, fused_write=True,
                                    **dict(call_kw, **skw_r))
        same = pools_same((kp_k, vp_k), (kp_r, vp_r), skw_k, skw_r)
        if kw.get("poison"):
            clean, clean_kw = prefill_case(seed, **dict(kw, poison=False))
            ref = prefill_attention_ref(*clean, **clean_kw)
        control = None
        if name in (MAIN_PREFILL, INT8 + MAIN_PREFILL):
            control = prefill_attention_ref(q, kp, vp, pt, pos, lens - 1, kc, vc, cl, **call_kw)
        judged(kernel, name, out, ref, kw["dtype"], control)
        emit({"phase": "kernels", "kernel": kernel, "case": name, "fused_write_pools_byte_identical": same})
        check(same, f"prefill {name}: fused-write pools differ from the plain version's")
        for b, c in enumerate(kw["chunks"]):
            if c == 0:
                check(float(out[b].float().abs().max()) == 0.0, f"prefill {name}: padded row not 0")

        # the write kernel alone, on its own copies of the pools
        wkernel = "kv_page_write_quant" if quant else "kv_page_write"
        kp_k, vp_k, skw_k = _clone_pools(args, call_kw)
        kp_r, vp_r, skw_r = _clone_pools(args, call_kw)
        if quant:
            kv_page_write_quant(kc, vc, lens, cl, pt, kp_k, vp_k, layer=call_kw["layer"], **skw_k)
            torch.cuda.synchronize()
            kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp_r, vp_r, layer=call_kw["layer"], **skw_r)
        else:
            kv_page_write(kc, vc, pos, cl, pt, kp_k, vp_k, layer=call_kw["layer"])
            torch.cuda.synchronize()
            kv_page_write_ref(kc, vc, pos, cl, pt, kp_r, vp_r, layer=call_kw["layer"])
        same = pools_same((kp_k, vp_k), (kp_r, vp_r), skw_k, skw_r)
        err = max([_pool_err(kp_k, kp_r), _pool_err(vp_k, vp_r)] + [_pool_err(skw_k[k], skw_r[k]) for k in skw_k])
        emit({"phase": "kernels", "kernel": wkernel, "case": name, "pools_byte_identical": same, "max_abs_err": err})
        check(same, f"{wkernel} {name}: pools differ from the plain version's")
        worst[wkernel] = max(worst[wkernel], err)

    for name, kw in QWRITE_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]), quant=True)
        args, call_kw = prefill_case(3, **kw)
        _, kp, vp, pt, pos, lens, kc, vc, cl = args
        kp_k, vp_k, skw_k = _clone_pools(args, call_kw)
        kp_r, vp_r, skw_r = _clone_pools(args, call_kw)
        kv_page_write_quant(kc, vc, lens, cl, pt, kp_k, vp_k, layer=call_kw["layer"], **skw_k)
        torch.cuda.synchronize()
        kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp_r, vp_r, layer=call_kw["layer"], **skw_r)
        same = pools_same((kp_k, vp_k), (kp_r, vp_r), skw_k, skw_r)
        layer = call_kw["layer"]
        others = [i for i in range(kw["L"]) if i != layer]
        untouched = all(
            _same_bytes(x[i], y[i]) for i in others
            for x, y in ((kp_k, kp), (vp_k, vp), (skw_k["k_scales"], call_kw["k_scales"]),
                         (skw_k["v_scales"], call_kw["v_scales"]))
        )
        changed = not _same_bytes(kp_k[layer], kp[layer])
        emit({"phase": "kernels", "kernel": "kv_page_write_quant", "case": name,
              "pools_and_scales_byte_identical": same, "other_layers_untouched": untouched, "wrote": changed})
        check(same and untouched and changed, f"kv_page_write_quant {name}: pools or scales differ from the "
                                              f"plain version's, or other layers changed")
    return worst


def _forward_run(model, impl, ids, chunk, burst, quant=False):
    """Two prefill chunks then one decode burst of ``burst`` steps through
    model.forward with attn_impl ``impl``, into bf16 pools or, with
    ``quant``, int8 pools and their scales. The burst reads its input tokens
    from ``ids`` (teacher forcing), so both implementations see the same
    tokens. Returns the logits [B, V] of both chunks and every burst step,
    and the pools (and scales) after the burst's commit."""
    import dataclasses

    import torch

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
    from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant

    cfg = dataclasses.replace(model.cfg, attn_impl=impl, kv_cache_dtype="int8" if quant else "auto")
    model.cfg = cfg
    dev = ids.device
    B, page = ids.shape[0], 64
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    maxp = -(-(2 * chunk + burst) // page)
    kp, vp = llama.init_kv_pages(cfg, B * maxp, page, dev)
    scales = (init_kv_scales(L, B * maxp, KH, dev), init_kv_scales(L, B * maxp, KH, dev)) if quant else None
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
    logits = []
    for c in range(2):
        pos = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        lens = torch.full((B,), (c + 1) * chunk, dtype=torch.int32, device=dev)
        lg = model(ids[:, c * chunk:(c + 1) * chunk], pos, kp, vp, pt, lens, kv_scales=scales)
        logits.append(lg)
    k_acc = torch.zeros((L, B, burst, KH, D), dtype=cfg.dtype, device=dev)
    v_acc = torch.zeros_like(k_acc)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(burst):
        pos = torch.full((B, 1), 2 * chunk + s, dtype=torch.int32, device=dev)
        lens = torch.full((B,), 2 * chunk + s + 1, dtype=torch.int32, device=dev)
        lg = model(ids[:, 2 * chunk + s][:, None], pos, kp, vp, pt, lens, kv_burst=(k_acc, v_acc, counts),
                   kv_scales=scales)
        counts = counts + 1
        logits.append(lg)
    jj = torch.arange(burst, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if quant:
        write_kv_pages_all_layers_quant(kp, vp, *scales, k_acc, v_acc, pt, 2 * chunk + jj)
    else:
        write_kv_pages_all_layers(kp, vp, k_acc, v_acc, pt, 2 * chunk + jj)
    torch.cuda.synchronize()
    return logits, (kp, vp) + (scales or ())


# the kernel forward's logits vs the plain forward's, llama-3.2-1b in bf16:
# attention outputs differ by bf16 rounding (a last-bit flip after another
# f32 summation order) and 16 layers carry it into logits of order 1, whose
# bf16 ulp is 2^-7 to 2^-5. The int8 pool run is held to the same bound.
FORWARD_LOGIT_BOUND = 0.25
FORWARD_TOP1_MIN = 0.9


def phase_forward():
    """llama-3.2-1b with the kernels and with the plain versions, first into
    bf16 pools, then into int8 pools. Layer 0's K/V come before any
    attention, so its int8 pages and scales must be byte-identical between
    the two int8 runs (the quantizing write kernel against its plain
    version, inside the model)."""
    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model

    t_load = time.perf_counter()
    _, cfg, model = load_model("llama-3.2-1b", seed=0, device="cuda")
    load_s = time.perf_counter() - t_load
    gen = torch.Generator().manual_seed(3)
    B, chunk, burst = 2, 512, 8
    ids = torch.randint(0, cfg.vocab_size, (B, 2 * chunk + burst), generator=gen, dtype=torch.int32).cuda()
    for quant in (False, True):
        t0 = time.perf_counter()
        with torch.no_grad():
            lk, pools_k = _forward_run(model, "cuda", ids, chunk, burst, quant)
            lp, pools_p = _forward_run(model, "plain", ids, chunk, burst, quant)
        finite = all(bool(torch.isfinite(x).all()) for x in lk)
        shapes_ok = all(tuple(x.shape) == (B, cfg.vocab_size) for x in lk)
        diffs = [float((a - b).abs().max()) for a, b in zip(lk, lp)]
        top1 = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(lk, lp)) / (B * len(lk))
        pool_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(pools_k, pools_p))
        line = {
            "phase": "forward", "model": "llama-3.2-1b", "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "dtype": "bfloat16", "kv_cache_dtype": "int8" if quant else "auto", "rows": B,
            "chunks": [chunk, chunk], "burst": burst,
            "max_logit_diff_per_step": diffs, "max_logit_diff": max(diffs), "bound": FORWARD_LOGIT_BOUND,
            "top1_agreement": top1, "top1_min": FORWARD_TOP1_MIN, "logit_absmax": float(lk[0].abs().max()),
            "pool_max_abs_diff_after_commit": pool_diff, "finite": finite,
            "seconds": round(time.perf_counter() - t0 + (0.0 if quant else load_s), 2),
        }
        if quant:
            line["layer0_pages_and_scales_byte_identical"] = all(
                _same_bytes(a[0], b[0]) for a, b in zip(pools_k, pools_p)
            )
        emit(line)
        what = "forward[int8]" if quant else "forward"
        check(finite and shapes_ok, f"{what}: logits not finite or of the wrong shape")
        check(max(diffs) <= FORWARD_LOGIT_BOUND, f"{what}: logit diff {max(diffs)} > {FORWARD_LOGIT_BOUND}")
        check(top1 >= FORWARD_TOP1_MIN, f"{what}: top-1 agreement {top1} < {FORWARD_TOP1_MIN}")
        if quant:
            check(line["layer0_pages_and_scales_byte_identical"],
                  f"{what}: layer 0's int8 pages or scales differ between the kernel and plain runs")
    del model
    torch.cuda.empty_cache()


# each kernel row's launch counter, as (wrapper, attribute): the int8 modes
# of the two attention kernels count apart from their fp modes
def _counters():
    from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
    from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

    kernels = {
        "decode_attention": (dmod.decode_attention, "launches"),
        "prefill_attention": (pmod.prefill_attention, "launches"),
        "kv_page_write": (pmod.kv_page_write, "launches"),
        "decode_attention[int8]": (dmod.decode_attention, "launches_int8"),
        "prefill_attention[int8]": (pmod.prefill_attention, "launches_int8"),
        "kv_page_write_quant": (pmod.kv_page_write_quant, "launches"),
    }
    plains = {
        "decode_attention_ref": dmod.decode_attention_ref,
        "prefill_attention_ref": pmod.prefill_attention_ref,
        "kv_page_write_ref": pmod.kv_page_write_ref,
        "kv_page_write_quant_ref": pmod.kv_page_write_quant_ref,
    }
    return kernels, plains


def _prompt(rng, n_chars: int) -> str:
    letters = "abcdefghijklmnopqrstuvwxyz     .,"
    return "".join(letters[rng.randrange(len(letters))] for _ in range(n_chars))


async def _serve_requests(port: int, metric_series: tuple = ()) -> dict:
    import random

    import aiohttp

    rng = random.Random(5)
    base = f"http://127.0.0.1:{port}"
    max_tokens = 32
    # 575 bytes + BOS = 576 tokens = 9 pages: the repeat hits 8 cached pages
    # and recomputes the last 64 tokens, in the same chunk shape as the first
    # run's second chunk, so greedy output must repeat bit for bit
    repeat = {"prompt": _prompt(rng, 575), "max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True}
    prompts = [_prompt(rng, 590 + 7 * i) for i in range(4)]
    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        for path in ("/health", "/v1/models", "/version"):
            async with s.get(base + path) as r:
                check(r.status == 200, f"serve: GET {path} -> {r.status}")

        async def complete(body):
            async with s.post(base + "/v1/completions", json=body) as r:
                return r.status, await r.json()

        async def stream(body):
            text, usage = [], None
            async with s.post(base + "/v1/completions", json=dict(body, stream=True)) as r:
                status = r.status
                async for raw in r.content:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    chunk = json.loads(line[6:])
                    if chunk.get("usage"):
                        usage = chunk["usage"]
                    for c in chunk["choices"]:
                        text.append(c.get("text") or "")
            return status, {"choices": [{"text": "".join(text)}], "usage": usage}

        async def chat(body):
            async with s.post(base + "/v1/chat/completions", json=body) as r:
                return r.status, await r.json()

        t0 = time.perf_counter()
        st, first = await complete(repeat)
        check(st == 200, f"serve: repeat request -> {st}")
        out["repeat_first_seconds"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        bodies = [
            {"prompt": p, "max_tokens": max_tokens, "temperature": 0.0 if i % 2 == 0 else 0.8,
             "top_p": 0.95, "ignore_eos": True}
            for i, p in enumerate(prompts)
        ]
        chat_body = {"messages": [{"role": "user", "content": _prompt(rng, 200)}], "max_tokens": 16,
                     "temperature": 0.0, "ignore_eos": True}
        results = await asyncio.gather(
            stream(bodies[0]), complete(bodies[1]), complete(bodies[2]), complete(bodies[3]), chat(chat_body)
        )
        out["concurrent_seconds"] = round(time.perf_counter() - t0, 3)
        for i, (st, body) in enumerate(results[:4]):
            check(st == 200, f"serve: completion {i} -> {st}: {body}")
            u = body["usage"]
            check(u["completion_tokens"] == max_tokens, f"serve: completion {i} usage {u}")
            check(u["prompt_tokens"] == len(prompts[i]) + 1, f"serve: completion {i} prompt tokens {u}")
        st, body = results[4]
        check(st == 200, f"serve: chat -> {st}: {body}")
        check(body["usage"]["completion_tokens"] == 16, f"serve: chat usage {body['usage']}")
        check(body["choices"][0]["message"]["role"] == "assistant", "serve: chat message role")
        st, second = await complete(repeat)
        check(st == 200, f"serve: repeat request (again) -> {st}")
        same = first["choices"][0]["text"] == second["choices"][0]["text"]
        out["greedy_repeat_identical"] = same
        out["repeat_cached_tokens"] = second["usage"]["prompt_tokens_details"]["cached_tokens"]
        check(same, "serve: the same greedy request returned different text")
        async with s.get(base + "/metrics") as r:
            metrics = await r.text()
        for series in ("vllm:generation_tokens_total",) + metric_series:
            check(f"{series}{{" in metrics, f"serve: /metrics lacks {series}")
        out["metrics"] = {
            line.split("{")[0]: float(line.rsplit(" ", 1)[1]) for line in metrics.splitlines()
            if line.split("{")[0] in metric_series
        }
        out["usage_example"] = results[1][1]["usage"]
    return out


# The int8 server: int8 pools and the CPU offload tier, with a pool of 40
# pages (2,560 tokens) that the concurrent requests (~46 pages) overrun, so
# the repeat request's prefix pages are evicted to the tier between its two
# runs and restored from it for the second.
INT8_SERVE = dict(kv_cache_dtype="int8", kv_offload_cpu_gb=1.0, num_pages=40)
INT8_METRICS = (
    "vllm:kv_cache_dtype_bytes_per_token", "vllm:kv_quant_pages", "vllm:kv_quant_dequant_err_max",
    "vllm:kv_offload_saved_pages_total", "vllm:kv_offload_loaded_pages_total", "vllm:kv_offload_hit_pages_total",
    "vllm:kv_offload_max_io_pages", "vllm:kv_offload_link_bandwidth_bytes_per_sec",
)
SERVE_ROWS = {
    False: ("decode_attention", "prefill_attention", "kv_page_write"),
    True: ("decode_attention[int8]", "prefill_attention[int8]", "kv_page_write_quant"),
}


def phase_serve(quant: bool = False) -> dict:
    """The port's OpenAI server in-process: bf16 pools, or (``quant``) int8
    pools with the CPU offload tier. Returns the launch counts of the run."""
    import socket

    import torch

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cfg = EngineConfig(model="llama-3.2-1b", host="127.0.0.1", port=port, **(INT8_SERVE if quant else {}))
    kernels, plains = _counters()

    async def run():
        server, runner = await serve(cfg)
        try:
            # every count to 0 right before the main path, read right after
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            for fn in plains.values():
                fn.calls = 0
            t0 = time.perf_counter()
            res = await _serve_requests(port, INT8_METRICS if quant else ())
            res["seconds"] = round(time.perf_counter() - t0, 3)
            res["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
            res["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
            keep = ["prompt_tokens_total", "generation_tokens_total", "decode_dispatches_total",
                    "gpu_prefix_cache_hits_total", "kv_evicted_pages_total", "num_pages"]
            if quant:
                keep += ["cache_dtype", "kv_cache_dtype_bytes_per_token", "kv_quant_pages",
                         "kv_quant_dequant_err_max", "kv_offload_saved_pages_total",
                         "kv_offload_loaded_pages_total", "kv_offload_hit_pages_total",
                         "kv_proactive_spilled_pages_total", "kv_offload_cpu_bytes", "kv_corrupt_pages_total",
                         "kv_offload_max_io_pages", "kv_offload_link_bandwidth_bytes_per_sec"]
            stats = server.engine.stats()
            res["engine"] = {k: stats[k] for k in keep if k in stats}
            return res
        finally:
            await runner.cleanup()
            server.engine.stop()

    t0 = time.perf_counter()
    res = asyncio.run(run())
    res["seconds_with_startup"] = round(time.perf_counter() - t0, 2)
    what = "serve[int8]" if quant else "serve"
    emit({"phase": "serve", "model": "llama-3.2-1b", "kv_cache_dtype": cfg.kv_cache_dtype,
          **({"config": INT8_SERVE} if quant else {}), **res})
    for k in SERVE_ROWS[quant]:
        check(res["launches"][k] > 0, f"{what}: kernel {k} was not launched on the main path")
    for k in SERVE_ROWS[not quant]:  # an int8 pool never reaches an fp mode, nor the other way round
        check(res["launches"][k] == 0, f"{what}: kernel {k} ran {res['launches'][k]} times on the main path")
    for k, n in res["plain_calls"].items():
        check(n == 0, f"{what}: plain version {k} ran {n} times on the main path")
    if quant:
        e = res["engine"]
        check(e["kv_offload_saved_pages_total"] > 0, f"{what}: no page was saved to the CPU tier")
        check(e["kv_offload_loaded_pages_total"] > 0 and e["kv_offload_hit_pages_total"] > 0,
              f"{what}: no page was restored from the CPU tier")
        check(e["kv_corrupt_pages_total"] == 0, f"{what}: the CPU tier held corrupt pages")
        check(res["repeat_cached_tokens"] >= 512, f"{what}: the repeat reused {res['repeat_cached_tokens']} tokens")
    torch.cuda.empty_cache()
    return res["launches"]


def _time_ms(fn, iters=30, warmup=3) -> float:
    """Median device ms of one call, CUDA events around each launch. Before
    each launch a 128 MB read evicts the 50 MB L2 (a read, so no write-back
    of the flush competes with the timed launch), then a ~0.5 ms spin on
    the card holds the start event back until the host has enqueued the
    call: the wrapper's Python time never lands between the two events."""
    import torch

    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def _bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


SMALL_BATCH_DECODE = (DECODE_B1_2K, DECODE_B8_1K, DECODE_B1_8K)


def _decode_timing(case_name: str, quant: bool) -> dict:
    """The decode kernel, its plain version and SDPA on one decode case's
    inputs (int8 pools and scales for ``quant``), beside the byte bound."""
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_ref
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    case = dict(dict(DECODE_CASES)[case_name], dtype=bf16, quant=quant)
    B, NH, KH, D, page, maxp = (case[k] for k in ("B", "NH", "KH", "D", "page", "maxp"))
    lens, C, cur = case["lens"], case["C"], case["cur_lens"]
    G = NH // KH
    args, kw = decode_case(case.pop("seed"), **case)
    q, kp, vp, pt, _ = args
    ms = _time_ms(lambda: decode_attention(*args, **kw))
    plain = _time_ms(lambda: decode_attention_ref(*args, **kw))
    if quant:  # the yardstick reads KV dequantized beforehand (the dequant is not timed)
        kg, vg = gather_kv_pages_quant(kp[0], vp[0], kw["k_scales"][0], kw["v_scales"][0], pt, dtype=bf16)
    else:
        kg, vg = gather_kv_pages(kp[0], vp[0], pt)
    ctx = lens[0]  # the timed cases have rows of one length and full windows
    k_all = torch.cat([kg[:, : ctx - C], kw["k_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v_all = torch.cat([vg[:, : ctx - C], kw["v_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    lib = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all))
    el = 2
    hist = sum(n - c for n, c in zip(lens, cur))  # pool slots read, over all rows
    kv_el = 1 if quant else el
    pages = sum(-(-(n - c) // page) for n, c in zip(lens, cur))
    nbytes = (2 * B * NH * D * el + 2 * hist * KH * D * kv_el + (2 * pages * KH * 4 if quant else 0)
              + 2 * sum(cur) * KH * D * el + pt.numel() * 4 + 2 * B * 4)
    b_ms, b_by = _bound(nbytes, 4 * NH * D * sum(lens))
    pool = "int8 pool, bf16 q/window" if quant else "bf16"
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=f"B={B} ctx={ctx} C={C} NH={NH} KH={KH} D={D} page={page} {pool}",
                library="scaled_dot_product_attention over gathered KV, heads repeated"
                        + (" (KV dequantized to bf16 beforehand, not timed)" if quant else ""))


def phase_timing() -> dict:
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.prefill_attention import (
        kv_page_write,
        kv_page_write_quant,
        kv_page_write_quant_ref,
        kv_page_write_ref,
        prefill_attention,
        prefill_attention_ref,
    )
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    rows = {}
    NH, KH, D, page = 32, 8, 64, 64
    G = NH // KH

    # K1 at a decode burst step: 32 rows x 1,024 context, window C = 8 full
    rows["decode_attention"] = _decode_timing(MAIN_DECODE, quant=False)
    el = 2

    # K2 at a main-path prefill chunk: T = 512 after 1,536 tokens of history
    case = dict(dict(PREFILL_CASES)[MAIN_PREFILL], dtype=bf16)
    T, hist = case["T"], case["computed"][0]
    args, kw = prefill_case(case.pop("seed"), **case)
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    ms = _time_ms(lambda: prefill_attention(*args, **kw))
    plain = _time_ms(lambda: prefill_attention_ref(*args, **kw))
    kg, vg = gather_kv_pages(kp[0], vp[0], pt)
    kk = torch.cat([kg[:, :hist], kc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = torch.cat([vg[:, :hist], vc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    mask = (torch.arange(hist + T, device="cuda")[None, :] <= hist + torch.arange(T, device="cuda")[:, None])
    lib = _time_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask))
    pairs = T * hist + T * (T + 1) // 2  # visible (query, key) pairs per head
    nbytes = 2 * T * NH * D * el + 2 * hist * KH * D * el + 2 * T * KH * D * el + pt.numel() * 4 + T * 4 + 8
    flops = 4 * NH * D * pairs
    b_ms, b_by = _bound(nbytes, flops)
    rows["prefill_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                                     shape=f"B=1 T={T} history={hist} NH={NH} KH={KH} D={D} page={page} bf16",
                                     library="scaled_dot_product_attention with a causal-offset mask")

    # the chunk's KV write, same chunk (into the pool slots after the history)
    ms = _time_ms(lambda: kv_page_write(kc, vc, pos, cl, pt, kp, vp, layer=0))
    plain = _time_ms(lambda: kv_page_write_ref(kc, vc, pos, cl, pt, kp, vp, layer=0))
    p0 = pos[0].long()
    slots = pt[0, p0 // page].long() * page + p0 % page
    kflat, vflat = kp[0].view(-1, KH, D), vp[0].view(-1, KH, D)
    lib = _time_ms(lambda: (kflat.index_copy_(0, slots, kc[0]), vflat.index_copy_(0, slots, vc[0])))
    nbytes = 4 * T * KH * D * el + T * 4 + pt.numel() * 4
    b_ms, b_by = _bound(nbytes, 0.0)
    rows["kv_page_write"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                                 shape=f"T={T} KH={KH} D={D} page={page} bf16",
                                 library="index_copy_ into the flat pool, K and V")

    # the int8 modes at the same shapes: int8 pools with per-page scales
    rows["decode_attention[int8]"] = _decode_timing(MAIN_DECODE, quant=True)

    case = dict(dict(PREFILL_CASES)[INT8 + MAIN_PREFILL], dtype=bf16)
    args, kw = prefill_case(case.pop("seed"), **case)
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    ms = _time_ms(lambda: prefill_attention(*args, **kw))
    plain = _time_ms(lambda: prefill_attention_ref(*args, **kw))
    kg, vg = gather_kv_pages_quant(kp[0], vp[0], kw["k_scales"][0], kw["v_scales"][0], pt, dtype=bf16)
    kk = torch.cat([kg[:, :hist], kc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = torch.cat([vg[:, :hist], vc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    lib = _time_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask))
    nbytes = (2 * T * NH * D * el + 2 * hist * KH * D + 2 * (hist // page) * KH * 4 + 2 * T * KH * D * el
              + pt.numel() * 4 + T * 4 + 8)
    b_ms, b_by = _bound(nbytes, 4 * NH * D * pairs)
    rows["prefill_attention[int8]"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 T={T} history={hist} NH={NH} KH={KH} D={D} page={page} int8 history, bf16 q/chunk",
        library="scaled_dot_product_attention over history dequantized to bf16 beforehand (dequant not "
                "timed), causal-offset mask")

    # the chunk's quantizing write into its 8 fresh pages after the history
    skw = dict(k_scales=kw["k_scales"], v_scales=kw["v_scales"])
    ms = _time_ms(lambda: kv_page_write_quant(kc, vc, lens, cl, pt, kp, vp, layer=0, **skw))
    plain = _time_ms(lambda: kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp, vp, layer=0, **skw))
    n_pages = T // page
    nbytes = 2 * T * KH * D * el + 2 * n_pages * page * KH * D + 2 * n_pages * KH * 4 + 8 + pt.numel() * 4
    b_ms, b_by = _bound(nbytes, 0.0)
    rows["kv_page_write_quant"] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                                       shape=f"T={T} into {n_pages} fresh pages, KH={KH} D={D} page={page} "
                                             f"bf16 -> int8",
                                       library="none: no single PyTorch call quantizes per page and scatters")
    for name, r in rows.items():
        emit({"phase": "timing", "kernel": name, **r})
    # the decode kernel at small batch, both modes (rows of their own; the
    # kernel table keeps the main-path shapes above)
    for case in SMALL_BATCH_DECODE:
        for quant in (False, True):
            emit({"phase": "timing", "kernel": _kernel_name("decode_attention", quant), "case": case,
                  **_decode_timing(case, quant)})
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    if not (ROOT / "production_stack_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no production_stack_tpu_torch package")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build()
    worst = phase_kernels()
    phase_forward()
    launches = {}
    for quant in (False, True):  # each row's launches come from its own server's run
        counts = phase_serve(quant)
        launches.update({k: counts[k] for k in SERVE_ROWS[quant]})
    timing = phase_timing()

    table = []
    for name in REPLACES:
        t = timing[name]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 2)})
    emit({"kernels": table})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PSTPU_LOG_LEVEL", "WARNING")
    sys.exit(main())
