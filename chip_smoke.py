#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (production_stack_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase ends the run with a
non-zero exit (nothing is caught):

1. build    -- nvcc builds every kernel library from production_stack_tpu_torch/
               csrc/ (one nvcc per source, all started together).
2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
               fp pools and int8 pools (per-page scales), at D = 64, 128
               and 256: llama-3.2-1b's heads, qwen2.5-7b's (NH = 28,
               KH = 4: 7 query heads per KV head), opt-125m's (NH = KH =
               12) and gemma-2-2b's (window 4,096, softcap 50, sm_scale
               144^-0.5): ragged, burst-window, stacked-layer,
               window+softcap, bf16/f32 and NaN-poisoned stale-slot (or
               stale-scale) cases, the decode kernel's split-KV edges
               (rows with empty splits, a deep window start, the burst on
               a row whose last split is empty, G = 1 / 7 / 8, page 48,
               one row at 8,192; each decode call made twice and held to
               the same bytes), OPT's 3-token chunk, and the timing phase's
               inputs, each held to a bound scaled to its output (TOL; D =
               256 with scores that reach the softcap, to the tighter
               TOL_CAPPED); the main cases' one-key-fewer controls must
               fail it; the chunk's KV write, inside the same launch (fp,
               and the quantizing write), must leave pools and scales
               byte-identical to the writes' plain versions and other
               layers untouched, in every prefill case and in the write
               cases (aligned chunk, chunk ending mid-page, unaligned head
               page, other layers untouched, G = 1 / 7 / 8, a 3-token
               chunk over two pages, B = 2 with a padded row, pages of
               128) at D = 64, 128 and 256, bf16 and f32, fp and int8
               pools; the launch without the write leaves them untouched,
               with the same attention bytes.
3. forward  -- llama-3.2-1b (two 512-token chunks) and gemma-2-2b (nine,
               past its 4,096 window) at full width and depth (bf16,
               seeded random weights), then one 8-step decode burst, with
               the kernels and with the plain versions, into bf16 pools and
               then into int8 pools (layer 0's int8 pages and scales
               byte-identical between the two).
4. hf       -- qwen2.5-7b's HF directory (its published config.json, 28
               layers, seeded bf16 weights in shards of at most 5 GB with
               the index) written under build/hf_models/, loaded through
               the port's loader (config equal to the preset but for
               max_model_len, sampled parameters byte-identical to the
               tensors written), and its forward checked as in phase 3;
               then opt-125m's directory (float16, as published).
5. serve    -- the port's OpenAI server in-process on localhost, six
               times: llama-3.2-1b with bf16 pools; with int8 pools, the
               CPU offload tier and a pool small enough to evict; gemma-2-2b
               with bf16 pools and one prompt of 4,301 tokens; qwen2.5-7b
               from its directory with bf16 pools, then int8 pools; and
               opt-125m from its directory: concurrent /v1/completions (one
               streaming) and /v1/chat/completions; a greedy request repeats
               exactly over at least 512 cached tokens (with int8 and the
               tier, after its prefix pages were spilled and restored; for
               every model but llama, its token logprobs too); the launch
               counters show each run went through its mode's kernels and
               no plain version; the int8 runs' /metrics carry the quant
               (and offload) series. Then an OPT engine with int8 pools
               must be refused. The directories are deleted.
6. timing   -- each kernel row (three fp, three int8, at llama-3.2-1b's,
               qwen2.5-7b's and gemma-2-2b's shapes), its plain version and
               a PyTorch yardstick, with CUDA events, beside its bound (the
               prefill launch timed without and with the chunk's write: the
               write rows' time is the difference, beside the write's
               bound, and the whole launch's time beside its own); then
               the decode kernel at small batch (1 x 2,048, 8 x 1,024, 1 x
               8,192; qwen2.5-7b's 1 x 8,192), gemma-2-2b's 1 x 8,192 on a
               sliding and a global layer, both modes, and opt-125m's
               decode and prefill, as rows of their own.

Then the kernel table line (each row's launches from its own path's runs:
the llama and opt-125m servers for D = 64, the qwen2.5-7b servers for
D = 128, the gemma-2-2b server for its bf16 rows and its int8 kernel
forward for its int8 rows, which no server runs), the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``. With
no CUDA device, or run from a directory without the package, it exits
non-zero and prints no result. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import shutil
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
# The capped-score cases (D = 256, q scaled so that scores reach the
# softcap of 50) hold bf16 to k = 0.02: a tanh with a relative error of
# 2^-11 (PTX's bound for tanh.approx.f32) would move a capped score by up
# to 0.024 and p by up to 2.4%, which the 0.05 term could let through.
TOL_CAPPED = {"bfloat16": (2.0**-6, 0.02)}

# Where each TPU kernel's launch sits in the JAX package. Each kernel has a
# row at head_dim 64 (llama-3.2-1b, opt-125m), one at 128 ("[d128]":
# qwen2.5-7b) and one at 256 ("[d256]": gemma-2-2b).
_BASE_REPLACES = {
    "decode_attention": "production_stack_tpu/ops/pallas/paged_attention.py:67",
    "prefill_attention": "production_stack_tpu/ops/pallas/prefill_attention.py:72",
    "kv_page_write": "production_stack_tpu/ops/pallas/prefill_attention.py:396",
    "decode_attention[int8]": "production_stack_tpu/ops/pallas/paged_attention.py:97",
    "prefill_attention[int8]": "production_stack_tpu/ops/pallas/prefill_attention.py:112",
    "kv_page_write_quant": "production_stack_tpu/ops/pallas/prefill_attention.py:304",
}
_BASE_SOURCES = {
    "decode_attention": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "decode_attention[int8]": "production_stack_tpu_torch/csrc/decode_attention.cu",
    "prefill_attention[int8]": "production_stack_tpu_torch/csrc/prefill_attention.cu",
    "kv_page_write_quant": "production_stack_tpu_torch/csrc/prefill_attention.cu",
}


def _dtag(name: str, D: int) -> str:
    """A kernel row's name at head_dim D (64 keeps the bare name):
    decode_attention[int8] at 256 -> decode_attention[int8,d256]."""
    if D == 64:
        return name
    return name[:-1] + f",d{D}]" if name.endswith("]") else name + f"[d{D}]"


HEAD_DIMS = (64, 128, 256)
REPLACES = {_dtag(k, D): v for D in HEAD_DIMS for k, v in _BASE_REPLACES.items()}
SOURCES = {_dtag(k, D): v for D in HEAD_DIMS for k, v in _BASE_SOURCES.items()}


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


def _pools(gen, shape, dtype, device, quant, kv_normal=False):
    """(k_pages, v_pages, scales kwargs): random pools in ``dtype``, or with
    ``quant`` int8 pools and per-page, per-KV-head scales: uniformly random
    bytes with scales of a typical size (amax / 127 of unit-normal KV is
    ~0.025), or with ``kv_normal`` unit-normal K/V quantized as the KV write
    quantizes a page (scale = amax / 127 over the page's slots and D)."""
    import torch

    if not quant:
        return _rand(gen, shape, dtype, device), _rand(gen, shape, dtype, device), {}
    L, P, _, KH, _ = shape
    if kv_normal:
        pools, scales = [], []
        for _ in range(2):
            x = torch.randn(shape, generator=gen)
            sc = (x.abs().amax(dim=(2, 4)) / 127.0).clamp(min=1e-8)  # [L, P, KH]
            pools.append((x / sc[:, :, None, :, None]).round().clamp(-127, 127).to(torch.int8).to(device))
            scales.append(sc.to(device))
        return pools[0], pools[1], dict(k_scales=scales[0], v_scales=scales[1])
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
                softcap=None, sm_scale=None, layer=0, poison=False, quant=False, kv_normal=False, q_scale=1.0):
    """Inputs of one decode-kernel call: pools [L, P, page, KH, D] (int8
    with scales for ``quant``); with C > 0 a burst window k_cur/v_cur
    [B, C, KH, D] and its cur_lens; q unit-normal times ``q_scale``."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant, kv_normal)
    pt = _page_table(gen, B, maxp, P, device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, sm_scale=sm_scale, layer=layer, **skw)
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
    q = _rand(gen, (B, NH, D), dtype, device, q_scale)
    return (q, kp, vp, pt, lens_t), kw


def prefill_case(seed, *, B, T, NH, KH, D, page, maxp, L, computed, chunks, dtype, window=None,
                 softcap=None, sm_scale=None, layer=0, poison=False, quant=False, kv_normal=False, q_scale=1.0):
    """Inputs of one prefill-kernel call: row b has computed[b] tokens in
    the pool (int8 with scales for ``quant``) and a chunk of chunks[b]
    tokens (0 = padded row); q unit-normal times ``q_scale``."""
    import torch

    device = "cuda"
    gen = torch.Generator().manual_seed(seed)
    P = B * maxp + 3
    kp, vp, skw = _pools(gen, (L, P, page, KH, D), dtype, device, quant, kv_normal)
    pt = _page_table(gen, B, maxp, P, device)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    for b in range(B):
        pos[b, : chunks[b]] = torch.arange(computed[b], computed[b] + chunks[b])
    kv_lens = torch.tensor([c + n for c, n in zip(computed, chunks)], dtype=torch.int32, device=device)
    cur_lens = torch.tensor(chunks, dtype=torch.int32, device=device)
    kw = dict(window=window, logit_softcap=softcap, sm_scale=sm_scale, layer=layer, **skw)
    if poison and quant:  # the scales of pages wholly past each chunk start
        _poison_scales(kw, layer, pt, B, [-(-computed[b] // page) for b in range(B)])
    elif poison:  # every slot at or after each row's chunk start holds NaN
        for b in range(B):
            for s in range(computed[b], maxp * page):
                pid = int(pt[b, s // page])
                kp[layer, pid, s % page] = float("nan")
                vp[layer, pid, s % page] = float("nan")
    q = _rand(gen, (B, T, NH, D), dtype, device, q_scale)
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


def _judge(out, ref, dtype, tol=TOL) -> dict:
    """The TOL check (or ``tol``'s): ``ratio`` is the largest |out - ref|
    over its allowed bound, so the output passes when ratio <= 1."""
    import torch

    rtol, k = tol[str(dtype).split(".")[-1]]
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
        # a "wgmma ... serialized" warning means ptxas made the products synchronous
        keep = ("Compiling entry function", "registers", "spill", "wgmma")
        report = [l.strip() for l in _build.ptxas_report(name).splitlines() if any(k in l for k in keep)]
        emit({"phase": "build", "ptxas": name, "lines": report[:60]})


MAIN_DECODE = "main_path_b32_ctx1024_c8_bf16"
DECODE_B1_8K = "small_batch_b1_ctx8192_c8_bf16"
DECODE_B1_2K = "small_batch_b1_ctx2048_c8_bf16"
DECODE_B8_1K = "small_batch_b8_ctx1024_c8_bf16"
MAIN_PREFILL = "main_path_t512_h1536_bf16"
INT8 = "int8_"  # the int8 pool twin of a case: same shapes, int8 pools and scales
# gemma-2-2b's attention (D = 256, G = 2): sm_scale = query_pre_attn_scalar**-0.5
# with a scalar other than D (144, so a kernel that falls back to D**-0.5
# fails), softcap 50, the sliding layers' window of 4,096. Its int8 pools
# hold unit-normal K/V quantized per page: with uniformly random bytes the
# scores spread so far (std ~2.4 after the scale) that a few keys carry each
# softmax, and a one-key-fewer output stayed inside the bound (ratio 0.86 at
# 32 x 1,024)
GEMMA = dict(NH=8, KH=4, D=256, softcap=50.0, sm_scale=144.0**-0.5, kv_normal=True)
GEMMA_WINDOW = 4096
GEMMA_DECODE = "gemma_main_b32_ctx1024_c8_bf16"
GEMMA_DECODE_B1_8K_SLIDING = "gemma_b1_ctx8192_c8_sliding_bf16"
GEMMA_DECODE_B1_8K_GLOBAL = "gemma_b1_ctx8192_c8_global_bf16"
GEMMA_PREFILL = "gemma_main_t512_h1536_bf16"
# qwen2.5-7b's attention (D = 128, G = 7: the decode fold fills 7 of its 16
# mma rows, and a prefill warpgroup's 64 rows hold 9 tokens x 7 heads and
# one padding row); its int8 pools hold unit-normal K/V quantized per page,
# as GEMMA's
QWEN = dict(NH=28, KH=4, D=128, kv_normal=True)
QWEN_DECODE = "qwen_main_b32_ctx1024_c8_bf16"
QWEN_DECODE_B1_8K = "qwen_b1_ctx8192_c8_bf16"
QWEN_PREFILL = "qwen_main_t512_h1536_bf16"
# opt-125m's (D = 64, G = 1: one row of the fold's 16, 64 tokens of one head
# in a prefill tile)
OPT = dict(NH=12, KH=12, D=64)
OPT_DECODE = "opt_b8_ctx1024_c8_g1_bf16"
OPT_PREFILL = "opt_t512_h1536_g1_bf16"
# the cases whose one-key-fewer control must fail the bound
CONTROLLED = {MAIN_DECODE, MAIN_PREFILL, GEMMA_DECODE, GEMMA_PREFILL, QWEN_DECODE, QWEN_PREFILL, OPT_DECODE,
              OPT_PREFILL}
CONTROLLED |= {INT8 + n for n in CONTROLLED}
# D = 256 with q x 20: scores of std ~27 before the cap, so most keys that
# carry a row's softmax sit where tanh bends (|s| / 50 ~ 0.3-1.5); held to
# TOL_CAPPED
GEMMA_CAPPED = "d256_capped_scores_q20_bf16"
CAPPED = {GEMMA_CAPPED, INT8 + GEMMA_CAPPED}

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
    # D = 256 (gemma-2-2b's heads): ragged rows with a burst window in a
    # stacked pool, the 4,096 window biting on the long rows
    ("d256_ragged_burst_layer2_window_bf16", dict(GEMMA, B=5, page=64, maxp=72, L=3, layer=2,
                                                  lens=[9, 700, 4500, 4097, 1], C=8, cur_lens=[8, 3, 5, 8, 1],
                                                  window=GEMMA_WINDOW, dtype="bfloat16")),
    ("d256_ragged_window_f32", dict(GEMMA, B=3, page=16, maxp=290, L=2, layer=1, lens=[4500, 50, 4097], C=2,
                                    cur_lens=[2, 1, 1], window=GEMMA_WINDOW, dtype="float32")),
    ("d256_empty_row_global_bf16", dict(GEMMA, B=3, page=16, maxp=8, L=1, lens=[77, 0, 128], dtype="bfloat16")),
    ("d256_nan_stale_slots_bf16", dict(GEMMA, B=3, page=16, maxp=10, L=2, layer=1, lens=[20, 41, 90], C=8,
                                       cur_lens=[4, 8, 1], poison=True, dtype="bfloat16")),
    ("d256_nan_stale_slots_f32", dict(GEMMA, B=2, page=16, maxp=6, L=1, lens=[33, 70], C=4, cur_lens=[4, 2],
                                      poison=True, dtype="float32")),
    # the split edges at D = 256: one row at 8,192 behind the window (the
    # shares start 4,096 slots in), and the burst on a row whose last split
    # is empty
    (GEMMA_DECODE_B1_8K_SLIDING, dict(GEMMA, seed=13, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                                      window=GEMMA_WINDOW, dtype="bfloat16")),
    (GEMMA_DECODE_B1_8K_GLOBAL, dict(GEMMA, seed=13, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                                     dtype="bfloat16")),
    ("d256_splits_burst_last_split_empty_nan_bf16", dict(GEMMA, B=3, page=64, maxp=24, L=2, layer=1,
                                                         lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                         poison=True, dtype="bfloat16")),
    (GEMMA_CAPPED, dict(GEMMA, B=3, page=64, maxp=24, L=1, lens=[1500, 600, 1400], C=8, cur_lens=[8, 3, 5],
                        q_scale=20.0, dtype="bfloat16")),
    # the timing phase's inputs: a decode burst step of gemma-2-2b
    (GEMMA_DECODE, dict(GEMMA, seed=14, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                        window=GEMMA_WINDOW, dtype="bfloat16")),
    # qwen2.5-7b's heads: the burst on a row whose last split is empty, with
    # NaN past each row's history; f32; one row at 8,192; and the timing
    # phase's decode burst step
    ("qwen_splits_burst_last_split_empty_nan_bf16", dict(QWEN, B=3, page=64, maxp=24, L=2, layer=1,
                                                         lens=[30, 1500, 900], C=8, cur_lens=[3, 5, 8],
                                                         poison=True, dtype="bfloat16")),
    ("qwen_ragged_f32", dict(QWEN, B=2, page=16, maxp=20, L=1, lens=[300, 77], C=2, cur_lens=[2, 1],
                             dtype="float32")),
    (QWEN_DECODE_B1_8K, dict(QWEN, seed=17, B=1, page=64, maxp=129, L=1, lens=[8192], C=8, cur_lens=[8],
                             dtype="bfloat16")),
    (QWEN_DECODE, dict(QWEN, seed=18, B=32, page=64, maxp=16, L=1, lens=[1024] * 32, C=8, cur_lens=[8] * 32,
                       dtype="bfloat16")),
    # opt-125m's heads: ragged rows with an empty one in a stacked pool, and
    # the serve batch (8 rows at 1,024)
    ("opt_g1_ragged_empty_row_layer1_bf16", dict(OPT, B=4, page=64, maxp=8, L=2, layer=1, lens=[0, 9, 300, 512],
                                                 C=8, cur_lens=[0, 8, 3, 8], dtype="bfloat16")),
    (OPT_DECODE, dict(OPT, seed=19, B=8, page=64, maxp=17, L=1, lens=[1024] * 8, C=8, cur_lens=[8] * 8,
                      dtype="bfloat16")),
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
    # D = 256 (32-key tiles, Q read by wgmma from shared memory)
    ("d256_history_unaligned_layer1_bf16", dict(GEMMA, B=3, T=64, page=16, maxp=10, L=2, layer=1,
                                                computed=[37, 64, 5], chunks=[64, 59, 51], dtype="bfloat16")),
    ("d256_first_chunk+padded_row_bf16", dict(GEMMA, B=3, T=48, page=64, maxp=2, L=1, computed=[0, 0, 0],
                                              chunks=[48, 17, 0], dtype="bfloat16")),
    ("d256_window_bites_bf16", dict(GEMMA, B=2, T=96, page=64, maxp=72, L=1, computed=[4200, 30],
                                    chunks=[96, 70], window=GEMMA_WINDOW, dtype="bfloat16")),
    ("d256_window_bites_f32", dict(GEMMA, B=2, T=48, page=16, maxp=266, L=1, computed=[4150, 20],
                                   chunks=[48, 33], window=GEMMA_WINDOW, dtype="float32")),
    ("d256_nan_stale_slots_bf16", dict(GEMMA, B=2, T=32, page=16, maxp=8, L=1, computed=[24, 8],
                                       chunks=[32, 20], poison=True, dtype="bfloat16")),
    ("d256_nan_stale_slots_f32", dict(GEMMA, B=2, T=40, page=16, maxp=8, L=2, layer=1, computed=[30, 3],
                                      chunks=[40, 29], poison=True, dtype="float32")),
    ("d256_page48_unaligned_history_bf16", dict(GEMMA, B=2, T=96, page=48, maxp=8, L=1, computed=[101, 29],
                                                chunks=[96, 70], dtype="bfloat16")),
    (GEMMA_CAPPED, dict(GEMMA, B=2, T=64, page=64, maxp=24, L=1, computed=[1400, 300], chunks=[64, 50],
                        q_scale=20.0, dtype="bfloat16")),
    # the forward phase's chunk where the sliding window starts to bite
    ("d256_t512_h4096_window_bf16", dict(GEMMA, seed=15, B=1, T=512, page=64, maxp=72, L=1, computed=[4096],
                                         chunks=[512], window=GEMMA_WINDOW, dtype="bfloat16")),
    # the timing phase's inputs: gemma-2-2b's 512-token chunk after 1,536
    (GEMMA_PREFILL, dict(GEMMA, seed=16, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                         window=GEMMA_WINDOW, dtype="bfloat16")),
    # qwen2.5-7b's heads: ragged rows (one padded) in a stacked pool with
    # NaN past each chunk start; f32; the timing phase's 512 after 1,536
    ("qwen_ragged_padded_row_layer1_nan_bf16", dict(QWEN, B=3, T=96, page=16, maxp=16, L=2, layer=1,
                                                    computed=[100, 0, 37], chunks=[96, 61, 0], poison=True,
                                                    dtype="bfloat16")),
    ("qwen_history_f32", dict(QWEN, B=2, T=40, page=16, maxp=8, L=1, computed=[30, 3], chunks=[40, 29],
                              dtype="float32")),
    (QWEN_PREFILL, dict(QWEN, seed=20, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                        dtype="bfloat16")),
    # opt-125m's heads: a 3-token chunk (the JAX OPT takes its XLA path
    # below 16 tokens; the port takes this kernel for every chunk), and a
    # 512-token chunk after 1,536
    ("opt_g1_t3_chunk_bf16", dict(OPT, B=2, T=3, page=16, maxp=4, L=1, computed=[20, 0], chunks=[3, 2],
                                  dtype="bfloat16")),
    (OPT_PREFILL, dict(OPT, seed=21, B=1, T=512, page=64, maxp=32, L=1, computed=[1536], chunks=[512],
                       dtype="bfloat16")),
]
PREFILL_CASES += [(INT8 + name, dict(kw, quant=True)) for name, kw in PREFILL_CASES]

# the chunk's KV write in the prefill launch, against the writes' plain
# versions alone: each case with bf16 and f32 inputs, fp and int8 pools
WRITE_CASES = [
    ("aligned_chunk", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1, computed=[32, 0], chunks=[64, 64])),
    ("chunk_ends_mid_page", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=1, computed=[32, 16],
                                 chunks=[50, 37])),
    ("unaligned_head_page_d128", dict(B=2, T=64, NH=8, KH=2, D=128, page=16, maxp=8, L=1, computed=[37, 5],
                                      chunks=[64, 40])),
    ("other_layers_untouched", dict(B=2, T=64, NH=32, KH=8, D=64, page=16, maxp=8, L=3, layer=1, computed=[21, 0],
                                    chunks=[60, 33])),
]
# the same four cases at gemma-2-2b's KV heads (KH = 4, D = 256)
WRITE_CASES += [("d256_" + name.replace("_d128", ""), dict(kw, NH=8, KH=4, D=256)) for name, kw in WRITE_CASES]
# the write's partition over the launch's blocks (fp: each block its own
# tokens; int8: row b's page tasks to the lowest x-blocks first): opt-125m's
# G = 1 with a 3-token chunk over two pages (one x-block), qwen2.5-7b's G = 7
# with a chunk ending mid-page beside a padded row, G = 8 with unaligned head
# pages, gemma-2-2b's heads with a padded row, and pages of 128
WRITE_CASES += [
    ("g1_t3_two_pages", dict(OPT, B=2, T=3, page=16, maxp=4, L=1, computed=[15, 0], chunks=[3, 2])),
    ("g7_d128_mid_page_padded_row_layer1", dict(QWEN, B=2, T=96, page=16, maxp=16, L=2, layer=1, computed=[37, 0],
                                                chunks=[90, 0])),
    ("g8_unaligned_head_pages", dict(B=2, T=40, NH=32, KH=4, D=64, page=16, maxp=8, L=1, computed=[21, 5],
                                     chunks=[40, 33])),
    ("d256_padded_row", dict(GEMMA, B=2, T=48, page=16, maxp=6, L=1, computed=[13, 0], chunks=[48, 0])),
    # pages of 128 slots: the f32 kernel stages an int8 page task in two
    # slabs of 64
    ("page128_slabs", dict(B=2, T=40, NH=32, KH=8, D=64, page=128, maxp=2, L=1, computed=[100, 0],
                           chunks=[40, 33])),
]


def _kernel_name(base: str, quant: bool, D: int = 64) -> str:
    return _dtag(base + "[int8]" if quant else base, D)


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
        kv_page_write_quant_ref,
        kv_page_write_ref,
        prefill_attention,
        prefill_attention_ref,
    )

    worst = {name: 0.0 for name in REPLACES}

    def judged(kernel, name, out, ref, dtype, control=None, **extra):
        res = _judge(out, ref, dtype, TOL_CAPPED if name in CAPPED else TOL)
        line = {"phase": "kernels", "kernel": kernel, "case": name, **res, **extra}
        if control is not None:
            # the plain version with one history key fewer per row, held to
            # the same bound: the check must reject it
            line["one_key_fewer_ratio_to_bound"] = _judge(control, ref, dtype, TOL)["ratio_to_bound"]
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
        kernel = _kernel_name("decode_attention", kw.get("quant", False), kw["D"])
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
        if name in CONTROLLED:
            q, kp, vp, pt, lens = args
            control = decode_attention_ref(q, kp, vp, pt, lens - 1, **call_kw)
        plan = split_plan(kw["B"], kw["KH"], kw["maxp"], kw["page"], kw["D"], kw.get("quant", False))
        judged(kernel, name, out, ref, kw["dtype"], control, splits=plan.splits, byte_identical_rerun=True)
        if 0 in kw["lens"]:
            check(float(out[kw["lens"].index(0)].float().abs().max()) == 0.0, f"decode {name}: empty row not 0")

    def fused_launch(name, kw, seed):
        """One prefill case through the launch that attends and writes, on
        its own copies of the pools: the output against the plain version
        within TOL, pools and scales against the plain write alone (other
        layers untouched), and the attention-only launch on fresh copies
        (pools untouched, the same output bytes)."""
        quant = kw.get("quant", False)
        kernel = _kernel_name("prefill_attention", quant, kw["D"])
        args, call_kw = prefill_case(seed, **kw)
        q, kp, vp, pt, pos, lens, kc, vc, cl = args
        layer = call_kw["layer"]
        kp_k, vp_k, skw_k = _clone_pools(args, call_kw)
        kp_r, vp_r, skw_r = _clone_pools(args, call_kw)
        out = prefill_attention(q, kp_k, vp_k, pt, pos, lens, kc, vc, cl, fused_write=True, **dict(call_kw, **skw_k))
        torch.cuda.synchronize()
        if quant:
            kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp_r, vp_r, layer=layer, **skw_r)
        else:
            kv_page_write_ref(kc, vc, pos, cl, pt, kp_r, vp_r, layer=layer)
        if kw.get("poison"):  # the plain version on clean inputs: poisoned slots must be skipped
            clean, clean_kw = prefill_case(seed, **dict(kw, poison=False))
            ref = prefill_attention_ref(*clean, **clean_kw)
        else:
            ref = prefill_attention_ref(*args, **call_kw)
        control = None
        if name in CONTROLLED:
            control = prefill_attention_ref(q, kp, vp, pt, pos, lens - 1, kc, vc, cl, **call_kw)
        judged(kernel, name, out, ref, kw["dtype"], control)
        for b, c in enumerate(kw["chunks"]):
            if c == 0:
                check(float(out[b].float().abs().max()) == 0.0, f"prefill {name}: padded row not 0")
        # the write, against its plain version alone
        wkernel = _kernel_name("kv_page_write_quant" if quant else "kv_page_write", False, kw["D"])
        same = pools_same((kp_k, vp_k), (kp_r, vp_r), skw_k, skw_r)
        untouched = all(
            _same_bytes(x[i], y[i]) for i in range(kw["L"]) if i != layer
            for x, y in [(kp_k, kp), (vp_k, vp)] + [(skw_k[k], call_kw[k]) for k in skw_k]
        )
        err = max([_pool_err(kp_k, kp_r), _pool_err(vp_k, vp_r)] + [_pool_err(skw_k[k], skw_r[k]) for k in skw_k])
        # the same launch without the write, on fresh copies
        kp_a, vp_a, skw_a = _clone_pools(args, call_kw)
        alone = prefill_attention(q, kp_a, vp_a, pt, pos, lens, kc, vc, cl, **dict(call_kw, **skw_a))
        torch.cuda.synchronize()
        kept = pools_same((kp_a, vp_a), (kp, vp), skw_a, {k: call_kw[k] for k in skw_a})
        emit({"phase": "kernels", "kernel": wkernel, "case": name, "pools_and_scales_byte_identical": same,
              "other_layers_untouched": untouched, "max_abs_err": err,
              "attention_only_pools_untouched": kept, "attention_only_same_output": _same_bytes(alone, out)})
        check(same and untouched, f"{wkernel} {name}: pools or scales differ from the plain write's, "
                                  f"or other layers changed")
        check(kept and _same_bytes(alone, out), f"prefill {name}: the launch without the write changed the pools "
                                                f"or gave other output bytes")
        worst[wkernel] = max(worst[wkernel], err)

    for name, kw in PREFILL_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        fused_launch(name, kw, kw.pop("seed", 2))

    for name, kw in WRITE_CASES:
        for dtype in ("bfloat16", "float32"):
            for quant in (False, True):
                case = dict(kw, dtype=getattr(torch, dtype), quant=quant)
                fused_launch(f"{INT8 if quant else ''}write_{name}_{dtype}", case, 3)
    return worst


def _forward_run(model, impl, ids, chunk, n_chunks, burst, quant=False):
    """``n_chunks`` prefill chunks then one decode burst of ``burst`` steps
    through model.forward with attn_impl ``impl``, into pools of the model's
    dtype or, with ``quant``, int8 pools and their scales. The burst reads
    its input tokens from ``ids`` (teacher forcing), so both implementations
    see the same tokens. Returns the logits [B, V] of every chunk and burst
    step, and the pools (and scales) after the burst's commit."""
    import dataclasses

    import torch

    from production_stack_tpu_torch import models
    from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
    from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant

    cfg = dataclasses.replace(model.cfg, attn_impl=impl, kv_cache_dtype="int8" if quant else "auto")
    model.cfg = cfg
    dev = ids.device
    B, page = ids.shape[0], 64
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    ctx = n_chunks * chunk
    maxp = -(-(ctx + burst) // page)
    kp, vp = models.module_for_config(cfg).init_kv_pages(cfg, B * maxp, page, dev)
    scales = (init_kv_scales(L, B * maxp, KH, dev), init_kv_scales(L, B * maxp, KH, dev)) if quant else None
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
    logits = []
    for c in range(n_chunks):
        pos = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        lens = torch.full((B,), (c + 1) * chunk, dtype=torch.int32, device=dev)
        lg = model(ids[:, c * chunk:(c + 1) * chunk], pos, kp, vp, pt, lens, kv_scales=scales)
        logits.append(lg)
    k_acc = torch.zeros((L, B, burst, KH, D), dtype=cfg.dtype, device=dev)
    v_acc = torch.zeros_like(k_acc)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(burst):
        pos = torch.full((B, 1), ctx + s, dtype=torch.int32, device=dev)
        lens = torch.full((B,), ctx + s + 1, dtype=torch.int32, device=dev)
        lg = model(ids[:, ctx + s][:, None], pos, kp, vp, pt, lens, kv_burst=(k_acc, v_acc, counts),
                   kv_scales=scales)
        counts = counts + 1
        logits.append(lg)
    jj = torch.arange(burst, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if quant:
        write_kv_pages_all_layers_quant(kp, vp, *scales, k_acc, v_acc, pt, ctx + jj)
    else:
        write_kv_pages_all_layers(kp, vp, k_acc, v_acc, pt, ctx + jj)
    torch.cuda.synchronize()
    return logits, (kp, vp) + (scales or ())


# the kernel forward's logits vs the plain forward's, in bf16: attention
# outputs differ by bf16 rounding (a last-bit flip after another f32
# summation order) and the layers carry it into logits of order 1, whose
# bf16 ulp is 2^-7 to 2^-5. The int8 pool runs are held to the same bound.
FORWARD_LOGIT_BOUND = 0.25
FORWARD_TOP1_MIN = 0.9
# (model, 512-token prefill chunks): llama-3.2-1b at two chunks; gemma-2-2b
# at nine (4,608 tokens), so its even layers' 4,096 window bites;
# qwen2.5-7b, loaded from its HF directory, at two (phase_hf_load)
FORWARD_RUNS = (("llama-3.2-1b", 2), ("gemma-2-2b", 9))
QWEN_FORWARD_CHUNKS = 2


def phase_forward(name: str, n_chunks: int, model=None) -> dict:
    """One model (the preset ``name``, or ``model`` as loaded) with the
    kernels and with the plain versions, first into bf16 pools, then into
    int8 pools. Layer 0's K/V come before any attention, so its int8 pages
    and scales must be byte-identical between the two int8 runs (the
    quantizing write in the prefill launch against its plain version,
    inside the model).
    Returns the launch counts of the kernel run into int8 pools (every
    count set to 0 just before it)."""
    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model

    t_load = time.perf_counter()
    if model is None:
        _, _, model = load_model(name, seed=0, device="cuda")
    cfg = model.cfg
    load_s = time.perf_counter() - t_load
    kernels, _ = _counters()
    gen = torch.Generator().manual_seed(3)
    B, chunk, burst = 2, 512, 8
    ids = torch.randint(0, cfg.vocab_size, (B, n_chunks * chunk + burst), generator=gen, dtype=torch.int32).cuda()
    launches = {}
    for quant in (False, True):
        t0 = time.perf_counter()
        with torch.no_grad():
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            lk, pools_k = _forward_run(model, "cuda", ids, chunk, n_chunks, burst, quant)
            launches = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
            lp, pools_p = _forward_run(model, "plain", ids, chunk, n_chunks, burst, quant)
        finite = all(bool(torch.isfinite(x).all()) for x in lk)
        shapes_ok = all(tuple(x.shape) == (B, cfg.vocab_size) for x in lk)
        diffs = [float((a - b).abs().max()) for a, b in zip(lk, lp)]
        top1 = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(lk, lp)) / (B * len(lk))
        pool_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(pools_k, pools_p))
        line = {
            "phase": "forward", "model": name, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "head_dim": cfg.head_dim, "dtype": "bfloat16", "kv_cache_dtype": "int8" if quant else "auto",
            "rows": B, "chunks": [chunk] * n_chunks, "burst": burst,
            "max_logit_diff_per_step": diffs, "max_logit_diff": max(diffs), "bound": FORWARD_LOGIT_BOUND,
            "top1_agreement": top1, "top1_min": FORWARD_TOP1_MIN, "logit_absmax": float(lk[0].abs().max()),
            "pool_max_abs_diff_after_commit": pool_diff, "finite": finite, "kernel_run_launches": launches,
            "seconds": round(time.perf_counter() - t0 + (0.0 if quant else load_s), 2),
        }
        if quant:
            line["layer0_pages_and_scales_byte_identical"] = all(
                _same_bytes(a[0], b[0]) for a, b in zip(pools_k, pools_p)
            )
        emit(line)
        what = f"forward[{name}{', int8' if quant else ''}]"
        check(finite and shapes_ok, f"{what}: logits not finite or of the wrong shape")
        check(max(diffs) <= FORWARD_LOGIT_BOUND, f"{what}: logit diff {max(diffs)} > {FORWARD_LOGIT_BOUND}")
        check(top1 >= FORWARD_TOP1_MIN, f"{what}: top-1 agreement {top1} < {FORWARD_TOP1_MIN}")
        for k in SERVE_ROWS[quant]:
            check(launches[k] > 0, f"{what}: kernel {k} was not launched")
        if quant:
            check(line["layer0_pages_and_scales_byte_identical"],
                  f"{what}: layer 0's int8 pages or scales differ between the kernel and plain runs")
    del model
    torch.cuda.empty_cache()
    return launches


# each kernel row's launch counter, as (wrapper, attribute): the int8 modes
# of the two attention kernels count apart from their fp modes, and the
# write rows count the prefill launches that also wrote the chunk
def _counters():
    from production_stack_tpu_torch.ops.kernels import decode_attention as dmod
    from production_stack_tpu_torch.ops.kernels import prefill_attention as pmod

    kernels = {
        "decode_attention": (dmod.decode_attention, "launches"),
        "prefill_attention": (pmod.prefill_attention, "launches"),
        "kv_page_write": (pmod.prefill_attention, "launches_write"),
        "decode_attention[int8]": (dmod.decode_attention, "launches_int8"),
        "prefill_attention[int8]": (pmod.prefill_attention, "launches_int8"),
        "kv_page_write_quant": (pmod.prefill_attention, "launches_write_int8"),
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


async def _serve_requests(port: int, metric_series: tuple = (), long_prompt: int = 0,
                          repeat_logprobs: bool = False) -> dict:
    """The serve phase's requests. ``long_prompt`` > 0 makes the first
    concurrent completion's prompt that many bytes long; with
    ``repeat_logprobs`` the greedy repeat also asks for its tokens' logprobs
    and must repeat them exactly (a model whose tokens mostly lie outside
    the byte tokenizer's 256 byte values decodes to little text)."""
    import random

    import aiohttp

    rng = random.Random(5)
    base = f"http://127.0.0.1:{port}"
    max_tokens = 32
    # 575 bytes + BOS = 576 tokens = 9 pages: the repeat hits 8 cached pages
    # and recomputes the last 64 tokens, in the same chunk shape as the first
    # run's second chunk, so greedy output must repeat bit for bit
    repeat = {"prompt": _prompt(rng, 575), "max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True}
    if repeat_logprobs:
        repeat["logprobs"] = 1
    prompts = [_prompt(rng, 590 + 7 * i) for i in range(4)]
    if long_prompt:
        prompts[0] = _prompt(rng, long_prompt)
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
        if repeat_logprobs:
            lps = [r["choices"][0]["logprobs"]["token_logprobs"] for r in (first, second)]
            check(len(lps[0]) == max_tokens, f"serve: the repeat returned {len(lps[0])} logprobs")
            same = same and lps[0] == lps[1]
            out["repeat_token_logprobs_head"] = lps[0][:4]
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
        out["prompt_tokens"] = [body["usage"]["prompt_tokens"] for _, body in results]
    return out


# The int8 server: int8 pools and the CPU offload tier, with a pool of 40
# pages (2,560 tokens) that the concurrent requests (~46 pages) overrun, so
# the repeat request's prefix pages are evicted to the tier between its two
# runs and restored from it for the second.
INT8_SERVE = dict(kv_cache_dtype="int8", kv_offload_cpu_gb=1.0, num_pages=40)
QUANT_METRICS = ("vllm:kv_cache_dtype_bytes_per_token", "vllm:kv_quant_pages", "vllm:kv_quant_dequant_err_max")
OFFLOAD_METRICS = (
    "vllm:kv_offload_saved_pages_total", "vllm:kv_offload_loaded_pages_total", "vllm:kv_offload_hit_pages_total",
    "vllm:kv_offload_max_io_pages", "vllm:kv_offload_link_bandwidth_bytes_per_sec",
)
SERVE_ROWS = {
    False: ("decode_attention", "prefill_attention", "kv_page_write"),
    True: ("decode_attention[int8]", "prefill_attention[int8]", "kv_page_write_quant"),
}


# gemma-2-2b's server: bf16 pools, a context of 8,192 so one concurrent
# prompt can run past the sliding window (4,300 bytes: nine prefill chunks)
GEMMA_SERVE = dict(max_model_len=8192)
GEMMA_LONG_PROMPT = 4300


def phase_serve(label: str, overrides: dict) -> dict:
    """The port's OpenAI server in-process on ``EngineConfig(**overrides)``
    (a preset or an HF directory as ``model``; int8 pools, the CPU offload
    tier, a longer context as the run asks): the requests of
    ``_serve_requests``, gemma-2-2b's with one prompt past its 4,096 window,
    and the greedy repeat held to its token logprobs too except for llama
    (whose byte tokens decode to text). Returns the launch counts of the
    run."""
    import socket

    import torch

    from production_stack_tpu_torch.engine.api_server import serve
    from production_stack_tpu_torch.engine.config import EngineConfig

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    quant = overrides.get("kv_cache_dtype") == "int8"
    offload = "kv_offload_cpu_gb" in overrides
    gemma = label.startswith("gemma")
    cfg = EngineConfig(host="127.0.0.1", port=port, **overrides)
    kernels, plains = _counters()
    series = (QUANT_METRICS if quant else ()) + (OFFLOAD_METRICS if offload else ())

    async def run():
        server, runner = await serve(cfg)
        try:
            # every count to 0 right before the main path, read right after
            for fn, attr in kernels.values():
                setattr(fn, attr, 0)
            for fn in plains.values():
                fn.calls = 0
            t0 = time.perf_counter()
            res = await _serve_requests(port, series, GEMMA_LONG_PROMPT if gemma else 0,
                                        repeat_logprobs=not label.startswith("llama"))
            res["seconds"] = round(time.perf_counter() - t0, 3)
            res["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
            res["plain_calls"] = {k: fn.calls for k, fn in plains.items()}
            keep = ["prompt_tokens_total", "generation_tokens_total", "decode_dispatches_total",
                    "gpu_prefix_cache_hits_total", "kv_evicted_pages_total", "num_pages"]
            if quant:
                keep += ["cache_dtype", "kv_cache_dtype_bytes_per_token", "kv_quant_pages",
                         "kv_quant_dequant_err_max"]
            if offload:
                keep += ["kv_offload_saved_pages_total", "kv_offload_loaded_pages_total",
                         "kv_offload_hit_pages_total", "kv_proactive_spilled_pages_total", "kv_offload_cpu_bytes",
                         "kv_corrupt_pages_total", "kv_offload_max_io_pages",
                         "kv_offload_link_bandwidth_bytes_per_sec"]
            stats = server.engine.stats()
            res["engine"] = {k: stats[k] for k in keep if k in stats}
            res["served_name"] = server.cfg.name
            return res
        finally:
            await runner.cleanup()
            server.engine.stop()

    t0 = time.perf_counter()
    res = asyncio.run(run())
    res["seconds_with_startup"] = round(time.perf_counter() - t0, 2)
    what = f"serve[{label}]"
    emit({"phase": "serve", "model": label, "kv_cache_dtype": cfg.kv_cache_dtype, "config": overrides, **res})
    if gemma:
        check(max(res["prompt_tokens"]) > GEMMA_WINDOW, f"{what}: no prompt ran past the sliding window")
    for k in SERVE_ROWS[quant]:
        check(res["launches"][k] > 0, f"{what}: kernel {k} was not launched on the main path")
    for k in SERVE_ROWS[not quant]:  # an int8 pool never reaches an fp mode, nor the other way round
        check(res["launches"][k] == 0, f"{what}: kernel {k} ran {res['launches'][k]} times on the main path")
    for k, n in res["plain_calls"].items():
        check(n == 0, f"{what}: plain version {k} ran {n} times on the main path")
    check(res["repeat_cached_tokens"] >= 512, f"{what}: the repeat reused {res['repeat_cached_tokens']} tokens")
    if offload:
        e = res["engine"]
        check(e["kv_offload_saved_pages_total"] > 0, f"{what}: no page was saved to the CPU tier")
        check(e["kv_offload_loaded_pages_total"] > 0 and e["kv_offload_hit_pages_total"] > 0,
              f"{what}: no page was restored from the CPU tier")
        check(e["kv_corrupt_pages_total"] == 0, f"{what}: the CPU tier held corrupt pages")
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
# gemma-2-2b at one row of 8,192: a sliding layer (4,096 keys visible) and
# a global one
GEMMA_WINDOW_DECODE = (GEMMA_DECODE_B1_8K_SLIDING, GEMMA_DECODE_B1_8K_GLOBAL)


def _decode_timing(case_name: str, quant: bool) -> dict:
    """The decode kernel, its plain version and SDPA on one decode case's
    inputs (int8 pools and scales for ``quant``), beside the byte bound.
    The bound and the yardstick read only the keys the window leaves
    visible."""
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_ref
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    case = dict(dict(DECODE_CASES)[case_name], dtype=bf16, quant=quant)
    B, NH, KH, D, page, maxp = (case[k] for k in ("B", "NH", "KH", "D", "page", "maxp"))
    lens, C, cur = case["lens"], case["C"], case["cur_lens"]
    window = case.get("window") or (1 << 30)
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
    lo = max(ctx - window, 0)  # first visible position
    k_all = torch.cat([kg[:, lo: ctx - C], kw["k_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    v_all = torch.cat([vg[:, lo: ctx - C], kw["v_cur"]], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    lib = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all, scale=kw["sm_scale"]))
    el = 2
    # visible pool slots [max(n - window, 0), n - c) per row, over all rows
    hist = sum(max(0, (n - c) - max(n - window, 0)) for n, c in zip(lens, cur))
    kv_el = 1 if quant else el
    pages = sum(-(-(n - c) // page) - max(n - window, 0) // page for n, c in zip(lens, cur))
    nbytes = (2 * B * NH * D * el + 2 * hist * KH * D * kv_el + (2 * pages * KH * 4 if quant else 0)
              + 2 * sum(cur) * KH * D * el + pt.numel() * 4 + 2 * B * 4)
    b_ms, b_by = _bound(nbytes, 4 * NH * D * (hist + sum(cur)))
    pool = "int8 pool, bf16 q/window" if quant else "bf16"
    extra = "" if case.get("window") is None else f" window={case['window']}"
    extra += "" if case.get("softcap") is None else f" softcap={case['softcap']} sm_scale={kw['sm_scale']:.6g}"
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=f"B={B} ctx={ctx} C={C} NH={NH} KH={KH} D={D} page={page}{extra} {pool}",
                library="scaled_dot_product_attention over the visible gathered KV, heads repeated"
                        + (", no softcap" if case.get("softcap") else "")
                        + (" (KV dequantized to bf16 beforehand, not timed)" if quant else ""))


def _prefill_timing(case_name: str, quant: bool) -> tuple[dict, dict]:
    """The prefill kernel, its plain version and SDPA with a causal-offset
    (and window) mask on one prefill case, beside the bound; the same launch
    with the chunk's write is timed in the same process. Returns the row and
    what the write row needs: the case's inputs, the launch's times with and
    without the write, and the attention's bytes and operations."""
    import torch
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.attention import gather_kv_pages
    from production_stack_tpu_torch.ops.kernels.prefill_attention import prefill_attention, prefill_attention_ref
    from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant

    bf16 = torch.bfloat16
    case = dict(dict(PREFILL_CASES)[case_name], dtype=bf16, quant=quant)
    NH, KH, D, page, T = (case[k] for k in ("NH", "KH", "D", "page", "T"))
    hist = case["computed"][0]
    window = case.get("window") or (1 << 30)
    G = NH // KH
    args, kw = prefill_case(case.pop("seed"), **case)
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    ms = _time_ms(lambda: prefill_attention(*args, **kw))
    # the chunk's write rewrites the same bytes each call (fresh pages only)
    fused = _time_ms(lambda: prefill_attention(*args, fused_write=True, **kw))
    plain = _time_ms(lambda: prefill_attention_ref(*args, **kw))
    if quant:
        kg, vg = gather_kv_pages_quant(kp[0], vp[0], kw["k_scales"][0], kw["v_scales"][0], pt, dtype=bf16)
    else:
        kg, vg = gather_kv_pages(kp[0], vp[0], pt)
    kk = torch.cat([kg[:, :hist], kc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = torch.cat([vg[:, :hist], vc], 1).transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    kpos = torch.arange(hist + T, device="cuda")[None, :]
    qpos = hist + torch.arange(T, device="cuda")[:, None]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    lib = _time_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=kw["sm_scale"]))
    el = 2
    pairs = sum(min(hist + t + 1, window) for t in range(T))  # visible (query, key) pairs per head
    h_vis = hist - max(hist - window + 1, 0)  # history slots any query sees
    kv_bytes = 2 * h_vis * KH * D + 2 * (h_vis // page) * KH * 4 if quant else 2 * h_vis * KH * D * el
    nbytes = 2 * T * NH * D * el + kv_bytes + 2 * T * KH * D * el + pt.numel() * 4 + T * 4 + 8
    flops = 4 * NH * D * pairs
    b_ms, b_by = _bound(nbytes, flops)
    extra = "" if case.get("window") is None else f" window={case['window']}"
    extra += "" if case.get("softcap") is None else f" softcap={case['softcap']} sm_scale={kw['sm_scale']:.6g}"
    pool = "int8 history, bf16 q/chunk" if quant else "bf16"
    row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
               shape=f"B=1 T={T} history={hist} NH={NH} KH={KH} D={D} page={page}{extra} {pool}",
               library=("scaled_dot_product_attention over history dequantized to bf16 beforehand (dequant not "
                        "timed), causal-offset mask" if quant else
                        "scaled_dot_product_attention with a causal-offset mask")
                       + (", no softcap" if case.get("softcap") else ""),
               ms_is="the launch without the chunk's write (fused_write=False)")
    return row, dict(args=args, kw=kw, attention_ms=ms, fused_ms=fused, nbytes=nbytes, flops=flops)


def _write_timing(p: dict, quant: bool) -> dict:
    """The chunk's KV write (fp: into the slots after the history; int8:
    quantized into its fresh pages) as it runs now, inside the prefill
    launch: its time is the launch's with the write less the launch's
    without, beside the write's own byte bound; the whole launch's time
    beside its bound (the attention's, with the pools' written bytes
    added). Also the write's plain version and, for fp, the index_copy_
    yardstick."""
    from production_stack_tpu_torch.ops.kernels.prefill_attention import kv_page_write_quant_ref, kv_page_write_ref

    args, kw = p["args"], p["kw"]
    q, kp, vp, pt, pos, lens, kc, vc, cl = args
    _, T, KH, D = kc.shape
    page = kp.shape[2]
    el = 2
    if quant:
        skw = dict(k_scales=kw["k_scales"], v_scales=kw["v_scales"])
        plain = _time_ms(lambda: kv_page_write_quant_ref(kc, vc, lens, cl, pt, kp, vp, layer=0, **skw))
        lib = None
        n_pages = T // page
        written = 2 * n_pages * page * KH * D + 2 * n_pages * KH * 4
        read = 2 * T * KH * D * el + 8 + pt.numel() * 4
        shape = f"T={T} into {n_pages} fresh pages, KH={KH} D={D} page={page} bf16 -> int8"
        library = "none: no single PyTorch call quantizes per page and scatters"
    else:
        plain = _time_ms(lambda: kv_page_write_ref(kc, vc, pos, cl, pt, kp, vp, layer=0))
        p0 = pos[0].long()
        slots = pt[0, p0 // page].long() * page + p0 % page
        kflat, vflat = kp[0].view(-1, KH, D), vp[0].view(-1, KH, D)
        lib = _time_ms(lambda: (kflat.index_copy_(0, slots, kc[0]), vflat.index_copy_(0, slots, vc[0])))
        written = 2 * T * KH * D * el
        read = 2 * T * KH * D * el + T * 4 + pt.numel() * 4
        shape = f"T={T} KH={KH} D={D} page={page} bf16"
        library = "index_copy_ into the flat pool, K and V"
    b_ms, b_by = _bound(read + written, 0.0)
    f_ms, f_by = _bound(p["nbytes"] + written, p["flops"])
    return dict(ms=p["fused_ms"] - p["attention_ms"], plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                ms_is="fused_ms - attention_ms: the launch with the chunk's write less the launch without",
                attention_ms=p["attention_ms"], fused_ms=p["fused_ms"], fused_bound_ms=f_ms, fused_bound_by=f_by,
                shape=shape, library=library)


def phase_timing() -> dict:
    """Every kernel row at its model's main-path shapes: llama-3.2-1b's
    (D = 64), qwen2.5-7b's ("[d128]") and gemma-2-2b's ("[d256]"), fp and
    int8 pools; then the decode kernel at small batch, qwen2.5-7b's and
    gemma-2-2b's 1 x 8,192 (a sliding and a global layer), and opt-125m's
    decode and prefill (bf16, its only pool dtype), as rows of their own."""
    rows = {}
    for D, dec, pre in ((64, MAIN_DECODE, MAIN_PREFILL), (128, QWEN_DECODE, QWEN_PREFILL),
                        (256, GEMMA_DECODE, GEMMA_PREFILL)):
        for quant in (False, True):
            rows[_kernel_name("decode_attention", quant, D)] = _decode_timing(dec, quant)
            row, fused = _prefill_timing(INT8 + pre if quant else pre, quant)
            rows[_kernel_name("prefill_attention", quant, D)] = row
            rows[_dtag("kv_page_write_quant" if quant else "kv_page_write", D)] = _write_timing(fused, quant)
    for name, r in rows.items():
        emit({"phase": "timing", "kernel": name, **r})
    for case in SMALL_BATCH_DECODE + (QWEN_DECODE_B1_8K,) + GEMMA_WINDOW_DECODE:
        for quant in (False, True):
            D = dict(DECODE_CASES)[case]["D"]
            emit({"phase": "timing", "kernel": _kernel_name("decode_attention", quant, D), "case": case,
                  **_decode_timing(case, quant)})
    emit({"phase": "timing", "kernel": "decode_attention", "case": OPT_DECODE, **_decode_timing(OPT_DECODE, False)})
    emit({"phase": "timing", "kernel": "prefill_attention", "case": OPT_PREFILL,
          **_prefill_timing(OPT_PREFILL, False)[0]})
    return rows


# ---------------------------------------------------------------------------
# HF checkpoints: written from a seed as HF lays them out, then loaded and
# served through the port's loader


HF_ROOT = ROOT / "build" / "hf_models"
QWEN_DIR = HF_ROOT / "qwen2.5-7b"
OPT_DIR = HF_ROOT / "opt-125m"
HF_SHARD_BYTES = 5 * 10**9  # save_pretrained's default max_shard_size
# Qwen/Qwen2.5-7B's config.json as published
QWEN_HF_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 3584, "initializer_range": 0.02,
    "intermediate_size": 18944, "max_position_embeddings": 131072, "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 28, "num_hidden_layers": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 131072, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_mrope": False, "use_sliding_window": False, "vocab_size": 152064,
}
# facebook/opt-125m's config.json as published (its weights are float16)
OPT_HF_CONFIG = {
    "activation_dropout": 0.0, "activation_function": "relu", "architectures": ["OPTForCausalLM"],
    "attention_dropout": 0.0, "bos_token_id": 2, "do_layer_norm_before": True, "dropout": 0.1, "eos_token_id": 2,
    "ffn_dim": 3072, "hidden_size": 768, "init_std": 0.02, "layerdrop": 0.0, "max_position_embeddings": 2048,
    "model_type": "opt", "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1, "prefix": "</s>",
    "torch_dtype": "float16", "use_cache": True, "vocab_size": 50272, "word_embed_proj_dim": 768,
}
# the sampled parameters held byte-identical to what was written:
# (port name, HF name, transposed); layer 13 of 28
_L = "model.layers.13."
QWEN_SAMPLES = (
    ("embed", "model.embed_tokens.weight", False),
    ("layers.13.wq", _L + "self_attn.q_proj.weight", True),
    ("layers.13.bq", _L + "self_attn.q_proj.bias", False),
    ("layers.13.wk", _L + "self_attn.k_proj.weight", True),
    ("layers.13.w_down", _L + "mlp.down_proj.weight", True),
    ("lm_head", "lm_head.weight", True),
)


def _qwen2_hf_specs(c: dict, dtype) -> dict:
    """HF's Qwen2ForCausalLM tensors, {name: (shape, dtype)}, matrices [out, in]."""
    H, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    NH, KH = c["num_attention_heads"], c["num_key_value_heads"]
    q, kv = NH * (H // NH), KH * (H // NH)
    specs = {"model.embed_tokens.weight": (V, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs.update({
            p + "input_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (q, H), p + "self_attn.q_proj.bias": (q,),
            p + "self_attn.k_proj.weight": (kv, H), p + "self_attn.k_proj.bias": (kv,),
            p + "self_attn.v_proj.weight": (kv, H), p + "self_attn.v_proj.bias": (kv,),
            p + "self_attn.o_proj.weight": (H, q),
            p + "post_attention_layernorm.weight": (H,),
            p + "mlp.gate_proj.weight": (I, H), p + "mlp.up_proj.weight": (I, H), p + "mlp.down_proj.weight": (H, I),
        })
    specs.update({"model.norm.weight": (H,), "lm_head.weight": (V, H)})
    return {k: (v, dtype) for k, v in specs.items()}


def _opt_hf_specs(c: dict, dtype) -> dict:
    """HF's OPTForCausalLM tensors (the head is tied: no lm_head)."""
    H, I = c["hidden_size"], c["ffn_dim"]
    specs = {"model.decoder.embed_tokens.weight": (c["vocab_size"], H),
             "model.decoder.embed_positions.weight": (c["max_position_embeddings"] + 2, H)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.decoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            specs.update({p + f"self_attn.{proj}.weight": (H, H), p + f"self_attn.{proj}.bias": (H,)})
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            specs.update({p + f"{norm}.weight": (H,), p + f"{norm}.bias": (H,)})
        specs.update({p + "fc1.weight": (I, H), p + "fc1.bias": (I,), p + "fc2.weight": (H, I), p + "fc2.bias": (H,)})
    specs.update({"model.decoder.final_layer_norm.weight": (H,), "model.decoder.final_layer_norm.bias": (H,)})
    return {k: (v, dtype) for k, v in specs.items()}


def _hf_value(name: str, shape, dtype, seed: int, device="cuda"):
    """A tensor of the checkpoint at init_params' scales, drawn on the card
    from a seed and the tensor's name: norm weights 1, matrices (and
    embeddings) N(0, 1/in) of HF's [out, in]; biases N(0, 0.02^2), not 0,
    so the byte check of a bias reads real values."""
    import zlib

    import torch

    if len(shape) == 1 and "norm" in name and name.endswith("weight"):
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + zlib.crc32(name.encode()))
    scale = 0.02 if len(shape) == 1 else shape[1] ** -0.5
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(scale).to(dtype)


def phase_hf_write(path: Path, config: dict, specs: dict, seed: int = 0) -> dict:
    """Write an HF directory: config.json and the seeded tensors in shards of
    at most 5 GB with HF's index. Fails, with the free bytes it found, when
    the disk cannot hold it."""
    from production_stack_tpu_torch.utils.safetensors_io import save_sharded

    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in specs.values())
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    free = shutil.disk_usage(path).free
    check(free > nbytes + (1 << 30), f"hf_write[{path.name}]: {nbytes} bytes to write, {free} bytes free at {path}")
    t0 = time.perf_counter()
    (path / "config.json").write_text(json.dumps(config, indent=2))
    files = save_sharded(str(path), specs, lambda n: _hf_value(n, specs[n][0], specs[n][1], seed), HF_SHARD_BYTES)
    secs = time.perf_counter() - t0
    line = {"phase": "hf_write", "model": path.name, "tensors": len(specs), "bytes": nbytes, "files": files,
            "free_bytes_before": free, "seconds": round(secs, 2), "gb_per_s": round(nbytes / secs / 1e9, 3)}
    emit(line)
    return line


def phase_hf_qwen(seed: int = 0) -> None:
    """qwen2.5-7b at full width and depth: its HF directory written (bf16,
    sharded), loaded through the port's loader, its config held to the
    port's preset, sampled parameters held byte-identical to the tensors
    written (transposes included), then its kernel forward against its
    plain forward (phase_forward), bf16 and int8 pools."""
    import dataclasses

    import torch

    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.models import llama

    specs = _qwen2_hf_specs(QWEN_HF_CONFIG, torch.bfloat16)
    written = phase_hf_write(QWEN_DIR, QWEN_HF_CONFIG, specs, seed)
    t0 = time.perf_counter()
    mod, cfg, net = load_model(str(QWEN_DIR), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    preset = dataclasses.replace(llama.PRESETS["qwen2.5-7b"], max_model_len=cfg.max_model_len)
    own = dict(net.named_parameters())
    same = {}
    for pname, hf, transpose in QWEN_SAMPLES:
        want = _hf_value(hf, *specs[hf], seed)
        same[pname] = _same_bytes(own[pname], (want.t() if transpose else want).contiguous())
    emit({"phase": "hf_load", "model": "qwen2.5-7b", "module": mod.__name__, "seconds": round(load_s, 2),
          "gb_per_s": round(written["bytes"] / load_s / 1e9, 3), "config_equals_preset": cfg == preset,
          "max_model_len": cfg.max_model_len, "parameters": sum(p.numel() for p in own.values()),
          "samples_byte_identical": same})
    check(mod is llama and cfg == preset, f"hf_load[qwen2.5-7b]: config {cfg} differs from the preset {preset}")
    check(all(same.values()), f"hf_load[qwen2.5-7b]: parameters differ from the tensors written: {same}")
    phase_forward("qwen2.5-7b-hf", QWEN_FORWARD_CHUNKS, model=net)


def phase_opt_int8_refused() -> None:
    """An OPT engine with int8 pools is refused (the JAX OPT forward reads no
    pool scales)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    try:
        LLMEngine(EngineConfig(model=str(OPT_DIR), kv_cache_dtype="int8", max_model_len=2048))
    except ValueError as e:
        emit({"phase": "refusal", "model": "opt-125m-hf", "kv_cache_dtype": "int8", "refused": str(e)})
        check("does not support kv_cache_dtype=int8" in str(e), f"refusal[opt int8]: refused for another reason: {e}")
        return
    fail("refusal[opt int8]: an OPT engine with int8 pools started")


# (label, EngineConfig overrides, head_dim of the kernel rows whose launches it
# gives): each kernel row's launches come from its own servers' runs
SERVE_RUNS = (
    ("llama-3.2-1b", dict(model="llama-3.2-1b"), 64),
    ("llama-3.2-1b, int8", dict(model="llama-3.2-1b", **INT8_SERVE), 64),
    ("gemma-2-2b", dict(model="gemma-2-2b", **GEMMA_SERVE), 256),
    ("qwen2.5-7b-hf", dict(model=str(QWEN_DIR)), 128),
    ("qwen2.5-7b-hf, int8", dict(model=str(QWEN_DIR), kv_cache_dtype="int8"), 128),
    # OPT's position table holds 2,048: the engine's default 4,096 is refused
    ("opt-125m-hf", dict(model=str(OPT_DIR), max_model_len=2048), 64),
)


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
    launches = {}
    for name, n_chunks in FORWARD_RUNS:
        counts = phase_forward(name, n_chunks)
        if name.startswith("gemma"):  # gemma-2-2b's int8 rows: the launches of its int8 kernel forward
            launches.update({_dtag(k, 256): counts[k] for k in SERVE_ROWS[True]})
    try:
        phase_hf_qwen()
        phase_hf_write(OPT_DIR, OPT_HF_CONFIG, _opt_hf_specs(OPT_HF_CONFIG, torch.float16))
        for label, overrides, D in SERVE_RUNS:
            counts = phase_serve(label, overrides)
            quant = overrides.get("kv_cache_dtype") == "int8"
            for k in SERVE_ROWS[quant]:
                launches[_dtag(k, D)] = launches.get(_dtag(k, D), 0) + counts[k]
        phase_opt_int8_refused()
    finally:
        shutil.rmtree(HF_ROOT, ignore_errors=True)  # 15 GB of shards
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
