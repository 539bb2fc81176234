"""Ragged paged decode attention: the CUDA kernel (csrc/decode_attention.cu)
and its plain PyTorch version.

``decode_attention`` launches the kernel for CUDA tensors and runs
``decode_attention_ref`` for CPU tensors; there is no fallback between the
two. Counterpart of ``ragged_paged_attention_decode`` in the JAX package
(production_stack_tpu/ops/pallas/paged_attention.py), same arguments and
layouts: fp pools (bf16/f32, as q), or int8 pools with ``k_scales/v_scales``
[L, P, KH] f32 (ops/quant.py), which the kernel applies in f32 as it folds
each slot; the burst window stays fp. The wrapper counts fp launches in
``decode_attention.launches`` and int8 ones in ``launches_int8``.

The kernel splits each row's live context over ``split_plan(...)`` blocks
per (KV head, row) and merges their partial softmax states in a second
kernel; the plan depends on the bucket's shapes and the pool's dtype only,
never on ``seq_lens``, so it reads no device value on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from production_stack_tpu_torch.ops.attention import paged_attention_decode
from production_stack_tpu_torch.ops.kernels import HEAD_DIMS, MAX_GROUP, _build
from production_stack_tpu_torch.ops.quant import dequant

NO_WINDOW = 1 << 30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False

# blocks the split plan aims at: about two resident blocks on each of the
# H100's 132 SMs
TARGET_BLOCKS = 2 * 132


class SplitPlan(NamedTuple):
    splits: int  # blocks per (KV head, row), each taking a contiguous share of the row
    tile: int  # pool slots per staged tile; a split's share is whole tiles


def split_plan(B: int, KH: int, max_pages: int, page_size: int, head_dim: int, quant: bool) -> SplitPlan:
    """The decode kernel's launch plan for a bucket: tiles of 128 slots for
    pool rows of at most 64 bytes (int8 at D = 64), else 64 (csrc
    DecodeSmem / the tensor-core tiles); as many splits as bring B * KH
    blocks to about TARGET_BLOCKS, and no more than the bucket's capacity
    max_pages * page_size has tiles, so no split is under one tile."""
    tile = 128 if head_dim * (1 if quant else 2) <= 64 else 64
    cap_tiles = -(-(max_pages * page_size) // tile)
    return SplitPlan(max(1, min(TARGET_BLOCKS // max(B * KH, 1), cap_tiles)), tile)


def stack_pools(k_pages, v_pages, layer, k_scales=None, v_scales=None):
    """One layer's pools ([P, page, KH, D], scales [P, KH]) as a one-layer
    stack; returns (k_pages, v_pages, layer, k_scales, v_scales)."""
    if k_pages.dim() == 4:
        k_pages, v_pages, layer = k_pages[None], v_pages[None], 0
        if k_scales is not None and k_scales.dim() == 2:
            k_scales, v_scales = k_scales[None], v_scales[None]
    return k_pages, v_pages, int(layer or 0), k_scales, v_scales


def check_pool_mode(k_pages, v_pages, k_scales, v_scales) -> bool:
    """True for int8 pools with their scales, False for fp pools; raises on
    a mix (int8 pages without scales read as garbage, silently)."""
    quant = k_pages.dtype == torch.int8
    if quant != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise TypeError("int8 KV pools and k_scales/v_scales come together")
    if quant and (v_pages.dtype != torch.int8 or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError("int8 pools take float32 k_scales/v_scales")
    return quant


def _normalize(k_pages, v_pages, k_cur, v_cur, layer, k_scales=None, v_scales=None):
    k_pages, v_pages, layer, k_scales, v_scales = stack_pools(k_pages, v_pages, layer, k_scales, v_scales)
    if k_cur is not None and k_cur.dim() == 3:  # [B, KH, D] -> C = 1
        k_cur, v_cur = k_cur[:, None], v_cur[:, None]
    return k_pages, v_pages, k_cur, v_cur, layer, k_scales, v_scales


def decode_attention_ref(
    q, k_pages, v_pages, page_table, seq_lens, window=None, *,
    sm_scale=None, logit_softcap=None, k_cur=None, v_cur=None, cur_lens=None,
    layer=None, k_scales=None, v_scales=None,
):
    """Plain version: gather the layer's pages (int8 pages dequantized in
    f32 by their scales), then masked f32 softmax attention
    (ops/attention.paged_attention_decode)."""
    decode_attention_ref.calls += 1
    check_pool_mode(k_pages, v_pages, k_scales, v_scales)
    k_pages, v_pages, k_cur, v_cur, layer, k_scales, v_scales = _normalize(
        k_pages, v_pages, k_cur, v_cur, layer, k_scales, v_scales
    )
    kp, vp = k_pages[layer], v_pages[layer]
    if k_scales is not None:
        # the row's pages, dequantized, as a pool read through an identity table
        B, maxp = page_table.shape
        pt = page_table.long()
        kp = dequant(kp[pt], k_scales[layer][pt]).flatten(0, 1)
        vp = dequant(vp[pt], v_scales[layer][pt]).flatten(0, 1)
        page_table = torch.arange(B * maxp, dtype=torch.int32, device=q.device).view(B, maxp)
    return paged_attention_decode(
        q, kp, vp, page_table, seq_lens,
        sm_scale=sm_scale, window=window, logit_softcap=logit_softcap,
        k_cur=k_cur, v_cur=v_cur, cur_lens=cur_lens,
    )


def _lib():
    global _bound
    lib = _build.load("decode_attention")
    if not _bound:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_launch.argtypes = [
            I, I, I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, I, P, P,
        ]
        lib.decode_attention_launch.restype = I
        _bound = True
    return lib


def decode_attention(
    q, k_pages, v_pages, page_table, seq_lens, window=None, *,
    sm_scale=None, logit_softcap=None, k_cur=None, v_cur=None, cur_lens=None,
    layer=None, k_scales=None, v_scales=None,
):
    """Decode attention of q [B, NH, D] over paged KV; returns [B, NH, D].

    Pools [L, P, page, KH, D] with ``layer``, or one layer's [P, page, KH,
    D]; int8 pools take ``k_scales/v_scales`` ([L, P, KH] or [P, KH] f32).
    With ``k_cur/v_cur`` ([B, C, KH, D], or [B, KH, D] for C = 1, in q's
    dtype) pool slots at positions >= seq_lens - cur_lens are stale and
    window entry j holds position seq_lens - cur_lens + j. Rows with seq_len
    0 give 0.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(
            q, k_pages, v_pages, page_table, seq_lens, window,
            sm_scale=sm_scale, logit_softcap=logit_softcap,
            k_cur=k_cur, v_cur=v_cur, cur_lens=cur_lens, layer=layer,
            k_scales=k_scales, v_scales=v_scales,
        )
    quant = check_pool_mode(k_pages, v_pages, k_scales, v_scales)
    k_pages, v_pages, k_cur, v_cur, layer, k_scales, v_scales = _normalize(
        k_pages, v_pages, k_cur, v_cur, layer, k_scales, v_scales
    )
    B, NH, D = q.shape
    L, P, page_size, KH, Dk = k_pages.shape
    max_pages = page_table.shape[1]
    if q.dtype not in _DTYPES or (not quant and (k_pages.dtype != q.dtype or v_pages.dtype != q.dtype)):
        raise TypeError(f"decode kernel takes f32/bf16 q and pools of q's dtype or int8, got {q.dtype}/{k_pages.dtype}")
    if D not in HEAD_DIMS or Dk != D or NH % KH or (NH // KH) > MAX_GROUP:
        raise ValueError(
            f"decode kernel takes D in {HEAD_DIMS} and 1..{MAX_GROUP} query heads per KV head; got D={D}, NH={NH}, KH={KH}"
        )
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} stacked layers")
    if quant and (k_scales.shape != (L, P, KH) or v_scales.shape != k_scales.shape):
        raise ValueError(f"k_scales/v_scales must be [L, P, KH] = {(L, P, KH)}")
    C = 0
    if k_cur is not None:
        C = k_cur.shape[1]
        if k_cur.shape != (B, C, KH, D) or v_cur.shape != k_cur.shape or k_cur.dtype != q.dtype or v_cur.dtype != q.dtype:
            raise ValueError("k_cur/v_cur must be [B, C, KH, D] in q.dtype")
        if cur_lens is None:
            cur_lens = torch.ones((B,), dtype=torch.int32, device=q.device)
    tensors = [q, k_pages, v_pages, page_table, seq_lens]
    if C:
        tensors += [k_cur, v_cur, cur_lens]
    for t in tensors + ([k_scales, v_scales] if quant else []):
        if t.device != q.device:
            raise ValueError("decode kernel inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("decode kernel inputs must be contiguous")
    for t in tensors[3:5] + tensors[7:]:
        if t.dtype != torch.int32:
            raise TypeError("page_table, seq_lens and cur_lens must be int32")
    if page_table.shape[0] != B or seq_lens.shape != (B,) or (C and cur_lens.shape != (B,)):
        raise ValueError("page_table/seq_lens/cur_lens batch dim must match q")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages) + ((k_cur, v_cur) if C else ())):
        raise ValueError("decode kernel needs 16-byte aligned q, pools and windows")
    out = torch.empty_like(q)
    splits = split_plan(B, KH, max_pages, page_size, D, quant).splits
    # each split's (acc[D], m, l) in f32, merged by the second kernel
    partials = torch.empty((B * NH * splits * (D + 2),), dtype=torch.float32, device=q.device) if splits > 1 else None
    err = _lib().decode_attention_launch(
        _DTYPES[q.dtype], int(quant), D, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        k_cur.data_ptr() if C else None, v_cur.data_ptr() if C else None,
        page_table.data_ptr(), seq_lens.data_ptr(), cur_lens.data_ptr() if C else None,
        out.data_ptr(), B, NH, KH, P, page_size, max_pages, layer, C,
        NO_WINDOW if window is None else int(window),
        float(sm_scale if sm_scale is not None else D**-0.5),
        float(logit_softcap or 0.0),
        splits, partials.data_ptr() if splits > 1 else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    if quant:
        decode_attention.launches_int8 += 1
    else:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.launches_int8 = 0
decode_attention_ref.calls = 0
