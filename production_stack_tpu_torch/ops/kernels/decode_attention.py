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
# H100's 132 SMs, or one where a block's ring fills an SM's shared memory
# (fp pools at D = 256: the tensor-core fold's 3-stage ring takes 202 KB)
SMS = 132
TARGET_BLOCKS = 2 * SMS


class SplitPlan(NamedTuple):
    splits: int  # blocks per (KV head, row), each taking a contiguous share of the row
    tile: int  # pool slots per staged tile; a split's share is whole tiles


def split_plan(B: int, KH: int, max_pages: int, page_size: int, head_dim: int, quant: bool) -> SplitPlan:
    """The decode kernel's launch plan for a bucket: tiles of 128 slots for
    pool rows of at most 64 bytes (int8 at D = 64), else 64 (csrc
    DecodeSmem / the tensor-core tiles); as many splits as bring B * KH
    blocks to about TARGET_BLOCKS (SMS for fp rows of 512 bytes or more,
    whose blocks run one per SM), and no more than the bucket's capacity
    max_pages * page_size has tiles, so no split is under one tile."""
    row_bytes = head_dim * (1 if quant else 2)
    tile = 128 if row_bytes <= 64 else 64
    target = SMS if row_bytes >= 512 else TARGET_BLOCKS
    cap_tiles = -(-(max_pages * page_size) // tile)
    return SplitPlan(max(1, min(target // max(B * KH, 1), cap_tiles)), tile)


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


def decode_attention_sharded(
    q, k_pages, v_pages, page_table, seq_lens, window=None, *, tp: int = 1, plain: bool = False,
    k_scales=None, v_scales=None, k_cur=None, v_cur=None, cur_lens=None, **kw,
):
    """One (dp, sp, ep, tp) rank's decode attention: the counterpart of
    ``ragged_paged_attention_decode_sharded``
    (production_stack_tpu/ops/pallas/paged_attention.py:472), which runs the
    TPU decode kernel per (dp, tp) shard under a ``shard_map`` whose ep axis
    replicates the decode activations.

    The contract is the JAX function's per shard. Rows: the rank holds its
    dp group's B/dp rows of ``q``, ``page_table``, ``seq_lens``, the burst
    window ``k_cur/v_cur`` and ``cur_lens``. Heads: NH/tp query heads ``q``
    [B/dp, NH/tp, D] and KH/tp KV heads of the pools [L, P, page, KH/tp, D],
    contiguous slices of the whole heads, so GQA groups stay whole (query
    head h reads KV head h // G, on the same rank); the int8 scales [L, P,
    KH/tp] and the window [B/dp, C, KH/tp, D] are sliced on KH alike. Page
    ids are global pool coordinates, valid on every rank: the pools are
    replicated over dp. Attention never crosses a row or a head, so the rank
    runs the decode kernel (``decode_attention``), or with ``plain`` its
    plain version, on its shard and needs no collective: the row-parallel
    ``wo`` after it all-reduces over tp, and the runner gathers the rows
    over dp. Where the JAX function lays the shards over a mesh inside one
    program, here each rank process calls this on its own shard
    (models/paged_step.py).

    Shared KV heads: where tp is a multiple of KH (Qwen2.5-1.5B's 2 KV heads
    at tp 4) the rank holds one KV head, KH t // (tp / KH), whole, and its
    NH/tp query heads, which lie inside that head's group: G = NH/tp on the
    rank (3 there). The JAX engine replicates the whole pool there and takes
    its XLA attention (``heads_ok``, production_stack_tpu/engine/runner.py);
    the kernel runs the rank's group as any other.

    ep: a 1-token decode shards nothing over the experts' axis, so the JAX
    function maps ep with every input replicated along it, and each (sp,
    ep) shard computes its (dp, tp) slice again. Here the same, with no
    argument for it: rank (d, e, t) calls this on its (d, t) slice, which
    is the same on every e (its pools are the ep replicas of one shard,
    written alike by every ep rank: ``KV_PAGES_SPEC`` shards tp only), and
    gets the same bytes.

    pp: the JAX function runs inside ``serving_layer_pipeline``'s
    ``shard_map`` on a stage's per-layer pool slices (``KV_PAGES_SPEC_PP``
    shards the layer axis over pp), one microbatch's rows at a time, with
    the token's K/V as ``k_cur``/``v_cur``. Here the same: a stage rank
    calls this with its stage's pools [L/pp, P, page, KH/tp, D], ``layer``
    the index into them, and one microbatch's rows of ``q``,
    ``page_table``, ``seq_lens`` and the token's K/V (models/llama.py,
    models/paged_step.py).

    sp: a decode step (T = 1) is not split over the sequence axis, so the
    JAX function maps sp with every input replicated along it (its
    ``manual`` axes include sp), and each sp shard computes its (dp, tp)
    slice again. Here the same: rank (s, t) calls this on its (d, t) slice,
    which is the same on every s, over pools that are the sp replicas of
    one shard (``KV_PAGES_SPEC`` shards tp only; every sequence rank writes
    every chunk and token into its own), and gets the same bytes.

    sp beside dp or pp: the two mappings compose, each rank running the one
    decode kernel on its shard. At dp x sp (``[dp2sp2]`` on the card) rank
    (d, s, t) calls this on its dp replica's B/dp rows over its sp replica
    of the pool; at pp x sp (``[pp2sp2]``) rank (p, s, t) calls it on one
    microbatch's rows over its sp replica of its stage's pool [L/pp, P,
    page, KH/tp, D]. Every s of a place gets the same bytes.
    """
    NHl, KHl = q.shape[1], k_pages.shape[-2]
    if NHl % KHl:
        raise ValueError(
            f"tp rank holds {NHl} query heads and {KHl} KV heads: GQA groups must stay whole "
            f"(tp = {tp} divides NH, and divides KH or is a multiple of it)"
        )
    for name, t, ax in (("k_scales", k_scales, -1), ("k_cur", k_cur, -2)):
        if t is not None and t.shape[ax] != KHl:
            raise ValueError(f"{name} holds {t.shape[ax]} KV heads, the rank's pools {KHl}: slice it on KH")
    rows = {name: t.shape[0] for name, t in (("q", q), ("page_table", page_table), ("seq_lens", seq_lens),
                                             ("k_cur", k_cur), ("v_cur", v_cur), ("cur_lens", cur_lens))
            if t is not None}
    if len(set(rows.values())) > 1:
        raise ValueError(f"the rank's row-leading inputs disagree on their rows {rows}: slice each on the same dp rows")
    fn = decode_attention_ref if plain else decode_attention
    return fn(q, k_pages, v_pages, page_table, seq_lens, window, k_scales=k_scales, v_scales=v_scales,
              k_cur=k_cur, v_cur=v_cur, cur_lens=cur_lens, **kw)
