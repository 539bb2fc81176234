"""Chunked-prefill attention over paged KV with the chunk's paged KV write:
the CUDA kernels (csrc/prefill_attention.cu) and their plain PyTorch
versions.

``prefill_attention`` launches the attention kernel for CUDA tensors and
runs ``prefill_attention_ref`` for CPU tensors; there is no fallback
between the two. With ``fused_write=True`` the same launch also writes the
chunk's K/V into its pool pages, as the TPU kernel's fused write does: one
launch per chunk and layer. Counterpart of ``ragged_paged_attention_prefill``
in the JAX package (production_stack_tpu/ops/pallas/prefill_attention.py),
same arguments and layouts. Unlike JAX, the pools (and scales) update IN
PLACE and only the attention output returns.

Two pool modes: fp pools in q's dtype, written as ``kv_page_write_ref``
writes them, and int8 pools with ``k_scales/v_scales`` [L, P, KH] f32
(ops/quant.py), where the history dequantizes inside the kernel, the
chunk's own K/V stay fp, and the write quantizes the chunk into its pages
as ``kv_page_write_quant_ref`` does. The wrapper counts fp launches in
``prefill_attention.launches`` and int8 ones in ``launches_int8``, and of
those the ones that wrote in ``launches_write`` and ``launches_write_int8``.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops.attention import (
    chunk_kv_positions,
    flash_attention,
    gather_kv_pages,
    write_kv_pages_all_layers,
)
from production_stack_tpu_torch.ops.kernels import HEAD_DIMS, MAX_GROUP, _build
from production_stack_tpu_torch.ops.kernels.decode_attention import check_pool_mode, stack_pools
from production_stack_tpu_torch.ops.quant import gather_kv_pages_quant, page_scale, quantize

NO_WINDOW = 1 << 30
ROWS_PER_BLOCK = 64  # f32 kernel: query rows (tokens x heads of a GQA group) per block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _written_positions(positions, cur_lens):
    """Chunk entry j lands at positions[b, j] while j < cur_lens[b]."""
    j = torch.arange(positions.shape[1], device=positions.device)[None, :]
    return torch.where(j < cur_lens[:, None], positions, torch.full_like(positions, -1))


def kv_page_write_ref(k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages, layer=None):
    """Plain version of the chunk write: the post-burst scatter, one layer."""
    kv_page_write_ref.calls += 1
    k_pages, v_pages, layer, _, _ = stack_pools(k_pages, v_pages, layer)
    write_kv_pages_all_layers(
        k_pages[layer:layer + 1], v_pages[layer:layer + 1],
        k_cur[None], v_cur[None], page_table, _written_positions(positions, cur_lens),
    )


def write_pages(kv_lens, cur_lens, page_size: int, T: int):
    """The pages a contiguous chunk writes, per row: (b, logical page) of
    every page overlapping [kv_lens - cur_lens, kv_lens), for rows with a
    chunk. At most ceil(T / page) + 1 per row."""
    out = []
    for b, (e0, cl) in enumerate(zip(kv_lens.tolist(), cur_lens.tolist())):
        if cl <= 0:
            continue
        s0 = e0 - cl
        for lp in range(s0 // page_size, -(-e0 // page_size)):
            out.append((b, lp))
    return out


def kv_page_write_quant_ref(k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages,
                            k_scales, v_scales, layer=None):
    """Plain version of the quantizing chunk write, IN PLACE; the semantics
    of the JAX kernel's fused int8 write (prefill_attention.py:304-394).

    Chunk entry j < cur_lens[b] holds position s0 + j, s0 = kv_lens[b] -
    cur_lens[b]. Per written page and KV head, over the page's slots in
    [s0, kv_lens[b]): a fresh page (its slot 0 at or after s0) gets scale
    max(amax / 127, 1e-8) and is written whole, zeros past the chunk's end;
    a head page that starts before s0 keeps its old scale, its new slots
    clip into it and its earlier slots keep their bytes. Pages past the
    page table are dropped."""
    kv_page_write_quant_ref.calls += 1
    k_pages, v_pages, layer, k_scales, v_scales = stack_pools(k_pages, v_pages, layer, k_scales, v_scales)
    _, _, page_size, KH, D = k_pages.shape
    Tn = k_cur.shape[1]
    max_pages = page_table.shape[1]
    slots = torch.arange(page_size, device=k_cur.device)
    for b, lp in write_pages(kv_lens, cur_lens, page_size, Tn):
        if lp >= max_pages:
            continue
        e0 = int(kv_lens[b])
        s0 = e0 - int(cur_lens[b])
        start = lp * page_size
        pid = int(page_table[b, lp])
        idx = start + slots
        keep = (idx >= s0) & (idx < e0)
        t = (idx - s0).clamp(0, Tn - 1)
        for cur, pool, scales in ((k_cur, k_pages, k_scales), (v_cur, v_pages, v_scales)):
            x = torch.where(keep[:, None, None], cur[b, t].float(), torch.zeros((), device=cur.device))
            if start >= s0:  # fresh page
                ns = page_scale(x.abs().amax(dim=(0, 2)))
                pool[layer, pid] = quantize(x, ns[None, :, None])
                scales[layer, pid] = ns
            else:
                q = quantize(x, scales[layer, pid][None, :, None])
                pool[layer, pid][keep] = q[keep]


def _attention_ref(q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur, cur_lens, window,
                   sm_scale, logit_softcap, layer, k_scales, v_scales):
    if k_scales is not None:
        k, v = gather_kv_pages_quant(k_pages[layer], v_pages[layer], k_scales[layer], v_scales[layer], page_table)
    else:
        k, v = gather_kv_pages(k_pages[layer], v_pages[layer], page_table)
    kv_pos = chunk_kv_positions(kv_lens, cur_lens, positions, k.shape[1])
    return flash_attention(
        q,
        torch.cat([k, k_cur.to(k.dtype)], dim=1),
        torch.cat([v, v_cur.to(v.dtype)], dim=1),
        q_positions=positions, kv_lens=kv_lens, sm_scale=sm_scale,
        window=window, logit_softcap=logit_softcap, kv_positions=kv_pos,
    )


def prefill_attention_ref(
    q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur,
    cur_lens, window=None, *, sm_scale=None, logit_softcap=None, layer=None,
    fused_write=False, k_scales=None, v_scales=None,
):
    """Plain version: gather the layer's pages (int8 pages dequantized in
    f32), append the chunk K/V, masked f32 softmax attention over the
    write-after-attend positions (ops/attention.chunk_kv_positions); the
    fused write is the plain scatter (fp) or ``kv_page_write_quant_ref``."""
    prefill_attention_ref.calls += 1
    quant = check_pool_mode(k_pages, v_pages, k_scales, v_scales)
    k_pages, v_pages, layer, k_scales, v_scales = stack_pools(k_pages, v_pages, layer, k_scales, v_scales)
    out = _attention_ref(q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur, cur_lens, window,
                         sm_scale, logit_softcap, layer, k_scales, v_scales)
    if fused_write and quant:
        kv_page_write_quant_ref(k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages,
                                k_scales, v_scales, layer)
    elif fused_write:
        kv_page_write_ref(k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages, layer)
    return out


def _lib():
    global _bound
    lib = _build.load("prefill_attention")
    if not _bound:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prefill_attention_launch.argtypes = [
            I, I, I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, I, P,
        ]
        lib.prefill_attention_launch.restype = I
        _bound = True
    return lib


def prefill_attention(
    q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur,
    cur_lens, window=None, *, sm_scale=None, logit_softcap=None, layer=None,
    fused_write=False, k_scales=None, v_scales=None,
):
    """Causal attention of a prefill chunk q [B, T, NH, D] over paged
    history plus the chunk's own K/V (k_cur/v_cur [B, T, KH, D] in q's
    dtype, entry j at positions[b, j], valid for j < cur_lens[b]); returns
    [B, T, NH, D]. Pool slots at positions >= kv_lens - cur_lens are stale
    (never read). Int8 pools take ``k_scales/v_scales``. ``fused_write=True``
    also writes the chunk's K/V into its pool slots in place, in the same
    launch: untouched slots keep their exact bytes."""
    if q.device.type == "cpu":
        return prefill_attention_ref(
            q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur,
            cur_lens, window, sm_scale=sm_scale, logit_softcap=logit_softcap,
            layer=layer, fused_write=fused_write, k_scales=k_scales, v_scales=v_scales,
        )
    quant = check_pool_mode(k_pages, v_pages, k_scales, v_scales)
    k_pages, v_pages, layer, k_scales, v_scales = stack_pools(k_pages, v_pages, layer, k_scales, v_scales)
    B, Tn, NH, D = q.shape
    L, P, page_size, KH, Dk = k_pages.shape
    pool_dtypes = {torch.int8} if quant else {q.dtype}
    if q.dtype not in _DTYPES or {k_pages.dtype, v_pages.dtype} != pool_dtypes or {k_cur.dtype, v_cur.dtype} != {q.dtype}:
        raise TypeError(
            f"prefill kernel takes f32/bf16 q and chunk K/V of one dtype, pools of it or int8; "
            f"got {q.dtype}/{k_pages.dtype}/{k_cur.dtype}"
        )
    G = NH // KH if KH and NH % KH == 0 else 0
    if D not in HEAD_DIMS or Dk != D or not 0 < G <= MAX_GROUP:
        raise ValueError(
            f"prefill kernel takes D in {HEAD_DIMS} and 1..{MAX_GROUP} query heads per KV head; got D={D}, NH={NH}, KH={KH}"
        )
    if k_cur.shape != (B, Tn, KH, D) or v_cur.shape != k_cur.shape:
        raise ValueError("k_cur/v_cur must be [B, T, KH, D] with q's B and T")
    if positions.shape != (B, Tn) or kv_lens.shape != (B,) or cur_lens.shape != (B,) or page_table.shape[0] != B:
        raise ValueError("positions/kv_lens/cur_lens/page_table must match q's batch")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} stacked layers")
    if quant and (k_scales.shape != (L, P, KH) or v_scales.shape != k_scales.shape):
        raise ValueError(f"k_scales/v_scales must be [L, P, KH] = {(L, P, KH)}")
    for t in [q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur, cur_lens] + (
            [k_scales, v_scales] if quant else []):
        if t.device != q.device:
            raise ValueError("prefill kernel inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("prefill kernel inputs must be contiguous")
    if any(t.dtype != torch.int32 for t in (positions, page_table, kv_lens, cur_lens)):
        raise TypeError("prefill kernel: positions, page_table, kv_lens and cur_lens must be int32")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_cur, v_cur)):
        raise ValueError("prefill kernel needs 16-byte aligned q, pools and chunk K/V")
    write = int(bool(fused_write))
    out = torch.empty_like(q)
    err = _lib().prefill_attention_launch(
        _DTYPES[q.dtype], int(quant), D, q.data_ptr(), positions.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        k_cur.data_ptr(), v_cur.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), cur_lens.data_ptr(), out.data_ptr(),
        B, Tn, NH, KH, P, page_size, page_table.shape[1], layer,
        max(1, ROWS_PER_BLOCK // G), NO_WINDOW if window is None else int(window),
        float(sm_scale if sm_scale is not None else D**-0.5), float(logit_softcap or 0.0), write,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"prefill_attention kernel launch failed: cudaError {err}")
    if quant:
        prefill_attention.launches_int8 += 1
        prefill_attention.launches_write_int8 += write
    else:
        prefill_attention.launches += 1
        prefill_attention.launches_write += write
    return out


prefill_attention.launches = 0
prefill_attention.launches_int8 = 0
prefill_attention.launches_write = 0
prefill_attention.launches_write_int8 = 0
prefill_attention_ref.calls = 0
kv_page_write_ref.calls = 0
kv_page_write_quant_ref.calls = 0
