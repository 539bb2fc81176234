"""Chunked-prefill attention over paged KV with the chunk's paged KV write:
the CUDA kernels (csrc/prefill_attention.cu) and their plain PyTorch
versions.

``prefill_attention`` launches the attention kernel — and, with
``fused_write=True``, the chunk's write kernel after it — for CUDA tensors,
and runs ``prefill_attention_ref`` for CPU tensors; there is no fallback
between the two. Counterpart of ``ragged_paged_attention_prefill`` in the
JAX package (production_stack_tpu/ops/pallas/prefill_attention.py), same
arguments and layouts. Unlike JAX, the pools (and scales) update IN PLACE
and only the attention output returns.

Two pool modes: fp pools in q's dtype (write kernel ``kv_page_write``), and
int8 pools with ``k_scales/v_scales`` [L, P, KH] f32 (ops/quant.py), where
the history dequantizes inside the attention kernel, the chunk's own K/V
stay fp, and ``kv_page_write_quant`` quantizes the chunk into its pages as
the JAX kernel's fused write does. The attention wrapper counts fp launches
in ``prefill_attention.launches`` and int8 ones in ``launches_int8``.
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
            I, I, I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, P,
        ]
        lib.prefill_attention_launch.restype = I
        lib.kv_page_write_launch.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        lib.kv_page_write_launch.restype = I
        lib.kv_page_write_quant_launch.argtypes = [
            I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P,
        ]
        lib.kv_page_write_quant_launch.restype = I
        _bound = True
    return lib


def _check(tensors, ints, device, what):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what} inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what} inputs must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: positions, page_table, kv_lens and cur_lens must be int32")


def kv_page_write(k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages, layer=None):
    """Write chunk K/V [B, T, KH, D] entries j < cur_lens[b] into the slots
    of ``positions`` [B, T] (-1 drops) of one layer of the pools, in place:
    every other slot keeps its exact bytes."""
    if k_cur.device.type == "cpu":
        return kv_page_write_ref(k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages, layer)
    k_pages, v_pages, layer, _, _ = stack_pools(k_pages, v_pages, layer)
    B, Tn, KH, D = k_cur.shape
    L, P, page_size, KHp, Dp = k_pages.shape
    if k_cur.dtype not in _DTYPES or {v_cur.dtype, k_pages.dtype, v_pages.dtype} != {k_cur.dtype}:
        raise TypeError("kv_page_write takes f32/bf16 chunk K/V in the pools' dtype")
    if (KHp, Dp) != (KH, D) or v_cur.shape != k_cur.shape or positions.shape != (B, Tn) or cur_lens.shape != (B,):
        raise ValueError("kv_page_write: chunk K/V, positions and pools disagree in shape")
    if (KH * D * k_cur.element_size()) % 16 or not 0 <= layer < L:
        raise ValueError("kv_page_write needs 16-byte slot rows and a valid layer")
    _check(
        [k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages],
        [positions, cur_lens, page_table], k_cur.device, "kv_page_write",
    )
    if any(t.data_ptr() % 16 for t in (k_cur, v_cur, k_pages, v_pages)):
        raise ValueError("kv_page_write needs 16-byte aligned chunk K/V and pools")
    err = _lib().kv_page_write_launch(
        _DTYPES[k_cur.dtype], k_cur.data_ptr(), v_cur.data_ptr(), positions.data_ptr(),
        cur_lens.data_ptr(), page_table.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        B, Tn, KH, D, P, page_size, page_table.shape[1], layer,
        torch.cuda.current_stream(k_cur.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"kv_page_write kernel launch failed: cudaError {err}")
    kv_page_write.launches += 1


def kv_page_write_quant(k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages,
                        k_scales, v_scales, layer=None):
    """Quantize chunk K/V [B, T, KH, D] (f32/bf16; entry j < cur_lens[b] at
    position kv_lens[b] - cur_lens[b] + j) into one layer of the int8 pools
    and their scales, in place; ``kv_page_write_quant_ref`` says what it
    writes."""
    if k_cur.device.type == "cpu":
        return kv_page_write_quant_ref(k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages,
                                       k_scales, v_scales, layer)
    if not check_pool_mode(k_pages, v_pages, k_scales, v_scales):
        raise TypeError("kv_page_write_quant writes int8 pools")
    k_pages, v_pages, layer, k_scales, v_scales = stack_pools(k_pages, v_pages, layer, k_scales, v_scales)
    B, Tn, KH, D = k_cur.shape
    L, P, page_size, KHp, Dp = k_pages.shape
    if k_cur.dtype not in _DTYPES or v_cur.dtype != k_cur.dtype:
        raise TypeError("kv_page_write_quant takes f32/bf16 chunk K/V")
    if (KHp, Dp) != (KH, D) or v_cur.shape != k_cur.shape or kv_lens.shape != (B,) or cur_lens.shape != (B,):
        raise ValueError("kv_page_write_quant: chunk K/V, lengths and pools disagree in shape")
    if k_scales.shape != (L, P, KH) or v_scales.shape != k_scales.shape or D % 4 or not 0 <= layer < L:
        raise ValueError("kv_page_write_quant needs [L, P, KH] scales, D % 4 == 0 and a valid layer")
    _check(
        [k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages, k_scales, v_scales],
        [kv_lens, cur_lens, page_table], k_cur.device, "kv_page_write_quant",
    )
    if any(t.data_ptr() % 16 for t in (k_cur, v_cur, k_pages, v_pages)):
        raise ValueError("kv_page_write_quant needs 16-byte aligned chunk K/V and pools")
    max_write = -(-Tn // page_size) + 1
    err = _lib().kv_page_write_quant_launch(
        _DTYPES[k_cur.dtype], k_cur.data_ptr(), v_cur.data_ptr(), kv_lens.data_ptr(),
        cur_lens.data_ptr(), page_table.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), B, Tn, KH, D, P, page_size, page_table.shape[1], layer,
        max_write, torch.cuda.current_stream(k_cur.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"kv_page_write_quant kernel launch failed: cudaError {err}")
    kv_page_write_quant.launches += 1


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
    also writes the chunk's K/V into its pool slots in place: untouched
    slots keep their exact bytes."""
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
    _check(
        [q, k_pages, v_pages, page_table, positions, kv_lens, k_cur, v_cur, cur_lens]
        + ([k_scales, v_scales] if quant else []),
        [positions, page_table, kv_lens, cur_lens], q.device, "prefill kernel",
    )
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_cur, v_cur)):
        raise ValueError("prefill kernel needs 16-byte aligned q, pools and chunk K/V")
    out = torch.empty_like(q)
    err = _lib().prefill_attention_launch(
        _DTYPES[q.dtype], int(quant), D, q.data_ptr(), positions.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        k_cur.data_ptr(), v_cur.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), cur_lens.data_ptr(), out.data_ptr(),
        B, Tn, NH, KH, P, page_size, page_table.shape[1], layer,
        max(1, ROWS_PER_BLOCK // G), NO_WINDOW if window is None else int(window),
        float(sm_scale if sm_scale is not None else D**-0.5), float(logit_softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"prefill_attention kernel launch failed: cudaError {err}")
    if quant:
        prefill_attention.launches_int8 += 1
    else:
        prefill_attention.launches += 1
    if fused_write and quant:
        kv_page_write_quant(k_cur, v_cur, kv_lens, cur_lens, page_table, k_pages, v_pages, k_scales, v_scales, layer)
    elif fused_write:
        kv_page_write(k_cur, v_cur, positions, cur_lens, page_table, k_pages, v_pages, layer)
    return out


prefill_attention.launches = 0
prefill_attention.launches_int8 = 0
kv_page_write.launches = 0
kv_page_write_quant.launches = 0
prefill_attention_ref.calls = 0
kv_page_write_ref.calls = 0
kv_page_write_quant_ref.calls = 0
