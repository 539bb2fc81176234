"""Paged-attention plumbing in plain PyTorch: the masking model shared with
the kernels, the post-burst KV commit, and the parity oracles.

Layout (the JAX package's, kept at every public function so tests compare
like with like): pools ``[L, P, page_size, KH, D]`` (or one layer's
``[P, page_size, KH, D]``), ``page_table [B, max_pages]`` int32, positions
``[B, T]`` int32 with -1 for padding.

Masking model (write-after-attend): paged slot ``s`` holds absolute position
``s`` and is valid while ``s < kv_len - cur_len``; the current chunk's or
burst's K/V ride beside the pool, entry ``j`` at position
``kv_len - cur_len + j``. The CUDA kernels (ops/kernels/) mirror it exactly.

Masked slots are *skipped*, never multiplied by ``p = 0``: stale pool slots
may hold any bytes, and ``0 * NaN`` is NaN.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _kv_flat_indices(
    page_table: torch.Tensor, positions: torch.Tensor, page_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat pool-slot index per token ([B*T]) and its validity mask: padding
    and positions beyond the owned pages are invalid (their writes drop)."""
    max_pages = page_table.shape[1]
    page_idx = torch.div(positions, page_size, rounding_mode="floor")
    slot = positions % page_size
    phys = torch.gather(page_table.long(), 1, page_idx.clamp(0, max_pages - 1).long())
    flat = phys * page_size + slot
    valid = (positions >= 0) & (page_idx < max_pages)
    return flat.reshape(-1), valid.reshape(-1)


def stale_kv_positions(
    page_table: torch.Tensor, positions: torch.Tensor, page_size: int
) -> torch.Tensor:
    """KV-slot positions for write-after-attend prefill: paged slot j holds
    position j while j < the chunk start, then the chunk's own positions.
    Returns [B, S + T] for ``flash_attention(kv_positions=...)``."""
    S = page_table.shape[1] * page_size
    chunk_start = positions[:, 0].clamp(min=0)
    slot_pos = torch.arange(S, dtype=torch.int32, device=positions.device)[None, :]
    paged_pos = torch.where(
        slot_pos < chunk_start[:, None], slot_pos, torch.full_like(slot_pos, -1)
    )
    return torch.cat([paged_pos, positions.to(torch.int32)], dim=1)


def burst_kv_positions(
    kv_lens: torch.Tensor, cur_lens: torch.Tensor, S: int, C: int
) -> torch.Tensor:
    """KV-slot positions for deferred-burst decode, [B, S + C]: paged slot j
    holds position j while j < kv_lens - cur_lens, window entry j holds
    ``kv_lens - cur_lens + j`` for j < cur_lens."""
    dev = kv_lens.device
    paged_end = (kv_lens - cur_lens).to(torch.int32)
    slot = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    paged_pos = torch.where(slot < paged_end[:, None], slot, torch.full_like(slot, -1))
    j = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    win_pos = torch.where(
        j < cur_lens[:, None], paged_end[:, None] + j, torch.full_like(j, -1)
    )
    return torch.cat([paged_pos, win_pos], dim=1)


def chunk_kv_positions(
    kv_lens: torch.Tensor, cur_lens: torch.Tensor, positions: torch.Tensor, S: int
) -> torch.Tensor:
    """KV-slot positions for chunked prefill as the prefill kernel masks
    them, [B, S + T]: paged slot j holds position j while j < kv_lens -
    cur_lens, chunk entry j holds positions[b, j] while j < cur_lens (the
    scheduler makes those contiguous from kv_lens - cur_lens, where this
    equals ``stale_kv_positions``)."""
    dev = positions.device
    paged_end = (kv_lens - cur_lens).to(torch.int32)
    slot = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    paged_pos = torch.where(slot < paged_end[:, None], slot, torch.full_like(slot, -1))
    j = torch.arange(positions.shape[1], device=dev)[None, :]
    cur_pos = torch.where(
        j < cur_lens[:, None], positions.to(torch.int32), torch.full_like(positions, -1, dtype=torch.int32)
    )
    return torch.cat([paged_pos, cur_pos], dim=1)


def write_kv_pages_all_layers(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
) -> None:
    """Commit every layer's fresh K/V into the stacked pools, IN PLACE.

    k_pages/v_pages [L, P, page, KH, D]; k_new/v_new [L, B, T, KH, D];
    positions [B, T] (-1 entries drop). A plain ``index_put_`` scatter —
    the JAX package leaves this to XLA too — writing the same bytes as its
    ``.at[].set(mode='drop')``: untouched slots keep their exact old bytes.
    """
    L, P, page_size, KH, D = k_pages.shape
    flat, valid = _kv_flat_indices(page_table, positions, page_size)
    idx = flat[valid]
    kf = k_pages.view(L, P * page_size, KH, D)
    vf = v_pages.view(L, P * page_size, KH, D)
    kf[:, idx] = k_new.reshape(L, -1, KH, D)[:, valid].to(k_pages.dtype)
    vf[:, idx] = v_new.reshape(L, -1, KH, D)[:, valid].to(v_pages.dtype)


def gather_kv_pages(
    k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's pages as contiguous [B, S, KH, D] (S = max_pages *
    page_size) from one layer's [P, page, KH, D] pools."""
    _, page_size, KH, D = k_pages.shape
    B, max_pages = page_table.shape
    pt = page_table.long()
    S = max_pages * page_size
    return (
        k_pages[pt].reshape(B, S, KH, D),
        v_pages[pt].reshape(B, S, KH, D),
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    kv_positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked softmax attention in float32 (GQA-aware) — the oracle.

    q [B, T, NH, D]; k, v [B, S, KH, D]; q_positions [B, T] (-1 = pad);
    kv_lens [B]. Without ``kv_positions`` KV index j is visible to a query
    at position p iff j <= p and j < kv_len; with ``kv_positions [B, S]``
    (-1 = invalid) visibility is (pos >= 0) & (pos <= p). ``window`` keeps
    only positions > p - window; ``logit_softcap`` bounds scores by
    cap * tanh(s / cap) before masking. Rows with nothing visible give 0.
    Returns [B, T, NH, D] in q.dtype.
    """
    B, T, NH, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = NH // KH
    scale = sm_scale if sm_scale is not None else D**-0.5
    qf = (q.float() * scale).reshape(B, T, KH, G, D)
    scores = torch.einsum("btkgd,bskd->btkgs", qf, k.float())
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    qp = q_positions[:, :, None]
    if kv_positions is None:
        idx = torch.arange(S, device=q.device)[None, None, :]
        visible = (idx <= qp) & (idx < kv_lens[:, None, None])
        if window is not None:
            visible &= idx > qp - window
        slot_ok = torch.arange(S, device=q.device)[None, :] < kv_lens[:, None]
    else:
        pos = kv_positions[:, None, :]
        visible = (pos >= 0) & (pos <= qp)
        if window is not None:
            visible &= pos > qp - window
        slot_ok = kv_positions >= 0
    vis = visible[:, :, None, None, :]
    scores = torch.where(vis, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1)
    # invalid slots are zeroed before the product: p = 0 there, but 0 * NaN
    # would still poison the row
    vf = torch.where(slot_ok[:, :, None, None], v.float(), torch.zeros((), device=v.device))
    acc = torch.einsum("btkgs,bskd->btkgd", p, vf)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, T, NH, D).to(q.dtype)


def paged_attention_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    sm_scale: float | None = None,
    window=None,
    logit_softcap: float | None = None,
    k_cur: torch.Tensor | None = None,
    v_cur: torch.Tensor | None = None,
    cur_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention (one query per row) over one layer's paged pool:
    gather + ``flash_attention``. q [B, NH, D] -> [B, NH, D].

    With ``k_cur/v_cur [B, C, KH, D]`` (write-after-attend) pool slots at
    positions >= seq_lens - cur_lens are stale and window entry j holds the
    token at position ``seq_lens - cur_lens + j`` (j < cur_lens)."""
    k, v = gather_kv_pages(k_pages, v_pages, page_table)
    kv_positions = None
    if k_cur is not None:
        B, C = k_cur.shape[0], k_cur.shape[1]
        if cur_lens is None:
            cur_lens = torch.ones((B,), dtype=torch.int32, device=q.device)
        kv_positions = burst_kv_positions(seq_lens, cur_lens, k.shape[1], C)
        k = torch.cat([k, k_cur.to(k.dtype)], dim=1)
        v = torch.cat([v, v_cur.to(v.dtype)], dim=1)
    out = flash_attention(
        q[:, None], k, v,
        q_positions=(seq_lens - 1)[:, None],
        kv_lens=seq_lens,
        sm_scale=sm_scale,
        window=window,
        logit_softcap=logit_softcap,
        kv_positions=kv_positions,
    )
    return out[:, 0]
