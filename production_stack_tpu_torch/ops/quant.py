"""Quantized paged-KV math: int8 pages plus per-page, per-KV-head scales.

Counterpart of production_stack_tpu/ops/quant.py, the contract every
consumer agrees on: the kernels' int8 modes (ops/kernels/), their plain
versions, the decode commit (``write_kv_pages_all_layers_quant``) and the
offload boundary (kvoffload/serde.py v3 blobs carry the exact pool bytes).

    k_pages, v_pages: [L, P, page_size, KH, D] int8
    k_scales, v_scales: [L, P, KH] float32      (value = q * scale)

- Symmetric int8: ``q = round(x / scale)`` clipped to [-127, 127], ``scale =
  max(amax / 127, 1e-8)``. ``x / scale`` is an f32 division (never a
  multiply by the reciprocal) and the rounding is half to even, as
  ``jnp.round``. On the device ``amax / 127`` is ``amax * f32(1 / 127)``:
  XLA folds the division by the constant into that multiply in the JAX
  package's compiled programs (its jitted commit and the Pallas kernel),
  and the two differ in the last bit for ~4% of values. The host functions
  divide, as numpy does in the JAX package. So the same inputs give the
  same bytes as the JAX package on both sides.
- A page's scale resets when its slot 0 is written (the page was
  reallocated); appends into a partly filled page may only grow it, and the
  page's int8 content requantizes by ``round(q * old / new)``.
- Stale slots are never read: attention masks them as for fp pools.

Device functions take and update torch tensors IN PLACE (the JAX versions
return new arrays); the host functions take numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from production_stack_tpu_torch.ops.attention import _kv_flat_indices

SCALE_EPS = 1e-8
QMAX = 127.0
RCP_QMAX = 1.0 / QMAX  # as f32: the correctly rounded 1 / 127


# -- device (torch) -----------------------------------------------------------


def init_kv_scales(num_layers: int, num_pages: int, num_kv_heads: int, device="cpu") -> torch.Tensor:
    """A fresh scales pool: ones (real pages reset theirs on first write)."""
    return torch.ones((num_layers, num_pages, num_kv_heads), dtype=torch.float32, device=device)


def dequant(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """q [..., page, KH, D] int8 * scale [..., KH] -> fp."""
    return (q.float() * scale[..., None, :, None]).to(dtype)


def gather_kv_pages_quant(k_pages, v_pages, k_scales, v_scales, page_table, dtype=torch.float32):
    """Each sequence's int8 pages and scales of one layer ([P, page, KH, D],
    [P, KH]) dequantized to contiguous [B, S, KH, D]."""
    _, page_size, KH, D = k_pages.shape
    B, max_pages = page_table.shape
    pt = page_table.long()
    S = max_pages * page_size
    k = dequant(k_pages[pt], k_scales[pt], dtype)
    v = dequant(v_pages[pt], v_scales[pt], dtype)
    return k.reshape(B, S, KH, D), v.reshape(B, S, KH, D)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to +-127, as int8 (x f32, scale broadcast)."""
    return torch.round(x / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def page_scale(amax: torch.Tensor) -> torch.Tensor:
    """The scale of a page whose kept values have this abs-max (f32):
    max(amax * f32(1 / 127), 1e-8), as the JAX package's compiled programs
    compute it."""
    f32 = dict(dtype=torch.float32, device=amax.device)
    return torch.maximum(amax * torch.tensor(RCP_QMAX, **f32), torch.tensor(SCALE_EPS, **f32))


def write_kv_pages_all_layers_quant(
    k_pages, v_pages, k_scales, v_scales, k_new, v_new, page_table, positions
) -> None:
    """Quantizing twin of ops.attention.write_kv_pages_all_layers, IN PLACE:
    the decode commit (burst windows, T = 1 steps).

    k_pages/v_pages [L, P, page, KH, D] int8; k_scales/v_scales [L, P, KH];
    k_new/v_new [L, B, T, KH, D] fp; positions [B, T] (-1 drops), contiguous
    and ascending per row. Pages whose slot 0 is written get a fresh scale,
    pages appended mid-page keep ``max(old, new)`` and requantize their
    content by the ratio. The same bytes as the JAX function, step by step.
    """
    L, P, page_size, KH, D = k_pages.shape
    B, T = positions.shape
    dev = k_pages.device
    flat, valid = _kv_flat_indices(page_table, positions, page_size)  # [B*T]
    pg = torch.where(valid, torch.div(flat, page_size, rounding_mode="floor"), P)
    slot = flat % page_size
    fresh = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    fresh[pg[valid & (slot == 0)]] = True
    touched = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    touched[pg[valid]] = True
    fresh, touched = fresh[None, :P, None], touched[None, :P, None]

    def new_scales(x_tok, scales):
        amax_tok = x_tok.abs().amax(dim=-1)  # [L, B*T, KH]
        amax_pg = torch.zeros((L, P + 1, KH), dtype=torch.float32, device=dev).scatter_reduce_(
            1, pg[None, :, None].expand(L, -1, KH), amax_tok, reduce="amax"
        )[:, :P]
        want = page_scale(amax_pg)
        return torch.where(touched, torch.where(fresh, want, torch.maximum(scales, want)), scales)

    k_tok = k_new.reshape(L, B * T, KH, D).float()
    v_tok = v_new.reshape(L, B * T, KH, D).float()
    ks_new, vs_new = new_scales(k_tok, k_scales), new_scales(v_tok, v_scales)

    # each row's touched page window: positions are contiguous, so row b
    # touches logical pages [min_pos // page .. max_pos // page]
    W = -(-T // page_size) + 1
    max_pages = page_table.shape[1]
    big = torch.full_like(positions, 2**30)
    p0 = torch.where(positions >= 0, positions, big).amin(dim=1)
    p_last = positions.amax(dim=1)  # -1 = dead row
    start_pg = torch.where(
        p_last >= 0, torch.div(torch.minimum(p0, p_last), page_size, rounding_mode="floor"), 0
    )
    logical = start_pg[:, None] + torch.arange(W, device=dev)[None, :]
    in_range = (p_last >= 0)[:, None] & (logical * page_size <= p_last[:, None]) & (logical < max_pages)
    gids = torch.gather(page_table.long(), 1, logical.clamp(0, max_pages - 1).long())
    gids = gids[in_range]

    for pool, old_s, new_s, tok in ((k_pages, k_scales, ks_new, k_tok), (v_pages, v_scales, vs_new, v_tok)):
        ratio = torch.where(new_s > 0, old_s / new_s, torch.ones_like(new_s))  # [L, P, KH]
        q = pool[:, gids].float() * ratio[:, gids][:, :, None, :, None]
        pool[:, gids] = torch.round(q).clamp_(-QMAX, QMAX).to(torch.int8)
        s_tok = torch.cat([new_s, torch.ones((L, 1, KH), dtype=torch.float32, device=dev)], dim=1)[:, pg]
        q_tok = quantize(tok, s_tok[..., None])
        pool.view(L, P * page_size, KH, D)[:, flat[valid]] = q_tok[:, valid]
        old_s.copy_(new_s)


# -- host (numpy): the serde / restore boundary --------------------------------


def quantize_page_host(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One logical page [L, page, KH, D] fp -> (q int8, scales [L, KH] f32):
    the plain amax rule (the page is complete)."""
    xf = np.asarray(x, np.float32)
    amax = np.abs(xf).max(axis=(1, 3))  # [L, KH]
    scale = np.maximum(amax / QMAX, SCALE_EPS).astype(np.float32)
    q = np.clip(np.round(xf / scale[:, None, :, None]), -QMAX, QMAX)
    return q.astype(np.int8), scale


def dequantize_page_host(q: np.ndarray, scale: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(q [L, page, KH, D] int8, scales [L, KH]) -> fp page."""
    return (np.asarray(q, np.float32) * np.asarray(scale, np.float32)[:, None, :, None]).astype(dtype)


def kv_bytes_per_token(
    num_layers: int, num_kv_heads: int, head_dim: int, page_size: int,
    quantized: bool, fp_itemsize: int = 2,
) -> float:
    """KV bytes one token costs the pool (k + v, scales amortized per page):
    exported as ``vllm:kv_cache_dtype_bytes_per_token``."""
    itemsize = 1 if quantized else fp_itemsize
    per_tok = 2 * num_layers * num_kv_heads * head_dim * itemsize
    if quantized:
        per_tok += 2 * num_layers * num_kv_heads * 4 / max(page_size, 1)
    return float(per_tok)
