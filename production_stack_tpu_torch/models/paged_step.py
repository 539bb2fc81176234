"""One forward step's attention over the paged KV pools, shared by the port's
models (models/llama.py, models/gemma2.py, models/opt.py).

The step is a prefill chunk (T > 1: the prefill kernel, whose fused write
commits the chunk's K/V to the pools in place), a single decode token
(T == 1: the decode kernel with the token's K/V beside the pool, then one
scatter of every layer's K/V after the layers), or a deferred burst step
(``kv_burst``: the token's K/V go into the burst window, the pools stay
read-only and the caller commits the window once per burst). With
``kv_scales`` the pools are int8: the kernels read them in their int8
modes and the writes quantize. ``attn_impl == "plain"`` runs the kernels'
plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
)
from production_stack_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
    prefill_attention_ref,
)
from production_stack_tpu_torch.ops.quant import write_kv_pages_all_layers_quant


class PagedStep:
    """The attention of every layer of one forward step, and the step's KV
    commit (``finish``)."""

    def __init__(self, attn_impl: str, positions, k_pages, v_pages, page_table, kv_lens,
                 kv_burst: Optional[tuple] = None, kv_scales: Optional[tuple] = None):
        B, T = positions.shape
        plain = attn_impl == "plain"
        self.decode = decode_attention_ref if plain else decode_attention
        self.prefill = prefill_attention_ref if plain else prefill_attention
        self.burst = kv_burst is not None
        if self.burst and T != 1:
            raise ValueError("kv_burst is a decode (T == 1) mode")
        self.T = T
        self.positions, self.k_pages, self.v_pages = positions, k_pages, v_pages
        self.page_table, self.kv_lens = page_table, kv_lens
        self.ks, self.vs = kv_scales if kv_scales is not None else (None, None)
        if self.burst:
            self.k_acc, self.v_acc, counts = kv_burst
            self.rows = torch.arange(B, device=positions.device)
            self.cnt = counts.long()
            self.cur_lens = (counts + 1).to(torch.int32)
        elif T > 1:
            self.cur_lens = (positions >= 0).sum(dim=1).to(torch.int32)
        self.new_k, self.new_v = [], []

    def attend(self, li: int, q, k, v, window, **kw) -> torch.Tensor:
        """Layer li's attention of q [B, T, NH, D] with this step's k, v
        [B, T, KH, D]; ``kw`` (sm_scale, logit_softcap) go to the kernels.
        Returns [B, T, NH, D]."""
        kw = dict(kw, k_scales=self.ks, v_scales=self.vs, layer=li)
        pools = (self.k_pages, self.v_pages, self.page_table)
        if self.burst:
            self.k_acc[li, self.rows, self.cnt] = k[:, 0]
            self.v_acc[li, self.rows, self.cnt] = v[:, 0]
            return self.decode(
                q[:, 0], *pools, self.kv_lens, window,
                k_cur=self.k_acc[li], v_cur=self.v_acc[li], cur_lens=self.cur_lens, **kw,
            )[:, None]
        if self.T == 1:
            self.new_k.append(k)
            self.new_v.append(v)
            return self.decode(
                q[:, 0], *pools, self.kv_lens, window, k_cur=k[:, 0].contiguous(), v_cur=v[:, 0].contiguous(), **kw,
            )[:, None]
        return self.prefill(
            q.contiguous(), *pools, self.positions, self.kv_lens, k.contiguous(), v.contiguous(),
            self.cur_lens, window, fused_write=True, **kw,
        )

    def finish(self) -> None:
        """After the layers: commit a single decode token's K/V of every
        layer to the pools, in place (a prefill chunk wrote its own; a burst
        leaves the commit to the caller)."""
        if not self.new_k:
            return
        k, v = torch.stack(self.new_k), torch.stack(self.new_v)
        if self.ks is not None:
            write_kv_pages_all_layers_quant(
                self.k_pages, self.v_pages, self.ks, self.vs, k, v, self.page_table, self.positions
            )
        else:
            write_kv_pages_all_layers(self.k_pages, self.v_pages, k, v, self.page_table, self.positions)
