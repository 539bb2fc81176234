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

Under tensor parallelism (``tp`` ranks) every tensor here is the rank's:
q holds NH/tp heads, the pools, scales and windows KH/tp (one KV head where
tp/KH ranks share each: the rank's query heads are that head's group). Under data
parallelism the runner hands the step its dp group's B/dp rows (the pools
stay whole: page ids are global). Under expert parallelism the attention
is replicated: every ep rank of a (dp, tp) place runs the same step on the
same rows, heads and pages, so nothing here depends on ep. The decode goes through
``decode_attention_sharded`` (the JAX package's sharded decode, per (dp,
ep, tp) rank), and the prefill kernel runs on the rank's rows and heads too,
where the JAX engine keeps its XLA attention for a multi-device prefill.

Under pipeline parallelism (models/llama.py with a ``stage``) a step is
made per microbatch: ``positions``, ``page_table`` and ``kv_lens`` are the
microbatch's rows, the pools are the stage's own [L/pp, P, page, KH/tp, D]
and ``attend``'s ``li`` is the index into them (not the model's layer
number). A decode microbatch takes the T == 1 path (the decode kernel with
the token's K/V, then ``finish``'s one scatter into the stage's layers:
only the pages holding the microbatch's positions change), a prefill
microbatch the prefill kernel with its fused write, as the JAX
``serving_layer_pipeline`` runs its stage's layers on one microbatch (its
prefill by XLA attention, which the port replaces by the kernel as it does
at tp). There is no burst window under pp.

Under sequence parallelism (models/llama.py with a ``seq``; a MoE model's
experts over the expert group of the rank's sequence place) a prefill chunk
is split along its tokens: ``positions`` are the whole chunk's, padded to a
multiple of sp (pads at -1), and ``attend`` takes the rank's T/sp queries
and K/V. It gathers the chunk's K/V over the sequence group, reads the
layer's pool slots for the rows' pages (``gather_kv_pages``; the pools are
whole on every sequence rank), and attends the rank's queries to the slots
before the chunk and the chunk itself (``stale_kv_positions``) through the
ring (parallel/ring_attention.ring_attention_serving), or with a sliding
window through ``flash_attention`` with explicit positions, as the JAX
forward does at sp. No fused write: ``finish`` commits the whole chunk's
K/V of every layer into the rank's pools with one scatter, as the JAX
forward's ``write_kv_pages_all_layers`` does after its layer scan. A decode
step and a burst take their paths above whole on every sequence rank. A
verify forward (T = 1 + k) splits like a chunk. On a stage of sequence
ranks (pp x sp) the step is made per microbatch as under pp: the pools are
the stage's, ``li`` indexes them and ``finish`` writes the stage's layers.
"""

from __future__ import annotations

from typing import Optional

import torch

from production_stack_tpu_torch.ops.attention import (
    flash_attention,
    gather_kv_pages,
    stale_kv_positions,
    write_kv_pages_all_layers,
)
from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention_sharded
from production_stack_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention,
    prefill_attention_ref,
)
from production_stack_tpu_torch.ops.quant import write_kv_pages_all_layers_quant
from production_stack_tpu_torch.parallel.ring_attention import ring_attention_serving, token_slice


class PagedStep:
    """The attention of every layer of one forward step, and the step's KV
    commit (``finish``)."""

    def __init__(self, attn_impl: str, positions, k_pages, v_pages, page_table, kv_lens,
                 kv_burst: Optional[tuple] = None, kv_scales: Optional[tuple] = None, tp: int = 1, seq=None):
        B, T = positions.shape
        plain = attn_impl == "plain"
        self.decode_kw = dict(tp=tp, plain=plain)
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
        # seq: a chunk split over the sequence ranks (None: every token here)
        self.seq = seq if seq is not None and seq.size > 1 and T > 1 else None
        if self.seq is not None:
            if self.burst or kv_scales is not None:
                raise ValueError("a sequence-parallel chunk takes neither kv_burst nor int8 pools")
            self.q_positions = token_slice(positions, self.seq)
            self.kv_pos = stale_kv_positions(page_table, positions, k_pages.shape[2])
        self.new_k, self.new_v = [], []

    def attend(self, li: int, q, k, v, window, **kw) -> torch.Tensor:
        """Layer li's attention of q [B, T, NH, D] with this step's k, v
        [B, T, KH, D]; ``kw`` (sm_scale, logit_softcap) go to the kernels.
        Returns [B, T, NH, D]."""
        if self.seq is not None:
            return self._attend_sp(li, q, k, v, window, **kw)
        kw = dict(kw, k_scales=self.ks, v_scales=self.vs, layer=li)
        pools = (self.k_pages, self.v_pages, self.page_table)
        if self.burst:
            self.k_acc[li, self.rows, self.cnt] = k[:, 0]
            self.v_acc[li, self.rows, self.cnt] = v[:, 0]
            return decode_attention_sharded(
                q[:, 0], *pools, self.kv_lens, window,
                k_cur=self.k_acc[li], v_cur=self.v_acc[li], cur_lens=self.cur_lens, **self.decode_kw, **kw,
            )[:, None]
        if self.T == 1:
            self.new_k.append(k)
            self.new_v.append(v)
            return decode_attention_sharded(
                q[:, 0], *pools, self.kv_lens, window, k_cur=k[:, 0].contiguous(), v_cur=v[:, 0].contiguous(),
                **self.decode_kw, **kw,
            )[:, None]
        return self.prefill(
            q.contiguous(), *pools, self.positions, self.kv_lens, k.contiguous(), v.contiguous(),
            self.cur_lens, window, fused_write=True, **kw,
        )

    def _attend_sp(self, li: int, q, k, v, window, sm_scale=None) -> torch.Tensor:
        """Layer li's attention of this sequence rank's queries q [B, T/sp,
        NH, D] (its k, v beside them): the chunk's K/V gathered over the
        group and kept for ``finish``, the layer's pool slots read for the
        rows' pages, and the queries against both. Returns [B, T/sp, NH,
        D]."""
        k, v = self.seq.all_gather(k, 1), self.seq.all_gather(v, 1)  # the whole chunk's
        self.new_k.append(k)
        self.new_v.append(v)
        kc, vc = gather_kv_pages(self.k_pages[li], self.v_pages[li], self.page_table)
        kc, vc = torch.cat([kc, k.to(kc.dtype)], dim=1), torch.cat([vc, v.to(vc.dtype)], dim=1)
        if window is None:
            return ring_attention_serving(self.seq, q, kc, vc, self.q_positions, self.kv_pos, sm_scale=sm_scale)
        return flash_attention(q, kc, vc, q_positions=self.q_positions, kv_lens=self.kv_lens, sm_scale=sm_scale,
                               window=window, kv_positions=self.kv_pos)

    def finish(self) -> None:
        """After the layers: commit a single decode token's K/V of every
        layer to the pools, in place, or a sequence-parallel chunk's whole
        K/V (a prefill chunk on one rank wrote its own; a burst leaves the
        commit to the caller)."""
        if not self.new_k:
            return
        k, v = torch.stack(self.new_k), torch.stack(self.new_v)
        if self.ks is not None:
            write_kv_pages_all_layers_quant(
                self.k_pages, self.v_pages, self.ks, self.vs, k, v, self.page_table, self.positions
            )
        else:
            write_kv_pages_all_layers(self.k_pages, self.v_pages, k, v, self.page_table, self.positions)
