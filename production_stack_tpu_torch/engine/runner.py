"""ModelRunner — owns the device state (the model's weights, the KV page
pools, the sampling generator) and runs the model step.

Counterpart of production_stack_tpu/engine/runner.py, in eager PyTorch: no
program cache and no buffer donation (the pools update in place), one
forward per decode step inside a burst. The batch arrives as the
scheduler's bucketed numpy arrays (``StepInput``), so the step sees the
same shapes as the JAX runner's.

- ``step``: one forward + sample (prefill chunk, or a single decode token),
  with the logprob, penalty and logit-bias variants.
- ``step_multi``: a deferred-write decode burst of k tokens. The pools stay
  read-only through the burst; each step appends its K/V to a small
  [L, B, k, KH, D] window that the decode kernel reads beside the pool, and
  one scatter commits the whole burst at the end.
- With ``kv_cache_dtype="int8"`` (``kv_quant``) the pools are int8 with
  scales ``k_scales/v_scales`` [L, P, KH] (ops/quant.py): the burst window
  stays in the model dtype and the burst commit is the quantizing scatter;
  ``get_pages_quant``/``set_pages_quant`` move pages with their scales.

CUDA graphs around the burst are later work: each step here launches its
kernels one by one from Python.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any

import numpy as np
import torch

from production_stack_tpu_torch import models
from production_stack_tpu_torch.engine.config import resolve_attn_impl
from production_stack_tpu_torch.utils.arrays import tensor_from_numpy
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.kernels import HEAD_DIMS, MAX_GROUP
from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant
from production_stack_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample,
    sample_with_logprobs,
)
from production_stack_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class StepInput:
    """Host-side batch description, already bucketed by the scheduler."""

    input_ids: Any      # [B, T] int32
    positions: Any      # [B, T] int32, -1 pad
    page_table: Any     # [B, max_pages] int32
    kv_lens: Any        # [B] int32 (including this step's tokens)
    temperature: Any    # [B] float32
    top_k: Any          # [B] int32
    top_p: Any          # [B] float32
    kv_limits: Any = None  # [B] int32 max kv_len (multi-step decode bound)
    # sampling penalties (set together when any row has penalties):
    history: Any = None      # [B, H] int32 prompt+output ids, position-indexed
    prompt_lens: Any = None  # [B] int32
    presence: Any = None     # [B] f32
    frequency: Any = None    # [B] f32
    repetition: Any = None   # [B] f32
    # OpenAI logit_bias (set together when any row has one):
    bias_ids: Any = None     # [B, K] int32 token ids, >= vocab_size = unused
    bias_vals: Any = None    # [B, K] f32 additive biases


def check_kernel_shapes(cfg) -> None:
    """Refuse, at construction, a model the CUDA kernels cannot serve (they
    take a head_dim in HEAD_DIMS and up to MAX_GROUP query heads per KV head),
    rather than failing its first request; attn_impl="plain" runs it."""
    G = cfg.num_heads // cfg.num_kv_heads
    if cfg.head_dim not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(
            f"the CUDA attention kernels take head_dim in {HEAD_DIMS} and at most {MAX_GROUP} query "
            f"heads per KV head; this model has head_dim {cfg.head_dim} and {G} (use attn_impl='plain')"
        )


class ModelRunner:
    """Holds the model and the KV pools on one device and runs its steps."""

    def __init__(
        self,
        model,
        *,
        num_pages: int = 512,
        page_size: int = 16,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.module = models.module_for_config(model.cfg)
        cfg = dataclasses.replace(
            model.cfg, attn_impl=resolve_attn_impl(model.cfg.attn_impl, self.device)
        )
        if cfg.attn_impl == "cuda":
            check_kernel_shapes(cfg)
        self.kv_quant = cfg.kv_cache_dtype == "int8"
        if self.kv_quant and "kv_scales" not in inspect.signature(self.module.CAUSAL_LM.forward).parameters:
            # the JAX runner's refusal: int8 pools need a forward that reads
            # their scales (OPT's takes none, in both packages)
            raise ValueError(
                f"model family {self.module.__name__.rsplit('.', 1)[-1]!r} does not support kv_cache_dtype=int8"
            )
        model.cfg = cfg
        self.model = model
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.k_pages, self.v_pages = self.module.init_kv_pages(
            cfg, num_pages, page_size, self.device
        )
        self.k_scales = self.v_scales = None
        if self.kv_quant:
            self.k_scales = init_kv_scales(cfg.num_layers, num_pages, cfg.num_kv_heads, self.device)
            self.v_scales = init_kv_scales(cfg.num_layers, num_pages, cfg.num_kv_heads, self.device)
        # one generator per runner: sampled draws are reproducible per seed,
        # and (unlike jax.random) independent of how many steps were traced
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    # -- staging ------------------------------------------------------------

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device, non_blocking=True)

    def _stage(self, inp: StepInput) -> dict:
        i32, f32 = torch.int32, torch.float32
        s = dict(
            input_ids=self._t(inp.input_ids, i32),
            positions=self._t(inp.positions, i32),
            page_table=self._t(inp.page_table, i32),
            kv_lens=self._t(inp.kv_lens, i32),
            temperature=self._t(inp.temperature, f32),
            top_k=self._t(inp.top_k, i32),
            top_p=self._t(inp.top_p, f32),
        )
        if inp.history is not None and inp.presence is not None:
            s["pen"] = (
                self._t(inp.history, i32), self._t(inp.prompt_lens, i32),
                self._t(inp.presence, f32), self._t(inp.frequency, f32),
                self._t(inp.repetition, f32),
            )
        if inp.bias_ids is not None:
            s["bias"] = (self._t(inp.bias_ids, i32), self._t(inp.bias_vals, f32))
        return s

    def _forward(self, s, input_ids, positions, kv_lens, kv_burst=None):
        kw = {"kv_scales": (self.k_scales, self.v_scales)} if self.kv_quant else {}
        return self.model(
            input_ids, positions, self.k_pages, self.v_pages, s["page_table"], kv_lens, kv_burst=kv_burst, **kw
        )

    def _sample_from(self, logits, s, hist, lens):
        """The distribution the draw uses: penalties, then logit bias (the
        reported logprobs stay those of the raw logits)."""
        out = logits
        if "pen" in s:
            _, plens, pres, freq, rep = s["pen"]
            out = apply_penalties(out, hist, lens, plens, pres, freq, rep)
        if "bias" in s:
            out = apply_logit_bias(out, *s["bias"])
        return out

    def _draw(self, logits, sample_from, s, want_lp):
        if want_lp:
            return sample_with_logprobs(
                logits, self.generator, s["temperature"], s["top_k"], s["top_p"],
                sample_from=sample_from,
            )
        return sample(sample_from, self.generator, s["temperature"], s["top_k"], s["top_p"])

    # -- steps --------------------------------------------------------------

    @torch.no_grad()
    def step(self, inp: StepInput, want_logprobs: bool = False):
        """One forward + sample. Returns (token_ids [B], logits [B, V]) or,
        with ``want_logprobs``, (ids, logits, (chosen_lp [B], top_ids [B, K],
        top_lp [B, K])); device tensors — the caller fetches what it needs."""
        s = self._stage(inp)
        logits = self._forward(s, s["input_ids"], s["positions"], s["kv_lens"])
        hist = s["pen"][0] if "pen" in s else None
        out = self._draw(logits, self._sample_from(logits, s, hist, s["kv_lens"]), s, want_logprobs)
        if want_logprobs:
            ids, lp, tids, tlp = out
            return ids, logits, (lp, tids, tlp)
        return out, logits

    @torch.no_grad()
    def step_multi(self, inp: StepInput, k: int, want_logprobs: bool = False):
        """k decode steps, each sampled token fed back as the next input.
        Returns tokens [B, k] — or (tokens, (chosen_lp [B, k], top_ids
        [B, k, K], top_lp [B, k, K])) with ``want_logprobs``.

        A row continues while it was active and ``kv_lens < kv_limits``;
        once it stops its position goes to -1, so its later steps attend to
        nothing and write nothing, and the host discards its surplus
        tokens."""
        if k == 1:
            if want_logprobs:
                ids, _, (lp, tids, tlp) = self.step(inp, want_logprobs=True)
                return ids[:, None], (lp[:, None], tids[:, None], tlp[:, None])
            ids, _ = self.step(inp)
            return ids[:, None]
        s = self._stage(inp)
        B = s["input_ids"].shape[0]
        L, _, _, KH, D = self.k_pages.shape
        dev = self.device
        if inp.kv_limits is not None:
            limits = self._t(inp.kv_limits, torch.int32)
        else:
            limits = torch.full((B,), np.iinfo(np.int32).max // 2, dtype=torch.int32, device=dev)
        # the window holds the commit's fp input (int8 pools included)
        k_acc = torch.zeros((L, B, k, KH, D), dtype=self.cfg.dtype, device=dev)
        v_acc = torch.zeros_like(k_acc)
        counts = torch.zeros((B,), dtype=torch.int32, device=dev)
        ids, pos, lens = s["input_ids"], s["positions"], s["kv_lens"]
        pos0 = pos[:, 0].clone()
        rows = torch.arange(B, device=dev)
        hist = None
        if "pen" in s:
            # one sentinel column past the end takes the writes of rows
            # that are done (the JAX runner's scatter mode='drop')
            h0 = s["pen"][0]
            H = h0.shape[1]
            hist_ext = torch.cat([h0, torch.zeros((B, 1), dtype=h0.dtype, device=dev)], dim=1)
            hist = hist_ext[:, :H]
        toks, lps = [], []
        for _ in range(k):
            logits = self._forward(s, ids, pos, lens, kv_burst=(k_acc, v_acc, counts))
            out = self._draw(logits, self._sample_from(logits, s, hist, lens), s, want_logprobs)
            nxt = out[0] if want_logprobs else out
            toks.append(nxt)
            if want_logprobs:
                lps.append(out[1:])
            act_now = pos[:, 0] >= 0
            if hist is not None:
                hist_ext[rows, torch.where(act_now & (lens < H), lens, H).long()] = nxt
            # an inactive row's window slot was written with garbage by the
            # forward; it stays beyond ``counts`` and is never read or
            # committed
            counts = counts + act_now.to(torch.int32)
            active = act_now & (lens < limits)
            pos = torch.where(active, pos[:, 0] + 1, -1)[:, None].to(torch.int32)
            lens = lens + active.to(torch.int32)
            ids = torch.where(active, nxt, 0)[:, None].to(torch.int32)
        # one commit for the burst: window entry j of row b holds the token
        # at position pos0 + j (valid for j < counts)
        jj = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
        commit_pos = torch.where(
            (jj < counts[:, None]) & (pos0[:, None] >= 0), pos0[:, None] + jj, -1
        ).to(torch.int32)
        if self.kv_quant:
            write_kv_pages_all_layers_quant(
                self.k_pages, self.v_pages, self.k_scales, self.v_scales, k_acc, v_acc,
                s["page_table"], commit_pos,
            )
        else:
            write_kv_pages_all_layers(
                self.k_pages, self.v_pages, k_acc, v_acc, s["page_table"], commit_pos
            )
        tokens = torch.stack(toks, dim=1)
        if want_logprobs:
            lp, tids, tlp = (torch.stack(x, dim=1) for x in zip(*lps))
            return tokens, (lp, tids, tlp)
        return tokens

    # -- page access (offload / transfer surfaces) --------------------------

    @staticmethod
    def _to_numpy(t: torch.Tensor) -> np.ndarray:
        """The JAX layout and dtype: bf16 as ml_dtypes' bfloat16."""
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def get_pages(self, pids: "list[int]"):
        """N pages' K/V to the host in one copy: per-page ``[L, page, KH, D]``
        numpy arrays (ks, vs)."""
        if not pids:
            return [], []
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        k = self._to_numpy(self.k_pages[:, idx])
        v = self._to_numpy(self.v_pages[:, idx])
        return [k[:, i] for i in range(len(pids))], [v[:, i] for i in range(len(pids))]

    def set_pages(self, pids: "list[int]", ks, vs) -> None:
        """Write N pages (per-page ``[L, page, KH, D]`` arrays, as
        ``get_pages`` returns them) into the pools."""
        if not pids:
            return
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        for pool, pages in ((self.k_pages, ks), (self.v_pages, vs)):
            src = tensor_from_numpy(np.stack(list(pages), axis=1))
            if src.dtype != pool.dtype:
                raise TypeError(f"pages are {src.dtype}, the pool holds {pool.dtype}")
            pool[:, idx] = src.to(self.device)

    def get_pages_quant(self, pids: "list[int]"):
        """N int8 pages and their scales to the host in one copy: per page
        ``[L, page, KH, D]`` int8 and ``[L, KH]`` f32 numpy arrays (ks, vs,
        sks, svs), the exact pool bytes."""
        if not pids:
            return [], [], [], []
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        out = [t[:, idx].cpu().numpy() for t in (self.k_pages, self.v_pages, self.k_scales, self.v_scales)]
        return tuple([a[:, i] for i in range(len(pids))] for a in out)

    def set_pages_quant(self, pids: "list[int]", ks, vs, sks, svs) -> None:
        """Write N int8 pages and their scales (as ``get_pages_quant`` gives
        them). Misshaped or missing scales are refused before the pools are
        touched: int8 pages without their scales would read as garbage."""
        n = len(pids)
        if n == 0:
            return
        ks, vs, sks, svs = list(ks), list(vs), list(sks), list(svs)
        if not (len(ks) == len(vs) == len(sks) == len(svs) == n):
            raise ValueError(
                f"set_pages_quant: {n} pids but {len(ks)}/{len(vs)}/{len(sks)}/{len(svs)} pages/scales"
            )
        scale_shape = (self.k_scales.shape[0], self.k_scales.shape[2])
        for s in sks + svs:
            a = np.asarray(s)
            if a.shape != scale_shape or not np.issubdtype(a.dtype, np.floating):
                raise ValueError(
                    f"set_pages_quant: scale {a.shape}/{a.dtype} does not match pool scales "
                    f"{scale_shape}/float32: a quantized page arrived without usable per-kv-head scales"
                )
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        for pool, pages, dt in (
            (self.k_pages, ks, np.int8), (self.v_pages, vs, np.int8),
            (self.k_scales, sks, np.float32), (self.v_scales, svs, np.float32),
        ):
            pool[:, idx] = torch.from_numpy(np.stack([np.asarray(p, dt) for p in pages], axis=1)).to(self.device)

    def reset_kv(self) -> None:
        """Zero the page pools (and reset int8 pools' scales to ones)."""
        self.k_pages.zero_()
        self.v_pages.zero_()
        if self.kv_quant:
            self.k_scales.fill_(1.0)
            self.v_scales.fill_(1.0)
