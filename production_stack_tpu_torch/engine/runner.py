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
- ``step_multi_pipelined``: a chain of bursts with no fetch between them:
  burst j + 1's input ids are burst j's last tokens, still on the device,
  and its positions and lengths the host's mirror of the burst's activity
  rule. With ``fetch_group`` g the tokens come back a group of g bursts at
  a time, each group's host copy started at its boundary (``HostTokens``).
- ``step_spec``: ``steps`` rounds of speculative decode: an n-gram draft of
  k tokens from the row's own history (``ngram_draft``), one verify forward
  over 1 + k positions with all-position logits (the prefill kernel, whose
  fused write puts the drafts' K/V in place), and exact acceptance of the
  leading matches plus one bonus token.
- With ``kv_cache_dtype="int8"`` (``kv_quant``) the pools are int8 with
  scales ``k_scales/v_scales`` [L, P, KH] (ops/quant.py): the burst window
  stays in the model dtype and the burst commit is the quantizing scatter;
  ``get_pages_quant``/``set_pages_quant`` move pages with their scales.
- ``encode``: the pooled-embedding forward of the model module's
  ``encode`` (llama family only, as in the JAX package).
- With ``enable_lora`` the runner holds ``max_loras + 1`` adapter slots
  (``init_lora_buffers``; slot 0 is the base model) on the device, and each
  forward of ``step`` and ``step_multi`` takes the batch's ``lora_ids``.
  ``set_lora_slot``/``clear_lora_slot`` write a slot in place; the engine
  calls them on its loop thread, between steps (engine/lora.py). With
  ranks they are replicated calls: ``set_lora_slot`` takes the whole
  adapter and each rank keeps its tp part of its stage's layers (the
  buffers split like their projections, parallel/tp.py); every dp, sp and
  ep replica holds the same. ``gathered_lora`` reads the buffers back
  whole, ``lora_digest`` each rank's.
- Sleep mode: ``drop_kv_pools`` releases the pools (level 1),
  ``offload_params`` moves the weights to host memory (level 2),
  ``restore_params`` and ``reset_kv`` bring both back, the pools at new
  addresses (no kernel wrapper keeps a pointer between launches). The LoRA
  buffers stay on the device through both levels, as in the JAX runner.
- Tensor parallelism (``tp``, a parallel/group.TPGroup): the runner is one
  rank's, and the leader's engine makes every call on every rank
  (engine/distributed.py). Its pools hold KH/tp heads of every page
  ([L, P, page, KH/tp, D], scales [L, P, KH/tp]); page ids, chains and
  eviction are the same on every rank, one logical page being tp head
  shards. Where tp is a multiple of KH the tp/KH ranks of a share hold one
  KV head each, the same one ([L, P, page, 1, D]), written alike by each
  (parallel/tp.py's shared KV heads). Each sampled token is rank 0's,
  broadcast before it feeds the next step (``_draw``). ``get_pages(_quant)``
  gather the heads (one replica of a shared one), so a blob is the one a
  tp = 1 runner gives; ``set_pages(_quant)`` keep the rank's slice of
  whole-head pages. ``rank_stats`` and ``gathered_params`` read
  every rank's kernel counters and weights on the leader.
- Disaggregated prefill's device path: ``kv_endpoint_start`` starts this
  process's CUDA IPC endpoint, a producer's ``kv_offer_page`` offers a copy
  of a page, a consumer's ``kv_pull_page`` copies it into ``kv_staged`` and
  ``kv_restore_page`` writes it into the pool with ``set_page_device``, the
  device-tensor counterpart of ``set_pages``.
- Data parallelism (``tp.dp``, the ranks holding the same KV heads, one per
  dp group): dp group d serves rows [d * B/dp, (d + 1) * B/dp) of every step
  (``_stage`` slices every row-leading input, parallel/dp.py) and every
  rank holds the whole pool of its KV heads, replicated over dp as the JAX
  engine's ``KV_PAGES_SPEC`` is. ``step``, ``step_multi`` and ``encode``
  gather their results over dp (a burst once, at its end: a group's rows
  stay its own for the whole burst); after a call that writes the pools,
  the whole pages each dp group wrote, with their scales, are copied into
  every other replica (``dp.sync_replicas``), so the replicas stay byte
  for byte equal. ``replica_digest`` reads each rank's pools.
- Expert parallelism (``tp.expert.ep_size`` > 1): the ep ranks of one (dp, tp)
  place run the same step on the same rows and heads (the model holds E/ep
  of a MoE model's experts and sums its MoE layers over the expert group,
  the ep x tp ranks of its dp replica) and write the same pages, so their
  pools are ep replicas of one shard, equal byte for byte with nothing
  copied between them. The sampled ids are the expert group's first
  rank's (``_draw``). A page read gathers the KV heads over the rank's own
  tp group, so each ep replica reads its own copy and the leader returns
  the (d 0, e 0) one; a page write lands on every ep replica.
  ``gathered_params`` joins the experts over the expert group, and
  ``replay_routes`` makes every rank's routers take another run's experts.
- Pipeline parallelism (``tp.stage.size`` pp > 1; dp = 1): the rank
  is one stage of one (sp, ep, tp) place. Its model holds L/pp layers, a MoE
  model's experts of them split over the stage's expert group
  (models/llama.py runs each step in microbatches through the stages), and
  its pools ``[L/pp, P, page, KH/tp, D]`` those layers' pages, as the JAX
  ``KV_PAGES_SPEC_PP`` shards them. There is no deferred burst, as in the
  JAX runner: ``step_multi`` runs k forwards, each T == 1 step committing
  its own K/V (only the pages its active rows write change), so
  ``step_multi_pipelined`` serves pp too, and ``step_spec``'s verify
  forward (T = 1 + k, all-position logits) runs in microbatches through
  the stages like a prefill chunk. The sampled ids are world rank 0's,
  broadcast to every stage (``_draw``). ``get_pages`` gathers a page's
  layers over the stage group and its heads over the tp group, so a page
  reaches the host whole, as the JAX runner's ``device_get`` of the
  pp-sharded pool gives it; ``set_pages`` keeps the stage's layers and the
  rank's heads. ``gathered_params`` takes a layer's tensors from the stage
  that holds it (``layers.{i}`` by the model's layer number).
- Sequence parallelism (``tp.seq.size`` sp > 1; beside dp or pp ranks,
  not both): the sp ranks of one (p, d, e, t) place hold the same weights
  and the same pool shard (replicated along sp, as the JAX
  ``KV_PAGES_SPEC`` shards tp only). A chunk's tokens (a prefill chunk, or
  step_spec's verify forward of 1 + k, padded to a multiple of sp) split
  over them (models/llama.py: the ring of parallel/ring_attention.py; on
  a stage its microbatches through the stages), after which every rank
  writes the whole chunk into its own pools; a decode step and a burst
  run whole on every rank, each writing its own pools, so the sp replicas
  stay byte for byte equal with nothing copied between them. Under dp
  each dp replica's sp ranks take its rows (``_stage``) and the replica
  sync runs over each sequence place's dp group, after a spec dispatch
  from the rows' final lengths; the sampled ids are the first rank's of
  each dp replica (``ids_groups``: the expert group's first, then the
  sequence group's), world rank 0's without dp. A page read gathers the
  KV heads over the rank's own tp group (and the layers over its stage
  group), so each sp and dp replica reads its own copy and the leader
  returns the (d 0, s 0) one; a page write lands on every replica.
  ``rank_stats``' ring columns count what crossed the sequence group, the
  relay columns the stages' relays.

CUDA graphs around the burst are later work: each step here launches its
kernels one by one from Python.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import inspect
import time
from typing import Any

import numpy as np
import torch

from production_stack_tpu_torch import models
from production_stack_tpu_torch.engine.config import resolve_attn_impl
from production_stack_tpu_torch.utils.arrays import numpy_from_tensor, tensor_from_numpy
from production_stack_tpu_torch.ops.attention import write_kv_pages_all_layers
from production_stack_tpu_torch.ops.kernels import HEAD_DIMS, MAX_GROUP
from production_stack_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_ref
from production_stack_tpu_torch.ops.kernels.prefill_attention import (
    kv_page_write_quant_ref,
    kv_page_write_ref,
    prefill_attention,
    prefill_attention_ref,
)
from production_stack_tpu_torch.ops.quant import init_kv_scales, write_kv_pages_all_layers_quant
from production_stack_tpu_torch.ops.sampling import (
    apply_logit_bias,
    apply_penalties,
    sample,
    sample_with_logprobs,
)
from production_stack_tpu_torch.parallel import dp as dpmod
from production_stack_tpu_torch.parallel import pipeline
from production_stack_tpu_torch.parallel.ep import gather_param
from production_stack_tpu_torch.parallel.ring_attention import seq_routes
from production_stack_tpu_torch.parallel.tp import (
    broadcast_ids,
    gather_split,
    kv_heads_per_rank,
    kv_parts,
    rank_slice,
    shard,
    size_rank,
)
from production_stack_tpu_torch.utils.device import resolve_device
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


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
    lora_ids: Any = None     # [B] int32 adapter slot (0 = base); None = all base


# this process's kernel launch and plain-version call counters (the
# wrappers' attributes), by name: what ``rank_stats`` reads on every rank
COUNTERS = (
    ("decode_attention", decode_attention, "launches"),
    ("prefill_attention", prefill_attention, "launches"),
    ("kv_page_write", prefill_attention, "launches_write"),
    ("decode_attention[int8]", decode_attention, "launches_int8"),
    ("prefill_attention[int8]", prefill_attention, "launches_int8"),
    ("kv_page_write_quant", prefill_attention, "launches_write_int8"),
    ("decode_attention_ref", decode_attention_ref, "calls"),
    ("prefill_attention_ref", prefill_attention_ref, "calls"),
    ("kv_page_write_ref", kv_page_write_ref, "calls"),
    ("kv_page_write_quant_ref", kv_page_write_quant_ref, "calls"),
)
# rank_stats' columns: the counters, then the rank's host seconds inside
# step/step_multi, its collectives' calls, bytes and host seconds, the dp
# replica sync's gathered bytes and the pages it copied into the rank's
# replica, the expert group's all-reduces (calls, bytes), the bytes the
# rank's process holds allocated on its device (0 on the CPU), the stage
# relays and hand-overs (calls, bytes, host seconds; part of the
# collectives too), the bytes its model read from a checkpoint
# directory (0 for a preset) and what crossed its sequence group (the
# ring's rotations and the token gathers: calls, bytes, host seconds; part
# of the collectives too), the bytes of its LoRA buffers (0 without), and
# which of its prefill kernel launches were step_spec's verify forwards
# (the wrapper's count over those calls)
RANK_STATS = tuple(name for name, _, _ in COUNTERS) + (
    "step_seconds", "steps", "collective_calls", "collective_bytes", "collective_seconds",
    "sync_bytes", "sync_pages", "expert_calls", "expert_bytes", "device_bytes",
    "relay_calls", "relay_bytes", "relay_seconds", "loaded_bytes",
    "ring_calls", "ring_bytes", "ring_seconds", "lora_bytes", "verify_launches",
)


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


def ngram_draft(buf: torch.Tensor, pos: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Prompt-lookup draft: the k tokens that followed the most recent
    earlier occurrence of each row's trailing n-gram ``buf[pos - n + 1 ..
    pos]``, all windows compared at once on the device. A row with no match
    repeats its current token (verify then almost surely rejects it, at no
    extra cost: the verify forward's width is fixed).

    buf: [B, H] int32 token history; pos: [B] the current token's position.
    Returns [B, k] int32."""
    B, H = buf.shape
    dev = buf.device
    tail_idx = (pos[:, None] + torch.arange(-n + 1, 1, device=dev)[None, :]).clamp(0, H - 1).long()
    tail = buf.gather(1, tail_idx)                                     # [B, n]
    match = (buf.unfold(1, n, 1) == tail[:, None, :]).all(dim=-1)       # [B, H - n + 1]
    starts = torch.arange(match.shape[1], device=dev)[None, :]
    # the match and the k tokens after it must lie in known history (which
    # also keeps the trailing n-gram from matching itself)
    ok = match & (starts + n + k - 1 <= pos[:, None])
    best = torch.where(ok, starts, -1).max(dim=1).values               # [B], the latest match
    d_idx = (best[:, None] + n + torch.arange(k, device=dev)[None, :]).clamp(0, H - 1)
    draft = buf.gather(1, d_idx)
    cur = buf.gather(1, pos.clamp(0, H - 1)[:, None].long())
    return torch.where((best >= 0)[:, None], draft, cur)


class HostTokens:
    """One group of a chain's tokens on their way to the host: the copy
    into pinned memory is queued on the current stream behind the group's
    bursts, and an event recorded after it. ``numpy()`` waits for that event
    alone, so earlier groups are read while later bursts still run."""

    def __init__(self, tokens: torch.Tensor):
        self.host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
        self.host.copy_(tokens, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


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
        enable_lora: bool = False,
        max_loras: int = 4,
        max_lora_rank: int = 16,
        lora_targets: tuple[str, ...] = ("wq", "wk", "wv", "wo"),
        tp=None,
    ):
        self.device = resolve_device(device)
        # tp: this rank's parallel/group.TPGroup (None: one process). Its tp
        # group runs the forward's collectives, its expert group (ep x tp)
        # the MoE sums and the sampled ids' broadcast, its dp group the row
        # gathers and the replica sync, its world the per-rank reads; a
        # group of one rank is None here, so a dp = 1, ep = 1 or tp = 1 axis
        # runs the code it ran without it
        self.ranks = tp
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.expert = tp.expert if tp is not None and tp.expert.size > 1 else None
        self.dp = tp.dp if tp is not None and tp.dp.size > 1 else None
        self.world = tp.world if tp is not None and tp.world.size > 1 else None
        stage = getattr(tp, "stage", None)
        # the pipeline stage group (None at pp = 1): the relays, the page
        # gathers over the layer axis
        self.stage = stage if stage is not None and stage.size > 1 else None
        seq = getattr(tp, "seq", None)
        # the sequence group (None at sp = 1): a chunk's token split
        self.seq = seq if seq is not None and seq.size > 1 else None
        # the sampled ids' source, the first rank of the rank's dp replica,
        # whose ids every rank of the replica feeds back: under pp (dp = 1)
        # or sp alone world rank 0; otherwise the expert group's first
        # rank, then under dp x sp the sequence group's first (so the ids
        # of (d, s 0, e 0, t 0) reach every (s, e, t) of replica d)
        if self.stage is not None or (self.seq is not None and self.dp is None):
            self.ids_groups = (self.world,)
        else:
            self.ids_groups = (self.expert, self.seq)
        self.tp_size = size_rank(self.tp)[0]
        self.step_seconds = 0.0
        self.steps = 0
        # the device history a burst with penalties left (this rank's rows),
        # read by the next burst of a chain
        self._last_hist = None
        self.sync_bytes = 0
        self.sync_pages = 0
        # the prefill kernel's launches inside step_spec (its verify
        # forwards), read from the wrapper's count around each call
        self.verify_launches = 0
        self.module = models.module_for_config(model.cfg)
        # the JAX runner's refusals: a family without "pp" in MESH_AXES, a
        # pp that does not divide the layers
        pipeline.check_pp(self.module, model.cfg, pipeline.stage_place(self.stage)[0])
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
        self._params_host = None
        self._alloc_kv()
        self.max_loras = max_loras
        self.lora_targets = tuple(lora_targets)
        self.lora = None
        if enable_lora:
            if not hasattr(self.module, "init_lora_buffers"):
                raise ValueError(
                    f"LoRA is not supported for model family "
                    f"{self.module.__name__.rsplit('.', 1)[-1]!r} (llama-family only)"
                )
            # max_loras counts adapters; slot 0 is the base model, hence + 1;
            # the rank's part of each buffer, its stage's layers
            self.lora = self.module.init_lora_buffers(
                cfg, max_loras + 1, max_lora_rank, self.lora_targets, device=self.device, tp=self.tp_size,
                pp=pipeline.stage_place(self.stage)[0],
            )
        # one generator per runner: sampled draws are reproducible per seed,
        # and (unlike jax.random) independent of how many steps were traced
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # the device KV path (disaggregated prefill, kv_endpoint_start): this
        # process's CUDA IPC endpoint and, on a consumer, the pages pulled
        # and awaiting admission (key -> (k, v, deadline))
        self.kv_endpoint = None
        self.kv_staged: dict[str, tuple] = {}
        # a MoE model's replayed routes (replay_routes), None when its
        # routers pick their own experts
        self.route_tape = None

    # -- staging ------------------------------------------------------------

    def _t(self, x, dtype) -> torch.Tensor:
        """``x`` on the runner's device as ``dtype``. A tensor already there
        passes through (a chained burst's input ids stay on the device: a
        trip through the host would be the sync that chaining removes)."""
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type and (
            self.device.index is None or x.device.index == self.device.index
        ):
            return x if x.dtype == dtype else x.to(dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device, non_blocking=True)

    def _stage(self, inp: StepInput, hist=None) -> dict:
        """The step's inputs on the device: under dp only this rank's rows
        of every row-leading input (every input here leads with B). ``hist``,
        already this rank's rows on the device, takes the place of
        ``inp.history`` (a chained burst reads the history its previous
        burst left on the device)."""
        inp = dataclasses.replace(inp, **{
            f.name: dpmod.row_slice(getattr(inp, f.name), self.dp) for f in dataclasses.fields(StepInput)
            if not (f.name == "history" and hist is not None)
        })
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
                self._t(inp.history, i32) if hist is None else hist, self._t(inp.prompt_lens, i32),
                self._t(inp.presence, f32), self._t(inp.frequency, f32),
                self._t(inp.repetition, f32),
            )
        if inp.bias_ids is not None:
            s["bias"] = (self._t(inp.bias_ids, i32), self._t(inp.bias_vals, f32))
        if self.lora is not None:
            ids = inp.lora_ids if inp.lora_ids is not None else np.zeros(np.asarray(inp.kv_lens).shape, np.int32)
            s["lora_ids"] = self._t(ids, i32)
        if inp.kv_limits is not None:
            s["kv_limits"] = self._t(inp.kv_limits, i32)
        return s

    def _forward(self, s, input_ids, positions, kv_lens, kv_burst=None, all_logits=False):
        kw = {"kv_scales": (self.k_scales, self.v_scales)} if self.kv_quant else {}
        if self.lora is not None:
            kw.update(lora=self.lora, lora_ids=s["lora_ids"])
        return self.model(
            input_ids, positions, self.k_pages, self.v_pages, s["page_table"], kv_lens, kv_burst=kv_burst,
            all_logits=all_logits, **kw
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
        """The sampled ids (with their logprobs when ``want_lp``): the ids
        of the first rank of the rank's dp replica on every rank of it
        (``ids_groups``: its ep x tp ranks, and under sp its sequence
        ranks; under pp every stage), whatever each rank drew.
        Under dp every rank draws the whole batch's noise and takes its
        rows' (ops/sampling.sample's ``batch_rows``)."""
        B = logits.shape[0]
        rows = (self.dp.rank * B, self.dp.size * B) if self.dp is not None else None
        if want_lp:
            ids, *lps = sample_with_logprobs(
                logits, self.generator, s["temperature"], s["top_k"], s["top_p"],
                sample_from=sample_from, batch_rows=rows,
            )
            return (self._share_ids(ids), *lps)
        return self._share_ids(sample(sample_from, self.generator, s["temperature"], s["top_k"], s["top_p"], rows))

    def _share_ids(self, ids: torch.Tensor) -> torch.Tensor:
        for group in self.ids_groups:
            ids = broadcast_ids(ids, group)
        return ids

    def _timed(self, t0: float) -> None:
        self.step_seconds += time.perf_counter() - t0
        self.steps += 1

    def _pools(self) -> list:
        return [t for t in (self.k_pages, self.v_pages, self.k_scales, self.v_scales) if t is not None]

    def _sync_replicas(self, inp: StepInput, positions) -> None:
        """After a call that wrote the pools at ``positions`` (the whole
        step's [B, T], -1 for no write): the pages each other dp group wrote,
        copied into this rank's replica (parallel/dp.py). The bytes gathered
        and the pages copied in add to ``rank_stats``' sync columns."""
        if self.dp is None:
            return
        pages = dpmod.group_pages(np.asarray(inp.page_table), positions, self.page_size, self.dp.size)
        self.sync_bytes += dpmod.sync_replicas(self._pools(), pages, self.dp)
        self.sync_pages += sum(len(p) for g, p in enumerate(pages) if g != self.dp.rank)

    # -- steps --------------------------------------------------------------

    @torch.no_grad()
    def step(self, inp: StepInput, want_logprobs: bool = False, want_logits: bool = True):
        """One forward + sample. Returns (token_ids [B], logits [B, V]) or,
        with ``want_logprobs``, (ids, logits, (chosen_lp [B], top_ids [B, K],
        top_lp [B, K])); device tensors — the caller fetches what it needs.
        Under dp every rank returns all B rows, gathered; ``want_logits``
        False returns None for the logits and skips their gather (the
        engine reads none: [B, V] through the host is MBs a step)."""
        t0 = time.perf_counter()
        s = self._stage(inp)
        logits = self._forward(s, s["input_ids"], s["positions"], s["kv_lens"])
        hist = s["pen"][0] if "pen" in s else None
        out = self._draw(logits, self._sample_from(logits, s, hist, s["kv_lens"]), s, want_logprobs)
        self._sync_replicas(inp, np.asarray(inp.positions))
        out = [dpmod.gather_rows(x, self.dp) for x in (out if want_logprobs else (out,))]
        logits = dpmod.gather_rows(logits, self.dp) if want_logits else None
        self._timed(t0)
        if want_logprobs:
            ids, lp, tids, tlp = out
            return ids, logits, (lp, tids, tlp)
        return out[0], logits

    @torch.no_grad()
    def step_multi(self, inp: StepInput, k: int, want_logprobs: bool = False):
        """k decode steps, each sampled token fed back as the next input.
        Returns tokens [B, k] — or (tokens, (chosen_lp [B, k], top_ids
        [B, k, K], top_lp [B, k, K])) with ``want_logprobs``.

        A row continues while it was active and ``kv_lens < kv_limits``;
        once it stops its position goes to -1, so its later steps attend to
        nothing and write nothing, and the host discards its surplus
        tokens. With penalties the history the burst leaves (its tokens
        recorded, this rank's rows, on the device) stays on ``_last_hist``
        for a chained next burst. On a pipeline stage each of the k forwards
        commits its own K/V (no burst window, as the JAX runner under pp)."""
        return self._burst(inp, k, want_logprobs)

    def _burst(self, inp: StepInput, k: int, want_logprobs: bool, hist=None):
        """``step_multi``, reading the penalties' history from ``hist`` (this
        rank's rows, on the device) instead of ``inp.history`` when given."""
        self._last_hist = None
        if k == 1 and hist is None:
            if want_logprobs:
                ids, _, (lp, tids, tlp) = self.step(inp, want_logprobs=True, want_logits=False)
                return ids[:, None], (lp[:, None], tids[:, None], tlp[:, None])
            ids, _ = self.step(inp, want_logits=False)
            return ids[:, None]
        t0 = time.perf_counter()
        s = self._stage(inp, hist)
        # the positions the burst commits, one rule on the host for the
        # write here and for the replica sync (parallel/dp.burst_positions)
        commit = dpmod.burst_positions(inp.positions, inp.kv_lens, inp.kv_limits, k)
        commit_pos = self._t(dpmod.row_slice(commit, self.dp), torch.int32)
        B = s["input_ids"].shape[0]
        L, _, _, KH, D = self.k_pages.shape
        dev = self.device
        if "kv_limits" in s:
            limits = s["kv_limits"]
        else:
            limits = torch.full((B,), np.iinfo(np.int32).max // 2, dtype=torch.int32, device=dev)
        counts = torch.zeros((B,), dtype=torch.int32, device=dev)
        windowed = self.stage is None  # a pipeline stage commits each step's K/V in its forward
        if windowed:
            # the window holds the commit's fp input (int8 pools included)
            k_acc = torch.zeros((L, B, k, KH, D), dtype=self.cfg.dtype, device=dev)
            v_acc = torch.zeros_like(k_acc)
        ids, pos, lens = s["input_ids"], s["positions"], s["kv_lens"]
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
            logits = self._forward(s, ids, pos, lens, kv_burst=(k_acc, v_acc, counts) if windowed else None)
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
        # at commit_pos[b, j] (the first counts[b] entries; -1 after them)
        if windowed and self.kv_quant:
            write_kv_pages_all_layers_quant(
                self.k_pages, self.v_pages, self.k_scales, self.v_scales, k_acc, v_acc,
                s["page_table"], commit_pos,
            )
        elif windowed:
            write_kv_pages_all_layers(
                self.k_pages, self.v_pages, k_acc, v_acc, s["page_table"], commit_pos
            )
        self._sync_replicas(inp, commit)
        self._last_hist = hist
        tokens = dpmod.gather_rows(torch.stack(toks, dim=1), self.dp)
        if want_logprobs:
            lps = tuple(dpmod.gather_rows(torch.stack(x, dim=1), self.dp) for x in zip(*lps))
        self._timed(t0)
        return (tokens, lps) if want_logprobs else tokens

    @torch.no_grad()
    def step_multi_pipelined(self, inp: StepInput, k: int, bursts: int, want_logprobs: bool = False,
                             fetch_group: int = 0) -> list:
        """``bursts`` chained k-step bursts with no fetch between them.
        Returns each burst's result as ``step_multi`` gives it (device
        tensors) or, with ``fetch_group`` g > 0 and no logprobs, one
        ``HostTokens`` per group of g bursts ([B, <= g * k] tokens; a plain
        tensor on the CPU): at each group boundary the group's tokens are
        joined on the device and their copy to pinned host memory is queued
        behind its bursts, so the caller can apply group j while the later
        groups still run.

        Burst j + 1's input ids are burst j's last tokens on the device. Its
        positions and lengths come from the host's mirror of step_multi's
        rule (a row goes on while active and kv_lens < kv_limits; a row that
        stops gets position -1, so the later bursts' steps attend to nothing
        and write nothing). With penalties, burst j + 1 reads the history
        burst j left on the device (``_last_hist``): the host's copy is stale
        past the seam. ``inp.kv_limits`` must cover the whole chain (the
        scheduler sizes them so)."""
        grouped = fetch_group > 0 and not want_logprobs
        if bursts <= 1:
            res = self._burst(inp, k, want_logprobs)
            return [self._to_host(res) if grouped else res]
        pos = np.asarray(inp.positions, np.int64)[:, 0].copy()
        lens = np.asarray(inp.kv_lens, np.int64).copy()
        limits = np.asarray(inp.kv_limits, np.int64)
        outs, group = [], []
        cur, hist = inp, None
        for j in range(bursts):
            res = self._burst(cur, k, want_logprobs, hist)
            toks = res[0] if want_logprobs else res
            if grouped:
                group.append(res)
                if len(group) == fetch_group or j == bursts - 1:
                    outs.append(self._to_host(torch.cat(group, dim=1)))
                    group = []
            else:
                outs.append(res)
            if j == bursts - 1:
                break
            for _ in range(k):  # the burst's own rule, step by step
                active = (pos >= 0) & (lens < limits)
                pos = np.where(active, pos + 1, -1)
                lens = lens + active
            hist = self._last_hist if inp.history is not None else None
            cur = dataclasses.replace(
                inp, input_ids=toks[:, -1:], positions=pos[:, None].astype(np.int32),
                kv_lens=lens.astype(np.int32),
            )
        return outs

    @staticmethod
    def _to_host(tokens: torch.Tensor):
        """A group's tokens on their way to the host: on the card a
        ``HostTokens`` (copy queued now, waited for on ``numpy()``); on the
        CPU the tensor itself."""
        return HostTokens(tokens) if tokens.is_cuda else tokens

    @torch.no_grad()
    def step_spec(self, inp: StepInput, history, steps: int, spec_k: int, ngram: int) -> torch.Tensor:
        """``steps`` rounds of speculative decode, each a draft, one verify
        forward and exact acceptance, with no host sync between rounds.

        The draft is prompt lookup (``ngram_draft``): the k tokens that
        followed the most recent earlier match of the row's trailing
        ``ngram`` tokens in its history. The verify forward scores the
        current token and the k drafts at once (T = 1 + k; all-position
        logits), and a token is sampled at every position (each row's
        sampling parameters repeated T times, from the runner's generator).
        The draft is deterministic, so accepting the leading drafts the
        samples agree with, then the first sample that disagrees (or the
        sample after the last draft: the bonus token), is exact rejection
        sampling: the output has the target's distribution.

        inp: a decode step ([B, 1] inputs) with ``kv_limits``: a row stays
        active while kv_lens + spec_k <= kv_limits (each round writes k
        drafts past its length). history: [B, H] int32, the row's prompt
        and output ids by position, 0-padded; it stays on the device and
        takes each round's emitted tokens. Returns [B, steps, 1 + spec_k]
        int32 tokens, -1 where nothing was emitted.

        The pools are written in place by the verify forward's prefill
        launches (its fused write): an inactive row has positions -1 and
        writes nothing, and ``kv_limits`` keeps every draft inside the row's
        own pages. Slots past the last accepted token hold the rejected
        drafts' K/V; attention never reads them (kv_lens masks them) and the
        next dispatch writes over them. Under dp every rank draws the whole
        batch's B x T noise and takes its rows', and the pages each group
        wrote are copied into the other replicas after the last round. On
        sequence ranks the verify forward splits its 1 + k tokens over the
        ring (without the kernel, as a chunk at sp); on a stage it runs in
        microbatches through the stages (the prefill kernel on the stage's
        pool)."""
        if self.kv_quant:
            raise ValueError(
                "speculative decoding is not supported with "
                "kv_cache_dtype=int8 (the spec scan carries raw pool blocks)"
            )
        if inp.kv_limits is None:
            raise ValueError("step_spec needs kv_limits (a row runs while kv_lens + spec_k <= kv_limits)")
        t0 = time.perf_counter()
        launched = prefill_attention.launches
        s = self._stage(inp)
        k, T = spec_k, 1 + spec_k
        h0 = self._t(dpmod.row_slice(history, self.dp), torch.int32)
        B, H = h0.shape
        dev = self.device
        # one sentinel column past the end takes the writes that drop
        buf = torch.cat([h0, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
        known = buf[:, :H]
        pos, lens, limits = s["positions"][:, 0], s["kv_lens"], s["kv_limits"]
        j = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        rows = torch.arange(B, device=dev)[:, None]
        per_pos = {name: s[name].repeat_interleave(T) for name in ("temperature", "top_k", "top_p")}
        toks = []
        for _ in range(steps):
            active = (pos >= 0) & (lens + k <= limits)
            p0 = pos.clamp(min=0)
            cur = known.gather(1, p0.clamp(max=H - 1)[:, None].long())
            draft = ngram_draft(known, p0, ngram, k)
            pos_in = torch.where(active[:, None], p0[:, None] + j, -1).to(torch.int32)
            lens_in = torch.where(active, lens + k, 0).to(torch.int32)
            logits = self._forward(s, torch.cat([cur, draft], dim=1), pos_in, lens_in, all_logits=True)
            flat = logits.reshape(B * T, -1)
            t = self._draw(flat, flat, per_pos, False).reshape(B, T)
            # the leading run of drafts the samples agree with, then the
            # first sample that disagrees (after k matches: the bonus)
            m = (t[:, :k] == draft).to(torch.int32).cumprod(dim=1).sum(dim=1)
            bonus = t.gather(1, m[:, None].long())
            upd = torch.where(j == m[:, None], bonus, torch.cat([draft, cur], dim=1))
            emit = active[:, None] & (j <= m[:, None])
            slots = p0[:, None] + 1 + j
            buf[rows, torch.where(emit & (slots < H), slots, H).long()] = upd
            toks.append(torch.where(emit, upd, -1))
            emitted = ((m + 1) * active).to(torch.int32)
            pos = torch.where(active, pos + emitted, -1)
            lens = lens + emitted
        out = dpmod.gather_rows(torch.stack(toks, dim=1), self.dp)
        if self.dp is not None:
            # the replicas: every group's written positions need the final
            # lengths of all rows (a [B] fetch)
            lens_f = dpmod.gather_rows(lens, self.dp).cpu().numpy()
            self._sync_replicas(inp, dpmod.spec_positions(inp.positions, inp.kv_lens, inp.kv_limits, lens_f, k))
        self.verify_launches += prefill_attention.launches - launched
        self._timed(t0)
        return out

    # -- page access (offload / transfer surfaces) --------------------------

    def _kv_parts(self) -> int:
        """The distinct KV-head slices over the tp group: tp, or KH where
        tp/KH ranks share each head."""
        return kv_parts(self.tp_size, self.cfg.num_kv_heads)

    def _whole(self, t: torch.Tensor, heads: int) -> torch.Tensor:
        """Pages or scales of this rank ([L/pp, N, ...], KV heads on axis
        ``heads``) with every KV head (over the tp group, one replica of a
        shared head) and every layer (over the stage group)."""
        return gather_split(gather_split(t, heads, self.tp, self._kv_parts()), 0, self.stage)

    def _own(self, t: torch.Tensor, heads: int) -> torch.Tensor:
        """This rank's part of whole pages or scales: its stage's layers and
        its KV heads (a shared head's, where tp/KH ranks share each)."""
        return rank_slice(rank_slice(t, heads, self.tp, self._kv_parts()), 0, self.stage)

    def get_pages(self, pids: "list[int]"):
        """N pages' K/V to the host in one copy: per-page ``[L, page, KH, D]``
        numpy arrays (ks, vs), every KV head (gathered from the tp ranks of
        the caller's dp group and sequence rank: each dp group and each sp
        rank reads its own replica) and every layer (gathered from the
        stages)."""
        if not pids:
            return [], []
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        k = numpy_from_tensor(self._whole(self.k_pages[:, idx], 3))
        v = numpy_from_tensor(self._whole(self.v_pages[:, idx], 3))
        return [k[:, i] for i in range(len(pids))], [v[:, i] for i in range(len(pids))]

    def set_pages(self, pids: "list[int]", ks, vs) -> None:
        """Write N pages (per-page ``[L, page, KH, D]`` arrays, as
        ``get_pages`` returns them) into the pools; a tp rank keeps its
        heads, a stage its layers, and every dp, sp and ep replica takes
        them."""
        if not pids:
            return
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        for pool, pages in ((self.k_pages, ks), (self.v_pages, vs)):
            src = tensor_from_numpy(np.stack(list(pages), axis=1))
            if src.dtype != pool.dtype:
                raise TypeError(f"pages are {src.dtype}, the pool holds {pool.dtype}")
            pool[:, idx] = self._own(src, 3).to(self.device)

    def get_pages_quant(self, pids: "list[int]"):
        """N int8 pages and their scales to the host in one copy: per page
        ``[L, page, KH, D]`` int8 and ``[L, KH]`` f32 numpy arrays (ks, vs,
        sks, svs), the exact pool bytes, every KV head (gathered from the tp
        ranks) and layer (from the stages)."""
        if not pids:
            return [], [], [], []
        idx = torch.as_tensor(list(pids), dtype=torch.long, device=self.device)
        out = [
            self._whole(t[:, idx], 3 if t.dim() == 5 else 2).cpu().numpy()
            for t in (self.k_pages, self.v_pages, self.k_scales, self.v_scales)
        ]
        return tuple([a[:, i] for i in range(len(pids))] for a in out)

    def set_pages_quant(self, pids: "list[int]", ks, vs, sks, svs) -> None:
        """Write N int8 pages and their scales (as ``get_pages_quant`` gives
        them; a tp rank keeps its heads). Misshaped or missing scales are
        refused before the pools are touched: int8 pages without their
        scales would read as garbage."""
        n = len(pids)
        if n == 0:
            return
        ks, vs, sks, svs = list(ks), list(vs), list(sks), list(svs)
        if not (len(ks) == len(vs) == len(sks) == len(svs) == n):
            raise ValueError(
                f"set_pages_quant: {n} pids but {len(ks)}/{len(vs)}/{len(sks)}/{len(svs)} pages/scales"
            )
        scale_shape = (self.cfg.num_layers, self.cfg.num_kv_heads)
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
            src = torch.from_numpy(np.stack([np.asarray(p, dt) for p in pages], axis=1))
            pool[:, idx] = self._own(src, 3 if src.dim() == 5 else 2).to(self.device)

    def set_page_device(self, pid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one page's K/V (``[L, page, KH, D]`` tensors, on a device)
        into the pools without a host copy: the device counterpart of
        ``set_pages`` (a tp rank keeps its heads, a stage its layers)."""
        for pool, src in ((self.k_pages, k), (self.v_pages, v)):
            if src.dtype != pool.dtype:
                raise TypeError(f"pages are {src.dtype}, the pool holds {pool.dtype}")
            pool[:, pid] = self._own(src, 2).to(self.device)

    # -- device-to-device KV (disaggregated prefill, one process a role) -----
    # The JAX runner's calls of the same names, on one process: the
    # producer copies a page and offers it (kv_offer_page), the consumer's
    # receiver pulls it into kv_staged on its own thread (kv_pull_page), and
    # admission writes it into the pool on the loop thread (kv_restore_page).

    def kv_endpoint_start(self, host: str = "127.0.0.1") -> None:
        """Start this process's CUDA IPC endpoint (idempotent)."""
        if self.kv_endpoint is not None:
            return
        if self.device.type != "cuda":
            raise ValueError("device KV transfer needs a CUDA device (CUDA IPC)")
        from production_stack_tpu_torch.kvoffload.transfer import DeviceKVEndpoint

        self.kv_endpoint = DeviceKVEndpoint(self.device, host=host)

    def kv_offer_page(self, pid: int, uuid: int) -> tuple:
        """Copy page ``pid``'s K and V into one fresh [2, L, page, KH, D]
        tensor (never a view of the pool, whose page is reused once its
        sequence is freed; one IPC handle a page) and offer it under
        ``uuid``. Returns (shape, dtype) of K for the consumer's
        page_ready."""
        kv = torch.stack((self.k_pages[:, pid], self.v_pages[:, pid]))
        self.kv_endpoint.offer_fixed(int(uuid), kv)
        return list(kv.shape[1:]), str(kv.dtype).removeprefix("torch.")

    # pulled pages outlive the consumer's staging entry (DeviceStaging ttl
    # 120 s): its expiry, not this sweep, is what drops a page
    KV_STAGED_TTL_S = 240.0

    def kv_pull_page(self, addr: str, uuid: int, shape, dtype, key: str) -> int:
        """Pull a page from its producer endpoint into ``kv_staged``; returns
        the staged bytes, 0 on failure (the address is then marked dead and
        the producer ships the page as a blob)."""
        self._kv_staged_sweep()
        try:
            k, v = self.kv_endpoint.pull(addr, int(uuid), shape, dtype)
        except Exception as e:  # noqa: BLE001
            self.kv_endpoint.mark_dead(addr)
            logger.warning("device kv pull failed: %s", e)
            return 0
        self.kv_staged[key] = (k, v, time.monotonic() + self.KV_STAGED_TTL_S)
        return int(k.numel() * k.element_size()) * 2

    def kv_restore_page(self, key: str, pid: int) -> None:
        """Write a staged page into the pool, device to device."""
        entry = self.kv_staged.pop(key, None)
        if entry is None:
            raise KeyError(f"kv_restore_page: page {key!r} is not staged")
        k, v = entry[0], entry[1]
        self.set_page_device(pid, k, v)
        if k.is_cuda:
            # the staged tensors came from the pull's copy stream; the write
            # above is queued on this one: without this the next pull could
            # take their memory and overwrite it before the write read it
            cur = torch.cuda.current_stream(k.device)
            k.record_stream(cur)
            v.record_stream(cur)

    def kv_unstage_page(self, key: str) -> None:
        """Drop a staged page (staging expiry, or a failed pull)."""
        self.kv_staged.pop(key, None)

    def _kv_staged_sweep(self) -> None:
        """Drop staged pages past their deadline (bounds the device memory a
        page whose staging entry never expired could hold)."""
        now = time.monotonic()
        for k in [k for k, (_, _, d) in list(self.kv_staged.items()) if d < now]:
            self.kv_staged.pop(k, None)

    def reset_kv(self) -> None:
        """Fresh zeroed page pools (and int8 pools' scales of ones): sleep
        drops them, wake makes them anew."""
        self.drop_kv_pools()
        self._alloc_kv()

    def _alloc_kv(self) -> None:
        """The rank's pools: its stage's L/pp layers (every layer at pp 1)
        and its KV heads of every page. Cached blocks are released first,
        so a pool is not carved out of a block that earlier work left in
        the caching allocator beside live tensors: sleep then gives all of
        its bytes back to the card."""
        self._release_cached()
        cfg = self.cfg
        kw = {"pp": self.stage.size} if self.stage is not None else {}
        self.k_pages, self.v_pages = self.module.init_kv_pages(
            cfg, self.num_pages, self.page_size, self.device, tp=self.tp_size, **kw
        )
        self.k_scales = self.v_scales = None
        if self.kv_quant:
            kh = kv_heads_per_rank(cfg.num_kv_heads, self.tp_size)
            self.k_scales = init_kv_scales(self.k_pages.shape[0], self.num_pages, kh, self.device)
            self.v_scales = init_kv_scales(self.k_pages.shape[0], self.num_pages, kh, self.device)

    def kv_pool_shard_layout(self) -> "list[tuple[str, int]]":
        """Per-rank KV pool footprint: ``(device label, bytes)`` of every
        rank, pp x dp x sp x ep x tp rows, k and v pools with their int8
        scales, from the pools' shapes (each rank holds KH/tp heads of its
        stage's L/pp layers of every page, so 1/(pp x tp) of the bytes, or
        one head, 1/(pp x KH), where tp/KH ranks share each; each dp group,
        and each sp and ep rank in it, a whole replica). Labels are distinct
        per rank (parallel/group.device_labels: two ranks on one card are
        ``cuda:0/tp0`` and ``cuda:0/tp1``, or ``cuda:0/dp0tp0`` ... with dp >
        1, ``cuda:0/dp0ep1tp0`` ... with ep > 1, ``cuda:0/sp1tp0`` ... with sp
        > 1, ``cuda:0/pp1tp0`` ... with pp > 1, ``cuda:0/dp1sp0tp0`` and
        ``cuda:0/pp1sp0tp0`` with sp beside dp or pp ranks)."""
        cfg = self.cfg
        kh = kv_heads_per_rank(cfg.num_kv_heads, self.tp_size)
        L = cfg.num_layers // pipeline.stage_place(self.stage)[0]
        item = 1 if self.kv_quant else torch.empty((), dtype=cfg.dtype).element_size()
        per = 2 * L * self.num_pages * self.page_size * kh * cfg.head_dim * item
        if self.kv_quant:
            per += 2 * L * self.num_pages * kh * 4
        labels = self.ranks.labels if self.ranks is not None else [f"{self.device.type}:{self.device.index or 0}"]
        return [(label, per) for label in labels]

    def rank_stats(self, reset: bool = False) -> np.ndarray:
        """Every rank's ``RANK_STATS`` row ([pp x dp x sp x ep x tp,
        len(RANK_STATS)] float64, global rank order): its kernel launches and
        plain-version calls, its step seconds and its collectives (tp,
        expert, dp, sequence and stage) since the last reset; with ``reset`` each
        rank's count starts again from 0 after the read."""
        r = self.ranks
        calls, nbytes, secs = r.stats() if r is not None else (0, 0, 0.0)
        row = [getattr(fn, attr) for _, fn, attr in COUNTERS]
        row += [self.step_seconds, self.steps, calls, nbytes, secs, self.sync_bytes, self.sync_pages]
        row += [r.expert_calls, r.expert_bytes] if r is not None else [0, 0]
        row += [torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0]
        row += [r.relay_calls, r.relay_bytes, r.relay_seconds] if r is not None else [0, 0, 0.0]
        row += [getattr(self.model, "loaded_bytes", 0)]
        row += [r.ring_calls, r.ring_bytes, r.ring_seconds] if r is not None else [0, 0, 0.0]
        row += [sum(t.numel() * t.element_size() for t in self._lora_tensors()), self.verify_launches]
        out = gather_split(torch.tensor([row], dtype=torch.float64, device=self.device), 0, self.world)
        if reset:
            for _, fn, attr in COUNTERS:
                setattr(fn, attr, 0)
            self.step_seconds, self.steps = 0.0, 0
            self.sync_bytes = self.sync_pages = self.verify_launches = 0
            if self.ranks is not None:
                self.ranks.reset_stats()
        return out.cpu().numpy()

    def replica_digest(self) -> np.ndarray:
        """Every rank's sha256 of its pools and scales ([pp x dp x sp x ep x
        tp, 32] uint8, global rank order; a diagnostic): the ranks of one tp
        column of one stage are the dp, sp and ep replicas of one KV-head
        shard and must give the same digest."""
        h = hashlib.sha256()
        for t in self._pools():
            for layer in t:  # a layer at a time through the host
                h.update(layer.contiguous().view(torch.uint8).cpu().numpy())
        own = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)[None].to(self.device)
        return gather_split(own, 0, self.world).cpu().numpy()

    def params_digest(self) -> np.ndarray:
        """Every rank's sha256 of its parameters, by name ([pp x dp x sp x
        ep x tp, 32] uint8, global rank order): the dp, sp and ep replicas
        of one (stage, tp place) hold the same part of the same weights,
        on whatever host each runs (a diagnostic: each host loads its own
        copy)."""
        h = hashlib.sha256()
        for name, t in sorted(self.model.named_parameters()):
            h.update(name.encode())
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy())
        own = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)[None].to(self.device)
        return gather_split(own, 0, self.world).cpu().numpy()

    def gathered_params(self, names: "list[str]") -> dict:
        """The named parameters whole (every tp rank's part joined over the
        caller's tp group, an expert tensor's over its expert group, a
        layer's taken from the stage that holds it, ``layers.{i}`` by the
        model's layer number; bit for bit), on the CPU."""
        own = dict(self.model.named_parameters())
        L = self.cfg.num_layers
        return {name: gather_param(pipeline.gather_layer_param(own, name, L, self.stage).detach(), name,
                                   self.ranks, self.cfg.num_kv_heads).cpu()
                for name in names}

    def replay_routes(self, picks=None) -> None:
        """Make every MoE router of this rank's model take the experts
        ``picks`` lists ([B, T, k] per layer and forward, in the order a
        one-rank run's forwards take them, the whole batch's rows), each
        weighted by its own probabilities, recording into a fresh
        ``route_tape`` (models/llama.RouteTape), until a call with None.
        Each rank replays its own part, in the order its forward routes:
        under dp its rows; on a pipeline stage its layers' entries, a
        microbatch at a time (parallel/pipeline.stage_routes); on a
        sequence rank its tokens of each chunk, padded as the chunk is
        (parallel/ring_attention.seq_routes). A replicated call: every rank
        of the expert group must take the same experts, or a token's sum
        would mix two routings. It lets a run at any (pp, dp, sp, ep, tp)
        take the experts another run took, as ``tape_routes`` does within
        one process."""
        from production_stack_tpu_torch.models.llama import RouteTape

        if not getattr(self.cfg, "num_experts", 0):
            raise ValueError("route replay needs a MoE model")
        tape = None
        if picks is not None:
            own = [self._t(dpmod.row_slice(np.asarray(p), self.dp), torch.long) for p in picks]
            own = pipeline.stage_routes(own, self.cfg.num_layers, self.stage)
            tape = RouteTape(seq_routes(own, self.seq, self.cfg.num_experts_per_tok))
        for layer in self.model.layers:
            layer.route_tape = tape
        self.route_tape = tape

    # -- LoRA slots (engine/lora.py drives these) ----------------------------

    def _check_lora_slot(self, slot: int) -> None:
        if self.lora is None:
            raise RuntimeError("runner built with enable_lora=False")
        if not 0 < slot <= self.max_loras:
            raise ValueError(f"slot must be in [1, {self.max_loras}], got {slot}")

    @torch.no_grad()
    def set_lora_slot(self, slot: int, tensors: dict, scale: float) -> None:
        """Write one adapter into ``slot`` in place: ``tensors`` maps
        ``a_<t>``/``b_<t>`` to the whole adapter's [L, in, R] / [L, R, out]
        numpy arrays (as the step stream carries them; cast to the model's
        dtype), ``scale`` its alpha / r. A replicated call: each
        rank copies in its tp part of each (parallel/tp.split_axis) for its
        stage's layers, global layer i at its stage-local index. A target it
        does not name keeps what the slot held."""
        self._check_lora_slot(slot)
        L = self.cfg.num_layers
        held = pipeline.stage_range(L, *pipeline.stage_place(self.stage))
        n, r = size_rank(self.tp)
        for name, stacked in tensors.items():
            src = tensor_from_numpy(stacked)
            if src.shape[0] != L:
                raise ValueError(f"LoRA {name} holds {src.shape[0]} layers, the model {L}")
            src = shard(src[held.start:held.stop], "layers.0." + name, r, n, kv_heads=self.cfg.num_kv_heads)
            src = src.to(self.device)
            for li, bufs in enumerate(self.lora["layers"]):
                bufs[name][slot].copy_(src[li])
        self.lora["scale"][slot] = scale

    @torch.no_grad()
    def clear_lora_slot(self, slot: int) -> None:
        """Zero ``slot`` (its scale too) in this rank's buffers."""
        self._check_lora_slot(slot)
        for bufs in self.lora["layers"]:
            for t in bufs.values():
                t[slot].zero_()
        self.lora["scale"][slot] = 0.0

    def _lora_tensors(self) -> list:
        """This rank's LoRA buffers and scales (none without LoRA)."""
        if self.lora is None:
            return []
        return [t for bufs in self.lora["layers"] for t in bufs.values()] + [self.lora["scale"]]

    def gathered_lora(self) -> dict:
        """The LoRA buffers whole, as a one-rank runner holds them
        (``init_lora_buffers``' dict: every tp rank's part joined over the
        caller's tp group, the stages' layers over the stage group; bit for
        bit), copied to the CPU."""
        KH = self.cfg.num_kv_heads
        layers = [{name: gather_param(t, f"layers.{li}.{name}", self.ranks, KH) for name, t in bufs.items()}
                  for li, bufs in enumerate(self.lora["layers"])]
        if self.stage is not None:
            whole = {name: gather_split(torch.stack([x[name] for x in layers]), 0, self.stage)
                     for name in layers[0]}
            layers = [{name: t[i] for name, t in whole.items()} for i in range(self.cfg.num_layers)]
        # copies: a replicated buffer is the rank's own, which a later
        # slot write changes
        return {"layers": [{name: t.to("cpu", copy=True) for name, t in x.items()} for x in layers],
                "scale": self.lora["scale"].to("cpu", copy=True)}

    def lora_digest(self) -> np.ndarray:
        """Every rank's sha256 of its LoRA buffers and scales ([pp x dp x
        sp x ep x tp, 32] uint8, global rank order): the dp, sp and ep
        replicas of one (stage, tp place) hold the same buffers."""
        h = hashlib.sha256()
        for t in self._lora_tensors():
            h.update(t.contiguous().view(torch.uint8).cpu().numpy())
        own = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)[None].to(self.device)
        return gather_split(own, 0, self.world).cpu().numpy()

    # -- embeddings ---------------------------------------------------------

    def encode(self, input_ids, positions) -> torch.Tensor:
        """Pooled unit-norm embeddings [B, H] f32 of bucketed [B, T] inputs
        (positions -1 = padding); under dp each group embeds its rows and
        every rank returns all B."""
        if not hasattr(self.module, "encode"):
            raise ValueError(
                f"embeddings are not supported for model family {self.module.__name__.rsplit('.', 1)[-1]!r}"
            )
        ids, pos = (self._t(dpmod.row_slice(x, self.dp), torch.int32) for x in (input_ids, positions))
        return dpmod.gather_rows(self.module.encode(self.model, ids, pos), self.dp)

    # -- sleep mode ---------------------------------------------------------

    def drop_kv_pools(self) -> None:
        """Release the page pools and scales (sleep level 1+). The device
        memory returns to the caching allocator once these were the last
        references; the card's cached blocks go back to it."""
        self.k_pages = self.v_pages = self.k_scales = self.v_scales = None
        self._release_cached()

    def _release_cached(self) -> None:
        # the caching allocator gives blocks back to the card only once
        # nothing refers to them
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def offload_params(self) -> None:
        """Move the weights to host memory (sleep level 2): each parameter's
        bytes are copied to the host, then its device storage is released
        (an empty tensor in its place). A tied head is the embedding itself
        (no second parameter), so the tie survives the round trip. The host
        copy is complete before any device tensor is released, so a failure
        on the way leaves the weights on the device."""
        params = dict(self.model.named_parameters())
        host = {name: p.detach().to("cpu", copy=True) for name, p in params.items()}
        for p in params.values():
            p.data = torch.empty((0,), dtype=p.dtype, device=self.device)
        self._params_host = host
        self._release_cached()

    def restore_params(self) -> None:
        """Put back on the device the weights ``offload_params`` saved, byte
        for byte."""
        host = self._params_host
        if host is None:
            return  # never offloaded: the device weights are live
        for name, p in self.model.named_parameters():
            p.data = host[name].to(self.device)
        self._params_host = None
