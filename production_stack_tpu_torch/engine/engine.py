"""LLMEngine — the continuous-batching serving core of the port.

Execution model, as in the JAX engine: one daemon thread owns the device
(scheduler + ModelRunner) and spins the step loop; the asyncio side (HTTP
handlers) submits sequences through a thread-safe inbox and receives
``RequestOutput`` items on per-request asyncio queues.

The loop runs the main serving path: chunked prefill with prefix caching,
then fused decode bursts of ``decode_steps`` tokens, with greedy and
temperature sampling, penalties, logit bias, min_tokens, stop strings and
logprobs. With ``decode_pipeline`` > 1 a quiescent batch decodes in chains
of bursts (``runner.step_multi_pipelined``) fetched a group of four bursts
at a time and applied and streamed group by group; while a chain is in
flight, prefill chunks of new arrivals are dispatched behind it
(``_runahead_prefills``), and the scheduler caps the chain by the recent
arrival rate and the measured burst time. With ``speculative_k`` each
decode dispatch runs ``decode_steps`` rounds of n-gram draft and verify
(``runner.step_spec``). Admission control (queue bound and queue deadline)
sheds as the JAX engine does. ``kv_cache_dtype="int8"`` serves from int8
pools (half the bytes per token, about twice the pages for the same
memory), and the local offload tiers (``kv_offload_cpu_gb``,
``kv_offload_dir``) take evicted prefix pages and give them back on a later
prefix match.

The engine surface the rest of the stack reads and calls, as in the JAX
engine: every finished request leaves an SLO terminal record in the bounded
``slo_records`` log (the router scrapes it through ``GET /slo_records``) and
feeds the per-phase histograms (tracing/metrics.py); ``stats()`` carries the
per-class shed counters and the interactive p99 windows; ``embed`` runs the
pooled-embedding forward; ``sleep``/``wake_up`` free and restore the pools
(level 1) and the weights (level 2). Commands that touch device state from
another thread (``embed``, ``sleep``, ``wake_up``) run on the loop thread
between steps (``_run_on_device_thread``).

With ``enable_lora`` the engine serves batched multi-LoRA, as the JAX engine
does: ``load_lora_adapter`` parses a PEFT directory on the caller's thread
and writes the adapter's slot on the loop thread; ``generate(lora_name=)``
pins the slot for the request's life and salts its prefix-cache chain with
the adapter's per-load salt, so base and adapter requests never share pages;
``unload_lora_adapter`` is refused while a request holds the slot. With
ranks (every axis below) the slot writes are replicated runner calls: each
rank keeps its tp part of its stage's layers of the adapter, every dp, sp
and ep replica the same (engine/runner.set_lora_slot); the engine wraps its
runner before it builds the LoRA manager, so every write reaches every
rank.

With ``tensor_parallel_size`` tp > 1 the engine is the leader (rank 0) of
tp processes, one per rank, which it starts itself (from a fork server)
and joins with ``torch.distributed`` (engine/distributed.RankBlock): every
rank holds 1/tp of the weights and of every KV page, and the leader sends
each runner call that must run everywhere to the followers before it runs
it (``BroadcastingRunner``). Scheduling, the prefix cache and the offload tiers
stay the leader's; page ids are the same on every rank. ``num_pages`` comes
from the whole page's bytes, as in the JAX engine, so a tp engine has tp = 1's
page count and each rank 1/tp of the bytes. Where tp is a multiple of the
model's KV heads (Qwen2.5-1.5B's 2 at tp 4), each KV head is shared by tp/KH
ranks, each holding it whole (its page bytes 1/KH of the whole), where the
JAX engine replicates the whole pool. A step error with tp ranks ends
the process (exit 13): the ranks' collectives are out of step and no request
could be served right.

With ``data_parallel_size`` dp > 1 the engine runs dp x tp processes, rank r
at (d, t) = (r // tp, r % tp) as the JAX mesh orders them: each dp group d
is a tp group over the whole model and serves its B/dp contiguous rows of
every step, and every rank holds the whole pool of its KV heads (replicated
over dp, as in the JAX engine; the runner copies each step's written pages
into the other replicas). The scheduler pads every batch to a multiple of
dp (``batch_multiple``), the padded rows inert, as the JAX engine's does.

With ``expert_parallel_size`` ep > 1 each dp replica is ep x tp ranks,
rank r = (d * ep + e) * tp + t (the JAX mesh's (dp, ep, tp) order): a MoE
model's experts split over ep (E/ep a rank, parallel/ep.py) and a MoE
layer's output is summed over the replica's ep x tp ranks; the attention,
the pools and everything else are replicated along ep, every ep rank
writing the same pages. A dense model's ep ranks replicate it whole.
``mesh_devices`` counts pp x dp x sp x ep x tp, as the JAX engine reads it
from its mesh.

With ``pipeline_parallel_size`` pp > 1 (dp = 1) the engine runs pp x ep x tp
processes, rank r = (p * ep + e) * tp + t: stage p holds layers [p * L/pp,
(p + 1) * L/pp) of the llama family's models and their pages, split over
its tp ranks (parallel/pipeline.py), a MoE model's experts of them over its
ep ranks, every step running in microbatches through the stages. The step
stream, the scheduler and the pool's page count are those of pp 1
(``num_pages`` from the whole page, every layer's bytes, as the JAX engine
sizes it), each rank holding 1/(pp x tp) of every page. Speculative
decoding runs its verify forwards through the stages. Refused by name at
start-up: int8 pools, in-engine dp, Gemma-2 or OPT, and a pp that does not
divide the layers.

With ``sequence_parallel_size`` sp > 1 the engine runs sp x ep x tp
processes, rank r = (s * ep + e) * tp + t (the JAX mesh's (sp, ep, tp)
order), or, beside dp or pp ranks, pp x dp x sp x ep x tp, rank r =
(((p * dp + d) * sp + s) * ep + e) * tp + t: each prefill chunk's tokens
(and each verify forward's 1 + k with ``speculative_k``) split over the
sequence ranks of a (p, d, e, t) place, its attention through the ring
(parallel/ring_attention.py; on a stage a microbatch at a time) and a MoE
layer's tokens through the expert group of the rank's sequence place,
every sequence rank holding the whole model of its place (its stage's
layers) and a whole replica of its pool shard, into which it writes every
chunk and every decoded token itself; a decode step runs whole on every
sequence rank. The pool's page count is that of sp 1. Refused by name at
start-up: device KV transfer, int8 pools, and Gemma-2 or OPT (the last
two in the JAX engine's words).

The engine lives inside the stack's services as the JAX engine does. A
request's trace context (``generate(trace=)``, the server's
``engine.request`` span) parents the ``engine.queue``, ``engine.prefill`` and
``engine.decode`` spans it records at the request's finish, and the offload
tiers' spill and restore spans; the flight recorder's "sched" events carry
the batch's trace ids. ``kv_remote_url`` adds the shared cache server as the
last offload tier; ``kv_controller_url`` registers the engine with the
KV-index controller under its advertised URL and reports the chunk hashes it
admits and evicts, which the router's kvaware routing looks up; with
``warm_start`` the engine restores its previous incarnation's manifest
before it serves, spills one every ``warm_start_interval_s`` while idle, and
a last one when the server drains (``warm_spill``). With dp or tp ranks the
offload tiers and warm start move pages through the runner's page calls,
which every rank runs.

Disaggregated prefill, as in the JAX engine: a ``kv_role="producer"`` engine,
at a sequence's finish and before it answers, ships the sequence's full
pages to its decode peer (``_push_finished_kv``): over the KV fabric first
(``kv_fabric``, layer-windowed (pages, scales) frames, the only path for
int8 pools), then per page device to device (``kv_transfer_device``: CUDA
IPC between the two engine processes, fp pools, tp = dp = 1) or as a TCP
blob to the consumer's receiver. A ``kv_role="consumer"`` engine lands blobs
and frames in its offload store (it always has a CPU tier) and device pages
in its staging, and its admission restores them like any offloaded prefix.

The fleet, as in the JAX engine. With ``kv_directory_url`` the engine
publishes its prefix-cache claims to the fleet KV directory the cache server
hosts (kvdirectory.DirectoryPublisher: resident pages as they are
registered, shared-tier blobs as spills and warm-start saves confirm them,
withdrawals on eviction, batched off the loop thread), and at admission
pulls the chunks of a prompt the directory names past the local prefix
match into its local tiers (kvdirectory.DirectoryPuller: from the engine
that holds them resident over the KV fabric, else from the shared tier), so
the restore finds them locally; ``warm_prefetch_on_boot`` pulls the fleet's
warmest chunks before the server reports ready. Live migration
(``migration``, migration.MigrationManager): a running stream is frozen on
the loop thread (out of the running set, pages kept, in ``_frozen``), its
full pages shipped over the fabric to the target (``fabric_ship_pairs``) or
saved through the tiers, then finished with reason "migrated" on commit or
put back into the running set on rollback; the target re-admits the token
history through the ordinary prefix-cache path, so the shipped pages restore
and the tail chunk is prefilled. Directory and migration move pages only
through the offload tiers' page calls and the fabric, which serve tp and dp
ranks.

With ``distributed_num_processes`` n > 1 the ranks are split over n host
processes, equal blocks of consecutive global ranks (engine/distributed.py):
this engine is built on process 0 only, the leader, which starts its own
block and joins every rank over the coordinator's rendezvous; every other
host process runs its block's runners alone (distributed.follower_host_main,
api_server.serve's branch) and builds no engine.

Not ported yet: the "pre" KV write mode (engine/config.check_supported
refuses its flag).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import os
import queue as queue_mod
import threading
import time
from typing import AsyncIterator, Optional

import numpy as np
import torch

from production_stack_tpu_torch import tracing
from production_stack_tpu_torch.engine.config import EngineConfig, check_supported
from production_stack_tpu_torch.engine.distributed import RankBlock, resolve_process_id
from production_stack_tpu_torch.engine.kv_manager import KVPageManager
from production_stack_tpu_torch.engine.linkprobe import derive_max_io_pages, probe_link_bandwidth
from production_stack_tpu_torch.engine.lora import LoRAError, LoRAManager, lora_targets
from production_stack_tpu_torch.engine.model_loader import load_model, model_config
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.engine.scheduler import SamplingParams, Scheduler, Sequence
from production_stack_tpu_torch.engine.tokenizer import load_tokenizer
from production_stack_tpu_torch.kvoffload.connector import KVOffloadConnector
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.kvoffload.warmstart import WarmStartManager
from production_stack_tpu_torch.ops.quant import dequantize_page_host, kv_bytes_per_token, quantize_page_host
from production_stack_tpu_torch.parallel.ep import check_ep
from production_stack_tpu_torch.parallel.pipeline import check_pp
from production_stack_tpu_torch.parallel.ring_attention import check_sp
from production_stack_tpu_torch.parallel.tp import check_tp
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


def _slo_class(priority: str) -> str:
    """The SLO class a record or counter files under: anything but batch is
    interactive."""
    return priority if priority in ("interactive", "batch") else "interactive"


@dataclasses.dataclass
class RequestOutput:
    seq_id: str
    text_delta: str
    token_ids: list[int]
    finished: bool
    finish_reason: Optional[str] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0
    # per-token logprob entries aligned with token_ids (when requested):
    # {"logprob": float, "top_ids": [int], "top_logprobs": [float]}
    logprobs: Optional[list] = None


def build_runner(cfg: EngineConfig, device, model_cfg, params, num_pages: int, tp=None) -> ModelRunner:
    """The engine's ModelRunner on ``device``: its model (``model_cfg``
    resolved by model_loader.model_config; ``params`` a whole parameter
    dict, or None for the preset's seeded weights or the directory's), and
    ``num_pages`` pages. ``tp``: the rank's parallel/group.TPGroup; the
    model takes its tp group's part (the whole model at tp = 1), a MoE
    model its expert group's experts (the ep x tp ranks of its dp replica,
    over which its MoE layers sum), under pp its stage's layers, and under
    sp its sequence group (a chunk's token split)."""
    _, _, model = load_model(
        cfg.model, seed=cfg.seed, device=device, max_model_len=cfg.max_model_len, params=params,
        tp=tp if tp is not None and tp.size > 1 else None, config=model_cfg,
        experts=tp.expert if tp is not None and tp.expert.size > 1 else None,
        stage=tp.stage if tp is not None and tp.stage.size > 1 else None,
        seq=tp.seq if tp is not None and tp.seq.size > 1 else None,
    )
    model.cfg = dataclasses.replace(model.cfg, attn_impl=cfg.attn_impl, kv_cache_dtype=cfg.kv_cache_dtype)
    targets = lora_targets(cfg.lora_target_modules) if cfg.enable_lora else ()
    return ModelRunner(
        model, num_pages=num_pages, page_size=cfg.page_size, seed=cfg.seed,
        device=device, enable_lora=cfg.enable_lora, max_loras=cfg.max_loras,
        max_lora_rank=cfg.max_lora_rank, lora_targets=targets, tp=tp,
    )


def engine_geometry(cfg: EngineConfig, device) -> tuple:
    """(model config, pool pages) of the engine ``cfg``
    describes, after the refusals that need no weights (check_supported,
    and those that read the model: tp, ep, pp and sp against its shape).
    Every host of a multi-host engine derives the same pool from the same
    flags. ``num_pages`` comes from the whole page's bytes (every KV head
    of every layer), as the JAX engine sizes the pool: a tp or pp engine
    holds as many pages as one rank, each rank 1/tp of the heads of its
    stage's 1/pp of the layers (one KV head where tp/KH ranks share each;
    every sequence rank all of its tp place's); int8 pages count their f32
    scale rows too."""
    # int8 with speculative_k, or with a disagg role but no fabric, and a
    # producer without a peer too, in the JAX engine's words
    check_supported(cfg, device)
    module, model_cfg = model_config(cfg.model, cfg.max_model_len)
    check_tp(model_cfg, cfg.tensor_parallel_size)  # per tp group
    check_ep(model_cfg, cfg.expert_parallel_size)
    check_pp(module, model_cfg, cfg.pipeline_parallel_size)
    check_sp(module, model_cfg, cfg.sequence_parallel_size)
    return model_cfg, cfg.num_pages or max(64, int(cfg.kv_cache_memory_gb * 1e9 / page_bytes(cfg, model_cfg)))


def page_bytes(cfg: EngineConfig, model_cfg) -> int:
    """One whole page's bytes in the pool: K and V of every KV head of every
    layer (int8: one byte an element, plus the k and v scale rows)."""
    quant = cfg.kv_cache_dtype == "int8"
    itemsize = torch.empty((), dtype=model_cfg.dtype).element_size()
    L, KH, D = model_cfg.num_layers, model_cfg.num_kv_heads, model_cfg.head_dim
    n = 2 * L * cfg.page_size * KH * D * (1 if quant else itemsize)
    if quant:
        # the pages' f32 scale rows (k and v, per KV head) ride the pool
        # budget too: int8 about doubles the pages kv_cache_memory_gb holds
        n += 2 * L * KH * 4
    return n


class LLMEngine:
    def __init__(self, cfg: EngineConfig, *, device="cuda", params=None):
        """``params``: a parameter dict of the port (model_loader.
        params_from_jax) to serve instead of the preset's seeded weights;
        whole, also under tp (each rank takes its part). With
        ``distributed_num_processes`` > 1 this is process 0's engine (the
        leader of every host's ranks); another process id is refused."""
        model_cfg, num_pages = engine_geometry(cfg, device)
        if cfg.distributed_num_processes > 1 and resolve_process_id(cfg) != 0:
            raise ValueError(
                "a follower host of a multi-host engine builds no engine: run api_server.serve "
                "(or distributed.follower_host_main) with its process id"
            )
        self.cfg = cfg
        self.tensor_parallel = cfg.tensor_parallel_size
        self.data_parallel = cfg.data_parallel_size
        self.expert_parallel = cfg.expert_parallel_size
        self.pipeline_parallel = cfg.pipeline_parallel_size
        self.sequence_parallel = cfg.sequence_parallel_size
        self.mesh_devices = (self.pipeline_parallel * self.data_parallel * self.sequence_parallel
                             * self.expert_parallel * self.tensor_parallel)
        self.kv_quant = cfg.kv_cache_dtype == "int8"
        # a checkpoint directory holds its tokenizer, as in the JAX engine
        self.tokenizer = load_tokenizer(
            cfg.tokenizer or (cfg.model if "/" in cfg.model or cfg.model.startswith(".") else None)
        )
        itemsize = torch.empty((), dtype=model_cfg.dtype).element_size()
        L, KH, D = model_cfg.num_layers, model_cfg.num_kv_heads, model_cfg.head_dim
        self.kv_page_bytes = page_bytes(cfg, model_cfg)
        # bytes one token costs the pool, and a startup quantize-dequantize
        # round trip on seeded normal data: the relative error bound of the
        # int8 math on this build (vllm:kv_quant_dequant_err_max)
        self.kv_bytes_per_token = kv_bytes_per_token(L, KH, D, cfg.page_size, self.kv_quant, itemsize)
        self.kv_quant_dequant_err_max = 0.0
        if self.kv_quant:
            x = np.random.RandomState(0).randn(L, cfg.page_size, KH, D).astype(np.float32)
            qx, sx = quantize_page_host(x)
            self.kv_quant_dequant_err_max = float(
                np.abs(dequantize_page_host(qx, sx) - x).max() / max(np.abs(x).max(), 1e-9)
            )
        self._fr = tracing.configure_flightrecorder(
            capacity=cfg.flight_recorder_capacity,
            enabled=cfg.flight_recorder,
            dump_dir=(
                cfg.flight_recorder_dump_dir
                or os.environ.get("PSTPU_FLIGHTRECORDER_DIR")
            ),
        )
        # pp x dp x sp x ep x tp > 1: start this host's follower ranks and
        # join every host's before the leader loads its own part
        # (RankBlock.close undoes both)
        self._tp: Optional[RankBlock] = None
        if self.mesh_devices > 1:
            self._tp = RankBlock(cfg, device, model_cfg, params, num_pages)
        try:
            group = self._tp.group if self._tp else None
            runner = build_runner(cfg, group.device if group else device, model_cfg, params, num_pages, group)
            self.runner = self._tp.wrap(runner) if self._tp else runner
        except BaseException:
            if self._tp:
                self._tp.close()
            raise
        self.model_cfg = self.runner.cfg
        self.lora: Optional[LoRAManager] = None
        if cfg.enable_lora:
            # on the wrapped runner: with ranks its slot writes reach every rank
            self.lora = LoRAManager(self.runner, max_loras=cfg.max_loras, max_rank=cfg.max_lora_rank)
        self._offload = self._make_offload_connector(cfg)
        # offload I/O budget: an explicit >= 0 is taken as it is; -1 derives
        # it from a startup link probe (0 = unbounded on PCIe-class links)
        self.kv_link_bandwidth_bytes_per_s = None
        max_io_pages = max(cfg.kv_offload_max_io_pages, 0)
        if cfg.kv_offload_max_io_pages < 0 and self._offload is not None:
            bw = probe_link_bandwidth(self.runner.device)
            self.kv_link_bandwidth_bytes_per_s = bw
            max_io_pages = derive_max_io_pages(bw, self.kv_page_bytes)
            logger.info(
                "kv offload link probe: %s MB/s -> max_io_pages=%d",
                "?" if bw is None else f"{bw / 1e6:.1f}", max_io_pages,
            )
        self._max_io_pages = max_io_pages
        self.kv = KVPageManager(
            num_pages, cfg.page_size, offload=self._offload, max_io_pages=max_io_pages,
            spill_watermark=cfg.kv_spill_watermark,
        )
        # warm-start manifests: restore the previous incarnation's hot
        # working set into the pool before the server exists, so the first
        # requests after a restart hit warm prefixes. The loop has not
        # started, so the batched page uploads race nothing
        self.warm: Optional[WarmStartManager] = None
        if cfg.warm_start:
            if self._offload is None:
                logger.warning(
                    "--warm-start needs an offload tier that survives "
                    "restarts (--kv-offload-dir or --kv-remote-url); disabled"
                )
            else:
                self.warm = WarmStartManager(
                    self.kv, self._offload,
                    namespace=cfg.warm_start_namespace or cfg.kv_instance_id or f"{cfg.name}-{cfg.port}",
                    interval_s=cfg.warm_start_interval_s,
                    max_pages=cfg.warm_start_max_pages,
                    model=cfg.name,
                )
                self.warm.restore()
        # the fleet KV directory: the publisher advertises this engine's
        # prefix-cache claims (batched, off the loop thread); the puller
        # fetches fleet-warm prefixes at admission. Made after the warm
        # restore, so the generation fence follows the warm-start generation
        # (a boot epoch without warm start: wall-clock seconds grow across
        # restarts, which is all the fence needs)
        self._kvdir_pub = None
        self._kvdir_pull = None
        if cfg.kv_directory_url:
            from production_stack_tpu_torch.kvdirectory import DirectoryPublisher, DirectoryPuller

            shared_tier = self._offload.store.remote is not None
            self._kvdir_pub = DirectoryPublisher(
                cfg.kv_directory_url,
                engine_url=self._advertised_url(cfg),
                page_size=cfg.page_size,
                generation=self.warm.generation if self.warm is not None else int(time.time()),
                flush_interval_s=cfg.kv_directory_flush_s,
                # shared-tier claims need the write-through remote tier:
                # without one this engine's blobs are private, and its
                # resident claims alone feed the router's ranking
                shared_enabled=shared_tier,
            )
            self.kv.directory = self._kvdir_pub
            if self.kv.hash_to_page:
                # the warm restore ran before the publisher existed: its
                # working set is advertised under the new generation
                self._kvdir_pub.publish_resident([
                    (h, self.kv.pages[pid].depth, self.kv.pages[pid].hits)
                    for h, pid in self.kv.hash_to_page.items()
                ])
            if cfg.kv_directory_pull and shared_tier:
                # the shared tier is the remote cache server: without one
                # every pull would miss after a directory round trip
                self._kvdir_pull = DirectoryPuller(
                    cfg.kv_directory_url, self.kv, self._offload.store, cfg.page_size,
                    max_pages=cfg.kv_directory_pull_max_pages,
                )
            elif cfg.kv_directory_pull:
                logger.warning(
                    "--kv-directory-pull needs --kv-remote-url (the shared "
                    "tier blobs are pulled from the cache server); "
                    "publish-only mode"
                )
        # scale-up warm-up: the fleet's warmest chunks into the local tiers
        # before the server exists; the first matching request's admission
        # restores them through the ordinary offload path
        self.kv_directory_prefetched_pages = 0
        self.kv_directory_prefetch_seconds = 0.0
        if cfg.warm_prefetch_on_boot > 0 and cfg.kv_directory_url:
            t0 = time.perf_counter()
            self.kv_directory_prefetched_pages = self._boot_prefetch(cfg)
            self.kv_directory_prefetch_seconds = time.perf_counter() - t0
        # disaggregated prefill: a producer pushes each finished prefill's
        # pages to its decode peer; a consumer receives them into its store
        # (TCP blobs) or its device staging (kv_transfer_device)
        self._kv_sender = None
        self._kv_receiver = None
        if cfg.kv_role == "producer":
            from production_stack_tpu_torch.kvoffload.transfer import KVTransferSender

            self._kv_sender = KVTransferSender(cfg.kv_peer_url)
        elif cfg.kv_role == "consumer":
            from production_stack_tpu_torch.kvoffload.transfer import KVTransferReceiver

            self._kv_receiver = KVTransferReceiver(self._offload.store, host=cfg.host, port=cfg.kv_transfer_port)
            self._kv_receiver.start()
        if cfg.kv_transfer_device and cfg.kv_role != "none":
            # no TCP fallback for an endpoint that cannot start: it raises
            self.runner.kv_endpoint_start(cfg.kv_transfer_device_host)
            self._arm_device_kv()
        # the peer-to-peer KV fabric: the listener serves resident pages off
        # the pools (gathers run on the loop thread) and lands pushed frames
        # as blobs in the local store, where admission's restore finds them;
        # a producer streams its finished prefills over it first
        self._fabric_server = None
        self._fabric_client = None
        self._fabric_peer_addr: Optional[str] = None
        if cfg.kv_fabric:
            from production_stack_tpu_torch.kvfabric import FrameAssembler, KVFabricClient, KVFabricServer

            self._fabric_asm = FrameAssembler()
            self._fabric_client = KVFabricClient(retries=cfg.kv_fabric_retries)
            self._fabric_server = KVFabricServer(
                host=cfg.host, port=cfg.kv_fabric_port,
                generation=self.warm.generation if self.warm is not None else int(time.time()),
                quant=self.kv_quant, page_size=cfg.page_size, nlayers=model_cfg.num_layers,
                pages_fn=self._fabric_pages, sink_fn=self._fabric_sink,
                advertise_host=cfg.advertise_host or None,
            )
            self._fabric_server.start()
            if self._kvdir_pull is not None:
                # resident pages come engine to engine: the puller gets the
                # fabric client and this engine's URL (it never pulls from
                # itself); the shared tier stays its fallback
                self._kvdir_pull.enable_fabric(self._fabric_client, self._advertised_url(cfg),
                                               serde=self._offload.serde)
        self.scheduler = Scheduler(
            self.kv,
            max_num_seqs=cfg.max_num_seqs,
            max_model_len=cfg.max_model_len,
            prefill_chunk=cfg.prefill_chunk if cfg.enable_chunked_prefill else 10**9,
            prefill_batch=cfg.prefill_batch,
            enable_prefix_caching=cfg.enable_prefix_caching,
            batch_multiple=cfg.data_parallel_size,
            decode_steps=cfg.decode_steps,
            decode_pipeline=cfg.decode_pipeline,
            spec_k=cfg.speculative_k,
            spec_ngram=cfg.speculative_ngram,
            max_waiting_seqs=cfg.max_waiting_seqs,
            queue_deadline_s=cfg.queue_deadline_s,
            interactive_reserve=cfg.interactive_reserve,
            batch_queue_deadline_s=cfg.batch_queue_deadline_s,
            batch_prefill_share=cfg.batch_prefill_share,
        )
        # this loop dispatches run-ahead prefills behind in-flight chains
        # (_runahead_prefills), which licenses the scheduler's one-extra-burst
        # chaining floor past the admission-wait budget
        self.scheduler.runahead_available = True
        # live migration: a frozen sequence is out of the running set but
        # keeps its pages while the target decides; freeze, commit, rollback
        # and abort all run on the loop thread, which alone touches this map
        self._frozen: dict[str, Sequence] = {}
        self.migration = None
        if cfg.migration:
            from production_stack_tpu_torch.migration import MigrationManager

            self.migration = MigrationManager(self)
        self._inbox: queue_mod.Queue = queue_mod.Queue()
        # prefill dispatches whose results were never fetched (and run-ahead
        # prefills queued behind a chain); a deferred device error taints
        # these sequences too
        self._unfetched: list = []
        # two-writer maps (event-loop generate() registers/pops, device
        # thread _emit/_process_token reads/writes): every touch holds _lock
        self._outputs: dict[str, tuple[asyncio.AbstractEventLoop, asyncio.Queue]] = {}
        self._texts: dict[str, str] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.total_prompt_tokens = 0
        self.total_generation_tokens = 0
        self.decode_dispatches_total = 0
        self.decode_chained_dispatches_total = 0
        # prefill dispatches queued behind an in-flight chain (run-ahead)
        self.runahead_prefill_dispatches_total = 0
        self.spec_draft_tokens = 0     # drafts proposed (row-rounds * spec_k)
        self.spec_accepted_tokens = 0  # drafts the target accepted
        self.spec_verify_forwards = 0  # verify forwards run (dispatches * rounds)
        # recent arrival times and the per-burst wall-time EMA: the
        # scheduler's adaptive chain depth reads both
        self._arrival_times: collections.deque = collections.deque(maxlen=64)
        self._burst_seconds = 0.05
        # load-shed accounting, one writer per counter: requests_shed on the
        # device thread, api_requests_shed on the event loop
        self.requests_shed = {"queue_full": 0, "queue_deadline": 0}
        self.api_requests_shed = 0
        # the same split per SLO class: requests_shed_by_class on the device
        # thread, api_requests_shed_by_class on the event loop (note_api_shed)
        self.requests_shed_by_class = {"interactive": 0, "batch": 0}
        self.api_requests_shed_by_class = {"interactive": 0, "batch": 0}
        # recent shed times, for the flight recorder's shed-burst dump
        self._shed_times: collections.deque = collections.deque(maxlen=64)
        # SLO terminal records, one per finished request (and per API shed),
        # with a cursor the router scrapes by; appended by the device thread
        # and, for API sheds, the event loop (deque appends and the counter
        # are atomic)
        self.slo_records: collections.deque = collections.deque(maxlen=2048)
        self._slo_seq = itertools.count(1)
        # recent interactive ok requests' TTFT and inter-token p99, behind the
        # interactive_{ttft,itl}_p99_ms gauges
        self._interactive_ttft_ms: collections.deque = collections.deque(maxlen=64)
        self._interactive_itl_ms: collections.deque = collections.deque(maxlen=64)
        self._sleeping = False
        self._sleep_level = 0
        # arrival -> first prefill dispatch, ms (the ttft_hop_admission_wait
        # gauge)
        self.admission_wait_ms: collections.deque = collections.deque(maxlen=2048)
        self._inline_seconds = 0.0
        self.loop_seconds = {"wait": 0.0, "schedule": 0.0, "step": 0.0, "apply": 0.0, "emit": 0.0,
                             "chain_dispatch": 0.0, "chain_fetch": 0.0}
        self.step_idx = 0

    # -- admission control --------------------------------------------------

    def saturated(self, priority: str = "interactive") -> bool:
        return self.scheduler.saturated(priority)

    def shed_retry_after(self) -> float:
        return max(0.0, self.cfg.shed_retry_after_s)

    def can_shed_queued(self) -> bool:
        return self.scheduler.queue_deadline_s > 0 or self.scheduler.max_waiting_seqs > 0

    def _make_offload_connector(self, cfg: EngineConfig) -> Optional[KVOffloadConnector]:
        """The offload connector when any tier or the KV-index controller is
        configured (with the controller alone it only reports). A
        disaggregated-prefill consumer always gets a CPU tier: received KV
        lands there before admission restores it into the pool."""
        if cfg.kv_role == "consumer" and cfg.kv_offload_cpu_gb <= 0:
            cfg = dataclasses.replace(cfg, kv_offload_cpu_gb=2.0)
        if not (
            cfg.kv_offload_cpu_gb > 0 or cfg.kv_offload_dir or cfg.kv_remote_url or cfg.kv_controller_url
            or cfg.kv_directory_url
        ):
            return None
        return KVOffloadConnector(
            self.runner,
            cpu_bytes=int(cfg.kv_offload_cpu_gb * 1e9),
            disk_path=cfg.kv_offload_dir,
            disk_bytes=int(cfg.kv_offload_disk_gb * 1e9) if cfg.kv_offload_dir else 0,
            remote_url=cfg.kv_remote_url,
            serde=cfg.kv_serde,
            controller_url=cfg.kv_controller_url,
            instance_id=cfg.kv_instance_id or f"{cfg.name}-{cfg.port}",
            engine_url=self._advertised_url(cfg),
        )

    def _boot_prefetch(self, cfg: EngineConfig) -> int:
        """The scale-up prefetch: ask the cache server for the fleet's top
        warm chunks (``dir_top_prefixes``, chain heads first) and pull their
        blobs into the local tiers. Runs while the engine is built, before
        the server reports ready. Never raises: a directory that is down
        means a cold boot."""
        try:
            from production_stack_tpu_torch.kvoffload.protocol import BlockingClient, parse_hostport

            host, port = parse_hostport(cfg.kv_directory_url, default_port=8200)
            client = BlockingClient(host, port, timeout=10)
            try:
                hdr, _ = client.request({
                    "op": "dir_top_prefixes",
                    "limit": cfg.warm_prefetch_on_boot,
                    "page_size": cfg.page_size,
                })
            finally:
                client.close()
            keys = hdr.get("hashes") or []
            store = self._offload.store
            n = 0
            for key in keys:
                try:
                    if store.contains_local(key) or store.get(key) is not None:
                        n += 1
                except Exception:  # noqa: BLE001 - one bad blob: keep pulling
                    logger.exception("boot prefetch failed for %s", key)
            logger.info("warm prefetch on boot: pulled %d/%d fleet-warm chunks into local tiers", n, len(keys))
            return n
        except Exception as e:  # noqa: BLE001 - a directory that is down means a cold boot
            logger.warning("warm prefetch on boot failed: %s", e)
            return 0

    @staticmethod
    def _advertised_url(cfg: EngineConfig) -> str:
        """The URL other pods (the router, the KV controller's clients) reach
        this engine at. A wildcard bind address would never match a
        discovered endpoint, so it resolves to the host name's address."""
        host = cfg.advertise_host or cfg.host
        if host in ("0.0.0.0", "::", ""):
            import socket

            try:
                host = socket.gethostbyname(socket.gethostname())
            except OSError:
                host = "127.0.0.1"
            if cfg.kv_controller_url or cfg.kv_directory_url:
                logger.warning(
                    "--advertise-host not set; registering with the KV index as %s "
                    "(set it to the pod IP for kvaware routing)", host,
                )
        return f"http://{host}:{cfg.port}"

    def _note_shed(self, reason: str, seq: Optional[Sequence] = None) -> None:
        """The flight recorder's shed event and the shed-burst dump: a burst
        of sheds is the overload postmortem moment. Called from the loop
        thread (engine sheds) and the event loop (API sheds)."""
        fr = self._fr
        now = time.monotonic()
        self._shed_times.append(now)
        if not fr.enabled:
            return
        fr.record(
            "shed", step=self.step_idx, reason=reason,
            seq_id=seq.seq_id if seq is not None else None,
            waiting=self.scheduler.num_waiting(),
            running=self.scheduler.num_running(),
            trace_id=getattr(seq.trace if seq is not None else None, "trace_id", None),
        )
        burst = self.cfg.flight_recorder_shed_burst
        if burst > 0 and sum(1 for t in list(self._shed_times) if now - t <= 5.0) >= burst:
            # off-thread: neither caller may pay the ring's serialization
            fr.dump_async("shed_burst")

    def _shed(self, seq: Sequence, reason: str) -> None:
        self.scheduler._finish(seq, "shed")
        self.requests_shed[reason] += 1
        self.requests_shed_by_class[_slo_class(seq.priority)] += 1
        self._note_shed(reason, seq)
        self._emit(seq, "")

    def note_api_shed(self, request_id: Optional[str] = None, priority: str = "interactive") -> None:
        """A request the API layer shed before any sequence existed: its
        per-class count, a flight-recorder event and its SLO terminal record
        (event loop only)."""
        priority = _slo_class(priority)
        self.api_requests_shed_by_class[priority] += 1
        self._note_shed("api_queue_full")
        self.slo_records.append({
            "seq": next(self._slo_seq),
            "request_id": request_id or "unknown",
            "model": self.cfg.name,
            "outcome": "shed",
            "finish_reason": "shed",
            "priority": priority,
            "queue_ms": 0.0,
            "ttft_ms": None,
            "e2e_ms": None,
            "prompt_tokens": 0,
            "output_tokens": 0,
            "cached_tokens": 0,
            "itl_p99_ms": None,
            "kv_pages_peak": 0,
            "trace_id": None,
            "t": time.time(),
        })

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run_loop, daemon=True, name="engine-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._inbox.put(None)
        if self._thread:
            self._thread.join(timeout=10)
        if self._kvdir_pub is not None:
            self._kvdir_pub.stop()
        if self._kv_sender is not None:
            self._kv_sender.close()
        if self._kv_receiver is not None:
            self._kv_receiver.stop()
            if self._kv_receiver.staging is not None:
                self._kv_receiver.staging.clear()
        if self.runner.kv_endpoint is not None:
            self.runner.kv_endpoint.close()
        if self._fabric_server is not None:
            self._fabric_server.stop()
        if self._fabric_client is not None:
            self._fabric_client.close()
        if self._offload is not None:
            self._offload.stop()  # the controller reporter deregisters
        if self._tp is not None:
            self._tp.close()  # the followers leave their loops and exit

    # -- request api (asyncio side) -----------------------------------------

    async def generate(
        self,
        seq_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[list[int]] = None,
        params: Optional[SamplingParams] = None,
        priority: str = "interactive",
        lora_name: Optional[str] = None,
        trace: Optional[object] = None,
        shed_exempt: bool = False,
        text_context: Optional[list[int]] = None,
    ) -> AsyncIterator[RequestOutput]:
        """Stream a request's outputs. ``trace``: the tracing.SpanContext
        its phase spans parent under (the server's engine.request span).
        ``shed_exempt`` and ``text_context``: a migrated continuation, which
        admission control must not shed, and the ids its earlier legs
        emitted (the tail of ``prompt_token_ids``), whose text its own
        deltas follow on from."""
        params = params or SamplingParams()
        if priority not in ("interactive", "batch"):
            priority = "interactive"
        if lora_name and self.lora is None:
            raise ValueError("LoRA is not enabled (--enable-lora)")
        if prompt_token_ids is None:
            prompt_token_ids = self.tokenizer.encode(prompt or "")
        if not prompt_token_ids:
            if self.tokenizer.bos_token_id is None:
                # an HF tokenizer without BOS (Qwen2's): a None id would
                # stop the engine loop at its next schedule
                raise ValueError("the prompt is empty and the tokenizer has no BOS token to start from")
            prompt_token_ids = [self.tokenizer.bos_token_id]
        if len(prompt_token_ids) + 1 > self.cfg.max_model_len:
            raise ValueError(
                f"prompt has {len(prompt_token_ids)} tokens, max_model_len is "
                f"{self.cfg.max_model_len}"
            )
        if self._sleeping:
            raise RuntimeError("engine is sleeping")
        if self._kvdir_pull is not None and not lora_name:
            # the fleet-warm pull: the directory's restorable prefix blobs
            # into the local tiers before the sequence reaches the
            # scheduler, so the loop thread's restore reads them locally.
            # A hint, never a gate (its own timeout and backoff); adapter
            # prompts are salted and never shared across the fleet
            try:
                await self._kvdir_pull.maybe_prefetch(prompt_token_ids)
            except Exception:  # noqa: BLE001 - a failed pull means a prefill
                logger.exception("kv directory prefetch failed")
        lora_slot, cache_salt = 0, b""
        if lora_name:
            # resolve and pin last before the sequence is queued: every
            # later path runs inside the try/finally that releases it
            lora_slot, cache_salt = self.lora.acquire(lora_name)
        out_q: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        text_context = list(text_context or [])
        with self._lock:
            self._outputs[seq_id] = (loop, out_q)
            # what the earlier legs sent: their text, held back as they held it
            self._texts[seq_id] = self._held(self.tokenizer.decode(text_context), params.stop) if text_context else ""
        self._inbox.put(Sequence(
            seq_id=seq_id, prompt_ids=list(prompt_token_ids), params=params,
            priority=priority, lora_slot=lora_slot, cache_salt=cache_salt, trace=trace,
            shed_exempt=shed_exempt, text_context=text_context,
        ))
        try:
            while True:
                item = await out_q.get()
                yield item
                if item.finished:
                    break
        finally:
            with self._lock:
                self._outputs.pop(seq_id, None)
                self._texts.pop(seq_id, None)
            if lora_slot:
                self.lora.release(lora_slot)
            self._inbox.put(("abort", seq_id))

    def abort(self, seq_id: str) -> None:
        self._inbox.put(("abort", seq_id))

    # -- engine loop (device thread) ----------------------------------------

    def _drain_inbox(self, block: bool, defer_aborts: bool = False) -> list:
        """Take the queued arrivals, aborts and device commands. With
        ``defer_aborts`` (run-ahead, while a chain is in flight) aborts and
        device commands are returned instead of applied: an abort frees the
        sequence's pages, and a page that a dispatched, unfetched chain
        still writes must not go to a run-ahead admission; a command (a
        migration's freeze, a sleep) must not change the running set or the
        pools under the chain, whose bursts are applied after this drain.
        The caller queues them again; they run at the next ordinary drain,
        after the chain was applied."""
        deferred: list = []
        timeout = 0.5 if block else None
        while True:
            try:
                item = self._inbox.get(block=block, timeout=timeout)
            except queue_mod.Empty:
                return deferred
            block = False
            if item is None:
                return deferred
            if isinstance(item, tuple) and item[0] == "device_cmd":
                if defer_aborts:
                    deferred.append(item)
                    continue
                item[1]()  # embedding forward / sleep / wake / migration, serialized with steps
            elif isinstance(item, tuple) and item[0] == "abort":
                if defer_aborts:
                    deferred.append(item)
                    continue
                # a frozen sequence (mid-migration) is in no scheduler
                # queue; an abort (the client left during the handoff) must
                # still free it
                frozen = self._frozen.pop(item[1], None)
                if frozen is not None and not frozen.finished:
                    self.scheduler._finish(frozen, "abort")
                    self._emit(frozen, "")
                for s in self.scheduler.waiting + self.scheduler.running:
                    if s.seq_id == item[1] and not s.finished:
                        self.scheduler._finish(s, "abort")
                        # a consumer may still wait on its queue (POST /abort)
                        self._emit(s, "")
            else:
                self._accept(item)

    def _accept(self, seq: Sequence) -> None:
        self._arrival_times.append(time.monotonic())
        if self._sleeping:
            # generate() checked the flag on the event loop just before
            # sleep set it here: answer the request, do not park it
            seq.finished = True
            self._emit(seq, "", error=True)
        elif self.scheduler.saturated(seq.priority) and not seq.shed_exempt:
            # authoritative queue bound: the API layer's check races a
            # burst of arrivals the inbox has not drained yet (a migrated
            # continuation is mid-flight: shedding it would drop a stream)
            self._shed(seq, "queue_full")
        else:
            self.scheduler.add(seq)

    def _recent_arrival_rate(self, window: float = 1.0) -> float:
        """Arrivals per second over the trailing ``window`` seconds."""
        now = time.monotonic()
        n = 0
        for t in reversed(self._arrival_times):
            if now - t > window:
                break
            n += 1
        return n / window

    def _step_input(self, batch) -> StepInput:
        inp = StepInput(
            batch.input_ids, batch.positions, batch.page_table, batch.kv_lens,
            batch.temperature, batch.top_k, batch.top_p, kv_limits=batch.kv_limits,
            lora_ids=batch.lora_ids,
        )
        pad = len(batch.kv_lens) - len(batch.seqs)
        if batch.want_penalties:
            inp.history = batch.history
            inp.prompt_lens = batch.prompt_lens
            inp.presence = np.array([s.params.presence_penalty for s in batch.seqs] + [0.0] * pad, np.float32)
            inp.frequency = np.array([s.params.frequency_penalty for s in batch.seqs] + [0.0] * pad, np.float32)
            inp.repetition = np.array([s.params.repetition_penalty for s in batch.seqs] + [1.0] * pad, np.float32)
        # rows under their min_tokens floor get EOS masked out of the draw
        # for every token of this dispatch (vLLM semantics; the scheduler's
        # finish gate stays the exact backstop)
        eos = self.tokenizer.eos_token_id

        def eos_ban(s):
            return not s.params.ignore_eos and len(s.output_ids) < s.params.min_tokens

        if any(s.params.logit_bias or eos_ban(s) for s in batch.seqs):
            need = max(len(s.params.logit_bias or {}) + eos_ban(s) for s in batch.seqs)
            K = 8
            while K < need:
                K *= 2
            V = self.model_cfg.vocab_size
            bias_ids = np.full((len(batch.kv_lens), K), V, np.int32)  # V = unused slot
            bias_vals = np.zeros((len(batch.kv_lens), K), np.float32)
            for i, s in enumerate(batch.seqs):
                entries = list((s.params.logit_bias or {}).items())
                if eos_ban(s):
                    entries.append((eos, -1e9))
                for j, (tid, bv) in enumerate(entries):
                    bias_ids[i, j], bias_vals[i, j] = tid, bv
            inp.bias_ids, inp.bias_vals = bias_ids, bias_vals
        return inp

    def _dispatch(self, batch):
        """Run one scheduled batch; returns (tokens, lp_data, fetched).
        An all-intermediate prefill is not fetched (its tokens are -1s), and
        a chain without logprobs is applied and streamed group by group here
        (tokens None)."""
        inp = self._step_input(batch)
        runner = self.runner
        sched = self.scheduler
        wlp = batch.want_logprobs
        if batch.kind == "decode" and sched.spec_k and batch.history is not None:
            tokens = runner.step_spec(
                inp, batch.history, sched.decode_steps, sched.spec_k, sched.spec_ngram
            ).cpu().numpy()  # [B, steps, 1 + spec_k], -1 where nothing was emitted
            emitted = tokens >= 0
            rounds = int(emitted.any(axis=2).sum())
            self.spec_verify_forwards += sched.decode_steps
            self.spec_draft_tokens += rounds * sched.spec_k
            # each round emits its accepted drafts and one bonus token
            self.spec_accepted_tokens += int(emitted.sum()) - rounds
            return tokens, None, True
        if batch.kind == "decode" and sched.decode_steps > 1:
            self.decode_dispatches_total += 1
            if batch.bursts > 1:
                return self._chain(batch, inp)
            if wlp:
                toks, lps = runner.step_multi(inp, sched.decode_steps, True)
                return toks.cpu().numpy(), tuple(x.cpu().numpy() for x in lps), True
            return runner.step_multi(inp, sched.decode_steps).cpu().numpy(), None, True
        if batch.kind == "prefill" and not any(
            s.num_computed + c >= len(s.prompt_ids)
            for s, c in zip(batch.seqs, batch.chunk_sizes)
        ):
            # every chunk is intermediate: the sampled tokens are discarded,
            # so nothing is fetched (the launches queue behind each other)
            runner.step(inp, want_logits=False)
            self._unfetched.append(batch)
            return np.full((len(batch.seqs),), -1, np.int32), None, False
        if wlp:
            ids, _, lps = runner.step(inp, want_logprobs=True, want_logits=False)
            return ids.cpu().numpy(), tuple(x.cpu().numpy()[:, None] for x in lps), True
        ids, _ = runner.step(inp, want_logits=False)
        return ids.cpu().numpy(), None, True

    def _chain(self, batch, inp):
        """A chained decode dispatch of ``batch.bursts`` bursts. With
        logprobs the whole chain is fetched at once and returned. Without,
        each group of four bursts is copied to the host as its bursts end;
        meanwhile the prefill chunks of new arrivals are dispatched behind
        the chain (run-ahead), then every group is applied and streamed as
        it lands, then the run-ahead's final chunk. A row that finishes
        mid-chain keeps computing masked tokens that are discarded, and its
        freed pages go to no one before the next ``schedule()`` (this
        thread)."""
        self.decode_chained_dispatches_total += 1
        steps = self.scheduler.decode_steps
        wlp = batch.want_logprobs
        t_chain = time.perf_counter()
        outs = self.runner.step_multi_pipelined(inp, steps, batch.bursts, wlp, fetch_group=0 if wlp else 4)
        t_disp = time.perf_counter()
        self.loop_seconds["chain_dispatch"] += t_disp - t_chain
        inline = 0.0
        if wlp:
            tokens = torch.cat([o[0] for o in outs], dim=1).cpu().numpy()
            lp_data = tuple(torch.cat([o[1][x] for o in outs], dim=1).cpu().numpy() for x in range(3))
            result = (tokens, lp_data, True)
        else:
            ra_done, ra_inter = self._runahead_prefills(batch)
            ae0 = self.loop_seconds["apply"] + self.loop_seconds["emit"]
            for group in outs:
                self._apply_and_emit(batch, group.numpy())
            # the chain's fetches retire what was queued before it; the
            # run-ahead's intermediate chunks came after, so they stay
            # suspect until a later fetch (the run-ahead's final chunk is one)
            self._unfetched = ra_inter
            for ra, ids in ra_done:
                self._apply_and_emit(ra, ids.cpu().numpy())
            if ra_done:
                self._unfetched = []
            inline = self.loop_seconds["apply"] + self.loop_seconds["emit"] - ae0
            self._inline_seconds += inline
            result = (None, None, False)
        self.loop_seconds["chain_fetch"] += time.perf_counter() - t_disp - inline
        # per-burst wall time, apply and emit included: a mild overestimate
        # that errs toward shorter chains and so toward a shorter admission
        # wait under arrivals
        dt = (time.perf_counter() - t_chain) / batch.bursts
        self._burst_seconds = 0.7 * self._burst_seconds + 0.3 * dt
        return result

    @staticmethod
    def _runahead_allowed(s: Sequence) -> bool:
        """Rows whose prefill needs no penalty, logit-bias, EOS-ban or
        logprob staging: the run-ahead dispatch stages none; the others wait
        for the normal path."""
        return (
            not s.params.wants_penalties
            and s.params.logprobs is None
            and not s.params.logit_bias
            and (s.params.ignore_eos or len(s.output_ids) >= s.params.min_tokens)
        )

    def _runahead_prefills(self, chain_batch):
        """Dispatch prefill chunks of sequences outside an in-flight chain,
        queued behind its bursts on the device. Returns (final dispatches to
        fetch, intermediate batches). Stops at the first dispatch holding a
        final chunk, so one fetch retires every intermediate before it.
        Aborts that arrive meanwhile are queued again here, before anything
        can raise: they run at the next ordinary drain, after the chain was
        applied."""
        for item in self._drain_inbox(block=False, defer_aborts=True):
            self._inbox.put(item)
        ra_done: list = []
        ra_inter: list = []
        if self._sleeping:
            return ra_done, ra_inter
        exclude = {id(s) for s in chain_batch.seqs}
        for _ in range(4):  # bound the work queued behind one chain
            ra = self.scheduler.schedule_prefill_runahead(exclude, allow=self._runahead_allowed)
            if ra is None:
                break
            self._record_sched(ra)
            self._note_first_dispatch(ra)
            self.runahead_prefill_dispatches_total += 1
            inp = self._step_input(ra)
            if not any(s.num_computed + c >= len(s.prompt_ids) for s, c in zip(ra.seqs, ra.chunk_sizes)):
                # all intermediate: not fetched, progress applied now so the
                # next plan sees it
                self.runner.step(inp, want_logits=False)
                self._unfetched.append(ra)
                ra_inter.append(ra)
                self._apply_and_emit(ra, np.full((len(ra.seqs),), -1, np.int32))
            else:
                ids, _ = self.runner.step(inp, want_logits=False)
                ra_done.append((ra, ids))
                break
        return ra_done, ra_inter

    def _record_sched(self, batch) -> None:
        """The flight recorder's "sched" event: the batch and the queue
        depths, stamped with the step index and the members' trace ids, so
        a slow request's spans cross-link to the dispatches that served it."""
        self.step_idx += 1
        if not self._fr.enabled:
            return
        trace_ids = [
            s.trace.trace_id for s in batch.seqs
            if s.trace is not None and getattr(s.trace, "sampled", False)
        ][:4]
        self._fr.record(
            "sched", step=self.step_idx, batch_kind=batch.kind,
            tp=self.tensor_parallel,
            rows=len(batch.seqs), bursts=batch.bursts,
            chunk_tokens=sum(batch.chunk_sizes) if batch.chunk_sizes else 0,
            seq_ids=[s.seq_id for s in batch.seqs[:8]],
            trace_ids=trace_ids,
            gate=getattr(self.scheduler, "last_gate", None),
            running=self.scheduler.num_running(),
            waiting=self.scheduler.num_waiting(),
            kv_usage=round(self.kv.usage(), 4),
            trace_id=trace_ids[0] if trace_ids else None,
        )

    def _note_first_dispatch(self, batch) -> None:
        """The admission wait (arrival -> first prefill dispatch) of rows
        reaching the device for the first time, in the loop or run ahead."""
        if batch.kind != "prefill":
            return
        now = time.monotonic()
        for s in batch.seqs:
            if s.first_dispatch_time is None:
                s.first_dispatch_time = now
                self.admission_wait_ms.append((now - s.arrival_time) * 1000)

    def _run_loop(self) -> None:
        logger.info("engine loop started (model=%s)", self.cfg.name)
        while not self._stop.is_set():
            t_sec = time.perf_counter()
            self._drain_inbox(block=not self.scheduler.has_work())
            for s in self.scheduler.expired_waiting():
                if not s.shed_exempt:
                    self._shed(s, "queue_deadline")
            if self.warm is not None:
                # the periodic manifest (crash protection): in an idle loop
                # turn, forced past twice the interval
                self.warm.maybe_spill(busy=self.scheduler.has_work())
            # the adaptive chain depth's inputs (scheduler.schedule)
            sched = self.scheduler
            sched.arrival_rate = self._recent_arrival_rate()
            sched.burst_seconds = self._burst_seconds
            sched.last_arrival_age = (
                time.monotonic() - self._arrival_times[-1] if self._arrival_times else float("inf")
            )
            t0 = time.perf_counter()
            self.loop_seconds["wait"] += t0 - t_sec
            batch = sched.schedule()
            self.loop_seconds["schedule"] += time.perf_counter() - t0
            if batch is None:
                continue
            self._record_sched(batch)
            self._note_first_dispatch(batch)
            t_step = time.perf_counter()
            # apply and emit seconds a chain spends inline, kept out of the
            # step section so the sections stay disjoint
            self._inline_seconds = 0.0
            try:
                tokens, lp_data, fetched = self._dispatch(batch)
            except Exception as step_err:
                logger.exception("engine step failed; aborting batch")
                self._fr.record(
                    "error", step=self.step_idx, batch_kind=batch.kind,
                    error=repr(step_err)[:500],
                )
                self._fr.dump("engine_step_error", force=True)
                if self._tp is not None:
                    # the ranks' collectives are out of step (a rank may be
                    # gone): serving on would hang or give garbage
                    logger.critical("fatal with dp/tp ranks: exiting")
                    os._exit(13)
                # a deferred device error may belong to an unfetched
                # prefill dispatch: those sequences' KV is suspect too
                suspect = list(batch.seqs)
                for b in self._unfetched:
                    suspect.extend(b.seqs)
                self._unfetched.clear()
                for s in suspect:
                    if not s.finished:
                        self.scheduler._finish(s, "error")
                        self._emit(s, "", error=True)
                continue
            step_wall = time.perf_counter() - t_step - self._inline_seconds
            self.loop_seconds["step"] += step_wall
            self._fr.record(
                "step", step=self.step_idx, batch_kind=batch.kind,
                wall_ms=round(step_wall * 1000, 3), bursts=batch.bursts, fetched=fetched,
            )
            if fetched:
                self._unfetched.clear()  # a fetch retires earlier dispatches
                # a fetched prefill's wall is its chunk's device time (an
                # unfetched one's is only its enqueue); a decode burst's per
                # token while a prefill is resident is the interleave cost
                if batch.kind == "prefill":
                    tracing.prefill_chunk_hist.observe(step_wall)
                elif batch.kind == "decode" and any(s.in_prefill for s in self.scheduler.running):
                    tracing.interleaved_decode_hist.observe(
                        step_wall / max(1, self.scheduler.decode_steps * batch.bursts)
                    )
            if tokens is not None:
                self._apply_and_emit(batch, tokens, lp_data)
        logger.info("engine loop exited")

    def _apply_and_emit(self, batch, tokens, lp_data=None) -> None:
        """Apply one fetched token matrix to scheduler state and stream the
        resulting deltas: one RequestOutput per sequence per dispatch,
        carrying every new token of a burst."""
        t_apply = time.perf_counter()
        events = self.scheduler.apply_step(batch, tokens, self.tokenizer.eos_token_id)
        if batch.kind == "prefill":
            self.total_prompt_tokens += sum(batch.chunk_sizes)
        if self._kv_sender is not None:
            # ship KV before emitting the finish event: the prefill HTTP
            # response must not return until the decode peer holds the KV
            pushed = set()
            for s, _, _, _ in events:
                if s.finished and s.seq_id not in pushed:
                    pushed.add(s.seq_id)
                    self._push_finished_kv(s)
        t_emit = time.perf_counter()
        self.loop_seconds["apply"] += t_emit - t_apply
        grouped: dict[str, tuple[Sequence, list[int], list]] = {}
        for s, tok, i, j in events:
            g = grouped.setdefault(s.seq_id, (s, [], []))
            g[1].append(tok)
            if lp_data is not None and s.params.logprobs is not None:
                n = min(s.params.logprobs, lp_data[1].shape[2])
                g[2].append({
                    "logprob": float(lp_data[0][i, j]),
                    "top_ids": lp_data[1][i, j, :n].tolist(),
                    "top_logprobs": lp_data[2][i, j, :n].tolist(),
                })
        for s, toks, lps in grouped.values():
            self.total_generation_tokens += len(toks)
            self._process_token(s, toks, lps or None)
        self.loop_seconds["emit"] += time.perf_counter() - t_emit

    def _process_token(
        self, seq: Sequence, new_tokens: list[int], logprobs: Optional[list] = None
    ) -> None:
        """Detokenize incrementally, check stop strings, emit the delta (one
        token or a whole decode burst; ``logprobs`` aligns with
        ``new_tokens`` when requested)."""
        ctx = seq.text_context
        raw = full = self.tokenizer.decode(ctx + seq.output_ids)
        if not seq.finished:
            full = self._held(full, seq.params.stop)
        with self._lock:
            prev = self._texts.get(seq.seq_id, "")
        delta = full[len(prev):] if full.startswith(prev) else full
        if seq.params.stop and any(s in raw for s in seq.params.stop):
            # stop at the FIRST token prefix whose text holds a stop string,
            # exactly where a one-token-per-step engine would
            base = len(seq.output_ids) - len(new_tokens)
            hit = None  # (keep, text_at_keep, stop_index)
            for m in range(1, len(new_tokens) + 1):
                txt = self.tokenizer.decode(ctx + seq.output_ids[: base + m])
                for stop in seq.params.stop:
                    idx = txt.find(stop)
                    if idx >= 0:
                        hit = (m, txt, idx)
                        break
                if hit:
                    break
            if hit:
                keep, txt, idx = hit
                delta = txt[len(prev): idx] if txt.startswith(prev) else txt[:idx]
                del seq.output_ids[base + keep:]
                self.total_generation_tokens -= len(new_tokens) - keep
                new_tokens = new_tokens[:keep]
                if logprobs is not None:
                    logprobs = logprobs[:keep]
                if not seq.finished:
                    self.scheduler._finish(seq, "stop")
                elif seq.finish_reason == "length":
                    seq.finish_reason = "stop"
        with self._lock:
            # presence-gated: generate()'s finally may have popped the entry
            if seq.seq_id in self._texts:
                self._texts[seq.seq_id] = prev + delta
        self._emit(seq, delta, tokens=new_tokens, logprobs=logprobs)

    @staticmethod
    def _held(full: str, stop) -> str:
        """The text a stream has sent so far out of ``full``: a trailing
        incomplete byte sequence is held back until later tokens complete
        it, and a trailing partial stop-string match, so the emitted text
        does not depend on where a dispatch ends (both flush on the
        finishing emit)."""
        full = full.rstrip("�")
        hold = 0
        for s in stop or ():
            for j in range(min(len(s) - 1, len(full)), hold, -1):
                if full.endswith(s[:j]):
                    hold = j
                    break
        return full[: len(full) - hold] if hold else full

    def _emit(
        self,
        seq: Sequence,
        delta: str,
        tokens: Optional[list[int]] = None,
        error: bool = False,
        logprobs: Optional[list] = None,
    ) -> None:
        if tokens:
            # inter-token gaps for the SLO record: a burst of k tokens adds
            # its gap / k, capped at 4,096 samples a request
            now_m = time.monotonic()
            if seq.last_emit_time is not None and len(seq.itl_samples) < 4096:
                seq.itl_samples.append((now_m - seq.last_emit_time) / len(tokens))
            seq.last_emit_time = now_m
        if seq.finished and not seq.trace_done:
            try:
                self._record_phase_trace(seq)
            except Exception:  # noqa: BLE001 - observability never fails a request
                logger.exception("phase trace recording failed")
        if seq.finished and not seq.slo_done:
            self._record_slo(seq, error=error)
        with self._lock:
            entry = self._outputs.get(seq.seq_id)
        if entry is None:
            return
        loop, out_q = entry
        out = RequestOutput(
            seq_id=seq.seq_id,
            text_delta=delta,
            token_ids=(
                tokens if tokens is not None
                else [seq.output_ids[-1]] if seq.output_ids else []
            ),
            finished=seq.finished,
            finish_reason=("error" if error else seq.finish_reason) if seq.finished else None,
            prompt_tokens=len(seq.prompt_ids),
            completion_tokens=len(seq.output_ids),
            cached_tokens=seq.num_cached,
            logprobs=logprobs,
        )
        loop.call_soon_threadsafe(out_q.put_nowait, out)

    def _record_phase_trace(self, seq: Sequence) -> None:
        """The finished request's phase histograms and, when it carries a
        sampled trace context, its spans, from the times the scheduler
        keeps: arrival -> first dispatch (engine.queue), first dispatch ->
        first token (engine.prefill), first token -> finish (engine.decode).
        Runs once per request, at its finish."""
        seq.trace_done = True
        now_m = time.monotonic()
        anchor = time.time() - now_m  # monotonic -> wall clock
        end = seq.finish_time or now_m
        fd, ft = seq.first_dispatch_time, seq.first_token_time
        queue_s = max(0.0, (fd if fd is not None else end) - seq.arrival_time)
        prefill_s = max(0.0, ft - fd) if fd is not None and ft is not None else 0.0
        decode_s = max(0.0, end - ft) if ft is not None else 0.0
        steps = len(seq.output_ids)
        tracing.queue_time_hist.observe(queue_s)
        if fd is not None and ft is not None:
            tracing.prefill_time_hist.observe(prefill_s)
        if ft is not None and steps > 1:
            tracing.decode_step_time_hist.observe(decode_s / (steps - 1))
        tr = seq.trace
        if tr is None or not getattr(tr, "sampled", False):
            return
        col = tracing.get_collector()
        # the scheduler made the phase contexts at admission, so offload
        # spill and restore spans nest under the phase whose window holds them
        col.record("engine.queue", seq.queue_span or tr.child(), anchor + seq.arrival_time, queue_s,
                   seq_id=seq.seq_id)
        if fd is not None and ft is not None:
            col.record(
                "engine.prefill", seq.prefill_span or tr.child(), anchor + fd, prefill_s,
                seq_id=seq.seq_id, prompt_tokens=len(seq.prompt_ids), cached_tokens=seq.num_cached,
            )
        if ft is not None:
            attrs = {"seq_id": seq.seq_id, "output_tokens": steps, "finish_reason": seq.finish_reason}
            if steps > 1:
                attrs["per_token_ms"] = round(decode_s / (steps - 1) * 1000, 3)
            if seq.lora_slot:
                attrs["lora_slot"] = seq.lora_slot  # the adapter slot that served the decode
            if self.cfg.speculative_k:
                attrs["spec_k"] = self.cfg.speculative_k
            col.record("engine.decode", seq.decode_span or tr.child(), anchor + ft, decode_s, **attrs)

    def _record_slo(self, seq: Sequence, error: bool = False) -> None:
        """Append the finished request's SLO terminal record (queue wait,
        TTFT, token counts, inter-token p99, peak KV pages, outcome) to
        ``slo_records``, and an ok interactive request's latencies to the
        interactive windows."""
        seq.slo_done = True
        end = seq.finish_time or time.monotonic()
        fd, ft = seq.first_dispatch_time, seq.first_token_time
        reason = "error" if error else (seq.finish_reason or "error")
        outcome = "ok" if reason in ("stop", "length", "tool_calls") else reason
        itl_p99_ms = None
        if seq.itl_samples:
            srt = sorted(seq.itl_samples)
            itl_p99_ms = round(srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1000, 3)
        ttft_ms = round((ft - seq.arrival_time) * 1000, 3) if ft is not None else None
        rec = {
            "seq": next(self._slo_seq),
            "request_id": seq.seq_id,
            "model": self.cfg.name,
            "outcome": outcome,
            "finish_reason": reason,
            "queue_ms": round(((fd if fd is not None else end) - seq.arrival_time) * 1000, 3),
            "ttft_ms": ttft_ms,
            "e2e_ms": round((end - seq.arrival_time) * 1000, 3),
            "prompt_tokens": len(seq.prompt_ids),
            "output_tokens": len(seq.output_ids),
            "cached_tokens": seq.num_cached,
            "itl_p99_ms": itl_p99_ms,
            "kv_pages_peak": seq.pages_peak,
            "trace_id": getattr(seq.trace, "trace_id", None),
            "priority": seq.priority,
            "t": time.time(),
        }
        self.slo_records.append(rec)
        if outcome == "ok" and rec["priority"] == "interactive":
            if ttft_ms is not None:
                self._interactive_ttft_ms.append(ttft_ms)
            if itl_p99_ms is not None:
                self._interactive_itl_ms.append(itl_p99_ms)
        fr = self._fr
        if fr.enabled:
            fr.record(
                "slo", step=self.step_idx, trace_id=rec["trace_id"], request_id=seq.seq_id, outcome=outcome,
                ttft_ms=ttft_ms, itl_p99_ms=itl_p99_ms, output_tokens=rec["output_tokens"],
            )
            watermark = self.cfg.flight_recorder_ttft_watermark_ms
            if watermark > 0 and ttft_ms is not None and ttft_ms > watermark:
                fr.dump_async("ttft_breach")  # off the loop thread

    # -- disaggregated prefill and the KV fabric ------------------------------

    def _arm_device_kv(self) -> None:
        """Wire the runner's CUDA IPC endpoint into the role: a producer
        offers pages through it (one producer process, one consumer
        process), a consumer pulls them into device staging, which admission
        consults before the host tiers."""
        from production_stack_tpu_torch.kvoffload.transfer import DeviceStaging

        ep = self.runner.kv_endpoint
        if self._kv_sender is not None:
            self._kv_sender.enable_device(ep.address, self.runner.kv_offer_page, ep.retire)
        if self._kv_receiver is not None:
            staging = DeviceStaging(self.cfg.kv_transfer_stage_mb << 20, on_expire=self.runner.kv_unstage_page)
            self._offload.device_staging = staging
            self._kv_receiver.staging = staging
            self._kv_receiver.pull_fn = self.runner.kv_pull_page
            self._kv_receiver.unstage_fn = self.runner.kv_unstage_page

    def _push_finished_kv(self, seq: Sequence) -> None:
        """Producer role: push every hashed page of a finished sequence to the
        decode peer: over the fabric first, then per page device to device
        (fp pools) or as a TCP blob. Runs on the loop thread right after
        scheduler._finish registered the pages, so their ids are still valid
        (nothing else has allocated since)."""
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes

        hashes = list(prefix_hashes(seq.prompt_ids + seq.output_ids, self.kv.page_size, seq.cache_salt))
        if self._fabric_client is not None:
            # the whole chain as (pages, scales) frames; what the fabric
            # could not cover falls through to the per-page paths below
            # (counted on kv_fabric_fallbacks_total)
            hashes = self._fabric_stream_push(hashes)
        for h in hashes:
            pid = self.kv.hash_to_page.get(h)
            if pid is None:
                continue
            key = h.hex()
            if self._kv_sender.device_armed and not self.kv_quant:
                # the device path: the page is copied and offered only once
                # the consumer reserved staging for it; a refused or failed
                # page falls through to the TCP blob push
                kp = self.runner.k_pages
                page_nbytes = 2 * kp[:, 0].numel() * kp.element_size()
                if self._kv_sender.push_device(key, page_nbytes, pid):
                    continue
            blob = self._offload.store.get(key) if self._offload is not None else None
            if blob is None:
                if self.kv_quant:
                    # int8 pools ship their exact bytes and scales (serde v3)
                    ks, vs, sks, svs = self.runner.get_pages_quant([pid])
                    blob = get_serde("int8page").serialize_quant(ks[0], sks[0], vs[0], svs[0])
                else:
                    ks, vs = self.runner.get_pages([pid])
                    serde = self._offload.serde if self._offload is not None else get_serde(self.cfg.kv_serde)
                    blob = serde.serialize(ks[0], vs[0])
            self._kv_sender.push(key, blob)

    def _fabric_gather(self, keys: "list[str]"):
        """Resident pages for hex ``keys`` off the pools: (found_keys, ks,
        vs, sks, svs) host arrays, sks/svs None on fp pools. Runs on the
        loop thread (the runner's page calls run on every rank)."""
        found, pids = [], []
        for key in keys:
            try:
                pid = self.kv.hash_to_page.get(bytes.fromhex(key))
            except ValueError:
                pid = None
            if pid is not None:
                found.append(key)
                pids.append(pid)
        if not pids:
            return [], [], [], None, None
        if self.kv_quant:
            ks, vs, sks, svs = self.runner.get_pages_quant(pids)
            return found, ks, vs, sks, svs
        ks, vs = self.runner.get_pages(pids)
        return found, ks, vs, None, None

    def _fabric_pages(self, keys: "list[str]"):
        """The fabric listener's pull handler: resident pages for ``keys`` as
        one wire frame. Called on the listener's worker thread; the gather
        runs on the loop thread."""
        from production_stack_tpu_torch.kvfabric import wire as fabric_wire

        found, ks, vs, sks, svs = self._run_on_device_thread(lambda: self._fabric_gather(keys), what="fabric gather")
        if not found:
            return [], b""
        return found, fabric_wire.encode_frame(found, ks, vs, sks, svs, nlayers=int(ks[0].shape[0]))

    def _fabric_sink(self, frame: dict) -> int:
        """The fabric listener's push handler: assemble layer windows into
        whole pages and land them as local tier blobs, where admission's
        restore finds them. Quant frames keep their scales verbatim (a serde
        v3 blob)."""
        if self._offload is None:
            return 0
        stored = 0
        for key, (k, v, sk, sv) in self._fabric_asm.add(frame):
            if sk is not None:
                blob = get_serde("int8page").serialize_quant(k, sk, v, sv)
            else:
                blob = self._offload.serde.serialize(k, v)
            self._offload.store.put_local(key, blob)
            stored += 1
        return stored

    def _resolve_fabric_peer(self) -> Optional[str]:
        """The decode peer's fabric listener address. ``--kv-fabric-peer``
        is the address itself ("host:port") or the peer's HTTP URL, which
        GET /kv_fabric resolves (the peer may bind an ephemeral port).
        Cached; cleared after a fabric failure so the next push resolves
        again."""
        if self._fabric_peer_addr is not None:
            return self._fabric_peer_addr
        target = self.cfg.kv_fabric_peer
        if not target:
            return None
        addr = target
        if target.startswith("http"):
            try:
                import json
                import urllib.request

                with urllib.request.urlopen(target.rstrip("/") + "/kv_fabric", timeout=5) as r:
                    info = json.loads(r.read())
                addr = info.get("addr") if info.get("enabled", True) else None
            except Exception as e:  # noqa: BLE001 - the blob path covers it
                logger.warning("fabric peer resolve failed for %s: %s", target, e)
                addr = None
        self._fabric_peer_addr = addr
        return addr

    def _fabric_stream_push(self, hashes: list) -> list:
        """Streamed disagg prefill: ship a finished prefill's page chain to
        the decode peer as layer-windowed (pages, scales) frames
        (``--kv-fabric-stream-layers`` layers each), so the consumer lands
        pages before the last layer arrives. Returns the hashes NOT covered
        (no peer, gather or push failure): the per-page paths are their
        fallback, counted on kv_fabric_fallbacks_total."""
        addr = self._resolve_fabric_peer()
        if addr is None:
            return hashes
        from production_stack_tpu_torch.kvfabric import wire as fabric_wire

        try:
            found, ks, vs, sks, svs = self._fabric_gather([h.hex() for h in hashes])
        except Exception as e:  # noqa: BLE001 - fall back to TCP blobs
            logger.warning("fabric page gather failed: %s", e)
            self._fabric_client.count_fallback(len(hashes))
            return hashes
        if not found:
            return []
        nlayers = int(ks[0].shape[0])
        win = self.cfg.kv_fabric_stream_layers or nlayers
        for lo in range(0, nlayers, win):
            hi = min(lo + win, nlayers)
            frame = fabric_wire.encode_frame(
                found, [k[lo:hi] for k in ks], [v[lo:hi] for v in vs],
                [x[lo:hi] for x in sks] if sks is not None else None,
                [x[lo:hi] for x in svs] if svs is not None else None,
                layers=(lo, hi), nlayers=nlayers,
            )
            if not self._fabric_client.push(addr, frame):
                # mid-stream failure: drop the cached peer (it may have
                # restarted on a new port) and let the TCP path ship the
                # whole chain; the consumer's assembler bounds the partial
                # windows left behind
                self._fabric_peer_addr = None
                self._fabric_client.count_fallback(len(found))
                return hashes
        return []

    def fabric_ship_pairs(self, addr: str, pairs: "list[tuple[int, str]]") -> "list[str]":
        """Ship explicit ``(pid, key_hex)`` pages to the fabric listener at
        ``addr``: a migration's freeze-and-ship, whose frozen sequence's
        pages are not in hash_to_page yet (they are registered at its
        finish). Returns the keys shipped, all or none. The gather runs on
        the loop thread (inline when the caller is already there, as the
        freeze is)."""
        if self._fabric_client is None or not pairs:
            return []
        from production_stack_tpu_torch.kvfabric import wire as fabric_wire

        def gather():
            pids = [p for p, _ in pairs]
            if self.kv_quant:
                return self.runner.get_pages_quant(pids)
            return (*self.runner.get_pages(pids), None, None)

        try:
            ks, vs, sks, svs = self._run_on_device_thread(gather, what="fabric migration gather")
        except Exception as e:  # noqa: BLE001 - the tier save is the fallback
            logger.warning("fabric migration gather failed: %s", e)
            self._fabric_client.count_fallback(len(pairs))
            return []
        keys = [k for _, k in pairs]
        frame = fabric_wire.encode_frame(keys, ks, vs, sks, svs, nlayers=int(ks[0].shape[0]))
        if self._fabric_client.push(addr, frame):
            return keys
        self._fabric_client.count_fallback(len(pairs))
        return []

    # -- commands on the loop thread ------------------------------------------

    def _run_on_device_thread(self, fn, what: str = "device command"):
        """Run ``fn`` on the engine loop's thread between steps and return
        its result (its exception is raised here). Device state must not
        change under a running step, and extra forwards must not race one.
        Runs inline when the loop is not running, and when called on the loop
        thread itself (a migration's freeze gathers its pages from there):
        queueing would wait on itself."""
        if self._thread is None or not self._thread.is_alive() or threading.current_thread() is self._thread:
            return fn()
        done = threading.Event()
        box: dict = {}

        def cmd():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 - raised again on the caller's thread
                box["error"] = e
            finally:
                done.set()

        self._inbox.put(("device_cmd", cmd))
        if not done.wait(timeout=120):
            raise TimeoutError(f"{what} timed out")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    # -- LoRA adapters --------------------------------------------------------

    def _lora_cmd(self, op: str, name: str, path: Optional[str] = None):
        """A LoRA load or unload. The checkpoint is parsed on the caller's
        thread; the slot write (and the unload's in-use scan of the
        scheduler) runs on the loop thread between steps, so no write lands
        between a step's layers."""
        if self.lora is None:
            raise ValueError("LoRA is not enabled (--enable-lora)")
        if op == "load":
            # cheap checks before reading the checkpoint; load_parsed checks
            # again under the manager's lock
            if self.lora.is_adapter(name):
                raise LoRAError(f"adapter {name!r} is already loaded")
            if not self.lora.has_free_slot():
                raise LoRAError(f"no free LoRA slots (max_loras={self.cfg.max_loras})")
            tensors, scale = self.lora.read_checkpoint(path)

            def run():
                return self.lora.load_parsed(name, tensors, scale)
        else:
            def run():
                slot = self.lora.slot_for(name)  # 0 when not loaded
                in_use = slot != 0 and any(
                    s.lora_slot == slot for s in self.scheduler.waiting + self.scheduler.running if not s.finished
                )
                return self.lora.unload(name, in_use=in_use)

        return self._run_on_device_thread(run, what=f"LoRA {op} of {name!r}")

    def load_lora_adapter(self, name: str, path: str) -> int:
        """Load a PEFT adapter, served under the model name ``name``; returns
        its slot (POST /v1/load_lora_adapter)."""
        return self._lora_cmd("load", name, path)

    def unload_lora_adapter(self, name: str) -> None:
        """Unload an adapter; refused while requests that use it are in
        flight (the caller retries), so a slot never changes under a running
        sequence."""
        self._lora_cmd("unload", name)

    def list_lora_adapters(self) -> list[str]:
        return self.lora.list_adapters() if self.lora is not None else []

    # -- embeddings -----------------------------------------------------------

    _EMBED_T_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    _EMBED_B_BUCKETS = (1, 2, 4, 8, 16, 32)

    async def embed(self, token_id_lists: list[list[int]]) -> np.ndarray:
        """Pooled unit-norm embeddings of tokenized inputs ([N, hidden_size]
        float32), for /v1/embeddings, /v1/rerank and /v1/score. Inputs of
        similar length go through together, bucketed in B and T like the JAX
        engine's, each group one forward on the loop thread."""
        if self._sleeping:
            raise RuntimeError("engine is sleeping")
        if not hasattr(self.runner.module, "encode"):
            raise ValueError(
                f"embeddings are not supported for model family "
                f"{self.runner.module.__name__.rsplit('.', 1)[-1]!r}"
            )
        for ids in token_id_lists:
            if len(ids) > self.cfg.max_model_len:
                raise ValueError(f"input has {len(ids)} tokens, max_model_len is {self.cfg.max_model_len}")

        def bucket(n, buckets):
            return next((b for b in buckets if n <= b), buckets[-1])

        out = np.zeros((len(token_id_lists), self.model_cfg.hidden_size), np.float32)
        loop = asyncio.get_running_loop()
        order = sorted(range(len(token_id_lists)), key=lambda i: len(token_id_lists[i]))
        pos = 0
        while pos < len(order):
            group = order[pos: pos + self._EMBED_B_BUCKETS[-1]]
            pos += len(group)
            B = bucket(len(group), self._EMBED_B_BUCKETS)
            B = -(-B // self.data_parallel) * self.data_parallel  # rows split over dp, as a step's
            t_raw = max(max(len(token_id_lists[i]) for i in group), 1)
            T = bucket(t_raw, self._EMBED_T_BUCKETS)
            if T < t_raw:  # past the largest bucket: the next power of two
                T = 1 << (t_raw - 1).bit_length()
            input_ids = np.zeros((B, T), np.int32)
            positions = np.full((B, T), -1, np.int32)
            for row, i in enumerate(group):
                ids = token_id_lists[i]
                input_ids[row, : len(ids)] = ids
                positions[row, : len(ids)] = np.arange(len(ids))

            def encode_cmd(input_ids=input_ids, positions=positions):
                if self._sleeping:  # it may have gone to sleep since the check above
                    raise RuntimeError("engine is sleeping")
                return self.runner.encode(input_ids, positions).cpu().numpy()

            vecs = await loop.run_in_executor(
                None, lambda: self._run_on_device_thread(encode_cmd, what="embedding forward")
            )
            for row, i in enumerate(group):
                out[i] = vecs[row]
            with self._lock:
                self.total_prompt_tokens += sum(len(token_id_lists[i]) for i in group)
        return out

    # -- warm start -----------------------------------------------------------

    def warm_spill(self) -> int:
        """The last warm-start manifest spill, which the server's drain
        calls after in-flight requests finished. Runs on the loop thread, so
        its page fetches come between steps. 0 without ``warm_start``."""
        if self.warm is None:
            return 0
        try:
            return int(self._run_on_device_thread(lambda: self.warm.spill("drain"), what="warm-start spill") or 0)
        except Exception:  # noqa: BLE001 - shutdown must not hang on a spill
            logger.exception("warm-start drain spill failed")
            return 0

    # -- sleep mode -----------------------------------------------------------

    def sleep(self, level: int = 1) -> None:
        """Free device memory without ending the process: level 1 drops the
        KV pools, level 2 also moves the weights to host memory. Running and
        waiting requests are aborted. Runs on the loop thread."""
        if self._sleeping:
            return

        def do_sleep():
            if self._sleeping:
                return  # raced with another sleep
            self._sleeping = True
            self._sleep_level = level
            for s in list(self.scheduler.running) + list(self.scheduler.waiting):
                self.scheduler._finish(s, "abort")
                self._emit(s, "")
            # each rank releases its own pools (and weights) and gives the
            # freed blocks back to its card
            self.runner.drop_kv_pools()
            if level >= 2:
                self.runner.offload_params()

        self._run_on_device_thread(do_sleep, what="sleep")

    def wake_up(self) -> None:
        """Undo ``sleep``: the weights back on the device (level 2), fresh
        zeroed pools and an empty prefix cache."""
        if not self._sleeping:
            return

        def do_wake():
            if not self._sleeping:
                return  # raced with another wake
            if self._sleep_level >= 2:
                self.runner.restore_params()
            self.runner.reset_kv()
            self.kv = KVPageManager(
                self.kv.num_pages, self.kv.page_size, offload=self._offload,
                max_io_pages=self._max_io_pages, spill_watermark=self.cfg.kv_spill_watermark,
            )
            self.scheduler.kv = self.kv
            self.kv.directory = self._kvdir_pub  # fleet publishes go on
            if self._kvdir_pull is not None:
                self._kvdir_pull.kv = self.kv
            if self.warm is not None:
                # the manifest's pages are the new manager's: the old one's
                # page ids name pages of the dropped pools
                self.warm.kv = self.kv
            self._sleeping = False

        self._run_on_device_thread(do_wake, what="wake_up")

    @property
    def is_sleeping(self) -> bool:
        return self._sleeping

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "num_requests_running": self.scheduler.num_running(),
            "num_requests_waiting": self.scheduler.num_waiting(),
            "num_requests_swapped": self.scheduler.num_swapped(),
            "num_preemptions_total": self.scheduler.preemptions_total,
            "num_requests_shed_total": sum(self.requests_shed.values()) + self.api_requests_shed,
            "num_requests_shed_queue_full_total": self.requests_shed["queue_full"] + self.api_requests_shed,
            "num_requests_shed_queue_deadline_total": self.requests_shed["queue_deadline"],
            "num_requests_shed_interactive_total": (
                self.requests_shed_by_class["interactive"] + self.api_requests_shed_by_class["interactive"]
            ),
            "num_requests_shed_batch_total": (
                self.requests_shed_by_class["batch"] + self.api_requests_shed_by_class["batch"]
            ),
            "engine_saturated": int(self.saturated()),
            # 1 with engine_saturated 0: the interactive reserve is holding
            # while batch already sheds
            "engine_saturated_batch": int(self.saturated("batch")),
            # the dp x ep x tp ranks, one process and one device each (ranks may
            # share a card with gloo): the router and the fleet controller
            # read these as one replica over mesh_devices devices
            "tensor_parallel": self.tensor_parallel,
            "mesh_devices": self.mesh_devices,
            "gpu_cache_usage_perc": self.kv.usage(),
            "gpu_prefix_cache_hits_total": self.kv.prefix_hits,
            "gpu_prefix_cache_queries_total": self.kv.prefix_queries,
            "gpu_prefix_cache_hit_rate": self.kv.hit_rate(),
            "prompt_tokens_total": self.total_prompt_tokens,
            "generation_tokens_total": self.total_generation_tokens,
            "decode_dispatches_total": self.decode_dispatches_total,
            "decode_chained_dispatches_total": self.decode_chained_dispatches_total,
            "runahead_prefill_dispatches_total": self.runahead_prefill_dispatches_total,
            "kv_evicted_pages_total": self.kv.evicted_pages_total,
            "kv_evicted_hot_pages_total": self.kv.evicted_hot_pages_total,
            "kv_proactive_spilled_pages_total": self.kv.proactive_spilled_pages_total,
            # the int8 KV surface: cache_dtype is the string form for GET
            # /stats (non-numeric: the /metrics kv_* sweep skips it)
            "cache_dtype": self.cfg.kv_cache_dtype,
            "kv_cache_dtype_bytes_per_token": round(self.kv_bytes_per_token, 3),
            "kv_quant_pages": self.kv.num_pages if self.kv_quant else 0,
            "kv_quant_dequant_err_max": round(self.kv_quant_dequant_err_max, 6),
        }
        if self._offload is not None:
            o = self._offload.stats()
            out["kv_offload_hit_pages_total"] = self.kv.offload_hits
            out["kv_offload_saved_pages_total"] = o["saved_pages"]
            out["kv_offload_loaded_pages_total"] = o["loaded_pages"]
            out["kv_offload_cpu_bytes"] = o["cpu_bytes"]
            out["kv_offload_disk_bytes"] = o["disk_bytes"]
            out["kv_corrupt_pages_total"] = o["corrupt_pages"]
            out["kv_offload_dropped_evictions_total"] = o["dropped_evictions"]
            out["kv_offload_max_io_pages"] = self.kv.max_io_pages
            if self.kv_link_bandwidth_bytes_per_s is not None:
                out["kv_offload_link_bandwidth_bytes_per_sec"] = round(self.kv_link_bandwidth_bytes_per_s)
        if self.warm is not None:
            out.update(self.warm.stats())
        if self._kvdir_pub is not None:
            # the fleet directory, publish side
            p = self._kvdir_pub.stats()
            out["kv_directory_publishes_total"] = p["kv_directory_publishes_total"]
            out["kv_directory_withdrawals_total"] = p["kv_directory_withdrawals_total"]
            out["kv_directory_flush_errors_total"] = p["kv_directory_flush_errors_total"]
        if self.cfg.warm_prefetch_on_boot > 0:
            # chunks pulled into the local tiers before the server was ready
            out["kv_directory_prefetched_pages_total"] = self.kv_directory_prefetched_pages
        if self._kvdir_pull is not None:
            # and the pull side: lookups and hits, and the blobs fetched
            # into the local tiers
            q = self._kvdir_pull.stats()
            out["kv_directory_lookups_total"] = q["kv_directory_lookups_total"]
            out["kv_directory_lookup_hits_total"] = q["kv_directory_lookup_hits_total"]
            out["kv_directory_pulled_pages_total"] = q["kv_directory_pulled_pages_total"]
        if self._kv_sender is not None:
            out["kv_transfer_sent_chunks_total"] = self._kv_sender.sent_chunks
            out["kv_transfer_sent_bytes_total"] = self._kv_sender.sent_bytes
            out["kv_transfer_device_pages_total"] = self._kv_sender.device_pages
        if self._kv_receiver is not None:
            out["kv_transfer_received_chunks_total"] = self._kv_receiver.received_chunks
            out["kv_transfer_received_bytes_total"] = self._kv_receiver.received_bytes
            out["kv_transfer_device_pages_total"] = self._kv_receiver.device_pages
            # pushes the receiver refused on their checksum are corrupt pages too
            out["kv_corrupt_pages_total"] += self._kv_receiver.corrupt_chunks
        if self._offload is not None and self._offload.device_staging is not None:
            out["kv_offload_device_loaded_pages_total"] = self._offload.device_loaded_pages
        if self.runner.kv_endpoint is not None:
            # offer retirement: pinned device bytes and the upper bound on
            # offers never pulled
            out.update(self.runner.kv_endpoint.stats())
        if self._fabric_server is not None:
            # the fabric's volume, its tier fallbacks, frames quarantined on
            # either side, generation-fenced pulls, and the live op depth
            # peers fold into transfer-cost scores
            srv, cli = self._fabric_server.stats(), self._fabric_client.stats()
            out["kv_fabric_pushed_pages_total"] = cli["pushed_pages"]
            out["kv_fabric_pulled_pages_total"] = cli["pulled_pages"]
            out["kv_fabric_served_pages_total"] = srv["served_pages"]
            out["kv_fabric_received_pages_total"] = srv["received_pages"]
            out["kv_fabric_fallbacks_total"] = cli["fallbacks"]
            out["kv_fabric_corrupt_frames_total"] = cli["corrupt_frames"] + srv["corrupt_frames"]
            out["kv_fabric_stale_generation_pulls_total"] = srv["stale_generation_pulls"]
            out["kv_fabric_breaker_opens_total"] = cli["breaker_opens"]
            out["kv_fabric_peer_probes_total"] = cli["probes"]
            out["kv_fabric_queue_depth"] = srv["queue_depth"]
        if self.cfg.speculative_k:
            # accepted read before drafts: the loop adds drafts first, so a
            # snapshot never shows more accepted than drafted
            accepted = self.spec_accepted_tokens
            drafts = self.spec_draft_tokens
            out["spec_decode_num_draft_tokens_total"] = drafts
            out["spec_decode_num_accepted_tokens_total"] = accepted
            out["spec_decode_draft_acceptance_rate"] = accepted / drafts if drafts else 0.0
        for section, secs in self.loop_seconds.items():
            out[f"engine_loop_{section}_seconds_total"] = round(secs, 3)
        # p99 over the recent interactive ok-request windows, 0.0 while idle
        for name, window in (
            ("interactive_ttft_p99_ms", self._interactive_ttft_ms),
            ("interactive_itl_p99_ms", self._interactive_itl_ms),
        ):
            snap = sorted(window)
            out[name] = round(snap[min(len(snap) - 1, int(len(snap) * 0.99))], 3) if snap else 0.0
        return out
