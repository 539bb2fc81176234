"""Engine configuration + CLI (the port's own copy of the JAX engine's).

Every field keeps the JAX engine's flag name and default, so a flag means
the same to both servers. The port carries only the fields it reads, plus
one switch per JAX feature it does not serve yet; check_supported refuses
a non-default value of a switch instead of ignoring it. Two knobs are the
port's own: ``tp_backend`` and ``tp_device_ids``, which say how its ranks
(dp x ep x tp processes, one each) reach each other and their devices.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.parallel.group import BACKENDS as TP_BACKENDS
from production_stack_tpu_torch.parallel.group import parse_device_ids


@dataclasses.dataclass
class EngineConfig:
    model: str = "llama-debug"          # preset name or local HF directory
    served_model_name: Optional[str] = None
    tokenizer: Optional[str] = None
    host: str = "0.0.0.0"
    port: int = 8100
    max_num_seqs: int = 64
    max_model_len: int = 4096
    # engine-side admission control (overload survival): bound on the waiting
    # queue — at or past it new generation requests are SHED with 429 +
    # Retry-After instead of queued into unbounded TTFT (0 = unbounded,
    # matching vLLM). Export: vllm:engine_saturated / num_requests_shed_total.
    max_waiting_seqs: int = 0
    # per-request queue deadline: a request still undispatched after this many
    # seconds is shed (429) by the engine loop (0 = never shed by age)
    queue_deadline_s: float = 0.0
    # Retry-After seconds advertised on shed responses
    shed_retry_after_s: float = 1.0
    # SLO classes: waiting-queue slots reserved for interactive requests —
    # batch traffic saturates (sheds) this many slots early, so batch load
    # can never starve interactive out of a bounded queue
    interactive_reserve: int = 1
    # queue deadline applied to batch-class requests only (0 = inherit
    # queue_deadline_s); a shorter batch deadline makes the engine loop
    # expire batch out of a congested queue before any interactive request
    batch_queue_deadline_s: float = 0.0
    # max share of a prefill dispatch's chunk slots batch may hold while an
    # interactive prefill is waiting (1.0 = no cap)
    batch_prefill_share: float = 0.5
    # KV page size (tokens): the unit of paging, prefix sharing and KV
    # transfer. Larger pages mean fewer, bigger page reads per decode step
    # and coarser prefix sharing.
    page_size: int = 64
    num_pages: Optional[int] = None     # default: sized from kv_cache_memory_gb
    kv_cache_memory_gb: float = 4.0
    prefill_chunk: int = 512
    prefill_batch: int = 4
    # fused decode burst: tokens produced per dispatch (runner.step_multi);
    # surplus tokens after EOS are discarded host-side. With speculative
    # decoding on, the number of draft+verify rounds per dispatch instead
    decode_steps: int = 8
    # chained decode bursts per dispatch when the batch is quiescent: burst
    # j+1's input token comes from burst j's tokens on the device, so a chain
    # of m bursts is fetched once (runner.step_multi_pipelined), a group of
    # four bursts at a time; the scheduler caps the chain by the arrival rate
    # and the measured burst time, and prefills of new arrivals run ahead
    # behind an in-flight chain
    decode_pipeline: int = 1
    # speculative decoding (prompt lookup, runner.step_spec): draft length
    # per round (0 = off), and the n-gram the draft matches; bf16/f32 pools
    # only, no penalties, logit_bias, min_tokens or logprobs
    speculative_k: int = 0
    speculative_ngram: int = 3
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    # attention implementation, threaded into the model config:
    # auto | cuda | plain. "cuda" runs the hand-written decode and prefill
    # kernels (ops/kernels/), "plain" their PyTorch reference versions;
    # "auto" resolves to "cuda" on a CUDA device and "plain" on the CPU
    # (resolve_attn_impl). Asking for "cuda" on the CPU raises.
    attn_impl: str = "auto"
    # tool-call extraction from chat completions (engine/tool_parser.py):
    # auto | hermes | json | off ("off" renders no tools and parses none)
    tool_call_parser: str = "auto"
    # KV cache dtype: "auto" (= the model's dtype) | "int8": int8 pages with
    # per-page, per-KV-head f32 scales (ops/quant.py), read by the kernels'
    # int8 modes and written by the quantizing KV write and commit; the
    # same kv_cache_memory_gb holds about twice the tokens. The JAX engine's
    # "bf16"/"fp16" are refused by name.
    kv_cache_dtype: str = "auto"
    # local KV offload tiers (kvoffload/): evicted prefix pages spill to host
    # RAM (kv_offload_cpu_gb), then to disk (kv_offload_dir, capped at
    # kv_offload_disk_gb), and a later prefix match restores them. int8
    # pools ship their exact bytes and scales as serde v3 blobs; fp pools
    # use kv_serde (naive | int8)
    kv_offload_cpu_gb: float = 0.0
    kv_offload_dir: Optional[str] = None
    kv_offload_disk_gb: float = 16.0
    # pages moved per offload operation: 0 = unbounded, -1 = derived at
    # startup from a host<->device link probe (engine/linkprobe.py)
    kv_offload_max_io_pages: int = -1
    # pool usage past which the coldest evictable pages spill ahead of
    # eviction (0 or >= 1 disables)
    kv_spill_watermark: float = 0.9
    kv_serde: str = "naive"
    # the remote KV tier: the shared cache server (kvoffload/cache_server.py)
    # every offloaded page is written through to and a local miss reads back
    kv_remote_url: Optional[str] = None
    # the KV-index controller (kvoffload/controller.py): the engine registers
    # under kv_instance_id at its advertised URL and reports the chunk hashes
    # it admits and evicts, which the router's kvaware routing looks up
    kv_controller_url: Optional[str] = None
    kv_instance_id: Optional[str] = None
    advertise_host: Optional[str] = None  # URL other pods reach this engine at
    # warm-start manifests (kvoffload/warmstart.py): on drain and every
    # warm_start_interval_s the engine spills its hottest chain-head pages
    # and the prefix-index metadata to the offload tier under a
    # generation-fenced namespace, and restores them at startup before it
    # serves. Needs an offload tier; a disk or remote one survives the process
    warm_start: bool = False
    # seconds between periodic manifest spills; <= 0 spills only on drain
    warm_start_interval_s: float = 60.0
    # manifest namespace in the offload tier (default: kv_instance_id, else
    # "<model>-<port>")
    warm_start_namespace: Optional[str] = None
    # manifest size cap in pages (highest-reuse-score chain heads first)
    warm_start_max_pages: int = 256
    # the fleet-wide KV directory (kvdirectory/), hosted by the cache
    # server. When set, the engine publishes directory entries (prefix-cache
    # inserts -> resident claims; confirmed spills and warm-start saves ->
    # shared-tier claims; withdrawals on eviction) batched every
    # kv_directory_flush_s, and pulls fleet-warm prefixes: at admission, the
    # chunks past the local prefix match that the directory reports
    # restorable are fetched into the local host tiers (from the owning
    # engine over the fabric when it runs one, else from the shared tier),
    # so the loop thread's restore finds them locally. Entries are fenced by
    # the warm-start generation (a boot epoch without warm_start). Usually
    # the same address as kv_remote_url
    kv_directory_url: Optional[str] = None
    # seconds between directory publish-batch flushes
    kv_directory_flush_s: float = 5.0
    # consult the directory at admission and prefetch restorable prefix
    # blobs into the local tiers (--no-kv-directory-pull = publish-only)
    kv_directory_pull: bool = True
    # cap on pages one admission may prefetch
    kv_directory_pull_max_pages: int = 256
    # scale-up warm-up: pull the fleet's top-N warm chunks (the cache
    # server's dir_top_prefixes) into the local offload tiers while the
    # engine is built, before the server reports ready, so its first
    # requests restore those prefixes instead of prefilling them. Needs
    # kv_directory_url and an offload tier; 0 disables
    warm_prefetch_on_boot: int = 0
    # live sequence migration (migration/): serve POST /migrate_out (freeze
    # a running stream, ship its KV chain over the fabric or the offload
    # tiers and its sampling and decode state to a target engine), POST
    # /migrate_in (park the continuation), POST /migrate_attach (stream it)
    # and GET /migratable (the fleet controller's victim listing).
    # --no-migration turns them off (501); without an offload tier or the
    # fabric a migration ships no pages and the target recomputes them
    migration: bool = True
    # seconds a parked /migrate_in continuation waits for its
    # /migrate_attach before it is aborted
    migrate_attach_timeout_s: float = 30.0
    seed: int = 0
    # register the unauthenticated debug routes (GET /v1/traces, GET
    # /v1/debug/flightrecorder, POST /metrics/reset); benchmark and test
    # harnesses only
    enable_debug_endpoints: bool = False
    # distributed tracing (tracing/): head-sampling rate for traces rooted
    # at this engine (a request with a traceparent keeps the caller's
    # decision; 0.0 records nothing), and the span ring's size
    trace_sample_rate: float = 1.0
    trace_buffer_size: int = 4096
    # engine flight recorder (tracing/flightrecorder.py): a bounded ring of
    # structured engine events (scheduler dispatches, KV evictions, admission
    # sheds), dumped to disk on SIGTERM drain and exported in /metrics
    flight_recorder: bool = True
    flight_recorder_capacity: int = 8192
    # dump directory; None falls back to $PSTPU_FLIGHTRECORDER_DIR, else disk
    # dumps are disabled (the in-memory ring still works)
    flight_recorder_dump_dir: Optional[str] = None
    # TTFT breach watermark in ms: a request finishing with TTFT above this
    # triggers a (rate-limited) anomaly dump; 0 disables
    flight_recorder_ttft_watermark_ms: float = 0.0
    # shed-burst trigger: this many admission sheds within a 5 s window
    # dump the recorder; 0 disables
    flight_recorder_shed_burst: int = 10
    # sleep mode (POST /sleep?level=1|2, /wake_up, GET /is_sleeping): level
    # 1 frees the KV pools, level 2 also moves the weights to host memory;
    # without this flag /sleep and /wake_up answer 400
    enable_sleep_mode: bool = False
    # batched multi-LoRA (POST /v1/load_lora_adapter, /v1/unload_lora_adapter;
    # a request's "model" names a loaded adapter): max_loras adapters at
    # once (slot 0, the base model, comes on top), ranks up to max_lora_rank,
    # applied to the HF modules lora_target_modules lists (llama family only;
    # on Mixtral the attention projections alone)
    enable_lora: bool = False
    max_loras: int = 4
    max_lora_rank: int = 16
    lora_target_modules: str = "q_proj,k_proj,v_proj,o_proj"
    # tensor parallelism (alias --tensor-parallel): one process per rank,
    # started by the engine, each holding 1/tp of the heads, MLP and
    # vocabulary and 1/tp of every KV page (parallel/, engine/distributed.py)
    tensor_parallel_size: int = 1
    # in-engine data parallelism: dp replicas of ep x tp ranks, each serving
    # its B/dp rows of every step with a whole replica of the pool
    # (parallel/dp.py)
    data_parallel_size: int = 1
    # expert parallelism: a MoE model's experts split over ep ranks (E/ep
    # each, parallel/ep.py), the attention replicated along them; dense
    # models ignore it (their ep ranks replicate the whole computation).
    # dp x ep x tp processes in all, rank r = (d * ep + e) * tp + t
    expert_parallel_size: int = 1
    # pipeline parallelism (the llama family): the layer stack in pp
    # contiguous stages, each step in microbatches relayed from stage to
    # stage (parallel/pipeline.py); pp x ep x tp processes, rank r = (p * ep
    # + e) * tp + t (dp = 1)
    pipeline_parallel_size: int = 1
    # sequence parallelism (the llama family): a prefill chunk's tokens
    # split over sp ranks with ring attention (parallel/ring_attention.py),
    # the weights and the pools whole on each; a decode step runs whole on
    # every rank. sp x ep x tp processes, rank r = (s * ep + e) * tp + t
    # (dp = pp = 1)
    sequence_parallel_size: int = 1
    # the port's deployment knobs for its ranks (all pp x dp x sp x ep x tp of them): the
    # torch.distributed backend (nccl, or gloo, which stages CUDA tensors
    # through the host and so lets ranks share one card), and the CUDA
    # device of each rank, comma-separated (default: rank r on cuda:r)
    tp_backend: str = "nccl"
    tp_device_ids: Optional[str] = None
    # disaggregated prefill role: none | producer | consumer. A producer
    # ships each finished prefill's full pages to kv_peer_url (the
    # consumer's receiver) before it answers; a consumer listens on
    # kv_transfer_port and restores the received pages through its offload
    # path (it always gets a CPU tier for them)
    kv_role: str = "none"
    kv_transfer_port: int = 55555
    kv_peer_url: Optional[str] = None
    # device-to-device KV between a producer and a consumer on one host:
    # pages move over CUDA IPC (kvoffload/transfer.DeviceKVEndpoint) instead
    # of host serde + TCP blobs. Both roles must enable it; a page whose pull
    # fails ships as a blob. fp pools and tp = dp = 1 only
    kv_transfer_device: bool = False
    # host the producer's IPC endpoint listens at (the consumer asks it for
    # a page's handles)
    kv_transfer_device_host: str = "127.0.0.1"
    # staging budget for device-pulled pages awaiting admission (consumer)
    kv_transfer_stage_mb: int = 1024
    # the peer-to-peer KV fabric (kvfabric/): versioned, CRC-framed (pages,
    # scales) frames engine to engine, so int8 pools ship with their exact
    # scales. A disagg producer streams a finished prefill's pages over it
    # first and falls back to TCP blobs (vllm:kv_fabric_fallbacks_total); a
    # directory pull fetches an owner's resident pages over it, and a
    # migration ships its page chain over it, each with the tiers as the
    # fallback
    kv_fabric: bool = False
    # fabric listener port; 0 binds an ephemeral port (GET /kv_fabric)
    kv_fabric_port: int = 0
    # bounded per-request retries below the per-peer breaker
    kv_fabric_retries: int = 2
    # disagg producer: the decode peer's fabric listener ("host:port") or
    # its HTTP URL (GET /kv_fabric then resolves the advertised listener)
    kv_fabric_peer: Optional[str] = None
    # streamed disagg prefill: layers shipped per frame (the consumer
    # assembles windows into whole pages); 0 ships whole pages in one frame
    kv_fabric_stream_layers: int = 0

    # multi-host serving (engine/distributed.py): distributed_num_processes
    # host processes form one engine of pp x dp x sp x ep x tp ranks, host h
    # holding global ranks [h * L, (h + 1) * L), L = ranks / processes. The
    # ranks rendezvous at distributed_coordinator ("host:port" of process
    # 0's c10d store); process 0 (the leader) serves HTTP and streams its
    # runner calls from worker_sync_port (all interfaces) to every other
    # rank. distributed_process_id: this process's index (default: the
    # JAX_PROCESS_ID env var, else the StatefulSet hostname's ordinal)
    distributed_coordinator: Optional[str] = None   # host:port of process 0
    distributed_num_processes: int = 1
    distributed_process_id: Optional[int] = None    # default: hostname -N suffix
    worker_sync_port: int = 8477

    # Switches of the JAX engine's features that the port does not serve
    # yet. Each must keep its default: check_supported refuses any other
    # value rather than ignore it.
    kv_write_mode: str = "post"         # "pre" is not ported

    @property
    def name(self) -> str:
        return self.served_model_name or self.model


# --help text for flags whose one-line meaning is not obvious from the name;
# the dataclass comments stay the authoritative long-form docs
_FLAG_HELP = {
    "model": (
        "a preset name (seeded random weights) or a local HuggingFace "
        "directory: config.json plus *.safetensors (Llama, Mistral, Qwen2, "
        "Mixtral, Gemma-2, OPT)"
    ),
    "interactive_reserve": (
        "waiting-queue slots reserved for interactive-class requests: batch "
        "traffic sheds (429) this many slots before the queue bound, so "
        "batch load can never starve interactive admission"
    ),
    "batch_queue_deadline_s": (
        "queue deadline for batch-class requests only (0 = inherit "
        "--queue-deadline-s); set it shorter so congestion expires batch "
        "out of the queue before any interactive request"
    ),
    "batch_prefill_share": (
        "max share of one prefill dispatch's chunk slots batch-class rows "
        "may hold while an interactive prefill is waiting (1.0 = no cap)"
    ),
    "lora_target_modules": (
        "comma-separated HF module names LoRA adapters may target "
        "(q_proj, k_proj, v_proj, o_proj, gate_proj, up_proj, down_proj)"
    ),
    "attn_impl": (
        "auto | cuda | plain: the hand-written CUDA attention kernels or "
        "their PyTorch versions (auto = cuda on a CUDA device)"
    ),
    "tensor_parallel_size": (
        "tensor-parallel ranks, one process each (started by the server); "
        "query heads, the MLP and the vocabulary must divide by it, and the KV "
        "heads divide by it or it by them (each KV head then shared by "
        "tp / num_kv_heads ranks)"
    ),
    "data_parallel_size": (
        "in-engine data-parallel groups, each a tp group serving its share "
        "of every batch's rows with a whole replica of the KV pool; the "
        "server starts dp x ep x tp processes"
    ),
    "expert_parallel_size": (
        "expert-parallel ranks of a MoE model, each holding num_experts / ep "
        "experts (which ep must divide), attention replicated along them; "
        "dense models ignore it; the server starts dp x ep x tp processes"
    ),
    "pipeline_parallel_size": (
        "pipeline stages of a llama-family model, each holding num_layers / pp "
        "layers (which pp must divide) and their share of every KV page (a MoE "
        "model's experts of them over its ep ranks); each step runs in "
        "microbatches relayed stage to stage; the server starts pp x ep x tp "
        "processes"
    ),
    "sequence_parallel_size": (
        "sequence-parallel ranks of a llama-family model: each prefill "
        "chunk's tokens split over them with ring attention (a MoE model's "
        "experts over its ep ranks), the weights and the KV pool whole on "
        "each, decode replicated; the server starts sp x ep x tp processes"
    ),
    "decode_pipeline": (
        "chained decode bursts per dispatch while no request waits (1 = off): "
        "one fetch per chain, in groups of four bursts, with run-ahead prefills "
        "queued behind it"
    ),
    "speculative_k": (
        "speculative decoding: n-gram draft tokens verified per round (0 = off; "
        "not with --kv-cache-dtype int8, penalties, logit_bias, min_tokens or logprobs)"
    ),
    "speculative_ngram": "the n-gram the speculative draft looks up in the request's own tokens",
    "tp_backend": (
        "nccl | gloo: the torch.distributed backend of the engine's pp x dp x sp x ep x tp "
        "ranks (port only). gloo stages CUDA tensors through the host, so "
        "ranks may share one card (--tp-device-ids 0,0) and hosts may join; nccl refuses both"
    ),
    "tp_device_ids": (
        "comma-separated CUDA device index of each of this host's ranks (all "
        "pp x dp x sp x ep x tp of them on one host), in global rank order, "
        "r = (((p * dp + d) * sp + s) * ep + e) * tp + t (port only; default: "
        "the host's i-th rank on cuda:i)"
    ),
    "distributed_coordinator": (
        "host:port of process 0's rendezvous (a c10d TCP store) for multi-host "
        "serving; every host process names the same one"
    ),
    "distributed_num_processes": (
        "host processes that form one engine, each running an equal block of its "
        "ranks (the port needs --tp-backend gloo across hosts)"
    ),
    "distributed_process_id": (
        "this host process's index, 0 = the leader that serves HTTP (default: "
        "JAX_PROCESS_ID, else the hostname's -N suffix, as a StatefulSet names pods)"
    ),
    "worker_sync_port": (
        "the port the leader's step stream listens on (all interfaces) with more than "
        "one process; every other host's ranks dial <coordinator host>:<this port>"
    ),
    "warm_start": (
        "spill a warm-start manifest (hot chain-head KV pages + prefix-index "
        "metadata) to the offload tier on drain and every "
        "--warm-start-interval-s, and restore it on startup before reporting "
        "ready — engine restarts keep their hot prefixes. Needs an offload "
        "tier (--kv-offload-dir / --kv-remote-url for restart durability)"
    ),
    "warm_start_interval_s": (
        "seconds between periodic warm-start manifest spills (bounds how "
        "much warm state a hard crash loses); <= 0 spills only on SIGTERM "
        "drain"
    ),
    "warm_start_namespace": (
        "offload-tier namespace for this engine's warm-start manifests; "
        "restarts/replacements reusing a namespace fence the previous "
        "incarnation by generation (default: --kv-instance-id, else "
        "<model>-<port>)"
    ),
    "warm_start_max_pages": (
        "cap on pages a warm-start manifest covers (highest-reuse-score "
        "chain heads kept first)"
    ),
    "flight_recorder_ttft_watermark_ms": (
        "dump the flight recorder when a request's TTFT exceeds this many "
        "milliseconds (rate-limited; 0 = off)"
    ),
    "kv_role": (
        "disaggregated prefill role: none | producer (ships finished "
        "prefills' pages to --kv-peer-url) | consumer (receives them on "
        "--kv-transfer-port)"
    ),
    "kv_transfer_device": (
        "disaggregated prefill: move pages device to device over CUDA IPC "
        "(both engines on one host; fp pools, tp = dp = 1), a blob per "
        "page that fails"
    ),
    "kv_transfer_device_host": "host the producer's CUDA IPC endpoint listens at",
    "kv_transfer_stage_mb": "consumer: MiB of device-pulled pages staged before admission",
    "kv_fabric": (
        "peer-to-peer KV fabric: engine-to-engine (pages, scales) frames for "
        "streamed disagg prefill (the path for int8 pools), directory "
        "resident pulls and migration ships, with tier fallback on any "
        "failure"
    ),
    "kv_fabric_port": "fabric listener port (0 = ephemeral; advertised on GET /kv_fabric)",
    "kv_fabric_retries": "bounded fabric retries per request, below the per-peer breaker",
    "kv_fabric_peer": (
        "disagg producer: decode peer's fabric listener (host:port) or its "
        "HTTP URL (resolved via GET /kv_fabric)"
    ),
    "kv_fabric_stream_layers": (
        "streamed disagg prefill: layers per fabric frame so decode starts "
        "before the last layer lands (0 = whole pages per frame)"
    ),
    "flight_recorder_shed_burst": (
        "dump the flight recorder when this many admission sheds land "
        "within 5 s (0 = off)"
    ),
    "kv_directory_url": (
        "fleet-wide KV directory address (the cache server; usually the "
        "same as --kv-remote-url): publish this engine's prefix-cache "
        "claims and pull fleet-warm prefixes from the shared tier"
    ),
    "kv_directory_flush_s": "seconds between dirty-batched directory publish flushes",
    "kv_directory_pull": (
        "prefetch directory-reported restorable prefix blobs into the "
        "local tiers at request admission (--no-kv-directory-pull = "
        "publish-only)"
    ),
    "kv_directory_pull_max_pages": "cap on pages one admission may prefetch from the shared tier",
    "warm_prefetch_on_boot": (
        "pull this many top fleet-warm chunks (cache server "
        "dir_top_prefixes) into the local offload tiers before /ready, so "
        "a scaled-up engine starts warm; needs --kv-directory-url (0 = off)"
    ),
    "migration": (
        "serve the live-sequence-migration endpoints (/migrate_out, "
        "/migrate_in, /migrate_attach, /migratable) so running streams can "
        "move between engines without dropping; --no-migration disables"
    ),
    "migrate_attach_timeout_s": (
        "seconds a parked migrated-in continuation waits for the router's "
        "/migrate_attach before it is aborted"
    ),
}
# the port's own fields, which the JAX engine has not
PORT_ONLY = ("tp_backend", "tp_device_ids")
# extra flag names, as the JAX engine's
_ALIASES = {"tensor_parallel_size": ("--tensor-parallel",)}


def add_engine_args(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(EngineConfig):
        flag = "--" + f.name.replace("_", "-")
        flags = (flag, *_ALIASES.get(f.name, ()))
        ftype = str(f.type)
        help_ = _FLAG_HELP.get(f.name)
        if f.name in _UNSUPPORTED:
            help_ = f"not supported by the PyTorch port yet ({_UNSUPPORTED[f.name]}); keep the default"
        if ftype == "bool" or isinstance(f.default, bool):
            p.add_argument(*flags, action=argparse.BooleanOptionalAction,
                           default=f.default, help=help_)
        else:
            typ = str
            if "int" in ftype or isinstance(f.default, int):
                typ = int
            elif "float" in ftype or isinstance(f.default, float):
                typ = float
            p.add_argument(*flags, type=typ, default=f.default,
                           dest=f.name, help=help_)


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    kwargs = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(EngineConfig)
        if hasattr(args, f.name)
    }
    return EngineConfig(**kwargs)


ATTN_IMPLS = ("auto", "cuda", "plain")
TOOL_CALL_PARSERS = ("auto", "hermes", "json", "off")
KV_CACHE_DTYPES = ("auto", "int8")


def resolve_attn_impl(attn_impl: str, device) -> str:
    """``auto`` -> the CUDA kernels on a CUDA device, the plain versions on
    the CPU. The kernels exist only on the card, so asking for them on the
    CPU is an error, not a silent downgrade."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; options: {ATTN_IMPLS}")
    on_cuda = str(device).startswith("cuda")
    if attn_impl == "auto":
        return "cuda" if on_cuda else "plain"
    if attn_impl == "cuda" and not on_cuda:
        raise ValueError("attn_impl='cuda' needs a CUDA device")
    return attn_impl


# features of the JAX engine this port does not serve yet: each field listed
# here must keep its default, or the engine refuses to start (a flag that is
# accepted and then ignored would misreport what is being served)
_UNSUPPORTED = {
    "kv_write_mode": "the 'pre' KV write mode",
}


KV_ROLES = ("none", "producer", "consumer")


def check_supported(cfg: EngineConfig, device=None) -> None:
    """Raise on any non-default value of a feature the port lacks
    (``_UNSUPPORTED``), on a combination the port does not serve (device
    KV transfer with ranks, across hosts or, given ``device``, off the
    card; a multi-host engine without a coordinator, with a number of
    processes that does not divide its ranks, or over NCCL:
    ``check_hosts``), and on
    one the JAX engine refuses too (pp with in-engine dp; int8 pools with
    sp or pp, with speculative decoding, or with disaggregated prefill but
    no fabric; a producer without a peer; in its words). The refusals that
    read the model (a pp that does not divide its layers, a family without
    pp stages or sp) are
    parallel/pipeline.check_pp's and parallel/ring_attention.check_sp's,
    which the engine calls. Sequence ranks beside dp or pp ranks and
    speculative decoding at sp and pp are served, as in the JAX engine.
    LoRA is served at every rank layout the port serves; on a family
    without adapters (Gemma-2, OPT) the runner refuses it in the JAX
    runner's words."""
    dp, ep, pp = cfg.data_parallel_size, cfg.expert_parallel_size, cfg.pipeline_parallel_size
    sp = cfg.sequence_parallel_size
    if cfg.kv_transfer_device:
        # the CUDA IPC endpoint moves whole pages between two single-rank
        # engines on one host
        if cfg.distributed_num_processes > 1:
            raise ValueError(
                "not supported by the PyTorch port yet: device KV transfer "
                "(--kv-transfer-device) across hosts"
            )
        if pp * dp * sp * ep * cfg.tensor_parallel_size > 1:
            raise ValueError(
                "not supported by the PyTorch port yet: device KV transfer "
                "(--kv-transfer-device) with tp or dp ranks, or sp, ep or pp ranks; the TCP and fabric paths serve "
                "them"
            )
        if device is not None and not str(device).startswith("cuda"):
            raise ValueError(
                "not supported by the PyTorch port: device KV transfer "
                "(--kv-transfer-device) off the card (CUDA IPC needs a CUDA device)"
            )
    if dp < 1:
        raise ValueError(f"data_parallel_size must be >= 1, got {dp}")
    if ep < 1:
        raise ValueError(f"expert_parallel_size must be >= 1, got {ep}")
    if pp < 1:
        raise ValueError(f"pipeline_parallel_size must be >= 1, got {pp}")
    if sp < 1:
        raise ValueError(f"sequence_parallel_size must be >= 1, got {sp}")
    if cfg.prefill_chunk > Scheduler.CHUNK_BUCKETS[-1]:
        raise ValueError(
            f"not supported by the PyTorch port: prefill_chunk {cfg.prefill_chunk} above "
            f"{Scheduler.CHUNK_BUCKETS[-1]}, the scheduler's largest chunk"
        )
    if dp > 1 and pp > 1:
        # the JAX engine's own refusal (engine/engine.py)
        raise ValueError(
            "pipeline parallelism does not compose with in-engine data parallelism; "
            "use router-level replicas for DP"
        )
    defaults = EngineConfig()
    bad = sorted(
        {
            what
            for name, what in _UNSUPPORTED.items()
            if getattr(cfg, name) != getattr(defaults, name)
        }
    )
    if bad:
        raise ValueError(
            "not supported by the PyTorch port yet: " + "; ".join(bad)
        )
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r}; options: {ATTN_IMPLS}"
        )
    if cfg.tool_call_parser not in TOOL_CALL_PARSERS:
        raise ValueError(
            f"unknown tool_call_parser {cfg.tool_call_parser!r}; options: {TOOL_CALL_PARSERS}"
        )
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not supported by the PyTorch port; "
            f"options: {KV_CACHE_DTYPES}"
        )
    if cfg.kv_cache_dtype == "int8" and cfg.speculative_k:
        raise ValueError(
            "--kv-cache-dtype int8 is not compatible with "
            "--speculative-k (the spec scan carries raw pool blocks)"
        )
    if cfg.kv_cache_dtype == "int8" and (sp > 1 or pp > 1):
        # the JAX engine's own refusal (engine/engine.py)
        raise ValueError("--kv-cache-dtype int8 does not compose with sp/pp meshes")
    if cfg.kv_role not in KV_ROLES:
        raise ValueError(f"unknown kv_role {cfg.kv_role!r}; options: {KV_ROLES}")
    if cfg.kv_cache_dtype == "int8" and (cfg.kv_role != "none" or cfg.kv_transfer_device) and not cfg.kv_fabric:
        raise ValueError(
            "--kv-cache-dtype int8 with disaggregated-prefill or "
            "device KV transfer requires --kv-fabric (fabric frames "
            "carry the per-page scales; the raw page paths would "
            "ship quantized bytes without them)"
        )
    if cfg.kv_role == "producer" and not cfg.kv_peer_url:
        raise ValueError("kv_role=producer requires --kv-peer-url")
    tp = cfg.tensor_parallel_size
    if tp < 1:
        raise ValueError(f"tensor_parallel_size must be >= 1, got {tp}")
    if cfg.tp_backend not in TP_BACKENDS:
        raise ValueError(f"unknown tp_backend {cfg.tp_backend!r}; options: {TP_BACKENDS}")
    parse_device_ids(cfg.tp_device_ids, check_hosts(cfg))


def check_hosts(cfg: EngineConfig) -> int:
    """The ranks one host process runs (all pp x dp x sp x ep x tp of them
    on one host): refuses a multi-host engine without a coordinator (in
    the JAX engine's words), a number of processes that does not divide
    the ranks, and NCCL across hosts."""
    n = cfg.distributed_num_processes
    world = (cfg.pipeline_parallel_size * cfg.data_parallel_size * cfg.sequence_parallel_size
             * cfg.expert_parallel_size * cfg.tensor_parallel_size)
    if n < 1:
        raise ValueError(f"distributed_num_processes must be >= 1, got {n}")
    if n == 1:
        return world
    if not cfg.distributed_coordinator:
        raise ValueError("--distributed-num-processes > 1 requires --distributed-coordinator (multi-host serving)")
    host, _, port = cfg.distributed_coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--distributed-coordinator {cfg.distributed_coordinator!r} must be host:port")
    if world % n:
        raise ValueError(
            f"multi-host serving: {n} processes do not divide the engine's {world} ranks "
            f"(pipeline x data x sequence x expert x tensor parallel sizes); each host runs the same number"
        )
    if cfg.tp_backend == "nccl":
        raise ValueError(
            "not supported by the PyTorch port yet: NCCL across hosts (--tp-backend nccl with "
            "--distributed-num-processes > 1); ask for --tp-backend gloo"
        )
    return world // n
