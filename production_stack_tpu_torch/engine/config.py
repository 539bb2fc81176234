"""Engine configuration + CLI (the port's own copy of the JAX engine's).

Every field keeps the JAX engine's flag name and default, so a flag means
the same to both servers. The port carries only the fields it reads, plus
one switch per JAX feature it does not serve yet; check_supported refuses
a non-default value of a switch instead of ignoring it.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


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
    # surplus tokens after EOS are discarded host-side
    decode_steps: int = 8
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    # attention implementation, threaded into the model config:
    # auto | cuda | plain. "cuda" runs the hand-written decode and prefill
    # kernels (ops/kernels/), "plain" their PyTorch reference versions;
    # "auto" resolves to "cuda" on a CUDA device and "plain" on the CPU
    # (resolve_attn_impl). Asking for "cuda" on the CPU raises.
    attn_impl: str = "auto"
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
    seed: int = 0
    # engine flight recorder (tracing/flightrecorder.py): a bounded ring of
    # structured engine events (scheduler dispatches, KV evictions, admission
    # sheds), dumped to disk on SIGTERM drain and exported in /metrics
    flight_recorder: bool = True
    flight_recorder_capacity: int = 8192
    # dump directory; None falls back to $PSTPU_FLIGHTRECORDER_DIR, else disk
    # dumps are disabled (the in-memory ring still works)
    flight_recorder_dump_dir: Optional[str] = None

    # Switches of the JAX engine's features that the port does not serve
    # yet. Each must keep its default: check_supported refuses any other
    # value rather than ignore it. The JAX engine's per-feature sub-knobs
    # (LoRA ranks, fabric ports, warm-start intervals, ...) are not carried.
    kv_write_mode: str = "post"         # "pre" is not ported
    decode_pipeline: int = 1            # chained decode bursts
    speculative_k: int = 0              # speculative decoding
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    sequence_parallel_size: int = 1
    expert_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    distributed_coordinator: Optional[str] = None
    distributed_num_processes: int = 1
    enable_sleep_mode: bool = False
    enable_lora: bool = False
    warm_start: bool = False
    kv_remote_url: Optional[str] = None
    kv_controller_url: Optional[str] = None
    kv_directory_url: Optional[str] = None
    kv_role: str = "none"               # disaggregated prefill
    kv_fabric: bool = False

    @property
    def name(self) -> str:
        return self.served_model_name or self.model


# --help text for flags whose one-line meaning is not obvious from the name;
# the dataclass comments stay the authoritative long-form docs
_FLAG_HELP = {
    "model": (
        "a preset name (seeded random weights) or a local HuggingFace "
        "directory: config.json plus *.safetensors (Llama, Mistral, Qwen2, "
        "Gemma-2, OPT)"
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
    "attn_impl": (
        "auto | cuda | plain: the hand-written CUDA attention kernels or "
        "their PyTorch versions (auto = cuda on a CUDA device)"
    ),
}


def add_engine_args(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(EngineConfig):
        flag = "--" + f.name.replace("_", "-")
        ftype = str(f.type)
        help_ = _FLAG_HELP.get(f.name)
        if f.name in _UNSUPPORTED:
            help_ = f"not supported by the PyTorch port yet ({_UNSUPPORTED[f.name]}); keep the default"
        if ftype == "bool" or isinstance(f.default, bool):
            p.add_argument(flag, action=argparse.BooleanOptionalAction,
                           default=f.default, help=help_)
        else:
            typ = str
            if "int" in ftype or isinstance(f.default, int):
                typ = int
            elif "float" in ftype or isinstance(f.default, float):
                typ = float
            p.add_argument(flag, type=typ, default=f.default,
                           dest=f.name, help=help_)


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    kwargs = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(EngineConfig)
        if hasattr(args, f.name)
    }
    return EngineConfig(**kwargs)


ATTN_IMPLS = ("auto", "cuda", "plain")
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
    "decode_pipeline": "chained decode bursts",
    "speculative_k": "speculative decoding",
    "tensor_parallel_size": "tensor parallelism",
    "data_parallel_size": "in-engine data parallelism",
    "sequence_parallel_size": "sequence parallelism",
    "expert_parallel_size": "expert parallelism",
    "pipeline_parallel_size": "pipeline parallelism",
    "distributed_coordinator": "multi-host serving",
    "distributed_num_processes": "multi-host serving",
    "enable_sleep_mode": "sleep mode",
    "enable_lora": "LoRA adapters",
    "warm_start": "warm-start manifests",
    "kv_remote_url": "the remote KV tier (cache server)",
    "kv_controller_url": "the KV index controller",
    "kv_directory_url": "the fleet KV directory",
    "kv_role": "disaggregated prefill",
    "kv_fabric": "the KV fabric",
}


def check_supported(cfg: EngineConfig) -> None:
    """Raise on any non-default value of a feature the port lacks."""
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
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not supported by the PyTorch port; "
            f"options: {KV_CACHE_DTYPES}"
        )
