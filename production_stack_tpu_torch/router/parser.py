"""Router CLI parser.

The port's copy of ``production_stack_tpu/router/parser.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/parsers/parser.py of the upstream vLLM production stack (flag surface
:96-320, JSON config seeding :44-52, validation :69-93).
"""

from __future__ import annotations

import argparse
import json
import sys

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


def load_initial_config_from_config_json_if_required(argv: list[str]) -> list[str]:
    """`--config <file.json>` seeds defaults; explicit CLI flags win."""
    if "--config" not in argv:
        return argv
    idx = argv.index("--config")
    path = argv[idx + 1]
    with open(path) as f:
        cfg = json.load(f)
    seeded = []
    for k, v in cfg.items():
        flag = "--" + k.replace("_", "-")
        if flag in argv:
            continue
        if isinstance(v, bool):
            if v:
                seeded.append(flag)
        else:
            seeded.extend([flag, str(v)])
    return argv[:idx] + argv[idx + 2 :] + seeded


def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = load_initial_config_from_config_json_if_required(argv)
    p = argparse.ArgumentParser("tpu-router")
    p.add_argument("--config", type=str, default=None, help="JSON config seeding defaults")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--service-discovery", choices=["static", "k8s"], default="static")
    p.add_argument("--static-backends", type=str, default=None,
                   help="comma-separated engine URLs")
    p.add_argument("--static-models", type=str, default=None,
                   help="comma-separated model names (one per backend)")
    p.add_argument("--static-aliases", type=str, default=None)
    p.add_argument("--static-model-labels", type=str, default=None)
    p.add_argument("--static-model-types", type=str, default=None)
    p.add_argument("--static-backend-health-checks", action="store_true")
    p.add_argument("--health-check-interval", type=float, default=10.0)
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--k8s-label-selector", default="")
    p.add_argument("--k8s-port", default="8000")
    p.add_argument("--routing-logic", default="roundrobin",
                   choices=["roundrobin", "session", "kvaware", "prefixaware",
                            "disaggregated_prefill"])
    p.add_argument("--session-key", type=str, default=None)
    p.add_argument("--kv-controller-url", type=str, default=None)
    p.add_argument("--kv-directory-url", type=str, default=None,
                   help="fleet-wide KV directory address (the cache server, "
                        "docs/kv-directory.md): kvaware routing v2 ranks "
                        "backends resident > restorable > cold against it")
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--prefill-model-labels", type=str, default=None)
    p.add_argument("--decode-model-labels", type=str, default=None)
    p.add_argument("--model-aliases", type=str, default=None, help="JSON dict")
    p.add_argument("--engine-stats-interval", type=float, default=15.0)
    p.add_argument("--request-stats-window", type=float, default=60.0)
    p.add_argument("--log-stats", action="store_true")
    p.add_argument("--log-stats-interval", type=float, default=10.0)
    # unauthenticated state-mutating debug endpoints (POST /metrics/reset);
    # benchmark/test harnesses only
    p.add_argument("--enable-debug-endpoints", action="store_true")
    p.add_argument("--dynamic-config-json", type=str, default=None)
    p.add_argument("--enable-batch-api", action="store_true")
    p.add_argument("--file-storage-path", type=str, default="/tmp/tpu_router_files")
    p.add_argument("--batch-db-path", type=str, default="/tmp/tpu_router_batches.sqlite")
    p.add_argument("--callbacks", type=str, default=None,
                   help="path.py:instance of CustomCallbackHandler")
    p.add_argument("--feature-gates", type=str, default="",
                   help="e.g. SemanticCache=true,PIIDetection=true")
    p.add_argument("--semantic-cache-threshold", type=float, default=0.92)
    p.add_argument("--semantic-cache-embedder", type=str, default="auto",
                   choices=["auto", "ngram", "sentence-transformers"],
                   help="auto probes for a locally-cached sentence-transformers "
                        "model (HF-offline, fails fast) and falls back to the "
                        "dependency-free n-gram embedder")
    p.add_argument("--pii-policy", type=str, default="redact",
                   choices=["redact", "block"])
    p.add_argument("--pii-analyzer", type=str, default="auto",
                   choices=["auto", "regex", "presidio"],
                   help="presidio activates the NER tier (requires "
                        "presidio-analyzer); auto falls back to regex")
    p.add_argument("--sentry-dsn", type=str, default=None)
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of requests recorded by the distributed "
                        "tracer (head-based, decided at the router and "
                        "propagated via traceparent); 0.0 disables span "
                        "recording entirely")
    p.add_argument("--trace-buffer-size", type=int, default=4096,
                   help="span ring-buffer capacity (bounds tracer memory)")
    # failure-domain layer (docs/failure-handling.md): retry/failover,
    # deadlines, passive circuit breaking
    p.add_argument("--retry-max-attempts", type=int, default=3,
                   help="proxy attempt budget per request (connect-stage and "
                        "pre-first-byte failures fail over to the routing "
                        "logic's next choice; 1 = no retries)")
    p.add_argument("--retry-backoff-base", type=float, default=0.05,
                   help="base backoff seconds between proxy attempts "
                        "(exponential with full jitter)")
    p.add_argument("--retry-backoff-max", type=float, default=2.0,
                   help="backoff cap in seconds")
    p.add_argument("--deadline-request", type=float, default=0.0,
                   help="seconds the ATTEMPT phase (connect + retries up to "
                        "first byte) may take before the request 504s; 0 "
                        "disables. Does not bound an already-streaming "
                        "response")
    p.add_argument("--deadline-ttft", type=float, default=0.0,
                   help="seconds to wait for the backend's first response "
                        "byte before aborting the engine-side request and "
                        "failing over; 0 disables. NOTE: a non-streaming "
                        "response's first byte arrives only when generation "
                        "COMPLETES — set this above worst-case non-stream "
                        "generation time (or serve long requests streamed)")
    p.add_argument("--deadline-inter-chunk", type=float, default=0.0,
                   help="max seconds between streamed chunks before the "
                        "stream is aborted on the engine and terminated "
                        "with an SSE error event; 0 disables")
    p.add_argument("--breaker-failure-threshold", type=int, default=5,
                   help="consecutive proxy failures that open a backend's "
                        "circuit breaker (0 disables circuit breaking)")
    p.add_argument("--breaker-cooldown", type=float, default=30.0,
                   help="seconds an open breaker waits before admitting a "
                        "half-open probe request")
    # per-request SLO accounting (router/slo.py, docs/observability.md):
    # objectives applied to the terminal records scraped from each engine's
    # /slo_records, exported as vllm_router:slo_{attained,violated}_total
    p.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                   help="TTFT objective in ms for the per-backend SLO "
                        "attainment counters (objective=\"ttft\")")
    p.add_argument("--slo-itl-ms", type=float, default=200.0,
                   help="inter-token-latency p99 objective in ms for the "
                        "SLO attainment counters (objective=\"itl\")")
    p.add_argument("--saturation-queue-ref", type=int, default=8,
                   help="waiting-queue depth that counts one backend as "
                        "fully saturated in vllm_router:fleet_saturation "
                        "(the prometheus-adapter autoscaling gauge)")
    p.add_argument("--batch-avoid-attainment", type=float, default=0.9,
                   help="interactive-TTFT attainment ratio below which a "
                        "backend stops receiving NEW batch-class traffic "
                        "(X-Priority: batch); 0 disables class-aware "
                        "placement (docs/failure-handling.md)")
    args = p.parse_args(argv)
    validate_args(args)
    return args


def validate_args(args) -> None:
    if args.service_discovery == "static":
        if not args.static_backends:
            raise ValueError("static discovery requires --static-backends")
        if not args.static_models:
            raise ValueError("static discovery requires --static-models")
        n_backends = len(args.static_backends.split(","))
        n_models = len(args.static_models.split(","))
        if n_backends != n_models:
            raise ValueError(
                f"--static-backends ({n_backends}) and --static-models ({n_models}) "
                "must have the same length"
            )
    if not 0.0 <= args.trace_sample_rate <= 1.0:
        raise ValueError("--trace-sample-rate must be in [0, 1]")
    if not 0.0 <= args.batch_avoid_attainment <= 1.0:
        raise ValueError("--batch-avoid-attainment must be in [0, 1]")
    if args.retry_max_attempts < 1:
        raise ValueError("--retry-max-attempts must be >= 1")
    if args.retry_backoff_base < 0 or args.retry_backoff_max < 0:
        raise ValueError("--retry-backoff-base/--retry-backoff-max must be >= 0")
    for flag in ("deadline_request", "deadline_ttft", "deadline_inter_chunk",
                 "breaker_cooldown"):
        if getattr(args, flag) < 0:
            raise ValueError(f"--{flag.replace('_', '-')} must be >= 0 (0 disables)")
    if args.trace_buffer_size < 1:
        raise ValueError("--trace-buffer-size must be >= 1")
    if args.slo_ttft_ms <= 0 or args.slo_itl_ms <= 0:
        raise ValueError("--slo-ttft-ms/--slo-itl-ms must be > 0")
    if args.saturation_queue_ref < 1:
        raise ValueError("--saturation-queue-ref must be >= 1")
    if args.routing_logic == "session" and not args.session_key:
        raise ValueError("session routing requires --session-key")
    if args.routing_logic == "kvaware" and not (
        args.kv_controller_url or args.kv_directory_url
    ):
        raise ValueError(
            "kvaware routing requires --kv-controller-url or "
            "--kv-directory-url"
        )
    if args.routing_logic == "disaggregated_prefill" and not (
        args.prefill_model_labels and args.decode_model_labels
    ):
        raise ValueError(
            "disaggregated_prefill requires --prefill-model-labels and "
            "--decode-model-labels"
        )
