"""Per-phase Prometheus histograms (the port's copy of the JAX package's
tracing/metrics.py, same names, buckets and help text).

Named to mirror vLLM's metric definitions so the dashboard's phase-breakdown
panels read a port engine's ``/metrics`` unchanged:

- ``vllm:request_queue_time_seconds``   -- arrival -> first prefill dispatch
- ``vllm:request_prefill_time_seconds`` -- first dispatch -> first token
- ``vllm:time_per_output_token_seconds``-- decode time / output tokens (TPOT)
- ``vllm:kv_offload_restore_seconds``   -- offload-tier restore batches
- ``vllm:prefill_chunk_seconds``        -- one fetched prefill dispatch's wall
- ``vllm:interleaved_decode_step_seconds`` -- decode time per token of a
  burst dispatched while a prefill is resident

The engine observes them (it owns the phases): the first three once per
finished request, the last two once per dispatch. A few observes per request
are noise beside a device step, so they are always on.
"""

from __future__ import annotations

from production_stack_tpu_torch.utils.metrics import LATENCY_BUCKETS, Histogram

# vLLM's time_per_output_token histogram boundaries (seconds)
TPOT_BUCKETS = (
    0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0, 2.5,
)
# restore batches are bounded by kv_offload_max_io_pages; sub-second to a few
# seconds on network-attached hosts
RESTORE_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

queue_time_hist = Histogram(
    "vllm:request_queue_time_seconds", LATENCY_BUCKETS,
    "Request queue wait (arrival to first prefill dispatch)",
)
prefill_time_hist = Histogram(
    "vllm:request_prefill_time_seconds", LATENCY_BUCKETS,
    "Prefill phase duration (first dispatch to first token)",
)
decode_step_time_hist = Histogram(
    "vllm:time_per_output_token_seconds", TPOT_BUCKETS,
    "Mean decode time per output token (first token to finish)",
)
offload_restore_hist = Histogram(
    "vllm:kv_offload_restore_seconds", RESTORE_BUCKETS,
    "KV offload-tier restore batch duration",
)
prefill_chunk_hist = Histogram(
    "vllm:prefill_chunk_seconds", TPOT_BUCKETS + (5.0, 10.0),
    "One chunked-prefill dispatch's device wall time",
)
interleaved_decode_hist = Histogram(
    "vllm:interleaved_decode_step_seconds", TPOT_BUCKETS,
    "Decode time per output token for bursts interleaved with an "
    "in-flight prefill",
)

PHASE_HISTOGRAMS = (
    queue_time_hist,
    prefill_time_hist,
    decode_step_time_hist,
    offload_restore_hist,
    prefill_chunk_hist,
    interleaved_decode_hist,
)


def render_phase_histograms(labels: str) -> list[str]:
    """Exposition lines for every phase histogram under ``labels``."""
    lines: list[str] = []
    for h in PHASE_HISTOGRAMS:
        lines.extend(h.render(labels))
    return lines


def reset_phase_histograms() -> None:
    """Debug/bench only (the /metrics/reset endpoint)."""
    for h in PHASE_HISTOGRAMS:
        h.reset()
