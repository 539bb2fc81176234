"""Request-level tracing and engine observability for the port, as the JAX
package's tracing/ gives them: a W3C ``traceparent`` context (context.py)
the server adopts from the router or roots itself; the span collector
(collector.py), a bounded ring with head sampling that the engine records
its ``engine.request``, ``engine.queue``, ``engine.prefill`` and
``engine.decode`` spans and the offload tiers their spill and restore spans
into, exported by ``/v1/traces``; the flight recorder (flightrecorder.py);
and the per-phase histograms (metrics.py: queue wait, prefill, TPOT,
offload restore, prefill chunk, interleaved decode).
"""

from production_stack_tpu_torch.tracing.collector import (
    Span,
    SpanCollector,
    configure_tracing,
    current_context,
    export_for_query,
    get_collector,
    render_collector_metrics,
    reset_current,
    set_current,
)
from production_stack_tpu_torch.tracing.context import (
    TRACEPARENT_HEADER,
    SpanContext,
    gen_span_id,
    gen_trace_id,
)
from production_stack_tpu_torch.tracing.flightrecorder import (
    FlightRecorder,
    configure_flightrecorder,
    get_flightrecorder,
    render_flightrecorder_metrics,
)
from production_stack_tpu_torch.tracing.metrics import (
    decode_step_time_hist,
    interleaved_decode_hist,
    offload_restore_hist,
    prefill_chunk_hist,
    prefill_time_hist,
    queue_time_hist,
    render_phase_histograms,
    reset_phase_histograms,
)

__all__ = [
    "FlightRecorder",
    "Span",
    "SpanCollector",
    "SpanContext",
    "TRACEPARENT_HEADER",
    "configure_flightrecorder",
    "configure_tracing",
    "current_context",
    "decode_step_time_hist",
    "export_for_query",
    "gen_span_id",
    "gen_trace_id",
    "get_collector",
    "get_flightrecorder",
    "interleaved_decode_hist",
    "offload_restore_hist",
    "prefill_chunk_hist",
    "prefill_time_hist",
    "queue_time_hist",
    "render_collector_metrics",
    "render_flightrecorder_metrics",
    "render_phase_histograms",
    "reset_current",
    "reset_phase_histograms",
    "set_current",
]
