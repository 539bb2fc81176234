"""Engine observability for the port: the flight recorder, the ambient
span-context slot the scheduler and KV manager publish admissions into, and
the offload-restore histogram (``vllm:kv_offload_restore_seconds``).

Only what the serving path calls lives here. The span collector and its
``/v1/traces`` export are not part of the port yet, so ``current_context``
always carries whatever the scheduler set (``None`` for untraced requests).
"""

from __future__ import annotations

import contextvars

from production_stack_tpu_torch.tracing.flightrecorder import (
    FlightRecorder,
    configure_flightrecorder,
    get_flightrecorder,
    render_flightrecorder_metrics,
)

from production_stack_tpu_torch.utils.metrics import Histogram

# the JAX package's buckets (production_stack_tpu/tracing/metrics.py)
RESTORE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
offload_restore_hist = Histogram(
    "vllm:kv_offload_restore_seconds", RESTORE_BUCKETS, "KV offload-tier restore batch duration"
)

_current: contextvars.ContextVar = contextvars.ContextVar(
    "pstpu_torch_trace_ctx", default=None
)


def set_current(ctx):
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


def current_context():
    return _current.get()


__all__ = [
    "FlightRecorder",
    "configure_flightrecorder",
    "current_context",
    "get_flightrecorder",
    "offload_restore_hist",
    "render_flightrecorder_metrics",
    "reset_current",
    "set_current",
]
