"""Engine observability for the port: the flight recorder, plus the ambient
span-context slot the scheduler and KV manager publish admissions into.

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
    "render_flightrecorder_metrics",
    "reset_current",
    "set_current",
]
