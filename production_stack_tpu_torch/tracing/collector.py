"""In-process span collector: bounded ring buffer + head-based sampling (the
port's copy of production_stack_tpu/tracing/collector.py).

Spans are recorded from latency-critical paths (the router's streaming proxy
and the engine device thread), so the collector is deliberately minimal:

- **Ring buffer.** A fixed-size slot list plus an ``itertools.count`` cursor.
  ``next()`` on a count is atomic under the GIL, so concurrent writers each
  claim a distinct slot without a lock on the hot path; the oldest spans are
  overwritten when the buffer wraps. Memory is bounded by ``capacity``
  regardless of traffic.
- **Head-based sampling.** The root of a trace decides sampling once —
  deterministically from the trace id — and the decision rides the
  ``traceparent`` flags, so a trace is recorded end-to-end or not at all.
  ``sample_rate=0.0`` records nothing (record() is a flag check and return);
  ``1.0`` records everything.

The process-global collector is shared by every server hosted in the process
(router and engine both, when co-hosted in one process), which is exactly
what lets ``/v1/traces`` on either endpoint stitch a full trace together.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from production_stack_tpu_torch.tracing.context import SpanContext

DEFAULT_CAPACITY = 4096


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float          # epoch seconds
    duration: float       # seconds
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "duration_ms": round(self.duration * 1000, 3),
            "attrs": self.attrs,
        }


class SpanCollector:
    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, sample_rate: float = 1.0
    ):
        self.capacity = max(1, int(capacity))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self._slots: list = [None] * self.capacity
        self._cursor = itertools.count()
        # head-sampling rejections: record() calls that arrived with a real
        # but UNSAMPLED context. Counted (atomically, same count trick as the
        # slot cursor) so span loss is visible on /metrics BEFORE someone
        # debugs a latency tail with a trace that silently isn't there.
        self._rejected = itertools.count()

    @property
    def recorded(self) -> int:
        """Count of record() calls that stored a span since construction or
        the last reset(). Peeks the slot cursor — the same atomic counter
        that claims slots — so concurrent writers cannot lose updates the
        way a separate ``+= 1`` (a non-atomic read-modify-write) would."""
        # count.__reduce__() -> (count, (next_value,)) without consuming
        return self._cursor.__reduce__()[1][0]

    @property
    def overwritten(self) -> int:
        """Spans lost to the ring wrapping: every record past ``capacity``
        overwrote the oldest surviving span. The exact silent-loss count the
        trace_spans_dropped_total{reason="ring_wrap"} series exposes."""
        return max(0, self.recorded - self.capacity)

    @property
    def sampling_rejected(self) -> int:
        """record() calls dropped because their context was unsampled
        (head-sampling). Expected under a <1.0 sample rate — the counter
        makes the loss *visible*, it does not make it wrong."""
        return self._rejected.__reduce__()[1][0]

    # -- sampling -----------------------------------------------------------

    def sample(self, trace_id: Optional[str] = None) -> bool:
        """Head sampling decision for a new root. Deterministic in the trace
        id so retries of the same trace (and every server seeing it) agree;
        rate 0.0 samples nothing, 1.0 samples everything."""
        if self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        if trace_id is None:
            trace_id = "00000001"
        return int(trace_id[:8], 16) < self.sample_rate * float(1 << 32)

    def root_from_headers(self, headers) -> SpanContext:
        """Adopt the remote context from ``traceparent`` (its sampled flag is
        authoritative — head-based sampling), else start a fresh root sampled
        by this collector's rate.

        Exception: rate 0.0 is the operator's kill switch — it wins even over
        a sampled remote flag, so an untrusted client header can never force
        recording back on (the trace id is still adopted for correlation)."""
        remote = SpanContext.from_headers(headers)
        if remote is not None:
            if self.sample_rate <= 0.0 and remote.sampled:
                from dataclasses import replace

                return replace(remote, sampled=False)
            return remote
        from production_stack_tpu_torch.tracing.context import gen_span_id, gen_trace_id

        tid = gen_trace_id()
        return SpanContext(
            trace_id=tid, span_id=gen_span_id(), sampled=self.sample(tid)
        )

    # -- recording ----------------------------------------------------------

    def record(
        self,
        name: str,
        ctx: Optional[SpanContext],
        start: float,
        duration: float,
        **attrs,
    ) -> None:
        """Store one completed span. No-op for missing/unsampled contexts —
        this is the entire overhead of tracing when sampling is off (plus one
        atomic counter bump for unsampled contexts, so trace loss is
        observable)."""
        if ctx is None:
            return
        if not ctx.sampled:
            next(self._rejected)
            return
        span = Span(
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_id=ctx.parent_id,
            name=name,
            start=start,
            duration=max(0.0, duration),
            attrs=attrs,
        )
        # lock-free-ish: the counter hands each writer a distinct slot; a
        # reader may see a slot mid-overwrite as either old or new span —
        # both are valid spans, so snapshots never tear
        self._slots[next(self._cursor) % self.capacity] = span

    # -- reading ------------------------------------------------------------

    def spans(self) -> list[Span]:
        return [s for s in list(self._slots) if s is not None]

    def traces(
        self, trace_id: Optional[str] = None, limit: int = 50
    ) -> list[dict]:
        """Spans grouped per trace, most recently started trace first."""
        by_trace: dict[str, list[Span]] = {}
        for s in self.spans():
            by_trace.setdefault(s.trace_id, []).append(s)
        if trace_id is not None:
            by_trace = {
                t: ss for t, ss in by_trace.items() if t == trace_id
            }
        ordered = sorted(
            by_trace.items(),
            key=lambda kv: max(s.start for s in kv[1]),
            reverse=True,
        )[: max(0, int(limit))]
        return [
            {
                "trace_id": t,
                "spans": [s.to_dict() for s in sorted(ss, key=lambda s: s.start)],
            }
            for t, ss in ordered
        ]

    def export(self, trace_id: Optional[str] = None, limit: int = 50) -> dict:
        """JSON-serializable payload for /v1/traces and offline analysis
        (scripts/trace_report.py consumes exactly this shape)."""
        return {
            "sample_rate": self.sample_rate,
            "capacity": self.capacity,
            "recorded_total": self.recorded,
            "exported_at": time.time(),
            "traces": self.traces(trace_id=trace_id, limit=limit),
        }

    def export_json(self, **kw) -> str:
        return json.dumps(self.export(**kw))

    def reset(self) -> None:
        """Debug/bench only: clear the buffer so a phase's traces describe
        that phase."""
        self._slots = [None] * self.capacity
        self._cursor = itertools.count()
        self._rejected = itertools.count()


# -- process-global collector -------------------------------------------------

_collector = SpanCollector()
_lock = threading.Lock()


def configure_tracing(
    sample_rate: Optional[float] = None, capacity: Optional[int] = None
) -> SpanCollector:
    """(Re)configure the process-global collector. Resizing replaces the
    buffer (old spans drop); a pure rate change keeps recorded spans."""
    global _collector
    with _lock:
        if capacity is not None and int(capacity) != _collector.capacity:
            _collector = SpanCollector(
                capacity=capacity,
                sample_rate=(
                    _collector.sample_rate if sample_rate is None else sample_rate
                ),
            )
        elif sample_rate is not None:
            _collector.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        return _collector


def get_collector() -> SpanCollector:
    return _collector


def render_collector_metrics(labels: str) -> list[str]:
    """Prometheus lines for span-loss visibility (rendered by every server
    hosting the collector — engine, router, fake engine): the ring wrapping
    and head-sampling both drop spans BY DESIGN, and an attribution built on
    an incomplete trace is misleading unless the loss is measurable."""
    col = get_collector()
    return [
        "# TYPE vllm:trace_spans_recorded_total counter",
        f"vllm:trace_spans_recorded_total{{{labels}}} {col.recorded}",
        "# TYPE vllm:trace_spans_dropped_total counter",
        f'vllm:trace_spans_dropped_total{{{labels},reason="ring_wrap"}} '
        f"{col.overwritten}",
        f'vllm:trace_spans_dropped_total{{{labels},reason="unsampled"}} '
        f"{col.sampling_rejected}",
        "# TYPE vllm:trace_buffer_capacity gauge",
        f"vllm:trace_buffer_capacity{{{labels}}} {col.capacity}",
    ]


def export_for_query(query) -> "tuple[dict, int]":
    """Shared ``GET /v1/traces`` implementation for every server hosting the
    collector (router, engine, fake engine): parse ``?trace_id=``/``?limit=``
    from an HTTP query mapping and return ``(json_payload, status)`` — one
    place, so the export contract cannot drift between surfaces."""
    try:
        limit = int(query.get("limit", "50"))
    except (TypeError, ValueError):
        return {"error": "limit must be an int"}, 400
    return (
        get_collector().export(trace_id=query.get("trace_id"), limit=limit),
        200,
    )


# -- ambient context (KV-offload spans) ---------------------------------------
#
# The offload tiers run deep inside the scheduler's admission path, far from
# any HTTP handler; the admitting sequence's context is published here (engine
# device thread) so spill/restore spans parent under the request that caused
# them.

_current: contextvars.ContextVar = contextvars.ContextVar(
    "pstpu_torch_trace_ctx", default=None
)


def set_current(ctx: Optional[SpanContext]):
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


def current_context() -> Optional[SpanContext]:
    return _current.get()
