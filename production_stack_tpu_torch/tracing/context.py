"""W3C trace-context propagation for request-level distributed tracing (the
port's copy of production_stack_tpu/tracing/context.py).

One request entering the stack carries a single 128-bit trace id from the
router proxy through the engine API server down to the KV-offload tiers; every
hop records spans under that id, so a trace stitches the whole
router -> engine -> offload path back together for latency attribution.

The wire format is the W3C ``traceparent`` header
(https://www.w3.org/TR/trace-context/):

    traceparent: 00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>

Only version ``00`` and the ``sampled`` flag bit (0x01) are interpreted;
unknown versions and malformed headers are ignored (a bad client header must
never break proxying). ``tracestate`` is not used.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, replace
from typing import Optional

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})"
    r"-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def gen_trace_id() -> str:
    return os.urandom(16).hex()


def gen_span_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class SpanContext:
    """Identity of one span: which trace it belongs to, its own id, the id of
    its parent span (None for a root), and whether the trace is sampled.

    The sampled flag is decided ONCE at the root (head-based sampling) and
    propagated, so a trace is either recorded end-to-end or not at all —
    partial traces are useless for attribution.
    """

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    sampled: bool = True

    def child(self) -> "SpanContext":
        """Context for a new span parented under this one."""
        return replace(self, span_id=gen_span_id(), parent_id=self.span_id)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @staticmethod
    def parse(header: Optional[str]) -> "Optional[SpanContext]":
        """Parse a ``traceparent`` header; None on anything malformed.

        An all-zero trace or span id is invalid per the spec (it would
        collide every such request into one phantom trace)."""
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m is None or m.group("version") == "ff":
            return None
        trace_id, span_id = m.group("trace_id"), m.group("span_id")
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return SpanContext(
            trace_id=trace_id,
            span_id=span_id,
            parent_id=None,
            sampled=bool(int(m.group("flags"), 16) & 0x01),
        )

    @staticmethod
    def from_headers(headers) -> "Optional[SpanContext]":
        """Extract the remote context from an HTTP header mapping."""
        try:
            return SpanContext.parse(headers.get(TRACEPARENT_HEADER))
        except Exception:  # noqa: BLE001 - malformed headers never break serving
            return None

    @staticmethod
    def new_root(sampled: bool = True) -> "SpanContext":
        return SpanContext(
            trace_id=gen_trace_id(), span_id=gen_span_id(), sampled=sampled
        )
