"""Engine flight recorder: a bounded, lock-free ring of structured engine
events for postmortem and live introspection.

The tracing subsystem (collector.py) answers "where did THIS request's time
go"; the flight recorder answers the complementary question — "what was the
ENGINE doing when things went wrong": which scheduler dispatches, KV
evictions/spills/restores, admission sheds, and JAX compiles surrounded a bad
tail or a chaos event. Events are cheap dicts stamped with a monotonically
increasing sequence number, the engine step index, wall-clock time, and the
active trace id (when the triggering request carries a sampled PR-1 span
context), so a flight-recorder window cross-links to ``/v1/traces`` spans by
trace id and to logs by request id.

Recording uses the same lock-free pattern as the span collector: an
``itertools.count`` cursor hands each writer a distinct ring slot (``next()``
is atomic under the GIL), so the device thread pays a dict build + one list
store per event and nothing blocks. Memory is bounded by ``capacity``.

Surfaces:

- ``GET /v1/debug/flightrecorder`` (engine + fake engine, debug-gated on the
  real engine): JSON export, filterable by ``?request_id=`` / ``?trace_id=`` /
  ``?kind=`` / ``?since_step=`` / ``?until_step=`` / ``?limit=``.
- **Anomaly dumps**: ``dump(reason)`` writes the current window to
  ``<dump_dir>/flightrecorder-<reason>-<ts>.json`` for postmortems. Triggers
  wired by the engine/fake engine: engine-loop step failure, SIGTERM drain,
  shed bursts, and the TTFT p99-breach watermark. Rate-limited per reason so
  a sustained breach cannot fill the disk (crash/drain dumps bypass the
  limit — there is no second chance to take them).

Event kinds recorded by the engine (docs/observability.md):

- ``sched``  — one per dispatched batch: kind, rows, bursts, chunk tokens,
  interleave-gate inputs/decision, queue depths, seq + trace ids.
- ``step``   — device wall time of a fetched dispatch.
- ``kv``     — page-manager ops (evict/spill/restore/warm_restore) with page
  counts and victim reuse scores.
- ``shed``   — admission-control sheds (queue_full / queue_deadline / api).
- ``compile``— JAX backend compiles (duration via jax.monitoring) and new
  jit program variants at the runner's cache boundaries.
- ``slo``    — per-request terminal records (mirrors /slo_records).
- ``anomaly``— a dump was taken (reason + path), recorded into the ring
  itself so later exports show the trigger history.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

DEFAULT_CAPACITY = 8192

# minimum seconds between two disk dumps for the SAME reason (forced dumps —
# crash / SIGTERM — bypass this)
DUMP_MIN_INTERVAL_S = 10.0


class FlightRecorder:
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        enabled: bool = True,
        dump_dir: Optional[str] = None,
    ):
        self.capacity = max(16, int(capacity))
        self.enabled = bool(enabled)
        self.dump_dir = dump_dir
        self._slots: list = [None] * self.capacity  # owned-by: any
        self._cursor = itertools.count()  # owned-by: any
        self._last_dump: dict[str, float] = {}  # guarded-by: _dump_lock
        self._dump_lock = threading.Lock()
        self.dumps_total = 0

    # -- recording ----------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Events recorded since construction/reset (atomic cursor peek)."""
        return self._cursor.__reduce__()[1][0]

    @property
    def dropped(self) -> int:
        """Events overwritten by the ring wrapping (bounded-memory cost)."""
        return max(0, self.recorded - self.capacity)

    def record(
        self,
        kind: str,
        *,
        step: int = -1,
        trace_id: Optional[str] = None,
        **data,
    ) -> None:
        """Store one event. The entire hot-path cost when disabled is one
        attribute check; when enabled, a dict build + one atomic slot claim
        (same lock-free scheme as the span collector's ring)."""
        if not self.enabled:
            return
        seq = next(self._cursor)
        self._slots[seq % self.capacity] = {
            "seq": seq,
            "kind": kind,
            "t": time.time(),
            "step": step,
            "trace_id": trace_id,
            "data": data,
        }

    # -- reading ------------------------------------------------------------

    def events(
        self,
        request_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        kind: Optional[str] = None,
        since_step: Optional[int] = None,
        until_step: Optional[int] = None,
        limit: int = 0,
    ) -> list[dict]:
        """Filtered, chronologically ordered (by seq) event snapshot.

        ``request_id`` matches the event's ``seq_id``/``request_id`` fields or
        membership in its ``seq_ids`` list (batch events carry the first few
        member ids). Events recorded outside any engine step (KV-manager ops,
        compile listener — ``step`` -1) are always inside a step-range
        window: a postmortem cut by step range must not silently claim "no
        evictions, no compiles". A reader may race a writer mid-overwrite
        and see either the old or the new event in a slot — both are whole
        events, so snapshots never tear."""
        out = []
        for ev in list(self._slots):
            if ev is None:
                continue
            if kind is not None and ev["kind"] != kind:
                continue
            if trace_id is not None and ev.get("trace_id") != trace_id:
                continue
            if since_step is not None and 0 <= ev["step"] < since_step:
                continue
            if (
                until_step is not None
                and ev["step"] >= 0
                and ev["step"] > until_step
            ):
                continue
            if request_id is not None:
                d = ev["data"]
                if not (
                    d.get("seq_id") == request_id
                    or d.get("request_id") == request_id
                    or request_id in (d.get("seq_ids") or ())
                ):
                    continue
            out.append(ev)
        out.sort(key=lambda e: e["seq"])
        if limit and limit > 0:
            out = out[-limit:]
        return out

    def export(self, **filters) -> dict:
        """JSON-serializable payload for /v1/debug/flightrecorder and the
        anomaly dump files (scripts/trace_report.py --flightrecorder consumes
        exactly this shape)."""
        return {
            "capacity": self.capacity,
            "enabled": self.enabled,
            "recorded_total": self.recorded,
            "dropped_total": self.dropped,
            "dumps_total": self.dumps_total,
            "exported_at": time.time(),
            "events": self.events(**filters),
        }

    # -- anomaly dumps ------------------------------------------------------

    def dump(self, reason: str, force: bool = False) -> Optional[str]:
        """Write the current window to disk for postmortem use. Returns the
        file path, or None when no dump dir is configured / the per-reason
        rate limit holds. ``force`` bypasses the limit (crash/SIGTERM —
        the process is about to die, this is the only chance)."""
        if not self.dump_dir:
            return None
        with self._dump_lock:
            now = time.monotonic()
            last = self._last_dump.get(reason, -1e18)
            if not force and now - last < DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[reason] = now
        # the trigger itself becomes part of the record BEFORE export, so the
        # dump (and later live exports) show it in sequence
        self.record("anomaly", reason=reason)
        path = os.path.join(
            self.dump_dir,
            f"flightrecorder-{reason}-{int(time.time() * 1000)}.json",
        )
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            payload = self.export()
            payload["reason"] = reason
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # readers only ever see whole dumps
        except OSError:
            return None
        self.dumps_total += 1
        return path

    def dump_async(self, reason: str) -> None:
        """Rate-limit-aware background dump for hot-path triggers (shed
        bursts on the event loop, TTFT breaches on the device thread):
        serializing an 8k-event ring inline would stall serving exactly when
        it is most loaded. The cheap pre-check races dump()'s authoritative
        one at worst into a spare no-op thread; forced dumps (crash/SIGTERM)
        stay synchronous — the process is about to die."""
        if not self.dump_dir:
            return
        # dump() re-reads _last_dump under _dump_lock authoritatively; the
        # worst a torn read here costs is one spare no-op thread
        last = self._last_dump.get(reason, -1e18)  # graftcheck: disable=GC004 — racy-by-design rate-limit pre-check, dump() re-checks under the lock
        if time.monotonic() - last < DUMP_MIN_INTERVAL_S:
            return
        threading.Thread(
            target=self.dump, args=(reason,), daemon=True
        ).start()

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def reset(self) -> None:
        """Debug/bench only: clear the ring so a phase's events describe
        that phase."""
        self._slots = [None] * self.capacity
        self._cursor = itertools.count()


# -- process-global recorder --------------------------------------------------

_recorder = FlightRecorder()
_lock = threading.Lock()


def configure_flightrecorder(
    capacity: Optional[int] = None,
    enabled: Optional[bool] = None,
    dump_dir: Optional[str] = None,
) -> FlightRecorder:
    """(Re)configure the process-global recorder. Resizing replaces the ring
    (old events drop); enable/dump-dir changes keep recorded events."""
    global _recorder
    with _lock:
        if capacity is not None and int(capacity) != _recorder.capacity:
            _recorder = FlightRecorder(
                capacity=capacity,
                enabled=_recorder.enabled if enabled is None else enabled,
                dump_dir=dump_dir if dump_dir is not None else _recorder.dump_dir,
            )
        else:
            if enabled is not None:
                _recorder.enabled = bool(enabled)
            if dump_dir is not None:
                _recorder.dump_dir = dump_dir
        return _recorder


def get_flightrecorder() -> FlightRecorder:
    return _recorder


def export_for_query(query) -> "tuple[dict, int]":
    """Shared ``GET /v1/debug/flightrecorder`` implementation for every server
    hosting the recorder (engine, fake engine): parse filters from an HTTP
    query mapping and return ``(json_payload, status)``."""
    filters: dict = {}
    for key in ("request_id", "trace_id", "kind"):
        if query.get(key):
            filters[key] = query[key]
    for key in ("since_step", "until_step", "limit"):
        raw = query.get(key)
        if raw is None:
            continue
        try:
            filters[key] = int(raw)
        except (TypeError, ValueError):
            return {"error": f"{key} must be an int"}, 400
    return get_flightrecorder().export(**filters), 200


def render_flightrecorder_metrics(labels: str) -> list[str]:
    """Prometheus exposition lines for the recorder's own health (the
    'recorder drops' dashboard panel): a wrapped ring silently loses the
    oldest events, and a postmortem built on a holey window must say so."""
    fr = get_flightrecorder()
    return [
        "# TYPE vllm:flightrecorder_events_total counter",
        f"vllm:flightrecorder_events_total{{{labels}}} {fr.recorded}",
        "# TYPE vllm:flightrecorder_dropped_events_total counter",
        f"vllm:flightrecorder_dropped_events_total{{{labels}}} {fr.dropped}",
        "# TYPE vllm:flightrecorder_capacity gauge",
        f"vllm:flightrecorder_capacity{{{labels}}} {fr.capacity}",
        "# TYPE vllm:flightrecorder_enabled gauge",
        f"vllm:flightrecorder_enabled{{{labels}}} {int(fr.enabled)}",
        "# TYPE vllm:flightrecorder_dumps_total counter",
        f"vllm:flightrecorder_dumps_total{{{labels}}} {fr.dumps_total}",
    ]
