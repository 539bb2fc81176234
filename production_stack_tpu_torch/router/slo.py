"""Router-side SLO accounting: per-model/per-backend attainment counters and
the fleet saturation gauge (docs/observability.md).

The port's copy of ``production_stack_tpu/router/slo.py``;
it imports neither the JAX package nor torch.

The engine attributes every finished request a terminal record (queue wait,
TTFT, inter-token p99, token counts, KV pages peak, outcome) in a bounded log
served by ``GET /slo_records?since=<cursor>``; the stats scraper
(engine_stats.py) polls it per backend each scrape interval and feeds the
records here. This module applies the router's configured objectives and
exports, on the router's ``/metrics``:

- ``vllm_router:slo_attained_total{objective,model,priority,server}`` /
  ``vllm_router:slo_violated_total{...}`` — per-objective counters, split
  by the request's SLO class (``priority="interactive"|"batch"``):
  * ``objective="ttft"``        — TTFT <= --slo-ttft-ms (ok requests only)
  * ``objective="itl"``         — inter-token p99 <= --slo-itl-ms
  * ``objective="availability"``— the request finished ok at all (sheds,
    aborts, and errors violate; they have no honest latency to judge)
- ``vllm_router:slo_request_outcomes_total{outcome,server}`` — terminal
  outcome counts (ok / shed / abort / error / migrated; a "migrated" record
  is the SOURCE side of a live migration and abstains from every latency
  and availability objective — the target attributes the real terminal).
- ``vllm_router:slo_records_total{server}`` — records ingested (a flat line
  while traffic flows means the backend's /slo_records scrape is broken).
- ``vllm_router:fleet_saturation`` — a single [0, 1] gauge: the mean
  per-backend saturation score, where a backend inside a shed Retry-After
  window or reporting ``vllm:engine_saturated`` scores 1.0 and otherwise
  its waiting-queue depth scores ``min(1, waiting / --saturation-queue-ref)``.
  This is the prometheus-adapter autoscaling signal
  (observability/prom-adapter.yaml exports it as ``tpu_fleet_saturation``):
  unlike raw QPS it rises with *pressure* (queue growth, sheds) rather than
  with traffic the fleet is absorbing fine, and unlike
  ``num_requests_waiting`` alone it is normalized to fleet size so the HPA
  target is a stable fraction.

All counters are label-bounded: objective/outcome are closed enums, model
and server come from service discovery (no per-request labels — the
cardinality test in tests/test_tracing.py enforces this stack-wide).
"""

from __future__ import annotations

from typing import Iterable, Optional

from production_stack_tpu_torch.router.utils import SingletonMeta
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

OBJECTIVES = ("ttft", "itl", "availability")
OUTCOMES = ("ok", "shed", "abort", "error", "migrated")
# per-request SLO classes (docs/failure-handling.md priority classes): a
# closed label set — records carrying anything else degrade to interactive
PRIORITIES = ("interactive", "batch")


class SLOMonitor(metaclass=SingletonMeta):
    def __init__(
        self,
        ttft_ms: float = 2000.0,
        itl_ms: float = 200.0,
        saturation_queue_ref: int = 8,
    ):
        self.ttft_ms = float(ttft_ms)
        self.itl_ms = float(itl_ms)
        self.saturation_queue_ref = max(1, int(saturation_queue_ref))
        # per-backend /slo_records cursor (the scraper reads + advances it)
        self._cursors: dict[str, int] = {}
        # (server, model, objective, priority) -> [attained, violated] —
        # same two families, one extra closed-set label, so per-class
        # attainment is scrapeable without new metric names
        self._counters: dict[tuple, list] = {}
        # (server, outcome) -> count
        self._outcomes: dict[tuple, int] = {}
        self._records_total: dict[str, int] = {}

    # -- scrape protocol -----------------------------------------------------

    def cursor(self, url: str) -> int:
        return self._cursors.get(url, 0)

    def ingest(self, url: str, payload: dict) -> int:
        """Apply one /slo_records response; returns records consumed. A
        ``head`` below our cursor means the engine restarted (fresh record
        counter) — reset so the next scrape picks the new incarnation's
        records up from zero instead of waiting out the old watermark."""
        try:
            head = int(payload.get("head", 0))
            records = payload.get("records") or []
        except AttributeError:
            return 0
        since = self._cursors.get(url, 0)
        if head < since:
            self._cursors[url] = 0
            return 0
        n = 0
        for rec in records:
            try:
                self._apply(url, rec)
                n += 1
            except (AttributeError, TypeError, KeyError, ValueError):
                continue  # malformed record must not poison the batch
        self._cursors[url] = max(since, int(payload.get("next", since)))
        return n

    def _bump(
        self,
        server: str,
        model: str,
        objective: str,
        attained: bool,
        priority: str = "interactive",
    ):
        key = (server, model, objective, priority)
        cell = self._counters.get(key)
        if cell is None:
            cell = self._counters[key] = [0, 0]
        cell[0 if attained else 1] += 1

    def _apply(self, url: str, rec: dict) -> None:
        model = str(rec.get("model") or "unknown")
        outcome = str(rec.get("outcome") or "error")
        if outcome not in OUTCOMES:
            outcome = "error"
        priority = str(rec.get("priority") or "interactive")
        if priority not in PRIORITIES:
            priority = "interactive"
        self._records_total[url] = self._records_total.get(url, 0) + 1
        self._outcomes[(url, outcome)] = self._outcomes.get((url, outcome), 0) + 1
        if outcome == "migrated":
            # the stream continues on another engine, which attributes the
            # REAL terminal record when it finishes — the source's handoff
            # record is diagnostic only. Counting it as an availability
            # violation would charge every rebalance as an outage; counting
            # it attained would double-count the request.
            return
        self._bump(url, model, "availability", outcome == "ok", priority)
        if outcome != "ok":
            # a shed/abort/error has no honest latency to judge: it violates
            # availability, and the latency objectives abstain (counting it
            # as a TTFT violation too would double-charge one failure)
            return
        ttft = rec.get("ttft_ms")
        if ttft is not None:
            self._bump(url, model, "ttft", float(ttft) <= self.ttft_ms,
                       priority)
        itl = rec.get("itl_p99_ms")
        if itl is not None:
            self._bump(url, model, "itl", float(itl) <= self.itl_ms,
                       priority)

    def interactive_attainment(
        self, server: str, objective: str = "ttft"
    ) -> Optional[float]:
        """Interactive-class attainment ratio for one backend and objective
        (all models summed), or None before any interactive record landed.
        The router's class-aware placement reads this: batch traffic avoids
        backends whose interactive attainment is degraded, and the fleet
        controller corroborates its engine-side latency watermark with it."""
        att = vio = 0
        for (srv, _model, obj, pri), cell in self._counters.items():
            if srv == server and obj == objective and pri == "interactive":
                att += cell[0]
                vio += cell[1]
        total = att + vio
        return (att / total) if total else None

    def forget(self, url: str) -> None:
        """Drop a backend's cursor. NOT called on discovery dropout — a
        flapping (but not restarted) backend rejoining would re-serve its
        retained records from seq 0 and double-count; ``ingest``'s
        head-below-cursor check already handles real restarts. Kept for
        tests and manual resets (counters persist either way — Prometheus
        counters must not vanish mid-series)."""
        self._cursors.pop(url, None)

    # -- fleet saturation ----------------------------------------------------

    def fleet_saturation(
        self,
        engine_stats: dict,
        shedding_urls: Optional[Iterable[str]] = None,
    ) -> float:
        """Mean per-backend saturation score in [0, 1] (see module doc)."""
        shedding = set(shedding_urls or ())
        urls = set(engine_stats) | shedding
        if not urls:
            return 0.0
        total = 0.0
        for url in urls:
            es = engine_stats.get(url)
            if url in shedding or (
                es is not None and getattr(es, "engine_saturated", 0)
            ):
                total += 1.0
            elif es is not None:
                waiting = float(getattr(es, "num_queuing_requests", 0) or 0)
                total += min(1.0, waiting / self.saturation_queue_ref)
        return total / len(urls)

    # -- exposition ----------------------------------------------------------

    def render(self, fleet_saturation: Optional[float] = None) -> list[str]:
        lines = [
            "# TYPE vllm_router:slo_attained_total counter",
            "# TYPE vllm_router:slo_violated_total counter",
        ]
        for (server, model, objective, priority), (att, vio) in sorted(
            self._counters.items()
        ):
            lab = (
                f'objective="{objective}",model="{model}"'
                f',priority="{priority}",server="{server}"'
            )
            lines.append(f"vllm_router:slo_attained_total{{{lab}}} {att}")
            lines.append(f"vllm_router:slo_violated_total{{{lab}}} {vio}")
        lines.append("# TYPE vllm_router:slo_request_outcomes_total counter")
        for (server, outcome), n in sorted(self._outcomes.items()):
            lines.append(
                f"vllm_router:slo_request_outcomes_total"
                f'{{outcome="{outcome}",server="{server}"}} {n}'
            )
        lines.append("# TYPE vllm_router:slo_records_total counter")
        for server, n in sorted(self._records_total.items()):
            lines.append(
                f'vllm_router:slo_records_total{{server="{server}"}} {n}'
            )
        if fleet_saturation is not None:
            lines += [
                "# TYPE vllm_router:fleet_saturation gauge",
                f"vllm_router:fleet_saturation {round(fleet_saturation, 4)}",
            ]
        return lines


def initialize_slo_monitor(
    ttft_ms: float = 2000.0,
    itl_ms: float = 200.0,
    saturation_queue_ref: int = 8,
) -> SLOMonitor:
    return SLOMonitor(ttft_ms, itl_ms, saturation_queue_ref)


def get_slo_monitor() -> SLOMonitor:
    return SLOMonitor()
