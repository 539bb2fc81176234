"""Prometheus histogram support for the serving metrics endpoints.

The reference dashboard's headline panels are TTFT *distribution* and
request-latency *distribution* heatmaps over `vllm:time_to_first_token_seconds`
and `vllm:e2e_request_latency_seconds` histogram buckets (the upstream
stack's vLLM Grafana dashboard); gauges and
quantile snapshots cannot back those panels. This module provides the
cumulative bucket counters both the engine API server and the router export.

Bucket boundaries mirror vLLM's metric definitions so the reference
dashboard's queries work unchanged against our `/metrics`.
"""

from __future__ import annotations

import threading

# vLLM's TTFT histogram boundaries (seconds)
TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5, 0.75,
    1.0, 2.5, 5.0, 7.5, 10.0,
)
# vLLM's e2e request-latency boundaries (seconds)
LATENCY_BUCKETS = (
    0.3, 0.5, 0.8, 1.0, 1.5, 2.0, 2.5, 5.0, 10.0, 15.0, 20.0, 30.0,
    40.0, 50.0, 60.0,
)


class Histogram:
    """Cumulative Prometheus histogram (thread-safe observe + render)."""

    def __init__(self, name: str, buckets: tuple, help_: str = ""):
        self.name = name
        self.help = help_ or name
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += value
            self._total += 1

    def reset(self) -> None:
        """Debug/bench only (the /metrics/reset endpoint): live Prometheus
        counters must never reset outside a process restart."""
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._total = 0

    def render(self, labels: str) -> list[str]:
        """Prometheus exposition lines; ``labels`` like 'model_name="m"'."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._total, self._sum
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            le = f"{b:g}"
            lines.append(f'{self.name}_bucket{{{labels},le="{le}"}} {cum}')
        lines.append(f'{self.name}_bucket{{{labels},le="+Inf"}} {total}')
        lines.append(f"{self.name}_count{{{labels}}} {total}")
        lines.append(f"{self.name}_sum{{{labels}}} {s}")
        return lines
