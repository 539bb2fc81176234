"""Per-engine request statistics with sliding windows.

The port's copy of ``production_stack_tpu/router/request_stats.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/stats/request_stats.py of the upstream vLLM production stack —
RequestStats :34-55, MovingAverageMonitor :58-103, RequestStatsMonitor
lifecycle callbacks :145-236, get_request_stats :238-306.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

from production_stack_tpu_torch.router.utils import SingletonMeta


@dataclasses.dataclass
class RequestStats:
    qps: float = 0.0
    ttft: float = -1.0
    in_prefill_requests: int = 0
    in_decoding_requests: int = 0
    finished_requests: int = 0
    uptime: float = 0.0
    avg_decoding_length: float = -1.0
    avg_latency: float = -1.0
    avg_itl: float = -1.0
    num_swapped_requests: int = 0


class MovingAverageMonitor:
    """Sliding-window average over (timestamp, value) samples."""

    def __init__(self, window: float):
        self.window = window
        self.samples: deque[tuple[float, float]] = deque()

    def update(self, ts: float, value: float) -> None:
        self.samples.append((ts, value))
        self._trim(ts)

    def update_no_value(self, ts: float) -> None:
        self.update(ts, 0.0)

    def _trim(self, now: float) -> None:
        while self.samples and self.samples[0][0] < now - self.window:
            self.samples.popleft()

    def get_average(self) -> float:
        if not self.samples:
            return -1.0
        return sum(v for _, v in self.samples) / len(self.samples)

    def get_sum(self) -> float:
        return sum(v for _, v in self.samples)

    def get_count(self) -> int:
        return len(self.samples)


class RequestStatsMonitor(metaclass=SingletonMeta):
    def __init__(self, sliding_window: float = 60.0):
        self.sliding_window = sliding_window
        self.qps_monitors: dict[str, MovingAverageMonitor] = {}
        self.ttft_monitors: dict[str, MovingAverageMonitor] = {}
        self.latency_monitors: dict[str, MovingAverageMonitor] = {}
        self.decoding_length: dict[str, MovingAverageMonitor] = {}
        self.itl_monitors: dict[str, MovingAverageMonitor] = {}
        # (engine_url, request_id) -> timestamps
        self.request_start: dict[tuple[str, str], float] = {}
        self.first_token: dict[tuple[str, str], float] = {}
        self.last_token: dict[tuple[str, str], float] = {}
        self.tokens_seen: dict[tuple[str, str], int] = {}
        self.in_prefill: dict[str, int] = {}
        self.in_decoding: dict[str, int] = {}
        self.finished: dict[str, int] = {}
        self.swapped: dict[str, int] = {}
        self.first_query: Optional[float] = None

    def _mon(self, d: dict, url: str) -> MovingAverageMonitor:
        if url not in d:
            d[url] = MovingAverageMonitor(self.sliding_window)
        return d[url]

    def on_new_request(self, url: str, request_id: str, ts: Optional[float] = None) -> None:
        ts = ts or time.monotonic()
        if self.first_query is None:
            self.first_query = ts
        self.request_start[(url, request_id)] = ts
        self.in_prefill[url] = self.in_prefill.get(url, 0) + 1
        self._mon(self.qps_monitors, url).update_no_value(ts)

    def on_request_response(self, url: str, request_id: str, ts: Optional[float] = None) -> None:
        """First token received: prefill -> decode."""
        key = (url, request_id)
        if key not in self.request_start or key in self.first_token:
            return
        ts = ts or time.monotonic()
        self.first_token[key] = ts
        self.last_token[key] = ts
        self.tokens_seen[key] = 1
        self.in_prefill[url] = max(0, self.in_prefill.get(url, 0) - 1)
        self.in_decoding[url] = self.in_decoding.get(url, 0) + 1
        self._mon(self.ttft_monitors, url).update(ts, ts - self.request_start[key])

    def on_token(self, url: str, request_id: str, ts: Optional[float] = None) -> None:
        key = (url, request_id)
        if key not in self.first_token:
            return
        ts = ts or time.monotonic()
        prev = self.last_token.get(key, ts)
        self._mon(self.itl_monitors, url).update(ts, ts - prev)
        self.last_token[key] = ts
        self.tokens_seen[key] = self.tokens_seen.get(key, 0) + 1

    def on_request_complete(self, url: str, request_id: str, ts: Optional[float] = None) -> None:
        key = (url, request_id)
        start = self.request_start.pop(key, None)
        ts = ts or time.monotonic()
        if key in self.first_token:
            self.in_decoding[url] = max(0, self.in_decoding.get(url, 0) - 1)
            self._mon(self.decoding_length, url).update(ts, self.tokens_seen.get(key, 0))
        else:
            self.in_prefill[url] = max(0, self.in_prefill.get(url, 0) - 1)
        self.finished[url] = self.finished.get(url, 0) + 1
        if start is not None:
            self._mon(self.latency_monitors, url).update(ts, ts - start)
        self.first_token.pop(key, None)
        self.last_token.pop(key, None)
        self.tokens_seen.pop(key, None)

    def on_request_swapped(self, url: str, request_id: str) -> None:
        self.swapped[url] = self.swapped.get(url, 0) + 1

    def get_request_stats(self, now: Optional[float] = None) -> dict[str, RequestStats]:
        now = now or time.monotonic()
        out: dict[str, RequestStats] = {}
        urls = (
            set(self.qps_monitors) | set(self.in_prefill) | set(self.in_decoding)
            | set(self.finished)
        )
        for url in urls:
            qps_mon = self.qps_monitors.get(url)
            if qps_mon is not None:
                qps_mon._trim(now)
                qps = qps_mon.get_count() / self.sliding_window
            else:
                qps = 0.0
            ttft_mon = self.ttft_monitors.get(url)
            lat_mon = self.latency_monitors.get(url)
            itl_mon = self.itl_monitors.get(url)
            dec_mon = self.decoding_length.get(url)
            out[url] = RequestStats(
                qps=qps,
                ttft=ttft_mon.get_average() if ttft_mon else -1.0,
                in_prefill_requests=self.in_prefill.get(url, 0),
                in_decoding_requests=self.in_decoding.get(url, 0),
                finished_requests=self.finished.get(url, 0),
                uptime=(now - self.first_query) if self.first_query else 0.0,
                avg_decoding_length=dec_mon.get_average() if dec_mon else -1.0,
                avg_latency=lat_mon.get_average() if lat_mon else -1.0,
                avg_itl=itl_mon.get_average() if itl_mon else -1.0,
                num_swapped_requests=self.swapped.get(url, 0),
            )
        return out


def initialize_request_stats_monitor(sliding_window: float = 60.0) -> RequestStatsMonitor:
    return RequestStatsMonitor(sliding_window)


def get_request_stats_monitor() -> RequestStatsMonitor:
    return RequestStatsMonitor()
