"""Engine statistics scraper.

The port's copy of ``production_stack_tpu/router/engine_stats.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/stats/engine_stats.py of the upstream vLLM production stack —
EngineStats.from_vllm_scrape :42-85, EngineStatsScraper (interval worker)
:88-218. Scrapes each engine's Prometheus /metrics text and extracts the
`vllm:*` gauges our TPU engine also emits (engine/api_server.py), so the same
scraper works against vLLM pods and TPU pods.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional

import aiohttp

from production_stack_tpu_torch.router.utils import SingletonMeta
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


@dataclasses.dataclass
class EngineStats:
    num_running_requests: int = 0
    num_queuing_requests: int = 0
    gpu_prefix_cache_hit_rate: float = 0.0
    gpu_prefix_cache_hits_total: float = 0.0
    gpu_prefix_cache_queries_total: float = 0.0
    gpu_cache_usage_perc: float = 0.0
    # engine-side admission control state (api_server overload surface):
    # routing deprioritizes saturated backends between Retry-After windows
    engine_saturated: int = 0
    # offload restore economics, scraped for KV-aware routing v2: the
    # engine's linkprobe-derived per-operation restore cap (engine-measured
    # restore-vs-recompute crossover; -1 = not exported, <=0 = unbounded)
    # and the measured host<->device link bandwidth (0 = not exported)
    kv_offload_max_io_pages: float = -1.0
    kv_offload_link_bandwidth_bytes_per_sec: float = 0.0
    # serving-mesh tp degree (chips per replica): capacity math — a tp=4
    # engine is ONE replica on 4 chips, not 4x the seats; the fleet
    # controller and dashboards read it through the router's scrape
    tensor_parallel: float = 1.0
    # KV pool bytes per token (ops/quant.py): an int8-KV engine streams
    # half the bytes AND holds ~2x the tokens per GB — capacity-aware
    # consumers (dashboards, the fleet controller) read the real number
    # instead of assuming the fp16 footprint (0 = not exported)
    kv_cache_dtype_bytes_per_token: float = 0.0
    # KV fabric transfer economics (kvfabric/peers.py, docs/kv-fabric.md):
    # probed engine-to-engine bandwidth summed over that engine's peer links
    # (from_scrape sums label sets) and the fabric listener's in-flight op
    # count — the disagg router and fleet controller combine them into a
    # transfer-cost score bw/(1+depth) per NetKV (0 = fabric not enabled)
    kv_fabric_peer_bandwidth_bytes_per_sec: float = 0.0
    kv_fabric_queue_depth: float = 0.0

    _FIELDS = {
        "vllm:num_requests_running": "num_running_requests",
        "vllm:num_requests_waiting": "num_queuing_requests",
        "vllm:gpu_prefix_cache_hit_rate": "gpu_prefix_cache_hit_rate",
        "vllm:gpu_prefix_cache_hits_total": "gpu_prefix_cache_hits_total",
        "vllm:gpu_prefix_cache_queries_total": "gpu_prefix_cache_queries_total",
        "vllm:gpu_cache_usage_perc": "gpu_cache_usage_perc",
        "vllm:engine_saturated": "engine_saturated",
        "vllm:kv_offload_max_io_pages": "kv_offload_max_io_pages",
        "vllm:kv_offload_link_bandwidth_bytes_per_sec": (
            "kv_offload_link_bandwidth_bytes_per_sec"
        ),
        "vllm:tensor_parallel_degree": "tensor_parallel",
        "vllm:kv_cache_dtype_bytes_per_token": "kv_cache_dtype_bytes_per_token",
        "vllm:kv_fabric_peer_bandwidth_bytes_per_sec": (
            "kv_fabric_peer_bandwidth_bytes_per_sec"
        ),
        "vllm:kv_fabric_queue_depth": "kv_fabric_queue_depth",
    }

    @staticmethod
    def from_scrape(text: str) -> "EngineStats":
        """Parse Prometheus exposition text, summing across label sets."""
        vals: dict[str, float] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                name_part, value = line.rsplit(None, 1)
                name = name_part.split("{")[0]
                if name in EngineStats._FIELDS:
                    vals[name] = vals.get(name, 0.0) + float(value)
            except ValueError:
                continue
        stats = EngineStats()
        for metric, attr in EngineStats._FIELDS.items():
            if metric in vals:
                setattr(stats, attr, type(getattr(stats, attr))(vals[metric]))
        # derive hit rate from counters when the gauge is absent (vLLM v1)
        if stats.gpu_prefix_cache_queries_total > 0 and stats.gpu_prefix_cache_hit_rate == 0:
            stats.gpu_prefix_cache_hit_rate = (
                stats.gpu_prefix_cache_hits_total / stats.gpu_prefix_cache_queries_total
            )
        return stats


class EngineStatsScraper(metaclass=SingletonMeta):
    # a snapshot older than this many scrape intervals is stale: load-aware
    # routing must stop trusting a dead pod's last-good queue depth
    STALE_INTERVALS = 3.0

    def __init__(self, scrape_interval: float = 15.0):
        self.scrape_interval = scrape_interval
        self.engine_stats: dict[str, EngineStats] = {}
        self.last_success: dict[str, float] = {}  # url -> monotonic ts
        # restart epochs: bumped when a backend's counters regress (the
        # process restarted) or when a dropped-for-staleness backend scrapes
        # again — a reborn pod's first successful scrape starts a NEW epoch,
        # so routing never blends pre-restart state into it (no lingering
        # saturation window, no stale-snapshot quarantine on the newborn)
        self.epochs: dict[str, int] = {}
        self._dropped_stale: set[str] = set()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def close(self) -> None:
        from production_stack_tpu_torch.router.utils import cancel_task

        if self._task:
            await cancel_task(self._task)
            self._task = None

    async def _loop(self) -> None:
        import time

        from production_stack_tpu_torch.router.service_discovery import get_service_discovery

        while True:
            try:
                endpoints = get_service_discovery().get_endpoint_info()
                results = await asyncio.gather(
                    *[self._scrape_one(ep.url) for ep in endpoints]
                )
                self.apply_scrape_results(
                    [ep.url for ep in endpoints], results, time.monotonic()
                )
            except Exception:
                logger.exception("engine stats scrape failed")
            try:
                # per-request SLO terminal records (router/slo.py): the same
                # scrape cadence pulls each backend's /slo_records tail and
                # feeds the attainment counters. Separate try: a broken SLO
                # surface on one pod must not cost the fleet its load stats.
                endpoints = get_service_discovery().get_endpoint_info()
                await asyncio.gather(
                    *[self._scrape_slo_records(ep.url) for ep in endpoints]
                )
            except Exception:
                logger.exception("slo records scrape failed")
            await asyncio.sleep(self.scrape_interval)

    async def _scrape_slo_records(self, url: str) -> None:
        """Pull one backend's new SLO terminal records (cursor-based) into
        the SLO monitor. Best-effort per backend: plain-vLLM pods without
        /slo_records (404) and dead pods are silently skipped."""
        from production_stack_tpu_torch.router.request_service import get_client_session
        from production_stack_tpu_torch.router.slo import get_slo_monitor

        slo = get_slo_monitor()
        try:
            session = await get_client_session()
            async with session.get(
                f"{url}/slo_records",
                params={"since": str(slo.cursor(url))},
                timeout=aiohttp.ClientTimeout(total=5),
            ) as resp:
                if resp.status != 200:
                    return
                payload = await resp.json()
        except Exception:  # noqa: BLE001 - scrape is best-effort
            return
        slo.ingest(url, payload)

    def apply_scrape_results(
        self, urls: list[str], results: list[Optional[EngineStats]], now: float
    ) -> None:
        """Merge one scrape round. A failed scrape (None) keeps the previous
        snapshot only within the staleness window — after STALE_INTERVALS
        scrape intervals without a success the entry is DROPPED, so
        load-aware routing stops trusting a dead pod's old queue depth."""
        fresh = {url: st for url, st in zip(urls, results) if st is not None}
        for url, st in fresh.items():
            prev = self.engine_stats.get(url)
            # restart detection: Prometheus counters only move forward within
            # one process lifetime, so a regression means the engine was
            # reborn. Also: a backend that was dropped for staleness and now
            # scrapes again came back from the dead (restart or partition).
            reborn = (
                prev is not None
                and st.gpu_prefix_cache_queries_total
                < prev.gpu_prefix_cache_queries_total
            ) or (url in self._dropped_stale)
            if reborn:
                self.epochs[url] = self.epochs.get(url, 0) + 1
                self._dropped_stale.discard(url)
                logger.info(
                    "engine %s restarted (stats epoch %d): clearing its "
                    "pre-restart saturation window", url, self.epochs[url],
                )
                # a Retry-After window from the previous incarnation must
                # not keep routing away from an engine with an empty queue;
                # the breaker is deliberately NOT reset — the reborn backend
                # re-enters traffic through the normal half-open probe
                from production_stack_tpu_torch.router.resilience import (
                    get_saturation_registry,
                )

                get_saturation_registry().forget(url)
        self.engine_stats.update(fresh)
        for url in fresh:
            self.last_success[url] = now
        for url in list(self.engine_stats):
            if url not in urls:
                del self.engine_stats[url]
                self.last_success.pop(url, None)
        # sweep per-backend bookkeeping for urls gone from the CONFIG —
        # including ones already stale-dropped from engine_stats (an
        # autoscaled fleet churning per-pod urls would otherwise leak these
        # forever, and a reused address would inherit a bogus 'reborn' epoch)
        current = set(urls)
        for url in list(self._dropped_stale):
            if url not in current:
                self._dropped_stale.discard(url)
        for url in list(self.epochs):
            if url not in current:
                del self.epochs[url]
                # migration session pins must not keep steering sessions at
                # a backend removed from the config (resilience.py)
                from production_stack_tpu_torch.router.resilience import (
                    get_session_pins,
                )

                get_session_pins().forget_backend(url)
                # deliberately NOT resetting the SLO cursor here: a backend
                # can drop out of discovery without restarting (health-check
                # flap under overload — exactly when SLO data matters), and
                # a reset would re-ingest its retained records on rejoin,
                # double-counting attainment. A genuinely reborn process
                # starts a fresh record counter, which ingest() detects via
                # head < cursor and resets on its own.
        cutoff = now - self.STALE_INTERVALS * self.scrape_interval
        for url in list(self.engine_stats):
            if self.last_success.get(url, now) < cutoff:
                logger.warning(
                    "dropping stale engine stats for %s (no successful "
                    "scrape in %.0fs)", url, now - self.last_success[url],
                )
                del self.engine_stats[url]
                self._dropped_stale.add(url)

    async def _scrape_one(self, url: str) -> Optional[EngineStats]:
        from production_stack_tpu_torch.router.request_service import get_client_session

        try:
            session = await get_client_session()
            async with session.get(
                f"{url}/metrics", timeout=aiohttp.ClientTimeout(total=5)
            ) as resp:
                return EngineStats.from_scrape(await resp.text())
        except Exception:
            return None

    def get_engine_stats(self) -> dict[str, EngineStats]:
        return dict(self.engine_stats)

    def get_health(self) -> bool:
        return self._task is not None and not self._task.done()


def initialize_engine_stats_scraper(scrape_interval: float = 15.0) -> EngineStatsScraper:
    return EngineStatsScraper(scrape_interval)


def get_engine_stats_scraper() -> EngineStatsScraper:
    return EngineStatsScraper()
