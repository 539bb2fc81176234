"""Routing algorithms.

The port's copy of ``production_stack_tpu/router/routing_logic.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/routers/routing_logic.py of the upstream vLLM production stack —
roundrobin :126-157, session (consistent hash ring) :160-209, kvaware (global
KV-index lookup) :212-329, prefixaware (HashTrie) :332-408,
disaggregated_prefill :411-451, QPS fallback _qps_routing :59-81,
initialize/reconfigure/get :455-511.

The KV-aware router queries this stack's own KV-index controller
(kvoffload/controller.py) — the TPU-native replacement for the LMCache
controller ZMQ protocol the reference router speaks.
"""

from __future__ import annotations

import abc
import asyncio
import hashlib
import time
from typing import Any, Optional

from production_stack_tpu_torch.router.hashtrie import HashTrie
from production_stack_tpu_torch.router.service_discovery import EndpointInfo
from production_stack_tpu_torch.router.utils import SingletonMeta
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class RoutingInterface(metaclass=SingletonMeta):
    @abc.abstractmethod
    async def route_request(
        self,
        endpoints: list[EndpointInfo],
        engine_stats: dict[str, Any],
        request_stats: dict[str, Any],
        request: Any,
        request_json: Optional[dict] = None,
    ) -> str: ...

    @staticmethod
    def breaker_filtered(endpoints: list[EndpointInfo]) -> list[EndpointInfo]:
        """Passive-circuit-breaker consultation: drop endpoints whose breaker
        is open (fail-static — an all-open set passes through unchanged).
        Idempotent, so request_service pre-filtering composes with routing
        implementations that call this themselves."""
        from production_stack_tpu_torch.router.resilience import get_breaker_registry

        return get_breaker_registry().filter_endpoints(endpoints)

    @staticmethod
    def saturation_filtered(
        endpoints: list[EndpointInfo], engine_stats: Optional[dict] = None
    ) -> list[EndpointInfo]:
        """Deprioritize saturated backends: drop endpoints currently inside
        a shed window (a recent 429 + Retry-After) or whose scraped stats
        report ``vllm:engine_saturated`` — they have no capacity for new
        non-sticky traffic. Fail-static: when EVERY candidate is saturated
        the original set passes through unchanged, so the requests reach an
        engine whose own 429 (with Retry-After) is the correct client
        answer — never a synthesized router error."""
        from production_stack_tpu_torch.router.resilience import get_saturation_registry

        reg = get_saturation_registry()
        out = []
        for ep in endpoints:
            if reg.is_saturated(ep.url):
                continue
            es = (engine_stats or {}).get(ep.url)
            if es is not None and getattr(es, "engine_saturated", 0):
                continue
            out.append(ep)
        return out if out else list(endpoints)

    @staticmethod
    def class_filtered(
        endpoints: list[EndpointInfo],
        priority: str,
        min_attainment: float = 0.9,
    ) -> list[EndpointInfo]:
        """Class-aware placement (docs/failure-handling.md priority classes):
        batch traffic avoids backends whose *interactive* TTFT SLO attainment
        has degraded below ``min_attainment``, keeping bulk work off engines
        that are already failing their latency-sensitive tenants. Interactive
        traffic is never filtered here — it sees every candidate. Fail-static
        like the saturation filter: if every backend is degraded (or none has
        attainment data yet) the original set passes through unchanged, so
        batch requests still land somewhere and the engine-side admission
        control (which sheds batch first) gives the honest 429."""
        if priority != "batch" or min_attainment <= 0.0:
            return list(endpoints)
        from production_stack_tpu_torch.router.slo import get_slo_monitor

        mon = get_slo_monitor()
        out = []
        for ep in endpoints:
            att = mon.interactive_attainment(ep.url, "ttft")
            if att is not None and att < min_attainment:
                continue
            out.append(ep)
        return out if out else list(endpoints)


def _qps_routing(endpoints: list[EndpointInfo], request_stats: dict[str, Any]) -> str:
    """Lowest-QPS endpoint (parity :59-81)."""
    best, best_qps = None, float("inf")
    for ep in endpoints:
        rs = request_stats.get(ep.url)
        qps = rs.qps if rs is not None else -1
        if qps < best_qps:
            best, best_qps = ep.url, qps
    if best is None:
        raise ValueError("no endpoints to route to")
    return best


class RoundRobinRouter(RoutingInterface):
    def __init__(self):
        self.idx = 0

    async def route_request(self, endpoints, engine_stats, request_stats, request,
                            request_json=None) -> str:
        urls = sorted(ep.url for ep in endpoints)
        url = urls[self.idx % len(urls)]
        self.idx += 1
        return url


class HashRing:
    """Consistent-hash ring with virtual nodes (uhashring replacement)."""

    VNODES = 100

    def __init__(self, nodes: Optional[list[str]] = None):
        self._ring: list[tuple[int, str]] = []
        self._nodes: set[str] = set()
        for n in nodes or []:
            self.add_node(n)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "little")

    def add_node(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.VNODES):
            self._ring.append((self._hash(f"{node}#{v}"), node))
        self._ring.sort()

    def remove_node(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def get_nodes(self) -> set[str]:
        return set(self._nodes)

    def get_node(self, key: str) -> str:
        if not self._ring:
            raise ValueError("hash ring is empty")
        h = self._hash(key)
        import bisect

        i = bisect.bisect_right(self._ring, (h, chr(0x10FFFF)))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]


class SessionRouter(RoutingInterface):
    """Sticky sessions via consistent hashing on a header/param key
    (parity :160-209)."""

    def __init__(self, session_key: Optional[str] = None):
        if not session_key:
            raise ValueError("session routing requires --session-key")
        self.session_key = session_key
        self.ring = HashRing()

    def _sync_ring(self, endpoints: list[EndpointInfo]) -> None:
        urls = {ep.url for ep in endpoints}
        for gone in self.ring.get_nodes() - urls:
            self.ring.remove_node(gone)
        for new in urls - self.ring.get_nodes():
            self.ring.add_node(new)

    async def route_request(self, endpoints, engine_stats, request_stats, request,
                            request_json=None) -> str:
        session_id = None
        headers = getattr(request, "headers", None)
        if headers is not None:
            session_id = headers.get(self.session_key)
        if session_id is None and request_json:
            session_id = request_json.get(self.session_key)
        self._sync_ring(endpoints)
        if not session_id:
            return _qps_routing(endpoints, request_stats)
        # migration re-pin (docs/migration.md): a session whose stream was
        # live-migrated is pinned to its new backend — the hash ring is
        # deterministic and would bounce it straight back, undoing the
        # controller's rebalance on the very next request
        from production_stack_tpu_torch.router.resilience import get_session_pins

        pinned = get_session_pins().lookup(str(session_id))
        if pinned is not None and any(ep.url == pinned for ep in endpoints):
            return pinned
        return self.ring.get_node(str(session_id))


class PrefixAwareRouter(RoutingInterface):
    """Route to the endpoint that has seen the longest prefix of this prompt
    (parity :332-408); falls back to lowest-QPS among tied candidates."""

    def __init__(self):
        self.trie = HashTrie()
        # endpoints ever inserted into the trie, for the discovery-dropout
        # sweep (a bugfix): the trie retained entries for backends
        # removed from service discovery, so a departed backend kept winning
        # locality scores forever — mirrors engine_stats' _dropped_stale
        # bookkeeping for config-removed urls
        self._trie_urls: set[str] = set()

    @classmethod
    def make_fallback(cls) -> "PrefixAwareRouter":
        """A NON-singleton instance for use as another router's fallback:
        ``cls()`` goes through SingletonMeta and would hand back (and
        register) THE shared prefixaware router — the fallback must be
        private state. Keep this the single place the fields are initialized
        so the __new__ bypass cannot drift from __init__."""
        r = cls.__new__(cls)
        r.trie = HashTrie()
        r._trie_urls = set()
        return r

    async def sweep_departed(self, current_urls: set) -> None:
        """Drop trie claims of endpoints no longer in service discovery. A
        swept backend that returns re-learns its locality from scratch —
        correct for both a config removal and a restart (its cache is cold
        either way)."""
        gone = self._trie_urls - current_urls
        for url in gone:
            await self.trie.remove_endpoint(url)
            logger.info(
                "prefix trie: swept departed backend %s (%d still tracked)",
                url, len(self._trie_urls) - 1,
            )
        self._trie_urls -= gone

    async def _sweep_with_discovery(self) -> None:
        from production_stack_tpu_torch.router.service_discovery import (
            get_service_discovery,
        )

        try:
            sd = get_service_discovery()
        except Exception:  # noqa: BLE001 - unit tests route without discovery
            return
        await self.sweep_departed({ep.url for ep in sd.get_endpoint_info()})

    @staticmethod
    def _prompt_of(request_json: Optional[dict]) -> Optional[str]:
        if not request_json:
            return None
        if "prompt" in request_json:
            p = request_json["prompt"]
            return p if isinstance(p, str) else (p[0] if p else None)
        if "messages" in request_json:
            return "".join(
                str(m.get("content", "")) for m in request_json["messages"]
            )
        return None

    async def route_request(self, endpoints, engine_stats, request_stats, request,
                            request_json=None) -> str:
        await self._sweep_with_discovery()
        available = {ep.url for ep in endpoints}
        prompt = self._prompt_of(request_json)
        if prompt is None:
            return _qps_routing(endpoints, request_stats)
        matched, candidates = await self.trie.longest_prefix_match(prompt, available)
        candidate_eps = [ep for ep in endpoints if ep.url in candidates]
        url = _qps_routing(candidate_eps or endpoints, request_stats)
        await self.trie.insert(prompt, url)
        self._trie_urls.add(url)
        return url


class KvawareRouter(RoutingInterface):
    """KV-aware routing.

    v1 (parity :212-329): query the KV-index controller for the instance
    holding the longest cached token prefix (LMCache controller protocol
    replaced by kvoffload/controller.py).

    v2 (docs/kv-directory.md): consult the fleet-wide KV directory
    hosted by the cache server and rank backends
    **resident > restorable > cold** —

    - *resident*: a backend already holds the longest prefix in its HBM
      prefix cache (the directory's generation-fenced resident claims);
    - *restorable*: the prefix's blobs sit in the shared cache-server tier,
      so ANY backend can pull them before prefill. Weighted by what the
      target would actually restore: each engine exports its
      linkprobe-derived per-operation restore cap
      (vllm:kv_offload_max_io_pages — the engine-measured
      restore-vs-recompute crossover, engine/linkprobe.py), scraped into
      EngineStats; restorable tokens beyond cap x page_size would recompute
      anyway and score zero. Ties break to the lowest-QPS backend;
    - *cold*: nothing known — fall through to the prefix-trie fallback.

    Both modes learn the outcome into the fallback trie, so a directory or
    controller outage degrades to prefixaware, not roundrobin."""

    def __init__(
        self,
        controller_url: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        directory_url: Optional[str] = None,
    ):
        if not controller_url and not directory_url:
            raise ValueError(
                "kvaware routing requires --kv-controller-url or "
                "--kv-directory-url"
            )
        self.controller_url = controller_url
        self.directory_url = directory_url
        from production_stack_tpu_torch.engine.tokenizer import load_tokenizer

        self.tokenizer = load_tokenizer(tokenizer_path)
        self._client = None
        self._dir_client = None
        # vllm_router:kvaware_v2_{resident,restorable,cold}_routes_total
        self.route_class_counts = {"resident": 0, "restorable": 0, "cold": 0}
        self.fallback = PrefixAwareRouter.make_fallback()

    async def _lookup(self, tokens: list[int]) -> Optional[str]:
        from production_stack_tpu_torch.kvoffload.controller import ControllerClient

        try:
            if self._client is None:
                self._client = ControllerClient(self.controller_url)
            return await self._client.lookup_url(tokens)
        except Exception as e:
            logger.warning("kv controller lookup failed: %s", e)
            self._client = None
            return None

    async def _dir_lookup(self, tokens: list[int]) -> Optional[dict]:
        from production_stack_tpu_torch.kvdirectory import DirectoryClient

        try:
            if self._dir_client is None:
                self._dir_client = DirectoryClient(self.directory_url)
            return await self._dir_client.lookup(tokens)
        except Exception as e:
            logger.warning("kv directory lookup failed: %s", e)
            self._dir_client = None
            return None

    @staticmethod
    def _restorable_tokens(restorable: dict, es, page_size: Optional[int]) -> int:
        """Tokens a backend would actually restore from the shared tier: the
        per-page-size restorable depth, clamped by the backend's exported
        restore cap. ``page_size`` is the backend's registered page size
        from the directory — chunk identity is page-size-dependent, so a
        backend is only credited the chain hashed at ITS page size (unknown
        backends fall back to the best chain, optimistically). Cap semantics
        follow the engine's export (engine/linkprobe.py): 0 = fast link,
        restore unbounded; N > 0 = slow link, N pages is the
        restore-vs-recompute crossover; the metric ABSENT from a scraped
        backend (-1 here) means it has NO offload tiers at all — it cannot
        pull anything, score 0. A backend with no stats yet (never scraped)
        is scored optimistically unbounded: the directory is a hint and a
        wrong pick only costs a recompute."""
        if es is None:
            cap = 0.0  # unscraped: optimistic
        else:
            cap = getattr(es, "kv_offload_max_io_pages", 0.0)
            if cap is None or cap < 0:
                return 0  # scraped, metric absent: no offload tiers
        if page_size is not None:
            restorable = {
                k: v for k, v in restorable.items() if int(k) == page_size
            }
        best = 0
        for ps_str, toks in restorable.items():
            ps = int(ps_str)
            eff = int(toks) if cap <= 0 else min(int(toks), int(cap) * ps)
            best = max(best, eff)
        return best

    def _rank_v2(self, res: dict, endpoints, engine_stats, request_stats):
        """resident > restorable > cold; returns (class, url|None)."""
        urls = {ep.url for ep in endpoints}
        best_url, best_tokens = None, 0
        for url, info in (res.get("engines") or {}).items():
            if url in urls and int(info.get("resident_tokens", 0)) > best_tokens:
                best_url, best_tokens = url, int(info["resident_tokens"])
        if best_url is not None:
            return "resident", best_url
        restorable = res.get("restorable") or {}
        if restorable:
            page_sizes = res.get("page_sizes") or {}
            scored = [
                (ep, self._restorable_tokens(
                    restorable, (engine_stats or {}).get(ep.url),
                    page_sizes.get(ep.url),
                ))
                for ep in endpoints
            ]
            top = max((s for _, s in scored), default=0)
            if top > 0:
                tied = [ep for ep, s in scored if s == top]
                return "restorable", _qps_routing(tied, request_stats)
        return "cold", None

    async def route_request(self, endpoints, engine_stats, request_stats, request,
                            request_json=None) -> str:
        prompt = PrefixAwareRouter._prompt_of(request_json)
        if prompt is not None:
            tokens = self.tokenizer.encode(prompt)
            if self.directory_url:
                res = await self._dir_lookup(tokens)
                if res is not None:
                    cls, url = self._rank_v2(
                        res, endpoints, engine_stats, request_stats
                    )
                    self.route_class_counts[cls] += 1
                    if url is not None:
                        # teach the fallback trie the outcome so a later
                        # directory outage keeps this locality
                        await self.fallback.trie.insert(prompt, url)
                        self.fallback._trie_urls.add(url)
                        return url
            if self.controller_url:
                url = await self._lookup(tokens)
                if url and any(ep.url == url for ep in endpoints):
                    return url
        return await self.fallback.route_request(
            endpoints, engine_stats, request_stats, request, request_json
        )


class DisaggregatedPrefillRouter(RoutingInterface):
    """Pick a (prefill, decode) endpoint pair by model labels
    (parity :411-451; the two-phase HTTP flow lives in request_service)."""

    def __init__(self, prefill_labels: list[str], decode_labels: list[str]):
        self.prefill_labels = prefill_labels
        self.decode_labels = decode_labels
        self._rr = {"prefill": 0, "decode": 0}
        # decode picks that were transfer-cost-aware (fabric bandwidth known
        # for at least one candidate) — vllm_router:disagg_fabric_routes_total
        self.fabric_routes = 0

    def _pick(self, endpoints: list[EndpointInfo], labels: list[str], kind: str) -> str:
        # breaker-aware even for direct route_prefill/route_decode callers —
        # but the breaker filter runs AFTER label selection so fail-static is
        # per ROLE: when every prefill-labeled pod is tripped, keep trying
        # the tripped prefillers rather than silently re-homing prefill
        # traffic onto decode-labeled pods
        role = [ep for ep in endpoints if ep.model_label in labels] or list(endpoints)
        role = self.breaker_filtered(role)
        if kind == "decode" and len(role) > 1:
            # transfer-cost-aware decode placement (docs/kv-fabric.md, NetKV):
            # the prefiller streams the prompt's KV to whichever decoder we
            # pick, so prefer the one with the best probed fabric bandwidth
            # per unit of fabric queue depth — scraped off each engine's
            # /metrics by the stats scraper. Engines without fabric (bw==0)
            # yield no score and the pool stays round-robin.
            url = self._fabric_pick(role)
            if url is not None:
                self.fabric_routes += 1
                return url
        pool = sorted(ep.url for ep in role)
        url = pool[self._rr[kind] % len(pool)]
        self._rr[kind] += 1
        return url

    @staticmethod
    def _fabric_pick(role: list[EndpointInfo]) -> Optional[str]:
        from production_stack_tpu_torch.kvfabric.peers import pick_best_peer
        from production_stack_tpu_torch.router.engine_stats import (
            get_engine_stats_scraper,
        )

        try:
            stats = get_engine_stats_scraper().get_engine_stats()
        except Exception:  # noqa: BLE001 - scraper not running: RR fallback
            return None
        candidates = []
        for ep in role:
            st = stats.get(ep.url)
            if st is None:
                continue
            candidates.append((
                ep.url,
                st.kv_fabric_peer_bandwidth_bytes_per_sec,
                st.kv_fabric_queue_depth,
            ))
        return pick_best_peer(candidates)

    async def route_request(self, endpoints, engine_stats, request_stats, request,
                            request_json=None) -> str:
        # plain route_request returns the decode endpoint; request_service
        # calls route_prefill/route_decode explicitly for the 2-phase flow
        return self._pick(endpoints, self.decode_labels, "decode")

    def route_prefill(self, endpoints: list[EndpointInfo]) -> str:
        return self._pick(endpoints, self.prefill_labels, "prefill")

    def route_decode(self, endpoints: list[EndpointInfo]) -> str:
        return self._pick(endpoints, self.decode_labels, "decode")


_router: Optional[RoutingInterface] = None


def render_kvaware_metrics() -> list[str]:
    """Prometheus lines for the KV-aware-v2 route-class counters (rendered
    by router/app.py /metrics; zero-valued when kvaware v2 is not active so
    dashboard queries always resolve)."""
    counts = (
        _router.route_class_counts
        if isinstance(_router, KvawareRouter)
        else {}
    )
    lines = []
    for name, key in (
        ("vllm_router:kvaware_v2_resident_routes_total", "resident"),
        ("vllm_router:kvaware_v2_restorable_routes_total", "restorable"),
        ("vllm_router:kvaware_v2_cold_routes_total", "cold"),
    ):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {counts.get(key, 0)}")
    # disagg decode picks that used fabric transfer-cost scoring instead of
    # round-robin (docs/kv-fabric.md; zero-valued outside disagg mode)
    fabric_routes = (
        _router.fabric_routes
        if isinstance(_router, DisaggregatedPrefillRouter)
        else 0
    )
    lines.append("# TYPE vllm_router:disagg_fabric_routes_total counter")
    lines.append(f"vllm_router:disagg_fabric_routes_total {fabric_routes}")
    return lines


def initialize_routing_logic(
    routing_logic: str,
    *,
    session_key: Optional[str] = None,
    kv_controller_url: Optional[str] = None,
    kv_directory_url: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    prefill_model_labels: Optional[list[str]] = None,
    decode_model_labels: Optional[list[str]] = None,
) -> RoutingInterface:
    global _router
    # reset only routing singletons (reconfigure support) — other singletons
    # (stats scraper, request monitor) must survive a routing swap
    for cls in list(SingletonMeta._instances):
        if issubclass(cls, RoutingInterface):
            SingletonMeta._instances.pop(cls)
    if routing_logic == "roundrobin":
        _router = RoundRobinRouter()
    elif routing_logic == "session":
        _router = SessionRouter(session_key)
    elif routing_logic == "prefixaware":
        _router = PrefixAwareRouter()
    elif routing_logic == "kvaware":
        _router = KvawareRouter(
            kv_controller_url, tokenizer_path, directory_url=kv_directory_url
        )
    elif routing_logic == "disaggregated_prefill":
        _router = DisaggregatedPrefillRouter(
            prefill_model_labels or [], decode_model_labels or []
        )
    else:
        raise ValueError(f"unknown routing logic: {routing_logic}")
    logger.info("initialized routing logic: %s", routing_logic)
    return _router


def reconfigure_routing_logic(routing_logic: str, **kwargs) -> RoutingInterface:
    return initialize_routing_logic(routing_logic, **kwargs)


def get_routing_logic() -> RoutingInterface:
    assert _router is not None, "routing logic not initialized"
    return _router
