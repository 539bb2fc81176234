"""Engine-endpoint discovery: static list or Kubernetes pod watch.

The port's copy of ``production_stack_tpu/router/service_discovery.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/service_discovery.py of the upstream vLLM production stack —
ServiceDiscovery ABC :175, StaticServiceDiscovery :203 (health loop :241-254),
K8sServiceDiscovery :326 (watch loop :542-574, _add_engine :576-620),
EndpointInfo :80-172, sleep-label handling :429-463.

TPU-native differences: asyncio tasks instead of daemon threads, and the K8s
watch speaks to the apiserver REST API directly over aiohttp (in-cluster
serviceaccount token) — the heavyweight `kubernetes` client is not needed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import ssl
import time
from abc import ABC, abstractmethod
from typing import Optional

import aiohttp

from production_stack_tpu_torch.router.utils import cancel_task, is_model_healthy
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

_global_service_discovery: Optional["ServiceDiscovery"] = None


@dataclasses.dataclass
class ModelInfo:
    id: str
    object: str = "model"
    created: int = 0
    owned_by: str = "production-stack-tpu"
    parent: Optional[str] = None
    is_adapter: bool = False

    @staticmethod
    def from_dict(d: dict) -> "ModelInfo":
        return ModelInfo(
            id=d.get("id", ""),
            created=d.get("created", 0),
            owned_by=d.get("owned_by", ""),
            parent=d.get("parent"),
            is_adapter=d.get("parent") is not None,
        )

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "object": self.object,
            "created": self.created,
            "owned_by": self.owned_by,
            "parent": self.parent,
        }


@dataclasses.dataclass
class EndpointInfo:
    url: str
    model_names: list[str]
    added_timestamp: float
    model_label: Optional[str] = None
    pod_name: Optional[str] = None
    namespace: Optional[str] = None
    sleep: bool = False
    model_info: dict = dataclasses.field(default_factory=dict)


class ServiceDiscovery(ABC):
    @abstractmethod
    def get_endpoint_info(self) -> list[EndpointInfo]: ...

    async def start(self) -> None:  # pragma: no cover - overridden
        pass

    async def close(self) -> None:
        pass

    def get_health(self) -> bool:
        return True

    async def set_sleep_label(self, url: str, sleep: bool) -> None:
        """Record an endpoint's sleep state (overridden per discovery kind)."""
        return None

    def get_model_names(self) -> list[str]:
        names: list[str] = []
        for ep in self.get_endpoint_info():
            for m in ep.model_names:
                if m not in names:
                    names.append(m)
        return names

    def get_unhealthy_endpoint_urls(self) -> list[str]:
        # passive circuit breaking feeds the health surface for every
        # discovery kind: a backend with an open breaker is unhealthy even
        # when no active health loop is configured
        return self._breaker_open_urls()

    @staticmethod
    def _breaker_open_urls() -> list[str]:
        from production_stack_tpu_torch.router.resilience import get_breaker_registry

        return get_breaker_registry().open_urls()


class StaticServiceDiscovery(ServiceDiscovery):
    """Fixed URL list; optional periodic per-model health checks with real
    dummy payloads (parity: service_discovery.py:203-324)."""

    def __init__(
        self,
        urls: list[str],
        models: list[str],
        *,
        aliases: Optional[list[str]] = None,
        model_labels: Optional[list[str]] = None,
        model_types: Optional[list[str]] = None,
        static_backend_health_checks: bool = False,
        health_check_interval: float = 10.0,
        prefill_model_labels: Optional[list[str]] = None,
        decode_model_labels: Optional[list[str]] = None,
    ):
        self.urls = urls
        self.models = models
        self.aliases = aliases
        self.model_labels = model_labels or [None] * len(urls)
        self.model_types = model_types
        self.enable_health_checks = static_backend_health_checks
        self.health_check_interval = health_check_interval
        self.prefill_model_labels = prefill_model_labels or []
        self.decode_model_labels = decode_model_labels or []
        self.added = time.time()
        self.unhealthy: set[str] = set()
        self.sleeping: set[str] = set()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        if self.enable_health_checks:
            self._task = asyncio.create_task(self._health_loop())

    async def close(self) -> None:
        if self._task:
            await cancel_task(self._task)
            self._task = None

    async def _health_loop(self) -> None:
        from production_stack_tpu_torch.router.resilience import get_breaker_registry

        while True:
            try:
                unhealthy: set[str] = set()
                for url, model, mtype in zip(
                    self.urls, self.models, self.model_types or ["chat"] * len(self.urls)
                ):
                    if not await is_model_healthy(url, model, mtype):
                        unhealthy.add(url)
                    else:
                        # active-probe success fast-tracks an OPEN breaker to
                        # half-open (skipping the cooldown) but does NOT close
                        # it or reset the failure streak: a backend can pass
                        # the 1-token dummy probe while failing real traffic,
                        # so only a data-plane success may close the breaker
                        get_breaker_registry().record_probe_success(url)
                if unhealthy != self.unhealthy:
                    logger.warning("unhealthy endpoints: %s", sorted(unhealthy))
                self.unhealthy = unhealthy
            except Exception:
                logger.exception("health check loop error")
            await asyncio.sleep(self.health_check_interval)

    def get_unhealthy_endpoint_urls(self) -> list[str]:
        return sorted(set(self.unhealthy) | set(self._breaker_open_urls()))

    async def set_sleep_label(self, url: str, sleep: bool) -> None:
        if sleep:
            self.sleeping.add(url)
        else:
            self.sleeping.discard(url)

    def get_endpoint_info(self) -> list[EndpointInfo]:
        out = []
        for i, (url, model) in enumerate(zip(self.urls, self.models)):
            if url in self.unhealthy:
                continue
            label = self.model_labels[i] if i < len(self.model_labels) else None
            out.append(
                EndpointInfo(
                    url=url,
                    model_names=[model],
                    added_timestamp=self.added,
                    model_label=label,
                    sleep=url in self.sleeping,
                )
            )
        return out


class K8sPodIPServiceDiscovery(ServiceDiscovery):
    """Watch pods matching a label selector via the K8s REST API; query each
    ready pod's /v1/models to learn what it serves; track sleep state.

    Parity: service_discovery.py:326-718 (watch loop, _add_engine,
    _check_pod_ready, sleep labels). Talks to the apiserver directly:
    GET /api/v1/namespaces/{ns}/pods?labelSelector=...&watch=true with the
    serviceaccount bearer token.
    """

    TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

    def __init__(
        self,
        namespace: str = "default",
        label_selector: str = "",
        port: str = "8000",
        *,
        api_server: Optional[str] = None,
        token: Optional[str] = None,
        prefill_model_labels: Optional[list[str]] = None,
        decode_model_labels: Optional[list[str]] = None,
    ):
        self.namespace = namespace
        self.label_selector = label_selector
        self.port = port
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        kport = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        scheme = "https" if kport in ("443", "6443") else "http"
        self.api_server = api_server or f"{scheme}://{host}:{kport}"
        self._token = token
        self.prefill_model_labels = prefill_model_labels or []
        self.decode_model_labels = decode_model_labels or []
        self.endpoints: dict[str, EndpointInfo] = {}
        self._lock = asyncio.Lock()
        self._task: Optional[asyncio.Task] = None
        self._healthy = False

    def _auth_headers(self) -> dict:
        token = self._token
        if token is None and os.path.exists(self.TOKEN_PATH):
            with open(self.TOKEN_PATH) as f:
                token = f.read().strip()
        return {"Authorization": f"Bearer {token}"} if token else {}

    def _ssl_ctx(self):
        if not self.api_server.startswith("https"):
            return None
        if os.path.exists(self.CA_PATH):
            return ssl.create_default_context(cafile=self.CA_PATH)
        # https apiserver without the in-cluster CA (out-of-cluster dev against
        # a self-signed apiserver): skip verification rather than fail forever
        return False

    async def start(self) -> None:
        self._task = asyncio.create_task(self._watch_loop())

    async def close(self) -> None:
        if self._task:
            await cancel_task(self._task)
            self._task = None

    def get_health(self) -> bool:
        return self._healthy

    def get_endpoint_info(self) -> list[EndpointInfo]:
        return [ep for ep in self.endpoints.values() if not ep.sleep]

    async def _watch_loop(self) -> None:
        url = f"{self.api_server}/api/v1/namespaces/{self.namespace}/pods"
        params = {"watch": "true", "timeoutSeconds": "30"}
        if self.label_selector:
            params["labelSelector"] = self.label_selector
        while True:
            try:
                # token read off the loop: _auth_headers re-reads the mounted
                # serviceaccount token file on every watch (re)connect (kubelet
                # rotates it), and a slow/overloaded kubelet volume must not
                # stall in-flight streaming proxies (graftcheck GC001)
                headers = await asyncio.to_thread(self._auth_headers)
                async with aiohttp.ClientSession(
                    headers=headers,
                    timeout=aiohttp.ClientTimeout(total=None, sock_read=60),
                ) as session:
                    async with session.get(url, params=params, ssl=self._ssl_ctx()) as resp:
                        resp.raise_for_status()
                        self._healthy = True
                        async for line in resp.content:
                            if line.strip():
                                await self._on_event(json.loads(line))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._healthy = False
                logger.warning("k8s watch error (%s); retrying", e)
                await asyncio.sleep(0.5)

    @staticmethod
    def _pod_ready(pod: dict) -> bool:
        statuses = (pod.get("status", {}).get("containerStatuses")) or []
        return bool(statuses) and all(s.get("ready") for s in statuses)

    async def _get_model_names(self, pod_ip: str) -> list[dict]:
        url = f"http://{pod_ip}:{self.port}/v1/models"
        try:
            async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=5)
            ) as session:
                async with session.get(url) as resp:
                    data = await resp.json()
                    return data.get("data", [])
        except Exception:
            return []

    async def _on_event(self, event: dict) -> None:
        etype = event.get("type")
        pod = event.get("object", {})
        name = pod.get("metadata", {}).get("name", "")
        labels = pod.get("metadata", {}).get("labels", {}) or {}
        pod_ip = pod.get("status", {}).get("podIP")
        if etype == "DELETED" or not self._pod_ready(pod) or not pod_ip:
            async with self._lock:
                if name in self.endpoints:
                    logger.info("Removing engine %s", name)
                    # drop the pod's breaker with it: a replacement pod that
                    # reuses the IP must start closed, not inherit the
                    # corpse's open state
                    from production_stack_tpu_torch.router.resilience import (
                        get_breaker_registry,
                    )

                    get_breaker_registry().forget(self.endpoints[name].url)
                    del self.endpoints[name]
            return
        models = await self._get_model_names(pod_ip)
        if not models:
            return
        url = f"http://{pod_ip}:{self.port}"
        sleep = labels.get("sleep") == "true"
        async with self._lock:
            self.endpoints[name] = EndpointInfo(
                url=url,
                model_names=[m["id"] for m in models],
                added_timestamp=time.time(),
                model_label=labels.get("model"),
                pod_name=name,
                namespace=self.namespace,
                sleep=sleep,
                model_info={m["id"]: m for m in models},
            )
            logger.info("Discovered engine %s at %s serving %s", name, url,
                        [m["id"] for m in models])

    async def set_sleep_label(self, url: str, sleep: bool) -> None:
        """Mark an endpoint sleeping/awake (mirrors pod relabeling,
        service_discovery.py:429-463)."""
        async with self._lock:
            for ep in self.endpoints.values():
                if ep.url == url:
                    ep.sleep = sleep


def initialize_service_discovery(kind: str, **kwargs) -> ServiceDiscovery:
    global _global_service_discovery
    if kind == "static":
        sd = StaticServiceDiscovery(**kwargs)
    elif kind == "k8s":
        sd = K8sPodIPServiceDiscovery(**kwargs)
    else:
        raise ValueError(f"unknown service discovery type: {kind}")
    _global_service_discovery = sd
    return sd


def get_service_discovery() -> ServiceDiscovery:
    assert _global_service_discovery is not None, "service discovery not initialized"
    return _global_service_discovery


def set_service_discovery(sd: ServiceDiscovery) -> None:
    global _global_service_discovery
    _global_service_discovery = sd
