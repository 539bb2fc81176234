"""Dynamic (hot-reload) router configuration.

The port's copy of ``production_stack_tpu/router/dynamic_config.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/dynamic_config.py of the upstream vLLM production stack —
DynamicRouterConfig :38-96, DynamicConfigWatcher polling loop :200-219,
reconfigure_* :133-188. Watches a JSON file (a mounted ConfigMap in K8s) and
live-swaps service discovery and routing logic.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
from typing import Optional

from production_stack_tpu_torch.router import routing_logic as rl
from production_stack_tpu_torch.router import service_discovery as sd
from production_stack_tpu_torch.router.utils import cancel_task, parse_comma_separated
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


@dataclasses.dataclass
class DynamicRouterConfig:
    service_discovery: Optional[str] = None
    static_backends: Optional[str] = None
    static_models: Optional[str] = None
    routing_logic: Optional[str] = None
    session_key: Optional[str] = None
    kv_controller_url: Optional[str] = None
    kv_directory_url: Optional[str] = None
    prefill_model_labels: Optional[str] = None
    decode_model_labels: Optional[str] = None

    @staticmethod
    def from_json(path: str) -> "DynamicRouterConfig":
        with open(path) as f:
            data = json.load(f)
        fields = {f.name for f in dataclasses.fields(DynamicRouterConfig)}
        return DynamicRouterConfig(**{k: v for k, v in data.items() if k in fields})

    def to_json_str(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class DynamicConfigWatcher:
    _instance: Optional["DynamicConfigWatcher"] = None

    def __init__(self, config_path: str, poll_interval: float = 10.0):
        self.config_path = config_path
        self.poll_interval = poll_interval
        self.current: Optional[DynamicRouterConfig] = None
        self._mtime: float = 0.0
        self._task: Optional[asyncio.Task] = None
        DynamicConfigWatcher._instance = self

    async def start(self) -> None:
        self._task = asyncio.create_task(self._watch())

    async def close(self) -> None:
        if self._task:
            await cancel_task(self._task)
            self._task = None

    async def _watch(self) -> None:
        while True:
            try:
                mtime = os.path.getmtime(self.config_path)
                if mtime != self._mtime:
                    self._mtime = mtime
                    # config read off the loop: a ConfigMap mount mid-update
                    # (or any slow volume) must not stall in-flight streaming
                    # proxies for the duration of a sync read (GC001)
                    cfg = await asyncio.to_thread(
                        DynamicRouterConfig.from_json, self.config_path
                    )
                    await self._apply(cfg)
            except FileNotFoundError:
                pass
            except Exception:
                logger.exception("dynamic config reload failed")
            await asyncio.sleep(self.poll_interval)

    async def _apply(self, cfg: DynamicRouterConfig) -> None:
        logger.info("applying dynamic config: %s", cfg.to_json_str())
        if cfg.service_discovery == "static" and cfg.static_backends:
            old = sd._global_service_discovery
            new = sd.StaticServiceDiscovery(
                urls=parse_comma_separated(cfg.static_backends),
                models=parse_comma_separated(cfg.static_models),
            )
            sd.set_service_discovery(new)
            if old is not None:
                await old.close()
        if cfg.routing_logic:
            rl.reconfigure_routing_logic(
                cfg.routing_logic,
                session_key=cfg.session_key,
                kv_controller_url=cfg.kv_controller_url,
                kv_directory_url=cfg.kv_directory_url,
                prefill_model_labels=parse_comma_separated(cfg.prefill_model_labels),
                decode_model_labels=parse_comma_separated(cfg.decode_model_labels),
            )
        self.current = cfg

    @staticmethod
    def get() -> Optional["DynamicConfigWatcher"]:
        return DynamicConfigWatcher._instance
