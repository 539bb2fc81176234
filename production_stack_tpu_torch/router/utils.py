"""Router utilities: singletons, model typing, health probes.

The port's copy of ``production_stack_tpu/router/utils.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/utils.py of the upstream vLLM production stack (SingletonMeta :16-45,
ModelType health payloads :48-81, is_model_healthy :160-175).
"""

from __future__ import annotations

import asyncio
import enum
import resource
from typing import Optional

import aiohttp

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


async def cancel_task(task: Optional["asyncio.Task"]) -> None:
    """Cancel a background task and wait for it to actually finish, so loop
    shutdown never destroys a still-pending task."""
    if task is None:
        return
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        if not task.cancelled():
            # the CancelledError came from OUR caller being cancelled
            # mid-shutdown, not from the awaited task — propagate it
            raise
    except Exception as e:  # noqa: BLE001
        logger.warning("background task %r died: %s: %s",
                       task.get_name(), type(e).__name__, e)


class SingletonMeta(type):
    _instances: dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    @classmethod
    def _reset(mcs, cls) -> None:
        mcs._instances.pop(cls, None)


class ModelType(enum.Enum):
    chat = "/v1/chat/completions"
    completion = "/v1/completions"
    embeddings = "/v1/embeddings"
    rerank = "/v1/rerank"
    score = "/v1/score"

    @staticmethod
    def get_test_payload(model_type: str) -> dict:
        return {
            "chat": {"messages": [{"role": "user", "content": "Hi"}], "max_tokens": 2},
            "completion": {"prompt": "Hi", "max_tokens": 2},
            "embeddings": {"input": "Hi"},
            "rerank": {"query": "Hi", "documents": ["a"]},
            "score": {"text_1": "a", "text_2": "b"},
        }[model_type]

    @staticmethod
    def get_all_fields() -> list[str]:
        return [m.name for m in ModelType]


async def is_model_healthy(url: str, model: str, model_type: str, timeout: float = 10.0) -> bool:
    """Send a real dummy request of the right type (parity: utils.py:160-175)."""
    endpoint = ModelType[model_type].value
    payload = {"model": model, **ModelType.get_test_payload(model_type)}
    try:
        from production_stack_tpu_torch.router.request_service import get_client_session

        session = await get_client_session()
        async with session.post(
            f"{url}{endpoint}", json=payload,
            timeout=aiohttp.ClientTimeout(total=timeout),
        ) as resp:
            return resp.status == 200
    except Exception:
        return False


def set_ulimit(target: int = 65535) -> None:
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < target:
            resource.setrlimit(resource.RLIMIT_NOFILE, (min(target, hard), hard))
    except Exception as e:
        logger.warning("could not raise ulimit: %s", e)


def parse_comma_separated(value: Optional[str]) -> list[str]:
    return [v.strip() for v in value.split(",") if v.strip()] if value else []


def parse_static_urls(static_backends: str) -> list[str]:
    return parse_comma_separated(static_backends)


def parse_static_model_names(static_models: str) -> list[str]:
    return parse_comma_separated(static_models)
