"""Pluggable request rewriting before the request is sent to an engine.

The port's copy of ``production_stack_tpu/router/rewriter.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/services/request_service/rewriter.py:30-119 of the
upstream vLLM production stack (abstract RequestRewriter; `noop` is the only built-in).
"""

from __future__ import annotations

import abc
from typing import Optional


class RequestRewriter(abc.ABC):
    @abc.abstractmethod
    def rewrite_request(self, body: bytes, model: str, endpoint: str) -> bytes: ...


class NoopRequestRewriter(RequestRewriter):
    def rewrite_request(self, body: bytes, model: str, endpoint: str) -> bytes:
        return body


_rewriter: RequestRewriter = NoopRequestRewriter()


def initialize_rewriter(kind: Optional[str]) -> RequestRewriter:
    global _rewriter
    if kind in (None, "", "noop"):
        _rewriter = NoopRequestRewriter()
    else:
        raise ValueError(f"unknown rewriter: {kind}")
    return _rewriter


def get_rewriter() -> RequestRewriter:
    return _rewriter
