"""User-supplied pre/post request hooks.

The port's copy of ``production_stack_tpu/router/callbacks.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/services/callbacks_service/custom_callbacks.py:20-55 of the
upstream vLLM production stack — a `--callbacks module.py:instance` file is loaded at startup;
`pre_request` may short-circuit with a response, `post_request` observes the
full response body in the background.
"""

from __future__ import annotations

import importlib.util
import sys
from typing import Any, Optional


class CustomCallbackHandler:
    def pre_request(self, request: Any, request_body: bytes, request_json: dict):
        """Return None to continue, or a (status, dict) tuple to short-circuit."""
        return None

    def post_request(self, request: Any, response_body: bytes) -> None:
        return None


_handler: Optional[CustomCallbackHandler] = None


def load_callbacks(spec: str) -> CustomCallbackHandler:
    """`/path/to/file.py:attribute` -> the attribute (an instance)."""
    global _handler
    path, _, attr = spec.partition(":")
    module_spec = importlib.util.spec_from_file_location("_router_callbacks", path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules["_router_callbacks"] = module
    module_spec.loader.exec_module(module)
    _handler = getattr(module, attr or "handler")
    return _handler


def get_callbacks() -> Optional[CustomCallbackHandler]:
    return _handler
