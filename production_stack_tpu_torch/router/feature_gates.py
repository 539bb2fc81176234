"""Experimental feature gates.

The port's copy of ``production_stack_tpu/router/feature_gates.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/experimental/feature_gates.py:46-108 of the upstream vLLM production stack
(`--feature-gates SemanticCache=true,PIIDetection=true`).
"""

from __future__ import annotations

from typing import Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

KNOWN_FEATURES = {"SemanticCache", "PIIDetection"}


class FeatureGates:
    def __init__(self, spec: str = ""):
        self.enabled: set[str] = set()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, value = part.partition("=")
            if name not in KNOWN_FEATURES:
                raise ValueError(
                    f"unknown feature gate {name!r}; known: {sorted(KNOWN_FEATURES)}"
                )
            if value.lower() in ("true", "1", "yes"):
                self.enabled.add(name)
        if self.enabled:
            logger.info("enabled experimental features: %s", sorted(self.enabled))

    def is_enabled(self, name: str) -> bool:
        return name in self.enabled


_gates = FeatureGates()


def initialize_feature_gates(spec: str) -> FeatureGates:
    global _gates
    _gates = FeatureGates(spec)
    return _gates


def get_feature_gates() -> FeatureGates:
    return _gates
