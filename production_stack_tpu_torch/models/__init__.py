"""Model registry of the port (the Llama family only, for now)."""

from __future__ import annotations

from production_stack_tpu_torch.models import llama

#: module search order for preset names
MODULES = (llama,)


def module_for_config(cfg):
    """Map a model config instance back to its module."""
    if isinstance(cfg, llama.LlamaConfig):
        return llama
    raise ValueError(f"unknown model config type {type(cfg).__name__}")


def find_preset(name: str):
    """Return (module, config) for a preset name, or None."""
    for mod in MODULES:
        if name in mod.PRESETS:
            return mod, mod.PRESETS[name]
    return None
