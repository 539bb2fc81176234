"""Model registry of the port: the Llama and Gemma-2 families.

Each model module holds ``PRESETS``, its config class, ``init_params``,
``init_kv_pages``, ``params_from_jax`` and one class entry, ``CAUSAL_LM``."""

from __future__ import annotations

from production_stack_tpu_torch.models import gemma2, llama

#: module search order for preset names
MODULES = (llama, gemma2)


def module_for_config(cfg):
    """Map a model config instance back to its module."""
    if isinstance(cfg, llama.LlamaConfig):
        return llama
    if isinstance(cfg, gemma2.Gemma2Config):
        return gemma2
    raise ValueError(f"unknown model config type {type(cfg).__name__}")


def find_preset(name: str):
    """Return (module, config) for a preset name, or None."""
    for mod in MODULES:
        if name in mod.PRESETS:
            return mod, mod.PRESETS[name]
    return None
