"""Model registry of the port: the Llama (with Mistral, Qwen2 and Mixtral),
OPT and Gemma-2 families.

Each model module holds ``PRESETS``, its config class (with
``from_hf_config``), ``init_params``, ``init_kv_pages``,
``params_from_jax`` and one class entry, ``CAUSAL_LM``. The llama module
alone also holds ``init_lora_buffers`` (and ``lora_dims``,
``lora_from_jax``): the runner refuses LoRA for a family without it.
``MESH_AXES``, where a module has it, names the mesh axes its forward
serves (the JAX modules' attribute): llama's includes "pp", Gemma-2's is
("dp", "tp"), and a module without one (OPT) serves ("dp", "tp")
(parallel/pipeline.check_pp reads it)."""

from __future__ import annotations

from production_stack_tpu_torch.models import gemma2, llama, opt

#: module search order for preset names and HF architectures
MODULES = (llama, opt, gemma2)

_ARCH_TO_MODULE = {
    "LlamaForCausalLM": llama,
    "MistralForCausalLM": llama,
    "Qwen2ForCausalLM": llama,
    "MixtralForCausalLM": llama,
    "OPTForCausalLM": opt,
    "Gemma2ForCausalLM": gemma2,
}


def module_for_arch(arch: str):
    """Map a HuggingFace ``architectures[0]`` string to a model module."""
    try:
        return _ARCH_TO_MODULE[arch]
    except KeyError:
        raise ValueError(
            f"unsupported architecture {arch!r}; supported: {sorted(_ARCH_TO_MODULE)}"
        ) from None


def module_for_config(cfg):
    """Map a model config instance back to its module."""
    for mod, cls in ((llama, llama.LlamaConfig), (opt, opt.OPTConfig), (gemma2, gemma2.Gemma2Config)):
        if isinstance(cfg, cls):
            return mod
    raise ValueError(f"unknown model config type {type(cfg).__name__}")


def find_preset(name: str):
    """Return (module, config) for a preset name, or None."""
    for mod in MODULES:
        if name in mod.PRESETS:
            return mod, mod.PRESETS[name]
    return None
