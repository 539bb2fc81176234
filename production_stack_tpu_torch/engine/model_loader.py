"""Build a model of the port: a preset with seeded random weights, a local
HuggingFace checkpoint, or a parameter tree carried over from the JAX
package.

- ``load_model(name_or_dir, seed, device)``: a local HF directory
  (``config.json`` plus ``*.safetensors``, ``is_hf_dir``) is loaded by
  ``load_from_hf``; any other name must be a preset, whose random-normal
  weights are drawn from a ``torch.Generator`` on ``device`` (the presets
  carry no checkpoint, as in the JAX package, so serving needs nothing
  from outside).
- ``load_from_hf(path, device)``: the architecture from
  ``config.json["architectures"][0]`` (Llama, Mistral, Qwen2 → llama; OPT
  → opt; Gemma2 → gemma2; Mixtral is refused), the config from the
  family's ``from_hf_config``, and each weight read from the shards with
  utils/safetensors_io.py (no ``safetensors`` package), HF's ``[out, in]``
  matrices transposed to the port's ``[in, out]``, cast to the config's
  dtype and copied onto the device one tensor at a time, under the HF
  names the JAX package's loader reads.
- ``params_from_jax(np_tree, cfg)``: the JAX package's layer-stacked tree
  (``{"embed", "layers": {name: [L, ...]}, "final_norm"}``, plus
  ``"lm_head"`` for an untied llama) given as numpy arrays, split per layer
  into the port's parameter names by the config's model module. It takes
  numpy, never jax: the caller converts (``jax.device_get``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from production_stack_tpu_torch import models
from production_stack_tpu_torch.models import gemma2, llama, opt
from production_stack_tpu_torch.utils.device import resolve_device
from production_stack_tpu_torch.utils.safetensors_io import SafetensorsDir


def params_from_jax(np_tree: dict, cfg) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (numpy leaves) of the model ``cfg``
    configures, as the port's parameter dict on the CPU, every bit kept."""
    return models.module_for_config(cfg).params_from_jax(np_tree, cfg)


@torch.no_grad()
def load_params(model: torch.nn.Module, params: dict[str, torch.Tensor]) -> None:
    """Copy a parameter dict into ``model``: every name must be present with
    the module's shape AND dtype (no silent casts)."""
    own = dict(model.named_parameters())
    missing, extra = set(own) - set(params), set(params) - set(own)
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for name, p in own.items():
        src = params[name]
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(
                f"{name}: got {tuple(src.shape)} {src.dtype}, model holds {tuple(p.shape)} {p.dtype}"
            )
        p.copy_(src)


def is_hf_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def load_model(
    model: str,
    seed: int = 0,
    device="cuda",
    max_model_len: int | None = None,
    params: dict[str, torch.Tensor] | None = None,
):
    """Returns (module, config, model) for a local HF directory, or for a
    preset name with weights from ``params`` when given, else seeded random
    ones drawn on ``device``."""
    dev = resolve_device(device)
    if is_hf_dir(model):
        if params is not None:
            raise ValueError(f"{model} is a checkpoint directory: it brings its own weights, not params")
        return load_from_hf(model, device=dev, max_model_len=max_model_len)
    hit = models.find_preset(model)
    if hit is None:
        names = sorted(n for m in models.MODULES for n in m.PRESETS)
        raise ValueError(
            f"model {model!r} is not a preset of the port ({names}) "
            "nor a local HF directory (config.json + *.safetensors)"
        )
    mod, cfg = hit
    if max_model_len:
        # before the model is built: OPT sizes its position table from this
        cfg = dataclasses.replace(cfg, max_model_len=max_model_len)
    net = mod.CAUSAL_LM(cfg, device=dev)
    if params is not None:
        load_params(net, params)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        mod.init_params(net, gen)
    return mod, cfg, net


# -- HF weight names: {port parameter: (HF tensor, transposed)} ----------------


def _llama_names(cfg: llama.LlamaConfig) -> dict[str, tuple[str, bool]]:
    out = {"embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False)}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = ("lm_head.weight", True)
    per_layer = {
        "attn_norm": ("input_layernorm.weight", False),
        "wq": ("self_attn.q_proj.weight", True),
        "wk": ("self_attn.k_proj.weight", True),
        "wv": ("self_attn.v_proj.weight", True),
        "wo": ("self_attn.o_proj.weight", True),
        "mlp_norm": ("post_attention_layernorm.weight", False),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
    }
    if cfg.attention_bias:
        per_layer.update({f"b{x}": (f"self_attn.{x}_proj.bias", False) for x in "qkv"})
    return {**out, **_layers(cfg.num_layers, "model.layers.{}.", per_layer)}


def _opt_names(cfg: opt.OPTConfig) -> dict[str, tuple[str, bool]]:
    """OPT's names with the ``model.`` prefix of OPTForCausalLM checkpoints
    stripped (bare OPTModel checkpoints have none)."""
    out = {
        "embed": ("decoder.embed_tokens.weight", False),
        "pos_embed": ("decoder.embed_positions.weight", False),
        "final_norm_w": ("decoder.final_layer_norm.weight", False),
        "final_norm_b": ("decoder.final_layer_norm.bias", False),
    }
    per_layer = {
        "attn_norm_w": ("self_attn_layer_norm.weight", False),
        "attn_norm_b": ("self_attn_layer_norm.bias", False),
        "mlp_norm_w": ("final_layer_norm.weight", False),
        "mlp_norm_b": ("final_layer_norm.bias", False),
        "fc1": ("fc1.weight", True),
        "fc1_b": ("fc1.bias", False),
        "fc2": ("fc2.weight", True),
        "fc2_b": ("fc2.bias", False),
    }
    for x, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        per_layer[f"w{x}"] = (f"self_attn.{hf}.weight", True)
        per_layer[f"b{x}"] = (f"self_attn.{hf}.bias", False)
    return {**out, **_layers(cfg.num_layers, "decoder.layers.{}.", per_layer)}


def _gemma2_names(cfg: gemma2.Gemma2Config) -> dict[str, tuple[str, bool]]:
    out = {"embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False)}
    per_layer = {
        "attn_norm": ("input_layernorm.weight", False),
        "post_attn_norm": ("post_attention_layernorm.weight", False),
        "mlp_norm": ("pre_feedforward_layernorm.weight", False),
        "post_mlp_norm": ("post_feedforward_layernorm.weight", False),
        "wq": ("self_attn.q_proj.weight", True),
        "wk": ("self_attn.k_proj.weight", True),
        "wv": ("self_attn.v_proj.weight", True),
        "wo": ("self_attn.o_proj.weight", True),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
    }
    return {**out, **_layers(cfg.num_layers, "model.layers.{}.", per_layer)}


def _layers(num_layers: int, prefix: str, per_layer: dict) -> dict[str, tuple[str, bool]]:
    return {
        f"layers.{i}.{name}": (prefix.format(i) + hf, t)
        for i in range(num_layers) for name, (hf, t) in per_layer.items()
    }


# family module -> (config class, weight names, prefix stripped from the checkpoint's names)
_FAMILIES = {
    llama: (llama.LlamaConfig, _llama_names, ""),
    opt: (opt.OPTConfig, _opt_names, "model."),
    gemma2: (gemma2.Gemma2Config, _gemma2_names, ""),
}


@torch.no_grad()
def load_from_hf(path: str, device="cuda", max_model_len: int | None = None):
    """Returns (module, config, model) for a local HF directory, its weights
    read from the shards one tensor at a time."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    mod = models.module_for_arch((hf_cfg.get("architectures") or ["LlamaForCausalLM"])[0])
    cfg_cls, names_of, strip = _FAMILIES[mod]
    cfg = cfg_cls.from_hf_config(hf_cfg)
    if max_model_len and mod is opt and max_model_len > cfg.max_model_len:
        # OPT's learned position table is the checkpoint's size and cannot
        # be extended; a position past it is a device-side assert on the card
        raise ValueError(f"max_model_len={max_model_len} exceeds OPT position table ({cfg.max_model_len})")
    shards = SafetensorsDir(path)
    keys = {(k[len(strip):] if strip and k.startswith(strip) else k): k for k in shards.keys()}
    net = mod.CAUSAL_LM(cfg, device=dev)
    own = dict(net.named_parameters())
    wanted = names_of(cfg)
    if set(wanted) != set(own):
        raise AssertionError(f"weight map and model differ: {sorted(set(wanted) ^ set(own))}")
    for pname, (hf, transpose) in wanted.items():
        if hf not in keys:
            raise KeyError(f"{path}: the checkpoint lacks {hf!r} ({type(cfg).__name__} needs it)")
        t = shards.get(keys[hf]).to(dev).to(cfg.dtype)
        if transpose:
            t = t.t()
        p = own[pname]
        if t.shape != p.shape:
            raise ValueError(f"{path}: {hf} gives {tuple(t.shape)} for {pname}, the config needs {tuple(p.shape)}")
        p.copy_(t)
    if max_model_len:
        # after the weights: OPT keeps the checkpoint's whole position table
        cfg = dataclasses.replace(cfg, max_model_len=max_model_len)
        net.cfg = cfg
    return mod, cfg, net
