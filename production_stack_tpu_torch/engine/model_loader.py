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
  ``config.json["architectures"][0]`` (Llama, Mistral, Qwen2, Mixtral →
  llama; OPT → opt; Gemma2 → gemma2), the config from the family's
  ``from_hf_config``, and each weight read from the shards with
  utils/safetensors_io.py (no ``safetensors`` package), HF's ``[out, in]``
  matrices transposed to the port's ``[in, out]``, cast to the config's
  dtype and copied onto the device one tensor at a time, under the HF
  names the JAX package's loader reads (a Mixtral layer's experts, one HF
  tensor each, stacked on the parameter's leading [E] axis).
- ``model_config(name_or_dir, max_model_len)``: the (module, config) that
  ``load_model`` would build, without weights (the engine checks a tp split
  against it before any rank starts).
- With ``tp`` (a parallel/group.TPGroup) the model is that rank's
  (parallel/tp.py), and with ``experts`` (its ``TPGroup.expert``, for a
  MoE model split over ep) it holds E/ep of the experts too: a preset draws each whole tensor from the seeded
  generator and keeps its part, so every (ep, tp) serves one model; a
  directory reads only the rank's slice of each split tensor from the
  mapped shards (of a Mixtral layer, only its experts' tensors, each on its
  I slice); ``params`` are whole and the rank takes its part
  (``shard_params``). With ``stage`` (its ``TPGroup.stage``, pp > 1) the
  model is one pipeline stage's: a preset draws every layer and keeps its
  stage's, a directory reads only the stage's ``model.layers.{i}`` tensors
  (and the embedding, final norm and head every stage holds), ``params``
  give the stage their layers. With ``seq`` (its ``TPGroup.seq``, sp > 1)
  the weights are replicated along sp: a sequence rank draws or reads what
  its tp place alone would, the same on every rank of its sequence group.
  A directory's model carries the bytes read from its shards
  (``loaded_bytes``).
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
from production_stack_tpu_torch.parallel.ep import expert_range
from production_stack_tpu_torch.parallel.pipeline import local_name
from production_stack_tpu_torch.parallel.tp import (
    expert_axis,
    expert_place,
    shard_params,
    size_rank,
    split_axis,
    split_parts,
)
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


def _hf_config(path: str):
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    mod = models.module_for_arch((hf_cfg.get("architectures") or ["LlamaForCausalLM"])[0])
    return mod, _FAMILIES[mod][0].from_hf_config(hf_cfg)


def model_config(model: str, max_model_len: int | None = None):
    """(module, config) of a local HF directory or a preset, as
    ``load_model`` builds it, without weights."""
    if is_hf_dir(model):
        mod, cfg = _hf_config(model)
    else:
        hit = models.find_preset(model)
        if hit is None:
            names = sorted(n for m in models.MODULES for n in m.PRESETS)
            raise ValueError(
                f"model {model!r} is not a preset of the port ({names}) "
                "nor a local HF directory (config.json + *.safetensors)"
            )
        mod, cfg = hit
    if max_model_len:
        cfg = dataclasses.replace(cfg, max_model_len=max_model_len)
    return mod, cfg


def load_model(
    model: str,
    seed: int = 0,
    device="cuda",
    max_model_len: int | None = None,
    params: dict[str, torch.Tensor] | None = None,
    tp=None,
    config=None,
    experts=None,
    stage=None,
    seq=None,
):
    """Returns (module, config, model) for a local HF directory, or for a
    preset name with weights from ``params`` when given, else seeded random
    ones drawn on ``device``. ``tp``: the tp rank's group (None: the whole
    model); ``experts``: its expert group, for a MoE model split over ep
    (a dense model ignores it); ``seq``: its sequence group under sp (the
    weights are whole on every sequence rank: it reads and draws what its tp
    place alone would); ``stage``: its stage group under pp (None:
    every layer). ``config``: a preset's config as the caller resolved it
    (``model_config``), which a spawned rank takes from its leader."""
    dev = resolve_device(device)
    if is_hf_dir(model):
        if params is not None:
            raise ValueError(f"{model} is a checkpoint directory: it brings its own weights, not params")
        return load_from_hf(model, device=dev, max_model_len=max_model_len, tp=tp, experts=experts, stage=stage,
                            seq=seq)
    mod, cfg = model_config(model, max_model_len) if config is None else (models.module_for_config(config), config)
    # before the model is built: OPT sizes its position table from max_model_len
    net = _build(mod, cfg, dev, tp, experts, stage, seq)
    if params is not None:
        n, r = size_rank(tp)
        m, e = expert_place(getattr(net, "experts", None))
        load_params(net, shard_params(params, r, n, e, m, stage=getattr(net, "stage", None),
                                      kv_heads=cfg.num_kv_heads))
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        mod.init_params(net, gen)
    return mod, cfg, net


# -- HF weight names: {port parameter: (HF tensor, transposed)} ----------------
# (a tuple of HF tensors fills the parameter's leading axis, one each)


def _llama_names(cfg: llama.LlamaConfig) -> dict[str, tuple]:
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
    }
    if cfg.num_experts:
        # Mixtral: the router [E, H], and per expert w1 (gate), w3 (up), w2 (down)
        def experts(w):
            return tuple(f"block_sparse_moe.experts.{e}.{w}.weight" for e in range(cfg.num_experts))

        per_layer.update({
            "moe_router": ("block_sparse_moe.gate.weight", True),
            "moe_gate": (experts("w1"), True),
            "moe_up": (experts("w3"), True),
            "moe_down": (experts("w2"), True),
        })
    else:
        per_layer.update({
            "w_gate": ("mlp.gate_proj.weight", True),
            "w_up": ("mlp.up_proj.weight", True),
            "w_down": ("mlp.down_proj.weight", True),
        })
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


def _layers(num_layers: int, prefix: str, per_layer: dict) -> dict[str, tuple]:
    def full(i, hf):
        return tuple(prefix.format(i) + h for h in hf) if isinstance(hf, tuple) else prefix.format(i) + hf

    return {
        f"layers.{i}.{name}": (full(i, hf), t)
        for i in range(num_layers) for name, (hf, t) in per_layer.items()
    }


# family module -> (config class, weight names, prefix stripped from the checkpoint's names)
_FAMILIES = {
    llama: (llama.LlamaConfig, _llama_names, ""),
    opt: (opt.OPTConfig, _opt_names, "model."),
    gemma2: (gemma2.Gemma2Config, _gemma2_names, ""),
}


def _build(mod, cfg, device, tp, experts, stage=None, seq=None):
    """The family's model, empty; the expert group goes to a MoE model
    alone, the stage and sequence groups to a family that serves pp and sp
    (the llama family's)."""
    kw = {}
    if seq is not None and seq.size > 1:
        kw["seq"] = seq
    if experts is not None and getattr(cfg, "num_experts", 0):
        kw["experts"] = experts
    if stage is not None and stage.size > 1:
        kw["stage"] = stage
    return mod.CAUSAL_LM(cfg, device=device, tp=tp, **kw)


@torch.no_grad()
def load_from_hf(path: str, device="cuda", max_model_len: int | None = None, tp=None, experts=None, stage=None,
                 seq=None):
    """Returns (module, config, model) for a local HF directory, its weights
    read from the shards one tensor at a time; a tp rank reads its slice of
    each split tensor (of a KV head shared by tp/KH ranks, that head's rows
    whole), an ep rank only its experts' tensors, and a pipeline stage only
    its layers' (the model's ``loaded_bytes``: what was read); a sequence
    rank reads what its tp place alone reads."""
    dev = resolve_device(device)
    mod, cfg = _hf_config(path)
    _, names_of, strip = _FAMILIES[mod]
    n, rank = size_rank(tp)
    if max_model_len and mod is opt and max_model_len > cfg.max_model_len:
        # OPT's learned position table is the checkpoint's size and cannot
        # be extended; a position past it is a device-side assert on the card
        raise ValueError(f"max_model_len={max_model_len} exceeds OPT position table ({cfg.max_model_len})")
    shards = SafetensorsDir(path)
    keys = {(k[len(strip):] if strip and k.startswith(strip) else k): k for k in shards.keys()}
    net = _build(mod, cfg, dev, tp, experts, stage, seq)
    m, e = expert_place(getattr(net, "experts", None))
    own = dict(net.named_parameters())
    # the stage's layers under its own names (every layer without pp)
    wanted = {held: v for name, v in names_of(cfg).items()
              if (held := local_name(name, cfg.num_layers, getattr(net, "stage", None))) is not None}
    if set(wanted) != set(own):
        raise AssertionError(f"weight map and model differ: {sorted(set(wanted) ^ set(own))}")
    read = 0
    for pname, (hf, transpose) in wanted.items():
        p = own[pname]
        ax = split_axis(pname) if n > 1 else None
        # the rank's part of the split axis: a KV leaf at shared heads is
        # one of KH parts, head rank // (tp / KH)
        at = rank * split_parts(pname, n, cfg.num_kv_heads) // n
        if isinstance(hf, tuple):
            # a stacked parameter takes one HF tensor per entry of its
            # leading axis: an ep rank's experts, each split like a 2-D
            # weight on the axis after the experts'
            if expert_axis(pname) is not None:
                hf = tuple(hf[i] for i in expert_range(len(hf), m, e))
            parts = zip(hf, p)
            ax = None if ax is None else ax - 1
        else:
            parts = [(hf, p)]
        for name, dst in parts:
            if name not in keys:
                raise KeyError(f"{path}: the checkpoint lacks {name!r} ({type(cfg).__name__} needs it)")
            if ax is None:
                t = shards.get(keys[name])
            else:
                # the rank's slice, on the HF tensor's axis ([out, in] where transposed)
                hf_ax = 1 - ax if transpose else ax
                part = dst.shape[ax]
                t = shards.get_slice(keys[name], hf_ax, at * part, part)
            read += t.nbytes
            t = t.to(dev).to(cfg.dtype)
            if transpose:
                t = t.t()
            if t.shape != dst.shape:
                raise ValueError(
                    f"{path}: {name} gives {tuple(t.shape)} for {pname}, the config needs {tuple(dst.shape)}"
                )
            dst.copy_(t)
    net.loaded_bytes = read
    if max_model_len:
        # after the weights: OPT keeps the checkpoint's whole position table
        cfg = dataclasses.replace(cfg, max_model_len=max_model_len)
        net.cfg = cfg
    return mod, cfg, net
