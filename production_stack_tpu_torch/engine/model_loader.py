"""Build a model of the port: a preset with seeded random weights, or a
parameter tree carried over from the JAX package.

- ``load_model(preset, seed, device)``: random-normal weights drawn from a
  ``torch.Generator`` on ``device`` (the presets carry no checkpoint, as in
  the JAX package, so serving needs nothing from outside).
- ``params_from_jax(np_tree, cfg)``: the JAX package's layer-stacked tree
  (``{"embed", "layers": {name: [L, ...]}, "final_norm", "lm_head"}``) given
  as numpy arrays, split per layer into the port's parameter names. It takes
  numpy, never jax: the caller converts (``jax.device_get``).

Loading local HuggingFace checkpoints is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from production_stack_tpu_torch import models
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.utils.device import resolve_device


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor with the same bits. bf16 arrives as ml_dtypes'
    bfloat16, which torch cannot read: it moves as uint16 and is viewed
    back, so no value passes through float32."""
    arr = np.require(arr, requirements=["C", "W"])  # torch wants a writable buffer
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_tree: dict, cfg: llama.LlamaConfig) -> dict[str, torch.Tensor]:
    """The JAX package's llama parameter tree (numpy leaves) as the port's
    parameter dict (``LlamaForCausalLM.state_dict()`` names), on the CPU."""
    out = {"embed": tensor_from_numpy(np_tree["embed"]), "final_norm": tensor_from_numpy(np_tree["final_norm"])}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = tensor_from_numpy(np_tree["lm_head"])
    for name, stacked in np_tree["layers"].items():
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layer-stacked {name} has {stacked.shape[0]} layers, config {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{name}"] = tensor_from_numpy(stacked[i])
    return out


@torch.no_grad()
def load_params(model: llama.LlamaForCausalLM, params: dict[str, torch.Tensor]) -> None:
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


def load_model(
    model: str,
    seed: int = 0,
    device="cuda",
    max_model_len: int | None = None,
    params: dict[str, torch.Tensor] | None = None,
):
    """Returns (module, config, model) for a preset name: weights from
    ``params`` when given, else seeded random ones drawn on ``device``."""
    dev = resolve_device(device)
    hit = models.find_preset(model)
    if hit is None:
        names = sorted(n for m in models.MODULES for n in m.PRESETS)
        raise ValueError(
            f"model {model!r} is not a preset of the port ({names}); "
            "loading HuggingFace checkpoints is not ported yet"
        )
    mod, cfg = hit
    if max_model_len:
        cfg = dataclasses.replace(cfg, max_model_len=max_model_len)
    net = mod.LlamaForCausalLM(cfg, device=dev)
    if params is not None:
        load_params(net, params)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        mod.init_params(net, gen)
    return mod, cfg, net
