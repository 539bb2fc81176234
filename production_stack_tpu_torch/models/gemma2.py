"""Gemma-2 family (gemma-2-2b/9b) in PyTorch.

The counterpart of production_stack_tpu/models/gemma2.py, on the serving
path the engine runs, with the forward contract of models/llama.py: paged KV
in layer-stacked pools ``[L, P, page, KH, D]``, ``kv_write_mode="post"``,
the prefill kernel's fused KV write for T > 1, one scatter after the layers
for T = 1, the deferred-burst decode (``kv_burst``), int8 pools with their
scales (``kv_scales``), and the f32 logits of each row's last token.

What Gemma-2 adds to that contract:

- interleaved attention: even layers slide over ``sliding_window`` keys,
  odd layers are global (no window);
- attention scaled by ``query_pre_attn_scalar**-0.5`` and soft-capped by
  ``attn_logit_softcap``, both passed to the kernels (head_dim 256 at every
  full-size preset);
- the embedding multiplied by ``hidden_size**0.5`` rounded to the model
  dtype first;
- sandwich norms with Gemma's zero-centred ``(1 + w)`` weights
  (ops/norms.rms_norm_1p): before and after attention and the MLP, the
  "after" norm applied before the residual add;
- a GeGLU MLP (tanh-approximate GELU on the gate);
- a head tied to the embedding, and a final logit softcap applied after the
  f32 cast (``None`` disables it).

With ``tp`` (a parallel/group.TPGroup) the model is one tensor-parallel
rank's, split as the llama family's (parallel/tp.py): the all-reduce of
``wo``'s and ``w_down``'s partial sums comes before their "after" norms, the
embedding scale after the vocab-parallel lookup, and the final softcap after
the logits are gathered.

``all_logits=True`` returns every position's logits, after the final
softcap (speculative decode's verify). The "pre" write mode is not ported;
the model raises on it. ``MESH_AXES`` is the JAX module's: no pp stages
(parallel/pipeline.check_pp refuses them in the JAX runner's words).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models.paged_step import PagedStep
from production_stack_tpu_torch.ops.norms import rms_norm_1p
from production_stack_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from production_stack_tpu_torch.parallel.tp import (
    all_reduce_,
    embed_lookup,
    gather_vocab,
    init_sharded_,
    kv_heads_per_rank,
    shard_shape,
)
from production_stack_tpu_torch.utils.arrays import tensor_from_numpy, unstack_layers


@dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 3584
    intermediate_size: int = 14336
    num_layers: int = 42
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_model_len: int = 8192
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0
    sliding_window: int = 4096        # even layers; odd layers are global
    dtype: torch.dtype = torch.bfloat16
    # "auto" | "cuda" | "plain", as LlamaConfig.attn_impl
    attn_impl: str = "auto"
    kv_write_mode: str = "post"       # "pre" is not ported
    kv_cache_dtype: str = "auto"      # "auto" | "int8", as LlamaConfig

    @property
    def tie_word_embeddings(self) -> bool:
        return True  # Gemma always ties the head to the embedding

    @staticmethod
    def from_hf_config(cfg: dict) -> "Gemma2Config":
        """Build from a HuggingFace ``config.json`` dict
        (Gemma2ForCausalLM), field for field as the JAX package's does."""
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return Gemma2Config(
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or hidden // heads,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            max_model_len=cfg.get("max_position_embeddings", 8192),
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar", 256.0),
            attn_logit_softcap=cfg.get("attn_logit_softcapping", 50.0),
            final_logit_softcap=cfg.get("final_logit_softcapping", 30.0),
            sliding_window=cfg.get("sliding_window", 4096),
        )


# the mesh axes this family's forward serves, as the JAX module declares them
MESH_AXES = ("dp", "tp")

PRESETS: dict[str, Gemma2Config] = {
    "gemma-2-9b": Gemma2Config(),
    "gemma-2-2b": Gemma2Config(
        hidden_size=2304,
        intermediate_size=9216,
        num_layers=26,
        num_heads=8,
        num_kv_heads=4,
        query_pre_attn_scalar=256.0,
    ),
    "gemma2-debug": Gemma2Config(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,            # layer 0 sliding, layer 1 global
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        query_pre_attn_scalar=32.0,
        sliding_window=8,
        max_model_len=256,
    ),
}


def layer_shapes(cfg: Gemma2Config) -> dict[str, tuple[int, ...]]:
    """Per-layer weight names and their [in, out] (or [n]) shapes."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "attn_norm": (H,),
        "post_attn_norm": (H,),
        "mlp_norm": (H,),
        "post_mlp_norm": (H,),
        "wq": (H, NH * D),
        "wk": (H, KH * D),
        "wv": (H, KH * D),
        "wo": (NH * D, H),
        "w_gate": (H, I),
        "w_up": (H, I),
        "w_down": (I, H),
    }


def layer_window(cfg: Gemma2Config, layer: int) -> Optional[int]:
    """Even layers slide over ``sliding_window`` keys; odd layers see all."""
    return cfg.sliding_window if layer % 2 == 0 else None


def _check_ported(cfg: Gemma2Config) -> None:
    if cfg.kv_write_mode != "post":
        raise NotImplementedError("only kv_write_mode='post' is ported")
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported (auto, int8)")


def init_kv_pages(
    cfg: Gemma2Config, num_pages: int, page_size: int, device, dtype=None, tp: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-stacked page pools: [L, num_pages, page_size, KH/tp, D] zeros
    (one KV head where tp/KH ranks share each), in ``dtype``, else int8 for
    ``kv_cache_dtype="int8"``, else ``cfg.dtype``."""
    shape = (cfg.num_layers, num_pages, page_size, kv_heads_per_rank(cfg.num_kv_heads, tp), cfg.head_dim)
    dt = dtype or (torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.dtype)
    return (
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
    )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def init_params(model: "Gemma2ForCausalLM", generator: torch.Generator) -> None:
    """Random-normal weights with the JAX package's scales (init_params
    there), written in place: norms 0 (Gemma multiplies by 1 + w), the
    embedding N(0, 1/H), projections N(0, 1/fan_in). The draw comes from
    ``generator`` (on the model's device), so its bits differ from
    ``jax.random``'s for the same seed. A tp rank draws each whole tensor
    and keeps its part."""
    dev = model.final_norm.device

    def leaf_init(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            return torch.zeros(shape, device=dev)
        fan_in = shape[1] if leaf == "embed" else shape[0]
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32).mul_(fan_in**-0.5)

    init_sharded_(model, leaf_init)


class Gemma2DecoderLayer(nn.Module):
    def __init__(self, cfg: Gemma2Config, device, tp=None):
        super().__init__()
        n = 1 if tp is None else tp.size
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _param(shard_shape("layers." + name, shape, n, kv_heads=cfg.num_kv_heads),
                                       cfg.dtype, device))
        self.tp = tp

    def qkv(self, h, cfg: Gemma2Config, cos, sin):
        B, T = h.shape[:2]
        # the rank's heads: NH/tp and KH/tp (all of them at tp = 1)
        q = (h @ self.wq).reshape(B, T, -1, cfg.head_dim)
        k = (h @ self.wk).reshape(B, T, -1, cfg.head_dim)
        v = (h @ self.wv).reshape(B, T, -1, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def mlp(self, x, cfg: Gemma2Config):
        h = rms_norm_1p(x, self.mlp_norm, cfg.rms_norm_eps)
        out = all_reduce_((F.gelu(h @ self.w_gate, approximate="tanh") * (h @ self.w_up)) @ self.w_down, self.tp)
        return x + rms_norm_1p(out, self.post_mlp_norm, cfg.rms_norm_eps)


class Gemma2ForCausalLM(nn.Module):
    """Decoder stack + tied head. Parameters are created empty on
    ``device``; engine/model_loader.py fills them."""

    def __init__(self, cfg: Gemma2Config, device="cuda", tp=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.tp = tp
        n = 1 if tp is None else tp.size
        self.embed = _param(shard_shape("embed", (cfg.vocab_size, cfg.hidden_size), n), cfg.dtype, device)
        self.layers = nn.ModuleList(Gemma2DecoderLayer(cfg, device, tp) for _ in range(cfg.num_layers))
        self.final_norm = _param((cfg.hidden_size,), cfg.dtype, device)

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: torch.Tensor,
        k_pages: torch.Tensor,
        v_pages: torch.Tensor,
        page_table: torch.Tensor,
        kv_lens: torch.Tensor,
        kv_burst: Optional[tuple] = None,
        all_logits: bool = False,
        kv_scales: Optional[tuple] = None,
    ) -> torch.Tensor:
        """One forward step (prefill chunk or decode) with paged KV; the
        arguments, the in-place pool updates and the result are those of
        ``LlamaForCausalLM.forward``. Returns the float32 logits [B, V] of
        each row's last valid token (with ``all_logits`` [B, T, V] of every
        position), soft-capped."""
        cfg = self.cfg
        B, T = input_ids.shape
        step = PagedStep(cfg.attn_impl, positions, k_pages, v_pages, page_table, kv_lens, kv_burst, kv_scales,
                         tp=1 if self.tp is None else self.tp.size)
        scale = dict(sm_scale=cfg.query_pre_attn_scalar**-0.5, logit_softcap=cfg.attn_logit_softcap)
        # the scale is rounded to the model dtype before the product
        x = embed_lookup(self.embed, input_ids, self.tp) * torch.tensor(cfg.hidden_size**0.5, dtype=cfg.dtype)
        cos, sin = rope_cos_sin(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta)
        eps = cfg.rms_norm_eps
        for li, layer in enumerate(self.layers):
            h = rms_norm_1p(x, layer.attn_norm, eps)
            q, k, v = layer.qkv(h, cfg, cos, sin)
            attn = step.attend(li, q, k, v, layer_window(cfg, li), **scale)
            x = x + rms_norm_1p(all_reduce_(attn.reshape(B, T, -1) @ layer.wo, self.tp), layer.post_attn_norm, eps)
            x = layer.mlp(x, cfg)
        step.finish()
        x = rms_norm_1p(x, self.final_norm, eps)
        if not all_logits:
            last = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)
            x = x[torch.arange(B, device=x.device), last]
        logits = gather_vocab((x @ self.embed.t()).float(), self.tp)
        cap = cfg.final_logit_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits


CAUSAL_LM = Gemma2ForCausalLM


def params_from_jax(np_tree: dict, cfg: Gemma2Config) -> dict[str, torch.Tensor]:
    """The JAX package's Gemma-2 parameter tree (numpy leaves: ``embed``,
    ``final_norm`` and the layer-stacked ``layers``; no ``lm_head``) as the
    port's parameter dict, every bit kept by ``tensor_from_numpy``."""
    out = {"embed": tensor_from_numpy(np_tree["embed"]), "final_norm": tensor_from_numpy(np_tree["final_norm"])}
    if "lm_head" in np_tree:
        raise ValueError("Gemma-2 ties its head to the embedding: the tree holds no lm_head")
    return {**out, **unstack_layers(np_tree["layers"], cfg.num_layers)}

