"""OPT family (facebook/opt-125m … opt-66b) in PyTorch.

The counterpart of production_stack_tpu/models/opt.py, with the forward
contract of models/llama.py: paged KV in layer-stacked pools
``[L, P, page, KH, D]``, ``kv_write_mode="post"``, and the f32 logits of
each row's last token. Attention goes through models/paged_step.py: a
prefill chunk (T > 1, whatever its length) takes the prefill kernel with
its fused KV write, a decode token the decode kernel, and a burst step the
deferred-burst window (``kv_burst``) that the runner commits once per
burst. The JAX forward has no burst: the JAX runner decodes OPT step by
step, writing after each step, which gives the same tokens while no row
stops mid-burst.

What OPT has that the llama family does not:

- learned positions: row ``max(pos, 0) + POS_OFFSET`` of ``pos_embed``
  (HF reserves the first two rows), added to the token embedding; the
  table has ``max_model_len + POS_OFFSET`` rows, and engine/model_loader.py
  refuses a ``max_model_len`` past a checkpoint's table (on the card a
  gather out of range is a device-side assert);
- pre-LayerNorm blocks (ops/norms.layer_norm) with biases on every
  projection, a ReLU MLP (``fc1``, ``fc2``), no RoPE, no GQA (KH = NH),
  and a head tied to the embedding.

int8 pools are not served: the JAX OPT forward takes no ``kv_scales``, and
this one takes none either (engine/runner.py refuses the int8 pool dtype
for it). All-position logits and the "pre" write mode raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models.paged_step import PagedStep
from production_stack_tpu_torch.ops.norms import layer_norm
from production_stack_tpu_torch.utils.arrays import tensor_from_numpy, unstack_layers

# HF OPT reserves the first 2 position-embedding rows (legacy padding offset)
POS_OFFSET = 2


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    max_model_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "auto" | "cuda" | "plain", as LlamaConfig.attn_impl
    attn_impl: str = "auto"
    kv_write_mode: str = "post"       # "pre" is not ported
    # kept for the engine's uniform config threading; only "auto" is served
    kv_cache_dtype: str = "auto"

    # the runner's and engine's uniform accessors (OPT has no GQA)
    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def tie_word_embeddings(self) -> bool:
        return True

    @property
    def sliding_window(self):
        return None

    @staticmethod
    def from_hf_config(cfg: dict) -> "OPTConfig":
        """Build from a HuggingFace ``config.json`` dict (OPTForCausalLM), as
        the JAX package's does. Post-LayerNorm checkpoints (opt-350m's
        ``do_layer_norm_before: false``) and a projected embedding are
        refused, not served with the wrong block order or width."""
        if cfg.get("word_embed_proj_dim", cfg["hidden_size"]) != cfg["hidden_size"]:
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size")
        if not cfg.get("do_layer_norm_before", True):
            raise NotImplementedError("OPT with do_layer_norm_before=false (post-LayerNorm blocks) is not ported")
        return OPTConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["ffn_dim"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            max_model_len=cfg.get("max_position_embeddings", 2048),
        )


PRESETS: dict[str, OPTConfig] = {
    "opt-125m": OPTConfig(),
    "opt-debug": OPTConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        max_model_len=256,
    ),
}
# f32 twin: greedy tokens on random (near-flat) logits are only
# reproducible across implementations in f32
PRESETS["opt-debug-f32"] = dataclasses.replace(PRESETS["opt-debug"], dtype=torch.float32)


def layer_shapes(cfg: OPTConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer weight names (the JAX tree's) and their [in, out] (or [n])
    shapes."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "attn_norm_w": (H,),
        "attn_norm_b": (H,),
        "wq": (H, H),
        "bq": (H,),
        "wk": (H, H),
        "bk": (H,),
        "wv": (H, H),
        "bv": (H,),
        "wo": (H, H),
        "bo": (H,),
        "mlp_norm_w": (H,),
        "mlp_norm_b": (H,),
        "fc1": (H, I),
        "fc1_b": (I,),
        "fc2": (I, H),
        "fc2_b": (H,),
    }


def _check_ported(cfg: OPTConfig) -> None:
    if cfg.kv_write_mode != "post":
        raise NotImplementedError("only kv_write_mode='post' is ported")


def init_kv_pages(
    cfg: OPTConfig, num_pages: int, page_size: int, device, dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-stacked page pools: [L, num_pages, page_size, NH, D] zeros in
    ``dtype`` or ``cfg.dtype``."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return (
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
    )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def init_params(model: "OPTForCausalLM", generator: torch.Generator) -> None:
    """Random-normal weights with the JAX package's scales (init_params
    there), written in place: LayerNorm weights 1, biases 0, the token and
    position tables N(0, 1/H), projections N(0, 1/fan_in). The draw comes
    from ``generator`` (on the model's device), so its bits differ from
    ``jax.random``'s for the same seed."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm_w"):
            p.fill_(1.0)
        elif p.dim() == 1:  # every other vector is a bias
            p.zero_()
        else:
            fan_in = p.shape[1] if leaf in ("embed", "pos_embed") else p.shape[0]
            w = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            p.copy_(w.mul_(fan_in**-0.5))


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.dtype, device))

    def qkv(self, h, cfg: OPTConfig):
        B, T = h.shape[:2]
        shape = (B, T, cfg.num_heads, cfg.head_dim)
        return (
            (h @ self.wq + self.bq).reshape(shape),
            (h @ self.wk + self.bk).reshape(shape),
            (h @ self.wv + self.bv).reshape(shape),
        )

    def mlp(self, x, cfg: OPTConfig):
        h = layer_norm(x, self.mlp_norm_w, self.mlp_norm_b, cfg.layer_norm_eps)
        return x + F.relu(h @ self.fc1 + self.fc1_b) @ self.fc2 + self.fc2_b


class OPTForCausalLM(nn.Module):
    """Decoder stack + tied head. Parameters are created empty on
    ``device``; engine/model_loader.py fills them."""

    def __init__(self, cfg: OPTConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed = _param((cfg.vocab_size, H), cfg.dtype, device)
        self.pos_embed = _param((cfg.max_model_len + POS_OFFSET, H), cfg.dtype, device)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm_w = _param((H,), cfg.dtype, device)
        self.final_norm_b = _param((H,), cfg.dtype, device)

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
    ) -> torch.Tensor:
        """One forward step (prefill chunk or decode) with paged KV; the
        arguments, the in-place pool updates and the result are those of
        ``LlamaForCausalLM.forward``, without ``kv_scales`` (no int8
        pools). Returns the float32 logits [B, V] of each row's last valid
        token."""
        if all_logits:
            raise NotImplementedError("all-position logits are not ported")
        cfg = self.cfg
        B, T = input_ids.shape
        step = PagedStep(cfg.attn_impl, positions, k_pages, v_pages, page_table, kv_lens, kv_burst)
        pos_ids = positions.clamp(min=0).long() + POS_OFFSET
        x = self.embed[input_ids.long()] + self.pos_embed[pos_ids]
        eps = cfg.layer_norm_eps
        for li, layer in enumerate(self.layers):
            h = layer_norm(x, layer.attn_norm_w, layer.attn_norm_b, eps)
            q, k, v = layer.qkv(h, cfg)
            attn = step.attend(li, q, k, v, None)
            x = x + attn.reshape(B, T, -1) @ layer.wo + layer.bo
            x = layer.mlp(x, cfg)
        step.finish()
        x = layer_norm(x, self.final_norm_w, self.final_norm_b, eps)
        last = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)
        x_last = x[torch.arange(B, device=x.device), last]
        return (x_last @ self.embed.t()).float()


CAUSAL_LM = OPTForCausalLM


def params_from_jax(np_tree: dict, cfg: OPTConfig) -> dict[str, torch.Tensor]:
    """The JAX package's OPT parameter tree (numpy leaves: ``embed``,
    ``pos_embed``, ``final_norm_w``/``_b`` and the layer-stacked
    ``layers``) as the port's parameter dict, every bit kept."""
    out = {k: tensor_from_numpy(np_tree[k]) for k in ("embed", "pos_embed", "final_norm_w", "final_norm_b")}
    return {**out, **unstack_layers(np_tree["layers"], cfg.num_layers)}
