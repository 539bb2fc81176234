"""Llama family (Llama 2/3/3.x, Mistral, Qwen2/2.5 dense) in PyTorch.

The counterpart of production_stack_tpu/models/llama.py, on the serving path
the engine runs: paged KV in layer-stacked pools ``[L, P, page, KH, D]``,
``kv_write_mode="post"`` (attention reads the pool for earlier tokens and
the current chunk's K/V beside it), the fused prefill KV write, and the
deferred-burst decode (``kv_burst``). Weights keep the JAX layout ``x @ W``
with W ``[in, out]``, so parameters carry over one to one
(engine/model_loader.params_from_jax).

The attention of every layer goes through the kernels of ops/kernels/ when
``attn_impl == "cuda"`` and through their plain versions when it is
"plain" (models/paged_step.py, shared with models/gemma2.py and
models/opt.py). With ``kv_cache_dtype="int8"`` the pools hold int8 pages
and the forward takes their scales (``kv_scales``, ops/quant.py): attention reads
them through the kernels' int8 modes, a prefill chunk quantizes its K/V in
the fused write, and a T = 1 step commits through the quantizing scatter.
``encode`` is the pooled-embedding forward behind the server's embedding,
rerank and score routes (dense causal attention, no pages). Mixtral MoE,
LoRA, sp/pp meshes, the "pre" write mode and all-position logits are not
ported; the model raises on them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models.paged_step import PagedStep
from production_stack_tpu_torch.ops.attention import flash_attention
from production_stack_tpu_torch.ops.norms import rms_norm
from production_stack_tpu_torch.ops.rope import RopeScaling, apply_rope, rope_cos_sin
from production_stack_tpu_torch.utils.arrays import tensor_from_numpy, unstack_layers


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-5
    max_model_len: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False          # Qwen2: bias on q/k/v projections
    sliding_window: Optional[int] = None  # Mistral/Qwen2: windowed attention
    num_experts: int = 0                  # Mixtral MoE: not ported
    dtype: torch.dtype = torch.bfloat16
    # "auto" | "cuda" (the hand-written kernels) | "plain" (their PyTorch
    # versions); the runner resolves "auto" by device
    attn_impl: str = "auto"
    kv_write_mode: str = "post"           # "pre" is not ported
    # "auto" (pools in ``dtype``) | "int8" (int8 pages + per-page, per-KV-head
    # f32 scales, ops/quant.py)
    kv_cache_dtype: str = "auto"

    @staticmethod
    def from_hf_config(cfg: dict) -> "LlamaConfig":
        """Build from a HuggingFace ``config.json`` dict (LlamaForCausalLM,
        MistralForCausalLM, Qwen2ForCausalLM; the arch from
        ``architectures[0]``), as the JAX package's does. A Mixtral config
        (``num_local_experts``) is refused here, before any weight is read."""
        arch = (cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        scaling = None
        rs = cfg.get("rope_scaling") or None
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            scaling = RopeScaling(
                factor=rs.get("factor", 8.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position=rs.get("original_max_position_embeddings", 8192),
            )
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        # Qwen2 always biases q/k/v, and windows only with use_sliding_window
        window = cfg.get("sliding_window")
        if arch.startswith("Qwen2") and not cfg.get("use_sliding_window", False):
            window = None
        out = LlamaConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or hidden // heads,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=scaling,
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_model_len=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", arch.startswith("Qwen2")),
            sliding_window=window,
            num_experts=cfg.get("num_local_experts", 0) if arch.startswith("Mixtral") else 0,
        )
        _check_ported(out)
        return out


PRESETS: dict[str, LlamaConfig] = {
    "llama-3-8b": LlamaConfig(),
    "llama-3.2-1b": LlamaConfig(
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        rope_scaling=RopeScaling(factor=32.0),
        tie_word_embeddings=True,
    ),
    "mistral-7b": LlamaConfig(
        vocab_size=32000, rope_theta=10000.0, sliding_window=4096, max_model_len=32768,
    ),
    "qwen2.5-7b": LlamaConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
        max_model_len=32768,
    ),
    "llama-debug": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        rope_theta=10000.0,
        max_model_len=256,
    ),
}
_debug = PRESETS["llama-debug"]
PRESETS["qwen2-debug"] = dataclasses.replace(_debug, attention_bias=True)
PRESETS["llama-debug-4kv"] = dataclasses.replace(_debug, num_heads=8, num_kv_heads=4)
# f32 twin: greedy tokens on random (near-flat) logits are only
# reproducible across implementations in f32
PRESETS["llama-debug-4kv-f32"] = dataclasses.replace(
    _debug, num_heads=8, num_kv_heads=4, dtype=torch.float32
)
PRESETS["mistral-debug"] = dataclasses.replace(_debug, sliding_window=8)

# per-layer weight names and their [in, out] (or [n]) shapes
def layer_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    H, I = cfg.hidden_size, cfg.intermediate_size
    NH, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "attn_norm": (H,),
        "wq": (H, NH * D),
        "wk": (H, KH * D),
        "wv": (H, KH * D),
        "wo": (NH * D, H),
        "mlp_norm": (H,),
        "w_gate": (H, I),
        "w_up": (H, I),
        "w_down": (I, H),
    }
    if cfg.attention_bias:
        shapes.update({"bq": (NH * D,), "bk": (KH * D,), "bv": (KH * D,)})
    return shapes


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError("Mixtral MoE layers are not ported")
    if cfg.kv_write_mode != "post":
        raise NotImplementedError("only kv_write_mode='post' is ported")
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported (auto, int8)")


def init_kv_pages(
    cfg: LlamaConfig, num_pages: int, page_size: int, device, dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-stacked page pools: [L, num_pages, page_size, KH, D] zeros, in
    ``dtype``, else int8 for ``kv_cache_dtype="int8"``, else ``cfg.dtype``."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype or (torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.dtype)
    return (
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
    )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def init_params(model: "LlamaForCausalLM", generator: torch.Generator) -> None:
    """Random-normal weights with the JAX package's scales (init_params
    there), written in place: projections N(0, 1/fan_in), norms 1, biases
    0. The draw comes from ``generator`` (on the model's device), so its
    bits differ from ``jax.random``'s for the same seed."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        else:
            # weights are [in, out]; embed [V, H] scales by H**-0.5 too
            fan_in = p.shape[1] if leaf == "embed" else p.shape[0]
            w = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            p.copy_(w.mul_(fan_in**-0.5))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.dtype, device))

    def qkv(self, h, cfg: LlamaConfig, cos, sin):
        B, T = h.shape[:2]
        q, k, v = h @ self.wq, h @ self.wk, h @ self.wv
        if cfg.attention_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def mlp(self, x, cfg: LlamaConfig):
        h = rms_norm(x, self.mlp_norm, cfg.rms_norm_eps)
        return x + (F.silu(h @ self.w_gate) * (h @ self.w_up)) @ self.w_down


class LlamaForCausalLM(nn.Module):
    """Decoder stack + head. Parameters are created empty on ``device``;
    engine/model_loader.py fills them (seeded init or a carried-over tree)."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed = _param((cfg.vocab_size, H), cfg.dtype, device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = _param((H,), cfg.dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((H, cfg.vocab_size), cfg.dtype, device)

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
        """One forward step (prefill chunk or decode) with paged KV.

        input_ids/positions [B, T] int32 (position -1 = padding); pools
        [L, P, page, KH, D]; page_table [B, max_pages] int32; kv_lens [B]
        int32 including this step's tokens.

        Without ``kv_burst`` this step's K/V are committed to the pools IN
        PLACE: by the prefill kernel's fused write for T > 1, by one scatter
        after the layers for T == 1.
        With ``kv_scales = (k_scales, v_scales)`` ([L, P, KH] f32) the pools
        are int8: reads dequantize in the kernels, writes quantize and
        update the scales IN PLACE.
        With ``kv_burst = (k_acc, v_acc, counts)`` (decode, T = 1; windows
        [L, B, C, KH, D], counts [B]) the pools stay read-only: row b's
        token is appended to its window at slot counts[b], IN PLACE, and
        attention reads pool slots < kv_lens - (counts + 1) plus the window.
        The caller commits the windows once per burst.

        Returns the float32 logits [B, V] of each row's last valid token.
        """
        if all_logits:
            raise NotImplementedError("all-position logits are not ported")
        cfg = self.cfg
        B, T = input_ids.shape
        step = PagedStep(cfg.attn_impl, positions, k_pages, v_pages, page_table, kv_lens, kv_burst, kv_scales)
        x = self.embed[input_ids.long()]
        cos, sin = rope_cos_sin(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        for li, layer in enumerate(self.layers):
            h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
            q, k, v = layer.qkv(h, cfg, cos, sin)
            attn = step.attend(li, q, k, v, cfg.sliding_window)
            x = x + attn.reshape(B, T, -1) @ layer.wo
            x = layer.mlp(x, cfg)
        step.finish()
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        head = self.embed.t() if cfg.tie_word_embeddings else self.lm_head
        last = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)
        x_last = x[torch.arange(B, device=x.device), last]
        return (x_last @ head).float()


CAUSAL_LM = LlamaForCausalLM

# encode's attention holds [rows, T, NH, T] f32 scores and a few temporaries
# of that size; it takes as many rows a call as keep the scores near this
ENCODE_SCORE_BYTES = 1 << 30


@torch.no_grad()
def encode(model: LlamaForCausalLM, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Pooled-embedding forward, as the JAX package's ``encode``: one dense
    causal pass (no KV pages), a mean-pool over the valid tokens of the final
    normed hidden layer, L2-normalized.

    input_ids [B, T] int32; positions [B, T] (-1 = padding). Returns [B, H]
    float32 unit vectors. Attention is ``ops.attention.flash_attention``, the
    counterpart of the XLA attention the JAX encode uses (no Pallas kernel
    runs there, and no CUDA kernel here), over groups of rows small enough
    that the largest bucket (32 x 4,096 at llama-3.2-1b's widths) fits the
    card."""
    cfg = model.cfg
    B, T = input_ids.shape
    rows = max(1, ENCODE_SCORE_BYTES // (T * T * cfg.num_heads * 4))
    x = model.embed[input_ids.long()]
    cos, sin = rope_cos_sin(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    valid = positions >= 0
    kv_lens = valid.sum(dim=1).to(torch.int32)
    for layer in model.layers:
        h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
        q, k, v = layer.qkv(h, cfg, cos, sin)
        attn = torch.cat([
            flash_attention(q[i: i + rows], k[i: i + rows], v[i: i + rows], q_positions=positions[i: i + rows],
                            kv_lens=kv_lens[i: i + rows], window=cfg.sliding_window)
            for i in range(0, B, rows)
        ])
        x = x + attn.reshape(B, T, -1) @ layer.wo
        x = layer.mlp(x, cfg)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps).float()
    mask = valid.float()[..., None]
    pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def params_from_jax(np_tree: dict, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """The JAX package's llama parameter tree (numpy leaves) as the port's
    parameter dict (``LlamaForCausalLM.state_dict()`` names), on the CPU."""
    out = {"embed": tensor_from_numpy(np_tree["embed"]), "final_norm": tensor_from_numpy(np_tree["final_norm"])}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = tensor_from_numpy(np_tree["lm_head"])
    return {**out, **unstack_layers(np_tree["layers"], cfg.num_layers)}
