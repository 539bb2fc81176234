"""Llama family (Llama 2/3/3.x, Mistral, Qwen2/2.5 dense, Mixtral MoE) in
PyTorch.

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

``num_experts > 0`` (Mixtral) swaps the MLP for the sparse-MoE block, routed
top-k and computed densely over every expert, as the JAX package computes
it. ``tape_routes`` records the experts each router picks, or makes a
second forward take the experts a first one picked (``RouteTape``), so
that two forwards which differ only by rounding can be compared token for
token. ``lora``/``lora_ids`` add batched multi-LoRA: each row's adapter slot
adds ``(h @ A) @ B * scale`` to every projection with a buffer
(``init_lora_buffers``). ``encode`` is the pooled-embedding forward behind
the server's embedding, rerank and score routes (dense causal attention, no
pages). ``all_logits=True`` returns every position's logits (speculative
decode's verify). The "pre" write mode is not ported; the model raises on
it.

With ``tp`` (a parallel/group.TPGroup) the model is one tensor-parallel
rank's: it holds its slice of each split weight (parallel/tp.py: NH/tp and
KH/tp heads, or one KV head shared by tp/KH ranks where tp is a multiple of
KH, I/tp of the MLP and of each expert's FFN, V/tp of the vocabulary), all-reduces after ``wo`` and ``w_down``, looks tokens up in
its vocab rows and gathers the logits, so every rank returns the whole
[B, V]. With ``experts`` (the rank's ``TPGroup.expert``: the ep x tp ranks
of its dp replica) a MoE model is one expert-parallel rank's too: it holds
E/ep experts (parallel/tp.py splits them, parallel/ep.py), routes every token over all E with the
replicated router, weighs its own experts' products by their columns of
the dense gate, and one all-reduce over the expert group sums the layer's
output. The LoRA slot buffers are the rank's too (``init_lora_buffers``
with ``tp``; parallel/tp.py splits them like their projections): a
column-parallel target's delta lands on the rank's own columns, and a
row-parallel one's partial delta is summed by the all-reduce after ``wo``
or ``w_down`` with the base product, so adapters add no collective.

With ``stage`` (the rank's ``TPGroup.stage``: the pp ranks of its (ep, tp)
place) the model is one pipeline stage's (parallel/pipeline.py): it builds
only its L/pp contiguous layers, named from 0 (a MoE model's experts of
them split over the stage's expert group), and holds the embedding,
the final norm and the head whole, as the JAX specs replicate them over
pp. Its forward runs the batch in ``microbatches(B, pp)`` microbatches:
stage 0 embeds, each stage runs its layers on a microbatch's rows over its
own pools [L/pp, P, page, KH/tp, D] and LoRA buffers (``layer`` the
local index; a microbatch's rows take their own adapter slots) and relays
it on; the last stage's final hidden states of what the head reads reach
every stage, where the head runs as at pp 1.

With ``seq`` (the rank's ``TPGroup.seq``: the sp ranks of its (ep, tp)
place) the model is one sequence-parallel rank's, as the JAX forward shards a chunk's
tokens over ``sp``: the weights and the pools are whole along sp
(replicated, the JAX ``KV_PAGES_SPEC`` shards tp only). A prefill chunk
(T > 1) pads to a multiple of sp (pads at position -1) and the rank runs
the embedding, the norms, the projections (with their LoRA deltas: the
rows are whole, so each keeps its slot) and the MLP on its T/sp tokens (a
MoE layer's routed there and summed over the expert group of the rank's
sequence place);
every layer's attention is models/paged_step.py's sp step (the chunk's K/V
gathered over the group, the rank's queries through
parallel/ring_attention.ring_attention_serving, or with a sliding window
``ops.attention.flash_attention`` with explicit positions, as the JAX
forward falls back). The prefill kernel does not run, as the JAX forward
keeps its kernel for one device (``prefill_kernel_ok`` needs sp = 1):
after the layers each rank writes the whole chunk's K/V into its own pools,
and each row's last valid hidden state is gathered from the rank that
holds it (every position's with ``all_logits``, a verify forward's), so
every rank returns the whole [B, V] ([B, T, V]). A decode step (T = 1) and
a burst are not split: every sequence rank runs them whole, the decode
kernel included. With both ``stage`` and ``seq`` (pp x sp) a chunk's
microbatches go through the stages as under pp, each stage's sequence rank
s relaying its token slice to the next stage's rank s and the last stage
gathering over its sequence group what the head reads. ``MESH_AXES`` names the
mesh axes the family serves, as the JAX module's does.
"""

from __future__ import annotations

import contextlib
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
from production_stack_tpu_torch.parallel import pipeline
from production_stack_tpu_torch.parallel.ep import expert_range
from production_stack_tpu_torch.parallel.ring_attention import pad_tokens, token_slice
from production_stack_tpu_torch.parallel.tp import (
    all_reduce_,
    embed_lookup,
    expert_place,
    gather_vocab,
    init_sharded_,
    kv_heads_per_rank,
    shard_shape,
    split_axis,
    split_parts,
)
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
    num_experts: int = 0                  # Mixtral: > 0 switches the MLP to sparse MoE
    num_experts_per_tok: int = 2
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
        MistralForCausalLM, Qwen2ForCausalLM, MixtralForCausalLM; the arch
        from ``architectures[0]``), as the JAX package's does."""
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
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )
        _check_ported(out)
        return out


# the mesh axes this family's forward serves (the JAX module's)
MESH_AXES = ("dp", "tp", "sp", "ep", "pp")

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
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, rope_theta=1000000.0, num_experts=8, num_experts_per_tok=2, max_model_len=32768,
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
PRESETS["mixtral-debug"] = dataclasses.replace(_debug, num_experts=4, num_experts_per_tok=2)

# per-layer weight names and their [in, out] (or [n]) shapes; a MoE layer's
# experts stack on a leading [E] axis
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
    }
    if cfg.attention_bias:
        shapes.update({"bq": (NH * D,), "bk": (KH * D,), "bv": (KH * D,)})
    E = cfg.num_experts
    if E:
        shapes.update({"moe_router": (H, E), "moe_gate": (E, H, I), "moe_up": (E, H, I), "moe_down": (E, I, H)})
    else:
        shapes.update({"w_gate": (H, I), "w_up": (H, I), "w_down": (I, H)})
    return shapes


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.kv_write_mode != "post":
        raise NotImplementedError("only kv_write_mode='post' is ported")
    if cfg.kv_cache_dtype not in ("auto", "int8"):
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported (auto, int8)")


def init_kv_pages(
    cfg: LlamaConfig, num_pages: int, page_size: int, device, dtype=None, tp: int = 1, pp: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-stacked page pools: [L/pp, num_pages, page_size, KH/tp, D]
    zeros (a stage's layers; one KV head where tp/KH ranks share each), in
    ``dtype``, else int8 for ``kv_cache_dtype="int8"``, else ``cfg.dtype``."""
    shape = (cfg.num_layers // pp, num_pages, page_size, kv_heads_per_rank(cfg.num_kv_heads, tp), cfg.head_dim)
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
    bits differ from ``jax.random``'s for the same seed. A tp or ep rank
    draws each whole tensor and keeps its part, so every (ep, tp) serves
    one model."""
    dev = model.final_norm.device

    def leaf_init(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            return torch.ones(shape, device=dev)
        if leaf in ("bq", "bk", "bv"):
            return torch.zeros(shape, device=dev)
        # weights are [in, out] ([E, in, out] for a MoE layer's experts:
        # the router and gate/up by H**-0.5, down by I**-0.5); embed [V, H]
        # scales by H**-0.5 too
        fan_in = shape[1] if leaf == "embed" else shape[-2]
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32).mul_(fan_in**-0.5)

    init_sharded_(model, leaf_init)


def lora_dims(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """(in_dim, out_dim) of each projection a LoRA adapter may target: the
    attention's four, and a dense model's MLP (a MoE layer's experts are no
    target, as in the JAX package)."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    dims = {
        "wq": (H, cfg.num_heads * cfg.head_dim),
        "wk": (H, cfg.num_kv_heads * cfg.head_dim),
        "wv": (H, cfg.num_kv_heads * cfg.head_dim),
        "wo": (cfg.num_heads * cfg.head_dim, H),
    }
    if not cfg.num_experts:
        dims.update({"w_gate": (H, I), "w_up": (H, I), "w_down": (I, H)})
    return dims


def init_lora_buffers(
    cfg: LlamaConfig, max_loras: int, max_rank: int, targets=("wq", "wk", "wv", "wo"), device="cpu",
    tp: int = 1, pp: int = 1,
) -> dict:
    """Slot-stacked LoRA buffers for batched multi-adapter serving, zeros:
    ``{"layers": [per layer {"a_<t>": [S, in, R], "b_<t>": [S, R, out]}],
    "scale": [S] f32}`` in the model's dtype, S = ``max_loras`` slots (the
    caller counts slot 0, the base model, which stays all zero). ``scale``
    is each slot's ``alpha / r``. A tp rank's buffers hold its part of each
    split one (parallel/tp.split_axis: ``b`` of a column-parallel target
    out/tp wide, ``a`` of a row-parallel one in/tp; ``b_wk``/``b_wv`` at
    shared KV heads the shared head's columns), a pipeline stage's its
    L/pp layers."""
    dims = lora_dims(cfg)
    unknown = set(targets) - set(dims)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}; known: {sorted(dims)}")
    S, R = max_loras, max_rank
    shapes = {}
    for t in targets:
        din, dout = dims[t]
        shapes["a_" + t] = shard_shape("layers.0.a_" + t, (S, din, R), tp)
        shapes["b_" + t] = shard_shape("layers.0.b_" + t, (S, R, dout), tp, kv_heads=cfg.num_kv_heads)
    layers = [{name: torch.zeros(shape, dtype=cfg.dtype, device=device) for name, shape in shapes.items()}
              for _ in range(cfg.num_layers // pp)]
    return {"layers": layers, "scale": torch.zeros((S,), dtype=torch.float32, device=device)}


class LoraStep:
    """One forward's view of the LoRA buffers: each row's slot (``ids``
    [B]) and its scale in the model's dtype, as the JAX forward casts it."""

    def __init__(self, lora: dict, ids: torch.Tensor, dtype):
        self.ids = ids.long()
        self.scale = lora["scale"][self.ids].to(dtype)


class RouteTape:
    """The experts each MoE layer's router takes ([B, T, k]), one entry per
    layer and call, in the order the forward runs them (``picks``). Given
    ``replay`` (another run's ``picks``, a list that may grow between
    calls), each router takes the experts recorded there, weighted by its
    own probabilities, and ``overridden``
    counts the (layer, token) pairs where its own top-k would have been
    another set: where two experts all but tie, two forwards that differ
    only by rounding would otherwise route a token apart and move its
    logits by O(1)."""

    def __init__(self, replay=None):
        self.picks = []
        self.replay = replay
        self.overridden = 0


@contextlib.contextmanager
def tape_routes(model, replay=None):
    """Within the block every router of ``model`` records into (or, with
    ``replay``, replays from) one ``RouteTape``, which the block yields."""
    tape = RouteTape(replay)
    for layer in model.layers:
        layer.route_tape = tape
    try:
        yield tape
    finally:
        for layer in model.layers:
            layer.route_tape = None


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, tp=None, experts=None):
        super().__init__()
        n = 1 if tp is None else tp.size
        m, e = expert_place(experts)
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _param(shard_shape("layers." + name, shape, n, m, cfg.num_kv_heads), cfg.dtype,
                                       device))
        self.tp = tp
        # a MoE layer's output sums over the expert group (ep x tp ranks;
        # without one, over tp); its experts are [first_expert,
        # first_expert + E/ep)
        self.moe_group = experts if experts is not None else tp
        self.first_expert = expert_range(cfg.num_experts, m, e).start
        self.route_tape: Optional[RouteTape] = None

    def proj(self, h, name: str, lora: Optional[dict] = None, step: Optional[LoraStep] = None):
        """``h @ W`` plus, for a projection with a LoRA buffer, each row's
        ``((h @ A[slot]) @ B[slot]) * scale[slot]`` (``lora``: this layer's
        buffers). Slot 0 adds exact zeros."""
        y = h @ getattr(self, name)
        if lora is not None and "a_" + name in lora:
            a = lora["a_" + name][step.ids]  # [B, in, R]
            b = lora["b_" + name][step.ids]  # [B, R, out]
            y = y + torch.einsum("btr,bro->bto", torch.einsum("bti,bir->btr", h, a), b) * step.scale[:, None, None]
        return y

    def qkv(self, h, cfg: LlamaConfig, cos, sin, lora=None, step=None):
        B, T = h.shape[:2]
        q, k, v = (self.proj(h, n, lora, step) for n in ("wq", "wk", "wv"))
        if cfg.attention_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        # the rank's heads: NH/tp and KH/tp (all of them at tp = 1; one
        # shared KV head where tp is a multiple of KH)
        q, k, v = (x.reshape(B, T, -1, cfg.head_dim) for x in (q, k, v))
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def mlp(self, x, cfg: LlamaConfig, lora=None, step=None):
        h = rms_norm(x, self.mlp_norm, cfg.rms_norm_eps)
        if cfg.num_experts:
            return x + self.moe(h, cfg)
        gate = F.silu(self.proj(h, "w_gate", lora, step)) * self.proj(h, "w_up", lora, step)
        return x + all_reduce_(self.proj(gate, "w_down", lora, step), self.tp)

    def route(self, h, cfg: LlamaConfig):
        """The router's top-k: f32 softmax over the experts of ``h @
        moe_router``, and the k largest probabilities with their experts
        ([B, T, k] each). Equal probabilities (router logits round to the
        model's dtype, so they tie) rank the lower expert first, as
        ``lax.top_k`` does: a stable descending sort. A ``route_tape``
        records the experts, or replays another run's."""
        probs = torch.softmax((h @ self.moe_router).float(), dim=-1)  # [B, T, E]
        topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topw, topi = topw[..., : cfg.num_experts_per_tok], topi[..., : cfg.num_experts_per_tok]
        tape = self.route_tape
        if tape is not None and tape.replay is not None:
            own = topi
            topi = torch.as_tensor(tape.replay[len(tape.picks)], dtype=torch.long, device=probs.device)
            topw = probs.gather(-1, topi)
            tape.overridden += int((own.sort(-1).values != topi.sort(-1).values).any(-1).sum())
        if tape is not None:
            tape.picks.append(topi)
        return probs, topw, topi

    def moe(self, h, cfg: LlamaConfig):
        """Mixtral's sparse-MoE MLP, computed densely over the experts as the
        JAX package's ``_moe_block`` computes it: the router's top-k
        (``route``), the top-k weights renormalized and scattered into a
        dense [B, T, E] gate that is cast to the model's dtype before the
        product; every expert's ``silu(h @ gate_e) * (h @ up_e) * gate[e]``;
        and one contraction over experts and I together. The expert products
        are batched over E ([E, BT, H] @ [E, H, I]), so no weight is
        copied.

        An ep x tp rank holds E/ep experts and I/tp of each: it routes over
        all E (the router is replicated), takes its experts' columns of the
        gate, contracts over its experts and its I, and the all-reduce over
        the expert group adds the ranks' partial sums."""
        B, T, H = h.shape
        E = cfg.num_experts
        probs, topw, topi = self.route(h, cfg)
        topw = topw / topw.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        gate = torch.zeros_like(probs).scatter_(-1, topi, topw).to(h.dtype)
        El = self.moe_gate.shape[0]  # this rank's experts (E at ep = 1)
        gate = gate.reshape(B * T, E)[:, self.first_expert: self.first_expert + El]
        hx = h.reshape(1, B * T, H)
        g = torch.matmul(hx, self.moe_gate)  # [El, BT, I/tp]
        u = torch.matmul(hx, self.moe_up)
        y = F.silu(g) * u * gate.t()[:, :, None]
        I = y.shape[-1]
        out = (y.transpose(0, 1).reshape(B * T, El * I) @ self.moe_down.reshape(El * I, H)).reshape(B, T, H)
        return all_reduce_(out, self.moe_group)


class LlamaForCausalLM(nn.Module):
    """Decoder stack + head. Parameters are created empty on ``device``;
    engine/model_loader.py fills them (seeded init or a carried-over tree)."""

    def __init__(self, cfg: LlamaConfig, device="cuda", tp=None, experts=None, stage=None, seq=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.tp = tp
        # seq: the sp ranks of this rank's tp place (None: a chunk's every
        # token here)
        self.seq = seq if seq is not None and seq.size > 1 else None
        # experts: the expert group of a MoE model split over ranks (the
        # ep x tp ranks of its dp replica; None: one rank); a dense model
        # has none
        self.experts = experts if cfg.num_experts else None
        # stage: the pp ranks of this rank's tp place (None: every layer here)
        self.stage = stage if stage is not None and stage.size > 1 else None
        pp, p = pipeline.stage_place(self.stage)
        n = 1 if tp is None else tp.size
        H = cfg.hidden_size
        self.embed = _param(shard_shape("embed", (cfg.vocab_size, H), n), cfg.dtype, device)
        n_layers = len(pipeline.stage_range(cfg.num_layers, pp, p))
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, device, tp, self.experts) for _ in range(n_layers))
        self.final_norm = _param((H,), cfg.dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param(shard_shape("lm_head", (H, cfg.vocab_size), n), cfg.dtype, device)

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
        lora: Optional[dict] = None,
        lora_ids: Optional[torch.Tensor] = None,
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
        With ``lora`` (``init_lora_buffers``) and ``lora_ids`` [B] int32,
        row b adds the deltas of adapter slot ``lora_ids[b]`` (0 = none).

        Returns the float32 logits [B, V] of each row's last valid token, or
        with ``all_logits`` [B, T, V] of every position (speculative verify:
        T is 1 + the draft length).

        With tp the pools and the LoRA buffers are the rank's
        (``init_lora_buffers`` with ``tp``).

        On a pipeline stage (``stage``) the pools and the LoRA buffers are
        the stage's and the step runs in microbatches
        (parallel/pipeline.run), each with its rows' adapter slots; every
        stage returns the whole logits. ``kv_burst`` is not taken there:
        each T == 1 step commits its own K/V, as the JAX runner's
        ``_multi_step_fn`` does under pp.

        On a sequence rank (``seq``) a chunk (T > 1: a prefill chunk or a
        verify forward's 1 + k) runs its T/sp tokens through the ring
        (``_chunk_sp``), on a pipeline stage too, every row with its
        adapter slot, and every rank returns the whole logits; it takes no
        int8 pools. T = 1 runs whole on every sequence rank.
        """
        cfg = self.cfg
        B, T = input_ids.shape
        if self.seq is not None and T > 1:
            if kv_scales is not None:
                raise ValueError("a sequence-parallel chunk takes no int8 pools")
            return self._chunk_sp(input_ids, positions, k_pages, v_pages, page_table, kv_lens, all_logits, lora,
                                  lora_ids)
        tp = 1 if self.tp is None else self.tp.size
        cos, sin = rope_cos_sin(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        last = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)
        if self.stage is not None:
            if kv_burst is not None:
                raise ValueError("a pipeline stage takes no kv_burst")

            def body(x, r):
                step = PagedStep(cfg.attn_impl, positions[r], k_pages, v_pages, page_table[r], kv_lens[r],
                                 kv_scales=kv_scales, tp=tp)
                x = self._decoder(x, step, cos[r], sin[r], lora, None if lora is None else lora_ids[r])
                step.finish()
                return x

            def keep(y, r):
                return y if all_logits else y[torch.arange(y.shape[0], device=y.device), last[r]]

            out = torch.empty((B, T, cfg.hidden_size) if all_logits else (B, cfg.hidden_size), dtype=cfg.dtype,
                              device=self.final_norm.device)
            x = pipeline.run(self.stage, B, lambda r: embed_lookup(self.embed, input_ids[r], self.tp), body, keep,
                             out, ((T, cfg.hidden_size), cfg.dtype))
            x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
            return gather_vocab((x @ self._head()).float(), self.tp)
        step = PagedStep(cfg.attn_impl, positions, k_pages, v_pages, page_table, kv_lens, kv_burst, kv_scales, tp=tp)
        x = embed_lookup(self.embed, input_ids, self.tp)
        x = self._decoder(x, step, cos, sin, lora, lora_ids)
        step.finish()
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        if all_logits:
            return gather_vocab((x @ self._head()).float(), self.tp)
        x_last = x[torch.arange(B, device=x.device), last]
        return gather_vocab((x_last @ self._head()).float(), self.tp)

    def _head(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_word_embeddings else self.lm_head

    def _chunk_sp(self, input_ids, positions, k_pages, v_pages, page_table, kv_lens, all_logits=False, lora=None,
                  lora_ids=None) -> torch.Tensor:
        """A chunk on this sequence rank (the JAX forward at sp with T > 1):
        the chunk padded to a multiple of sp (pads at position -1), the
        rank's T/sp tokens through the layers with their attention through
        the ring (models/paged_step.py) and each row's LoRA deltas, the
        whole chunk's K/V committed into this rank's pools after the layers
        (``finish``). On a pipeline stage the layers are the stage's and
        the rows go through the stages in microbatches (parallel/pipeline.
        run), each stage relaying its T/sp token slice to the same sequence
        rank of the next, whose ring runs over its own sequence group; the
        last stage gathers what the head reads. Returns the whole [B, V]
        logits, or [B, T, V] with ``all_logits`` (every position's hidden
        state gathered over the group before the head)."""
        cfg, seq = self.cfg, self.seq
        B, T = input_ids.shape
        pos = pad_tokens(positions, seq.size, value=-1)
        pos_l = token_slice(pos, seq)
        Tl = pos_l.shape[1]
        cos, sin = rope_cos_sin(pos_l.clamp(min=0), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        tp = 1 if self.tp is None else self.tp.size
        ids_l = token_slice(pad_tokens(input_ids, seq.size), seq)
        last = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)

        def layers(x, r):
            step = PagedStep(cfg.attn_impl, pos[r], k_pages, v_pages, page_table[r], kv_lens[r], tp=tp, seq=seq)
            x = self._decoder(x, step, cos[r], sin[r], lora, None if lora is None else lora_ids[r])
            step.finish()
            return x

        def head_rows(x, r):
            """What the head reads of rows ``r`` ([n, Tl, H] here): every
            position, or each row's last valid token, which sits on rank
            last // Tl (every rank's candidate rows gathered, the owner's
            taken)."""
            if all_logits:
                return seq.all_gather(x, 1)[:, :T]
            rows = torch.arange(x.shape[0], device=x.device)
            mine = x[rows, (last[r] - seq.rank * Tl).clamp(0, Tl - 1)]
            return seq.all_gather(mine[:, None], 1)[rows, torch.div(last[r], Tl, rounding_mode="floor")]

        def embed(r):
            return embed_lookup(self.embed, ids_l[r], self.tp)

        if self.stage is None:
            x = head_rows(layers(embed(slice(None)), slice(None)), slice(None))
        else:
            out = torch.empty((B, T, cfg.hidden_size) if all_logits else (B, cfg.hidden_size), dtype=cfg.dtype,
                              device=self.final_norm.device)
            x = pipeline.run(self.stage, B, embed, layers, head_rows, out, ((Tl, cfg.hidden_size), cfg.dtype))
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return gather_vocab((x @ self._head()).float(), self.tp)

    def _decoder(self, x, step: PagedStep, cos, sin, lora=None, lora_ids=None) -> torch.Tensor:
        """This model's layers on ``x`` [B, T, H], their attention through
        ``step`` (whose ``layer`` is the index into this model's, or stage's,
        layers), each row with its adapter slot's deltas (``lora_ids``)."""
        cfg = self.cfg
        ls = None if lora is None else LoraStep(lora, lora_ids, cfg.dtype)
        B, T = x.shape[:2]
        for li, layer in enumerate(self.layers):
            ll = None if lora is None else lora["layers"][li]
            h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
            q, k, v = layer.qkv(h, cfg, cos, sin, ll, ls)
            attn = step.attend(li, q, k, v, cfg.sliding_window)
            x = x + all_reduce_(layer.proj(attn.reshape(B, T, -1), "wo", ll, ls), self.tp)
            x = layer.mlp(x, cfg, ll, ls)
        return x


CAUSAL_LM = LlamaForCausalLM

# encode's attention holds [rows, T, NH, T] f32 scores and a few temporaries
# of that size, and a MoE layer's MLP [rows, T, E, I] products; each takes
# as many rows a call as keep its largest product near this
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
    card. A MoE layer's MLP goes over row groups too: its dense expert
    products are [rows, T, E, I] (30 GB for one call at mixtral-8x7b's
    widths and the largest bucket). On a pipeline stage the batch goes
    through the stages as one microbatch and every stage pools the last
    stage's output."""
    cfg = model.cfg
    B, T = input_ids.shape
    rows = max(1, ENCODE_SCORE_BYTES // (T * T * cfg.num_heads * 4))
    itemsize = model.embed.element_size()
    mlp_rows = max(1, ENCODE_SCORE_BYTES // (T * cfg.num_experts * cfg.intermediate_size * itemsize)) \
        if cfg.num_experts else B
    cos, sin = rope_cos_sin(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    valid = positions >= 0
    kv_lens = valid.sum(dim=1).to(torch.int32)

    def layers(x, _rows):
        for layer in model.layers:
            h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
            q, k, v = layer.qkv(h, cfg, cos, sin)
            attn = torch.cat([
                flash_attention(q[i: i + rows], k[i: i + rows], v[i: i + rows], q_positions=positions[i: i + rows],
                                kv_lens=kv_lens[i: i + rows], window=cfg.sliding_window)
                for i in range(0, B, rows)
            ])
            x = x + all_reduce_(attn.reshape(B, T, -1) @ layer.wo, model.tp)
            x = torch.cat([layer.mlp(x[i: i + mlp_rows], cfg) for i in range(0, B, mlp_rows)])
        return x

    def embed(r):
        return embed_lookup(model.embed, input_ids[r], model.tp)

    if model.stage is not None:  # the whole batch as one microbatch through the stages
        out = torch.empty((B, T, cfg.hidden_size), dtype=cfg.dtype, device=model.final_norm.device)
        x = pipeline.run(model.stage, B, embed, layers, lambda y, r: y, out, ((T, cfg.hidden_size), cfg.dtype), M=1)
    else:
        x = layers(embed(slice(None)), None)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps).float()
    mask = valid.float()[..., None]
    pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def params_from_jax(np_tree: dict, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """The JAX package's llama parameter tree (numpy leaves) as the port's
    parameter dict (``LlamaForCausalLM.state_dict()`` names), on the CPU;
    a MoE layer's [L, E, ...] expert leaves split on L alone."""
    out = {"embed": tensor_from_numpy(np_tree["embed"]), "final_norm": tensor_from_numpy(np_tree["final_norm"])}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = tensor_from_numpy(np_tree["lm_head"])
    return {**out, **unstack_layers(np_tree["layers"], cfg.num_layers)}


def lora_from_jax(np_lora: dict, cfg: LlamaConfig) -> dict:
    """The JAX package's LoRA buffers (``init_lora_buffers`` there: layer
    leaves [L, S, ...] and ``scale`` [S], as numpy) as the port's, on the
    CPU, every bit kept."""
    per_layer = unstack_layers(np_lora["layers"], cfg.num_layers)
    layers = [
        {name: per_layer[f"layers.{i}.{name}"] for name in np_lora["layers"]}
        for i in range(cfg.num_layers)
    ]
    return {"layers": layers, "scale": tensor_from_numpy(np_lora["scale"])}


def join_lora(parts: list, tp: int = 1, kv_heads: Optional[int] = None) -> dict:
    """The whole LoRA buffers from every rank's (``init_lora_buffers``
    dicts of pp x tp ranks in stage-major order, ``parts[p * tp + t]``),
    every bit kept: each layer's split buffers joined over the stage's tp
    ranks on their ``split_axis`` (``b_wk``/``b_wv`` at shared KV heads,
    ``kv_heads`` the model's KH, over one rank of each share), the stages'
    layers one after another. The scales are every rank's."""
    layers = []
    for p in range(len(parts) // tp):
        stage = parts[p * tp:(p + 1) * tp]
        for li, own in enumerate(stage[0]["layers"]):
            layers.append({
                name: t if (ax := split_axis(f"layers.{li}.{name}")) is None
                else torch.cat([r["layers"][li][name] for r in stage[::tp // split_parts(name, tp, kv_heads)]],
                               dim=ax)
                for name, t in own.items()
            })
    return {"layers": layers, "scale": parts[0]["scale"]}
