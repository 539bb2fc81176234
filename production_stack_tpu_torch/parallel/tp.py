"""How each weight splits over the tp ranks, and the collectives the
forward runs between them.

The counterpart of production_stack_tpu/parallel/shardings.py, with its
tables copied leaf for leaf (``_TOP_SPLIT``, ``_LAYER_SPLIT``): the axis of
each port tensor split over tp, or None where every rank holds it whole.
The port's per-layer tensors are the JAX layer-stacked leaves less their
leading [L] axis, so ``P(None, "tp")`` on ``[L, in, out]`` is axis 1 here.

- Column-parallel, split on the output axis: ``wq``/``wk``/``wv`` with
  their biases, ``w_gate``/``w_up``, ``fc1`` with ``fc1_b``. A rank holds
  NH/tp query heads, KH/tp KV heads (or one shared head: below) and I/tp
  of the MLP.
- Row-parallel, split on the input axis: ``wo``, ``w_down``, ``fc2``. Each
  rank's product is a partial sum; one ``all_reduce_`` adds them, and the
  bias (``bo``, ``fc2_b``) comes after it.
- Vocab-parallel: ``embed`` on its rows (``embed_lookup``: a masked lookup,
  then an all-reduce), ``lm_head`` on its columns; the head gives each rank
  its V/tp logits and ``gather_vocab`` gives every rank all of them.
- Replicated: norms, ``pos_embed``, the Gemma-2 sandwich norms, the MoE
  router.
- Each MoE expert's FFN (``moe_gate``/``moe_up`` on I, ``moe_down`` on its
  input I): one all-reduce over the expert group sums a MoE layer's
  output (parallel/ep.py).
- A MoE layer's experts (``_EXPERT_SPLIT``, axis 0 of the three expert
  tensors) split over ep as well: rank (e, t) of an expert group holds
  experts [e * E/ep, (e + 1) * E/ep), and of each the t-th I/tp slice, the
  JAX ``moe_*`` rows ``P("ep", None, "tp")`` and ``P("ep", "tp", None)``.
  ``shard_shape``, ``full_shape``, ``shard`` and ``shard_params`` take the
  (ep, e) place with ep = 1 by default.

Rank r's part of a split axis is its r-th contiguous slice. With ``group``
None (tp = 1) every function here is the identity, so the tp = 1 path runs
exactly the code it ran before.

Shared KV heads: where tp is a multiple of the model's KH (``kv_heads``;
Qwen2.5-1.5B's 2 KV heads at tp 4), the KV leaves (``wk``/``wv`` with their
biases, the LoRA ``b_wk``/``b_wv``) split into KH parts, not tp: rank t
holds KV head t // (tp / KH) whole, which its NH/tp query heads all read
(their group lies inside that head's), as vLLM replicates a KV head over
the ranks that share it. ``kv_parts`` gives the parts and each function
here that splits or joins takes ``kv_heads``; None (or a tp that divides
KH) is the plain split. The gathers join one replica per KV head (the
first rank of each share), so a gathered page or weight is the tp 1
engine's bytes. A tp that neither divides KH nor is a multiple of it is
refused (``check_tp``).

The layer axis splits over pp (parallel/pipeline.py, the JAX
``param_specs_for(pp=True)``: ``P("pp", ...)`` on every layer-stacked
leaf): stage p holds layers [p * L/pp, (p + 1) * L/pp), which it names
``layers.0`` ... ``layers.{L/pp - 1}``; the embedding, the final norm and
the head are every stage's. ``shard_params`` and ``init_sharded_`` take
the stage (``stage``, a parallel/group.StageGroup or None); a per-layer
tensor itself has no layer axis here, so ``shard_shape`` and ``shard`` are
the same at every stage.

Nothing splits over sp: every rank of a sequence group holds its tp
place's parameters whole (the JAX specs name no "sp" axis), seeded or read
as at sp = 1.

The LoRA slot buffers (models/llama.init_lora_buffers: per layer ``a_<t>``
[S, in, R] and ``b_<t>`` [S, R, out]) split like their projections, by the
same ``_LAYER_SPLIT`` rows (``split_axis`` of ``layers.{i}.a_<t>``): a
column-parallel target's ``b`` on its out axis, so the rank's delta lands
on its own heads or columns; a row-parallel target's (``wo``, ``w_down``)
``a`` on its in axis, so ``(h_r @ A_r) @ B`` is the rank's partial delta,
which the all-reduce after the projection sums with the base product. The
other factor is every rank's. They split over neither ep (no expert is a
target: attention is the same on every ep rank) nor sp, and over pp by
layer, as the weights.

The gathers (``gather_vocab``, ``gather_split``, ``gather_param``) are all-reduces over a
zero-filled full tensor that each rank fills at its own slice, summed as
int32 words: a sum of one value and zeros, exact to the bit, through the one
collective every backend takes for CUDA tensors (gloo's all-gather of CUDA
tensors is not relied on). They move tp times the bytes of an all-gather.
"""

from __future__ import annotations

from typing import Optional

import torch

_TOP_SPLIT = {
    "embed": 0,  # vocab rows
    "pos_embed": None,
    "final_norm": None,
    "final_norm_w": None,
    "final_norm_b": None,
    "lm_head": 1,  # vocab columns
}
_LAYER_SPLIT = {
    "attn_norm": None,
    "attn_norm_w": None,
    "attn_norm_b": None,
    "wq": 1,  # column parallel (+ bias on the out dim)
    "bq": 0,
    "wk": 1,
    "bk": 0,
    "wv": 1,
    "bv": 0,
    "wo": 0,  # row parallel (bias after the all-reduce)
    "bo": None,
    "mlp_norm": None,
    "mlp_norm_w": None,
    "mlp_norm_b": None,
    "post_attn_norm": None,  # Gemma-2 sandwich norms
    "post_mlp_norm": None,
    "w_gate": 1,
    "w_up": 1,
    "w_down": 0,
    "fc1": 1,
    "fc1_b": 0,
    "fc2": 0,
    "fc2_b": None,
    # MoE (Mixtral): each expert's FFN over tp ([E, in, out]); the experts'
    # axis splits over ep (parallel/ep.py)
    "moe_router": None,
    "moe_gate": 2,
    "moe_up": 2,
    "moe_down": 1,
}
# the experts' axis of each per-layer expert tensor ([E, in, out]), split
# over ep
_EXPERT_SPLIT = {"moe_gate": 0, "moe_up": 0, "moe_down": 0}
# the leaves that hold KV heads on their tp axis (a LoRA ``b_<t>`` of one of
# the two projections too): KH parts where tp/KH ranks share a head
_KV_LEAVES = ("wk", "wv", "bk", "bv", "b_wk", "b_wv")


def kv_parts(tp: int, kv_heads: Optional[int]) -> int:
    """The distinct slices of a KV leaf over ``tp`` ranks: tp where it
    divides the KV heads (or ``kv_heads`` is None), else KH, each shared
    by tp / KH ranks."""
    return tp if kv_heads is None or tp <= kv_heads else kv_heads


def kv_heads_per_rank(kv_heads: int, tp: int) -> int:
    """The KV heads one tp rank holds: KH/tp, or one shared head where tp
    is a multiple of KH."""
    return kv_heads // kv_parts(tp, kv_heads)


def split_parts(name: str, tp: int, kv_heads: Optional[int] = None) -> int:
    """The slices of ``name``'s tp axis: ``kv_parts`` for a KV leaf, tp for
    any other split one."""
    return kv_parts(tp, kv_heads) if name.rsplit(".", 1)[-1] in _KV_LEAVES else tp


def _lora_axis(leaf: str) -> Optional[int]:
    """The tp axis of LoRA buffer ``a_<t>`` ([S, in, R]) or ``b_<t>`` ([S,
    R, out]; any one leading axis, slots or layers), from its projection's
    row in ``_LAYER_SPLIT``: a column-parallel target splits ``b`` on its out
    axis in the weight's blocks, a row-parallel one ``a`` on its in axis;
    the other factor is every rank's."""
    kind, _, target = leaf.partition("_")
    ax = _LAYER_SPLIT[target]
    if kind not in ("a", "b") or ax not in (0, 1):
        raise KeyError(leaf)
    return {("a", 0): 1, ("b", 1): 2}.get((kind, ax))


def split_axis(name: str) -> Optional[int]:
    """The axis of parameter ``name`` (``embed``, ``layers.3.wq``) split over
    tp, or None for a replicated one; a LoRA buffer (``layers.3.a_wo``)
    splits as ``_lora_axis`` derives from its projection's rule."""
    leaf = name.rsplit(".", 1)[-1]
    try:
        if not name.startswith("layers."):
            return _TOP_SPLIT[name]
        return _LAYER_SPLIT[leaf] if leaf in _LAYER_SPLIT else _lora_axis(leaf)
    except KeyError:
        raise KeyError(f"parameter {name!r} has no tp split rule") from None


def expert_axis(name: str) -> Optional[int]:
    """The axis of parameter ``name`` split over ep, or None for one that
    every ep rank holds (all but a MoE layer's experts)."""
    if not name.startswith("layers."):
        return None
    return _EXPERT_SPLIT.get(name.rsplit(".", 1)[-1])


def _splits(name: str, tp: int, ep: int, kv_heads: Optional[int] = None) -> list[tuple[int, int, str]]:
    """(axis, parts, axis name) of each axis of ``name`` split in more than
    one part (a KV leaf's tp axis in ``kv_parts``)."""
    return [(ax, n, what) for ax, n, what in ((split_axis(name), split_parts(name, tp, kv_heads), "tp"),
                                             (expert_axis(name), ep, "ep"))
            if ax is not None and n > 1]


def shard_shape(name: str, shape, tp: int, ep: int = 1, kv_heads: Optional[int] = None) -> tuple[int, ...]:
    """A rank's shape of parameter ``name`` whose whole shape is ``shape``
    (``kv_heads``: the model's KH, for a tp that shares KV heads)."""
    shape = tuple(shape)
    for ax, n, what in _splits(name, tp, ep, kv_heads):
        if shape[ax] % n:
            raise ValueError(f"{name}: axis {ax} of {shape} does not split over {n} {what} ranks")
        shape = shape[:ax] + (shape[ax] // n,) + shape[ax + 1:]
    return shape


def full_shape(name: str, shape, tp: int, ep: int = 1, kv_heads: Optional[int] = None) -> tuple[int, ...]:
    """The whole shape of parameter ``name`` whose rank shape is ``shape``."""
    shape = tuple(shape)
    for ax, n, _ in _splits(name, tp, ep, kv_heads):
        shape = shape[:ax] + (shape[ax] * n,) + shape[ax + 1:]
    return shape


def shard(t: torch.Tensor, name: str, rank: int, tp: int, e: int = 0, ep: int = 1,
          kv_heads: Optional[int] = None) -> torch.Tensor:
    """Rank (e, ``rank``)'s part of the whole parameter ``t`` (a view): of a
    KV leaf at shared heads, the head rank // (tp / KH)."""
    part = shard_shape(name, t.shape, tp, ep, kv_heads)
    for ax, n, what in _splits(name, tp, ep, kv_heads):
        t = t.narrow(ax, (rank * n // tp if what == "tp" else e) * part[ax], part[ax])
    return t


def shard_params(params: dict[str, torch.Tensor], rank: int, tp: int, e: int = 0, ep: int = 1, stage=None,
                 kv_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """Rank (e, ``rank``) of (ep, ``tp``)'s parameter dict from a whole one
    (a ``params_from_jax`` dict, say), every bit kept; with ``stage`` (pp >
    1) only the stage's layers, under the stage's names."""
    from production_stack_tpu_torch.parallel.pipeline import local_name  # pipeline imports this module

    L = 1 + max((int(n.split(".")[1]) for n in params if n.startswith("layers.")), default=-1)
    out = {}
    for name, t in params.items():
        own = local_name(name, L, stage)
        if own is not None:
            out[own] = shard(t, name, rank, tp, e, ep, kv_heads).contiguous()
    return out


def check_tp(cfg, tp: int) -> None:
    """Refuse, by name, a model that does not split over ``tp`` ranks: tp
    must divide the KV heads or be a multiple of them (then tp/KH ranks
    share each), and divide the query heads (so each rank's lie in one KV
    head's group), the MLP (each expert's, for a MoE model) and the
    vocabulary."""
    if tp == 1:
        return
    KH = cfg.num_kv_heads
    if KH % tp and tp % KH:
        raise ValueError(
            f"tensor_parallel_size {tp} does not divide num_kv_heads {KH}; the JAX engine replicates the pool "
            "there, the port serves a tp that divides the KV heads or a multiple of them (each KV head then "
            "shared by tp / num_kv_heads ranks)"
        )
    for what, n in (("num_heads", cfg.num_heads), ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tensor_parallel_size {tp} does not divide {what} {n}")


def size_rank(group) -> tuple[int, int]:
    """(tp, rank) of ``group``; (1, 0) for None."""
    return (1, 0) if group is None else (group.size, group.rank)


def expert_place(experts) -> tuple[int, int]:
    """(ep, e) of an expert group (parallel/group.ExpertGroup: its
    ``ep_size`` and ``ep_rank``); (1, 0) for None."""
    return (1, 0) if experts is None else (experts.ep_size, experts.ep_rank)


def init_sharded_(model, init_leaf) -> None:
    """Seeded weights that make the same model at every (pp, ep, tp): for
    each parameter of the whole model, in the order of a one-stage
    ``model.named_parameters()`` (``model.tp`` is its tp group,
    ``experts`` and ``stage``, where it has them, its expert and stage
    groups; each None when not split), ``init_leaf(name, whole_shape)``
    gives the whole tensor, of which the rank keeps its part: a stage draws
    the other stages' layers too, and drops them. One whole tensor exists
    at a time."""
    from production_stack_tpu_torch.parallel.pipeline import local_name, stage_place  # pipeline imports this module

    n, r = size_rank(model.tp)
    m, e = expert_place(getattr(model, "experts", None))
    kh = model.cfg.num_kv_heads
    stage = getattr(model, "stage", None)
    own = dict(model.named_parameters())
    names = list(own)
    if stage_place(stage)[0] > 1:
        # the stage's layer block in named_parameters' order, widened to
        # every layer of the model
        layer = [nm for nm in names if nm.startswith("layers.")]
        leaves = [nm.split(".", 2)[2] for nm in layer if nm.startswith("layers.0.")]
        at = names.index(layer[0])
        rest = [nm for nm in names if not nm.startswith("layers.")]
        names = rest[:at] + [f"layers.{i}.{leaf}" for i in range(model.cfg.num_layers) for leaf in leaves] + rest[at:]
    for name in names:
        held = local_name(name, model.cfg.num_layers, stage)
        p = own[held] if held is not None else own["layers.0." + name.split(".", 2)[2]]
        whole = init_leaf(name, full_shape(name, p.shape, n, m, kh))
        if held is not None:
            p.copy_(shard(whole, name, r, n, e, m, kh))


# -- collectives (the identity at tp = 1) ---------------------------------------


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a row-parallel product's partial
    sums), in place and in x's dtype; ``x`` itself at tp = 1."""
    if group is not None:
        group.all_reduce(x)
    return x


def _exact_gather(local: torch.Tensor, dim: int, group, parts: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``local`` joined along ``dim``, bit for bit (module
    docstring); the last axis must hold a multiple of 4 bytes. With
    ``parts`` (< the group's size, dividing it) the ranks hold ``parts``
    slices, each shared by size / parts ranks in a row: the first rank of
    each share puts its slice in, the others zeros."""
    dim = dim % local.dim()
    n = local.shape[dim]
    parts = parts or group.size
    shape = list(local.shape)
    shape[dim] = n * parts
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    share = group.size // parts
    if group.rank % share == 0:
        full.narrow(dim, group.rank // share * n, n).copy_(local)
    group.all_reduce(full.view(torch.int32))
    return full


def gather_vocab(logits: torch.Tensor, group) -> torch.Tensor:
    """[B, V/tp] logits of each rank -> [B, V] on every rank, bit-equal on
    all of them."""
    if group is None:
        return logits
    return _exact_gather(logits.contiguous(), -1, group)


def gather_split(x: torch.Tensor, dim: int, group, parts: Optional[int] = None) -> torch.Tensor:
    """Each rank's slice along ``dim`` (the KV heads of pool pages or
    scales, a row of counters) -> the whole, bit for bit, on every rank;
    with ``parts`` (shared KV heads: ``kv_parts``) one replica of each
    shared slice."""
    if group is None:
        return x
    return _exact_gather(x.contiguous(), dim, group, parts)


def gather_param(t: torch.Tensor, name: str, group, kv_heads: Optional[int] = None) -> torch.Tensor:
    """The whole parameter ``name`` from every rank's part of it, bit for
    bit (a replicated one is the rank's own; a KV leaf at shared heads one
    replica of each head)."""
    ax = split_axis(name)
    if group is None or ax is None:
        return t
    return _exact_gather(t.contiguous(), ax, group, split_parts(name, group.size, kv_heads))


def rank_slice(x: torch.Tensor, dim: int, group, parts: Optional[int] = None) -> torch.Tensor:
    """This rank's slice along ``dim`` of a whole tensor (its KV heads of
    whole-head pages or scales; with ``parts`` < tp, its shared head's)."""
    if group is None:
        return x
    parts = parts or group.size
    n = x.shape[dim] // parts
    return x.narrow(dim, group.rank * parts // group.size * n, n)


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor, group) -> torch.Tensor:
    """Token embeddings [B, T, H] from a vocab-parallel table: each rank
    looks up the ids in its rows, zeros elsewhere, and the all-reduce adds
    them (one value and zeros: the whole table's lookup)."""
    if group is None:
        return embed[ids.long()]
    rows = embed.shape[0]
    local = ids.long() - group.rank * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], embed[local.clamp(0, rows - 1)], torch.zeros((), dtype=embed.dtype))
    return all_reduce_(x, group)


def broadcast_ids(ids: torch.Tensor, group) -> torch.Tensor:
    """The group's first rank's sampled ids on every rank of the group (the
    runner's expert group: the ep x tp ranks of its dp replica), so each
    rank feeds the same token into the next step whatever its own draw
    gave."""
    if group is None:
        return ids
    ids = ids.contiguous()
    group.broadcast(ids)
    return ids
