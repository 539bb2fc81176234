"""Expert parallelism: the checks of an ep split, the experts a rank holds,
and the gather that joins an expert tensor back.

The counterpart of the ``moe_*`` rows of production_stack_tpu/parallel/
shardings.py: ``moe_gate`` and ``moe_up`` ``P("ep", None, "tp")``,
``moe_down`` ``P("ep", "tp", None)``. The split itself is parallel/tp.py's
(``shard_shape``, ``shard``, ``shard_params`` and ``init_sharded_`` take
the rank's (ep, e) place): rank (e, t) of an expert group holds experts
[e * E/ep, (e + 1) * E/ep), and of each the t-th I/tp slice. Everything
else is replicated along ep: the router, the attention, the norms and the
embeddings stay split over tp alone.

A MoE layer's output is each rank's sum over its experts and its slice of
I; one all-reduce over the expert group (the ep x tp ranks of its dp
replica) adds them, as the JAX einsum over a sharded E and I is one psum
over (ep, tp). A dense model has no expert axis: its ep ranks replicate
the whole computation ("dense models ignore it", as the JAX engine's
config says).
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.parallel import tp as tpmod


def check_ep(cfg, ep: int) -> None:
    """Refuse, by name, an ep that does not split the model's experts."""
    if ep < 1:
        raise ValueError(f"expert_parallel_size must be >= 1, got {ep}")
    E = getattr(cfg, "num_experts", 0)
    if ep > 1 and E and E % ep:
        raise ValueError(f"expert_parallel_size {ep} does not divide num_experts {E} of the MoE model")


def expert_range(num_experts: int, ep: int, e: int) -> range:
    """The experts ep rank ``e`` holds."""
    n = num_experts // ep
    return range(e * n, (e + 1) * n)


def gather_param(t: torch.Tensor, name: str, ranks, kv_heads=None) -> torch.Tensor:
    """The whole parameter ``name`` from every rank's part of it, bit for
    bit, given the rank's ``TPGroup`` (None: one rank). An expert tensor is
    joined over the expert group: a zero-filled whole tensor that each rank
    fills at its (experts, I slice) block, summed as int32 words (one value
    and zeros, exact); any other over the tp group (tp.gather_param, with
    the model's ``kv_heads`` for a tp that shares them)."""
    if ranks is None:
        return t
    experts = ranks.expert
    ax = tpmod.expert_axis(name)
    if ax is None or experts.ep_size == 1:
        return tpmod.gather_param(t, name, ranks if ranks.size > 1 else None, kv_heads)
    ep, tp = experts.ep_size, ranks.size
    full = torch.zeros(tpmod.full_shape(name, t.shape, tp, ep), dtype=t.dtype, device=t.device)
    block = full.narrow(ax, experts.ep_rank * t.shape[ax], t.shape[ax])
    tax = tpmod.split_axis(name)
    if tp > 1:
        block = block.narrow(tax, ranks.rank * t.shape[tax], t.shape[tax])
    block.copy_(t)
    experts.all_reduce(full.view(torch.int32))
    return full
