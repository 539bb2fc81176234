"""Ring attention: exact attention over the sequence ranks, a prefill chunk's
queries split along its tokens and the KV blocks passed round the ring.

The port's own copy of production_stack_tpu/parallel/ring_attention.py, over
a parallel/group.SeqGroup instead of the ``sp`` mesh axis. Rank s holds
the queries of its slice of the tokens and, at first, KV block s; each of
the sp steps attends the local queries to the block it holds, accumulating
online-softmax partials in float32 (``_online_block``), then hands the
block to rank s + 1 and takes rank s - 1's (``SeqGroup.rotate``, the JAX
``ppermute``). The JAX scan rotates once more after its last step, a
rotation whose blocks nobody reads; the port leaves it out.

Visibility comes from explicit KV positions (``kv_positions``: a slot is
visible while its position is >= 0 and <= the query's; the positions
rotate with their block), which the serving path uses, or from offset mode
(``kv_lens``: block j holds positions [j * Sl, (j + 1) * Sl)). A slot that
is never visible is skipped, never multiplied by p = 0: its V is zeroed
before the product, as in ops/attention.flash_attention, since a stale pool
slot may hold any bytes.

The block math is plain torch, as the JAX package's is plain ``jnp`` outside
any Pallas kernel. A block's scores are [B, Tl, KH, G, Sl] float32, which at
a long chunk would be GBs: the local queries go through the ring in groups
of rows small enough that their scores stay near ``RING_SCORE_BYTES``.

Functions:

- ``ring_attention_local``: the per-rank body (the JAX function of that
  name inside its ``shard_map``).
- ``ring_attention_serving``: the serving path's call. The caller has split
  a chunk padded to a multiple of sp (``pad_tokens``: pads take position
  -1, as the JAX function pads T) and passes its rank's query rows; K, V and
  their positions are the whole [B, S, KH, D] every sequence rank holds
  (models/llama.py gathers the chunk's K/V over the group and reads the
  replicated pools), padded here to a multiple of sp and cut into the
  rank's block. Returns the rank's rows.
- ``ring_attention``: the convenience wrapper the JAX unit tests use: whole
  inputs on every rank, T and S multiples of sp, the whole output on every
  rank.
- ``check_sp``: the refusal that reads the model: the JAX runner's in its
  words (a family without "sp" in ``MESH_AXES``).
- ``seq_routes``: a one-rank run's MoE routes as a sequence rank's routers
  take them (a MoE layer runs on the rank's tokens of a chunk, as every
  other per-token layer does; the expert group of its (ep, tp) ranks sums
  it).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# the float32 scores (and the few temporaries of their size) of one group
# of query rows against one KV block stay near this
RING_SCORE_BYTES = 1 << 30


def check_sp(module, cfg, sp: int) -> None:
    """Refuse, by name, an sp the model cannot be served at: the JAX
    runner's refusal in its words (a family whose ``MESH_AXES`` lacks "sp":
    Gemma-2 and OPT)."""
    if sp < 1:
        raise ValueError(f"sequence_parallel_size must be >= 1, got {sp}")
    if sp == 1:
        return
    if "sp" not in getattr(module, "MESH_AXES", ("dp", "tp")):
        raise ValueError(
            f"model family {module.__name__.rsplit('.', 1)[-1]!r} does not support sequence/pipeline parallelism"
        )


def pad_tokens(x: torch.Tensor, n: int, dim: int = 1, value=0) -> torch.Tensor:
    """``x`` padded with ``value`` along ``dim`` to a multiple of ``n``."""
    pad = (-x.shape[dim]) % n
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def token_slice(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Sequence rank s's contiguous 1/sp of ``x`` along ``dim`` (whose
    length sp divides); ``x`` itself without a group."""
    if group is None or group.size == 1:
        return x
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


def seq_routes(picks: list, group, k: int) -> list:
    """A one-rank run's MoE routes (``picks``: [B, T, k] per layer and
    forward) as sequence rank ``group.rank`` routes them: a chunk's (T > 1)
    padded to a multiple of sp, as the forward pads the chunk, and the
    rank's contiguous T/sp tokens taken; a pad token routes to experts 0 ..
    k - 1 (its output is never read). A decode step's (T = 1) runs whole on
    every rank. The picks themselves without a group."""
    if group is None or group.size == 1:
        return list(picks)
    out = []
    for p in picks:
        if p.shape[1] > 1:
            pad = (-p.shape[1]) % group.size
            if pad:
                fill = torch.arange(k, dtype=p.dtype, device=p.device).expand(p.shape[0], pad, k)
                p = torch.cat([p, fill], dim=1)
            p = token_slice(p, group)
        out.append(p)
    return out


def _online_block(qf, k, v, visible, m, l, acc):
    """One online-softmax accumulation step of qf against a KV block, as
    the JAX function's.

    qf [B, T, KH, G, D] f32 (pre-scaled); k, v [B, S, KH, D]; visible
    [B, T, S] bool; m, l [B, T, KH, G] f32 running max and denominator; acc
    [B, T, KH, G, D] f32 running numerator. Returns (m, l, acc)."""
    hidden = ~visible[:, :, None, None, :]
    scores = torch.einsum("btkgd,bskd->btkgs", qf, k.float()).masked_fill_(hidden, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
    p = scores.sub_(m_new[..., None]).exp_().masked_fill_(hidden, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    # a slot no query of the block sees is zeroed: p = 0 there, but 0 * NaN
    # would still poison the row
    seen = visible.any(dim=1)[:, :, None, None]
    vf = torch.where(seen, v.float(), torch.zeros((), device=v.device))
    acc_new = acc * alpha[..., None] + torch.einsum("btkgs,bskd->btkgd", p, vf)
    return m_new, l_new, acc_new


def _rows_per_group(B: int, Tl: int, NH: int, Sl: int) -> int:
    return max(1, min(Tl, RING_SCORE_BYTES // max(1, B * NH * Sl * 4)))


def ring_attention_local(
    group,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lens: Optional[torch.Tensor],
    kv_positions: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One sequence rank's ring (the JAX function's per-shard body).

    q [B, Tl, NH, D] the rank's queries; k, v [B, Sl, KH, D] its KV block
    (block ``group.rank``, global offset rank * Sl); q_positions [B, Tl]
    global positions (-1: padding); ``kv_lens`` [B] the valid KV length
    (offset mode) or ``kv_positions`` [B, Sl] the block's explicit
    positions (-1: invalid; they rotate with the block and ``kv_lens`` is
    not read). ``group`` None runs one block: plain attention. Returns
    [B, Tl, NH, D] in q's dtype."""
    B, Tl, NH, D = q.shape
    Sl, KH = k.shape[1], k.shape[2]
    G = NH // KH
    scale = sm_scale if sm_scale is not None else D**-0.5
    sp = 1 if group is None else group.size
    me = 0 if group is None else group.rank
    dev = q.device
    qf = (q.float() * scale).reshape(B, Tl, KH, G, D)
    m = torch.full((B, Tl, KH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Tl, KH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tl, KH, G, D), dtype=torch.float32, device=dev)
    rows = _rows_per_group(B, Tl, NH, Sl)
    qp = q_positions[:, :, None]
    kvp = kv_positions
    for step in range(sp):
        if kvp is not None:
            visible = (kvp[:, None, :] <= qp) & (kvp[:, None, :] >= 0)
        else:
            src = (me - step) % sp  # whose block this is
            idx = src * Sl + torch.arange(Sl, device=dev)
            visible = (idx[None, None, :] <= qp) & (idx[None, None, :] < kv_lens[:, None, None])
        for r in range(0, Tl, rows):
            sl = slice(r, r + rows)
            m[:, sl], l[:, sl], acc[:, sl] = _online_block(qf[:, sl], k, v, visible[:, sl], m[:, sl], l[:, sl],
                                                           acc[:, sl])
        if step < sp - 1:  # the block after the last step would go unread
            if kvp is not None:
                k, v, kvp = group.rotate(k, v, kvp)
            else:
                k, v = group.rotate(k, v)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, Tl, NH, D).to(q.dtype)


def ring_attention_serving(
    group,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """A prefill chunk's attention over the sequence ranks, inside the
    serving step.

    q [B, Tl, NH, D] and q_positions [B, Tl]: the rank's rows of the chunk
    padded to a multiple of sp (``pad_tokens``, pads at position -1, then
    ``token_slice``); k, v [B, S, KH, D] and kv_positions [B, S] (-1:
    invalid): the whole gathered pool slots and chunk K/V, the same on
    every sequence rank. S pads to a multiple of sp (pads at position -1)
    and the rank takes its block of S/sp slots, as the JAX function shards
    S over sp. Visibility comes from the positions alone. Returns the
    rank's [B, Tl, NH, D]. A verify forward of speculative decoding is a
    chunk of 1 + k tokens, padded the same way (Tl = 3 at sp 2, k = 4),
    whose pool slots from the row's current position on are stale drafts
    (``stale_kv_positions`` hides them)."""
    sp = 1 if group is None else group.size
    k, v = pad_tokens(k, sp), pad_tokens(v, sp)
    kv_positions = pad_tokens(kv_positions, sp, value=-1)
    return ring_attention_local(
        group, q, token_slice(k, group), token_slice(v, group), q_positions, None,
        token_slice(kv_positions, group).contiguous(), sm_scale=sm_scale,
    )


def ring_attention(
    group,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The convenience wrapper: whole q [B, T, NH, D], k, v [B, S, KH, D],
    q_positions [B, T] and kv_lens [B] on every rank (T and S multiples of
    sp); each rank runs the ring on its T/sp queries and its S/sp block in
    offset mode, and every rank returns the whole [B, T, NH, D]."""
    sp = 1 if group is None else group.size
    if q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError(f"ring_attention needs T ({q.shape[1]}) and S ({k.shape[1]}) divisible by sp = {sp}")
    out = ring_attention_local(
        group, token_slice(q, group), token_slice(k, group).contiguous(), token_slice(v, group).contiguous(),
        token_slice(q_positions, group), kv_lens, sm_scale=sm_scale,
    )
    return out if sp == 1 else group.all_gather(out, 1)
