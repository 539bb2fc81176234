"""Token sampling — greedy / temperature / top-k / top-p with per-request
parameters, vectorised over the batch.

Greedy is an exact full-vocab argmax. Sampled rows draw from the top
``CANDIDATES`` logits only, with top-k / top-p applied inside that set (the
JAX engine's documented deviation from vLLM's full-vocab top-p; at typical
temperatures the truncated tail mass is far below 1e-4). The draw is the
exponential-race form of a categorical draw (argmax of p / E, E ~ Exp(1))
from the caller's ``torch.Generator``: it needs no host sync, and its bits
differ from ``jax.random``'s, so only distributions can be compared.
"""

from __future__ import annotations

import torch

CANDIDATES = 64
# OpenAI caps top_logprobs at 20
TOP_LOGPROBS = 20


def truncate_candidates(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The draw's candidate set: the top ``CANDIDATES`` logits scaled by
    1 / temperature, with ranks outside top-k and beyond the top-p mass set
    to -inf. Returns (scaled [B, n], candidate ids [B, n])."""
    n_cand = min(CANDIDATES, logits.shape[1])
    cand_logits, cand_ids = torch.topk(logits.float(), n_cand, dim=-1)
    scaled = cand_logits / temperature.clamp(min=1e-6)[:, None]
    rank = torch.arange(n_cand, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, n_cand, top_k.clamp(max=n_cand))[:, None]
    neg_inf = torch.full_like(scaled, float("-inf"))
    scaled = torch.where(rank < k, scaled, neg_inf)
    probs = torch.softmax(scaled, dim=-1)
    # keep tokens whose *preceding* cumulative mass is < top_p (rank 0 always)
    keep = (probs.cumsum(dim=-1) - probs) < top_p[:, None]
    return torch.where(keep, scaled, neg_inf), cand_ids


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    batch_rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Next token ids [B] int32 from logits [B, V]; temperature [B] (0 =>
    greedy row), top_k [B] (0 or >= CANDIDATES => off), top_p [B] (1 => off).

    ``batch_rows`` (first, total): these B rows are rows first .. first + B
    of a batch of ``total`` (a dp rank's share). The race noise is drawn for
    the whole batch and these rows' part taken, so every row gets the noise
    it gets when one process samples the whole batch, and no two dp ranks
    share theirs."""
    greedy_ids = logits.float().argmax(dim=-1).to(torch.int32)
    scaled, cand_ids = truncate_candidates(logits, temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    first, total = batch_rows if batch_rows is not None else (0, probs.shape[0])
    race = torch.empty((total, probs.shape[1]), dtype=probs.dtype, device=probs.device)
    race = race.exponential_(1.0, generator=generator)[first: first + probs.shape[0]]
    sampled_rank = (probs / race).argmax(dim=-1, keepdim=True)
    sampled_ids = torch.gather(cand_ids, 1, sampled_rank)[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_ids, sampled_ids)


def sample_with_logprobs(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    sample_from: torch.Tensor | None = None,
    batch_rows: tuple[int, int] | None = None,
):
    """``sample`` plus logprobs of the RAW distribution (log-softmax of the
    unscaled logits, independent of temperature/truncation/penalties);
    ``sample_from`` substitutes a penalty-adjusted distribution for the draw.

    Returns (ids [B] int32, chosen_logprob [B] f32,
             top_ids [B, TOP_LOGPROBS] int32, top_logprobs [B, TOP_LOGPROBS] f32).
    """
    ids = sample(
        logits if sample_from is None else sample_from,
        generator, temperature, top_k, top_p, batch_rows,
    )
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logprobs, 1, ids[:, None].long())[:, 0]
    top_lp, top_ids = torch.topk(logprobs, min(TOP_LOGPROBS, logits.shape[1]), dim=-1)
    return ids, chosen, top_ids.to(torch.int32), top_lp


def _counts(ids: torch.Tensor, mask: torch.Tensor, V: int) -> torch.Tensor:
    """Per-row token counts [B, V] of ``ids`` where ``mask``; masked slots go
    to a sentinel column V that is dropped."""
    B = ids.shape[0]
    safe = torch.where(mask, ids.long(), V)
    out = torch.zeros((B, V + 1), dtype=torch.float32, device=ids.device)
    out.scatter_add_(1, safe, torch.ones_like(safe, dtype=torch.float32))
    return out[:, :V]


def apply_penalties(
    logits: torch.Tensor,      # [B, V] f32
    history: torch.Tensor,     # [B, H] int32 prompt+output ids, 0-padded
    hist_len: torch.Tensor,    # [B] valid prefix of history
    prompt_len: torch.Tensor,  # [B] prompt portion (output starts here)
    presence: torch.Tensor,    # [B] f32 (0 = off)
    frequency: torch.Tensor,   # [B] f32 (0 = off)
    repetition: torch.Tensor,  # [B] f32 (1 = off)
) -> torch.Tensor:
    """OpenAI presence/frequency penalties over OUTPUT tokens and vLLM's
    repetition penalty over prompt + output, in vLLM's order: repetition
    on the raw logits first, then presence/frequency subtract."""
    B, V = logits.shape
    H = history.shape[1]
    idx = torch.arange(H, device=logits.device)[None, :]
    valid = idx < hist_len[:, None]
    out_part = valid & (idx >= prompt_len[:, None])
    all_counts = _counts(history, valid, V)
    out_counts = _counts(history, out_part, V)
    rep = repetition.clamp(min=1e-6)[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(all_counts > 0, penalized, logits)
    logits = logits - frequency[:, None] * out_counts
    return logits - presence[:, None] * (out_counts > 0).float()


def apply_logit_bias(
    logits: torch.Tensor,     # [B, V] f32
    bias_ids: torch.Tensor,   # [B, K] token ids; >= V = unused slot
    bias_vals: torch.Tensor,  # [B, K] f32 additive biases
) -> torch.Tensor:
    """OpenAI logit_bias: per-row sparse additive biases; out-of-range ids
    drop."""
    B, V = logits.shape
    ids = bias_ids.long().clamp(max=V)
    vals = torch.where(bias_ids < V, bias_vals.float(), torch.zeros_like(bias_vals.float()))
    out = torch.cat([logits.float(), torch.zeros((B, 1), device=logits.device)], dim=1)
    out.scatter_add_(1, ids, vals)
    return out[:, :V]
