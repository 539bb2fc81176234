"""Migration wire format: the sealed snapshot document a sequence moves as
(the port's copy of production_stack_tpu/migration/state.py; a snapshot is
byte-identical across the packages, and each reads the other's).

The snapshot is everything a *target* engine needs to resume a running
sequence mid-stream:

- **token history** — ``tokens`` is the full ``prompt + emitted output`` id
  list at freeze time. Position and emitted-token count derive from it
  (``prompt_len`` / ``output_len`` split it), and it doubles as the
  continuation's prompt: the target re-admits it through the ordinary
  prefix-cache path, so shipped KV pages are shared and everything past them
  is *recomputed deterministically* — which is exactly what makes greedy
  continuation bit-identical (same weights, same tokens, same logits).
- **KV page chain** — the hex chunk hashes (the fleet-standard rolling
  blake2b chain, engine/kv_manager.prefix_hashes) of the fully-written pages
  whose blobs were CONFIRMED saved into the offload tiers at freeze time.
  Blobs move through the existing tier/transfer path and are CRC-verified on
  every read (kvoffload/serde.py), exactly like warm-start manifests; a
  missing or corrupt blob truncates the restore there and the tail
  recomputes. Only ``(len(tokens) - 1) // page_size`` pages are ever listed:
  the newest emitted token's KV is not written until it is fed back as the
  next step's input, so the page containing position ``len(tokens) - 1`` is
  not yet complete.
- **sampling/decode state** — the ORIGINAL request's sampling params plus
  the emitted count; :func:`continuation_params` derives the target-side
  params (max_tokens/min_tokens less what was already emitted). Greedy
  (temperature 0) continuation is bit-identical; sampled continuation picks
  up the target's RNG stream (the per-engine RNG key is not portable) and is
  quality-equivalent, not bit-identical — documented in docs/migration.md.
- **presentation metadata** — response id / chat-vs-completion / created /
  client-visible model and prompt token count, so the target can emit
  continuation chunks in the exact client wire shape and the final usage
  block reports whole-request totals.

The document travels as ``seal_bytes`` (versioned header + length + CRC32,
kvoffload/serde.py) so a truncated or bit-flipped snapshot is rejected at
``/migrate_in`` instead of resuming a corrupted stream.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from production_stack_tpu_torch.kvoffload.serde import seal_bytes, unseal_bytes

SNAPSHOT_FORMAT = 1

# SamplingParams fields that ride the wire verbatim (continuation_params
# adjusts the budget fields afterwards)
_PARAM_FIELDS = (
    "max_tokens", "temperature", "top_k", "top_p", "stop", "ignore_eos",
    "min_tokens", "seed", "presence_penalty", "frequency_penalty",
    "repetition_penalty",
)


@dataclasses.dataclass
class SequenceSnapshot:
    request_id: str          # wire id the continuation parks under on the target
    model: str               # engine model name (must match on the target)
    page_size: int           # source KV page size (chunk-hash identity)
    tokens: list             # prompt_ids + output_ids at freeze time
    prompt_len: int          # split point: tokens[:prompt_len] was the prompt
    output_len: int          # emitted tokens (== len(tokens) - prompt_len)
    params: dict             # ORIGINAL SamplingParams fields (_PARAM_FIELDS)
    page_hashes: list        # hex chunk hashes, confirmed-restorable chain prefix
    meta: dict               # presentation: oid/chat/created/client model+usage

    def to_doc(self) -> dict:
        return {"format": SNAPSHOT_FORMAT, **dataclasses.asdict(self)}

    @staticmethod
    def from_doc(doc: dict) -> "SequenceSnapshot":
        if int(doc.get("format", 0)) != SNAPSHOT_FORMAT:
            raise ValueError(
                f"unsupported migration snapshot format {doc.get('format')!r}"
            )
        return SequenceSnapshot(
            request_id=str(doc["request_id"]),
            model=str(doc["model"]),
            page_size=int(doc["page_size"]),
            tokens=[int(t) for t in doc["tokens"]],
            prompt_len=int(doc["prompt_len"]),
            output_len=int(doc["output_len"]),
            params=dict(doc.get("params") or {}),
            page_hashes=[str(h) for h in doc.get("page_hashes") or []],
            meta=dict(doc.get("meta") or {}),
        )


def snapshot_to_wire(snap: SequenceSnapshot) -> bytes:
    """Sealed (CRC-framed) bytes for the POST /migrate_in body."""
    return seal_bytes(json.dumps(snap.to_doc()).encode(), kind="migration")


def snapshot_from_wire(data: bytes) -> SequenceSnapshot:
    """Parse + integrity-verify a /migrate_in body. Raises
    ``KVIntegrityError`` (corrupt/truncated) or ``ValueError`` (malformed)."""
    _, body = unseal_bytes(data)
    doc = json.loads(body)
    if not isinstance(doc, dict):
        raise ValueError("migration snapshot must be a JSON object")
    return SequenceSnapshot.from_doc(doc)


def params_to_doc(params) -> dict:
    """SamplingParams -> wire dict (original request values, unadjusted)."""
    return {f: getattr(params, f) for f in _PARAM_FIELDS}


def continuation_params(snap: SequenceSnapshot):
    """Target-side SamplingParams: budgets shrink by what was emitted.

    The continuation's prompt is ``snap.tokens`` (original prompt + emitted
    output), so ``max_tokens`` / ``min_tokens`` count only the REMAINING
    tokens. Raises ``ValueError`` when nothing remains (the source must not
    migrate a sequence about to finish)."""
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    p = dict(snap.params)
    remaining = int(p.get("max_tokens", 0)) - snap.output_len
    if remaining < 1:
        raise ValueError(
            f"nothing left to generate (max_tokens {p.get('max_tokens')}, "
            f"already emitted {snap.output_len})"
        )
    p["max_tokens"] = remaining
    p["min_tokens"] = max(0, int(p.get("min_tokens", 0)) - snap.output_len)
    p["stop"] = list(p.get("stop") or [])
    return SamplingParams(**{k: p[k] for k in _PARAM_FIELDS})


def unmigratable_reason(seq) -> Optional[str]:
    """Why a live sequence cannot migrate, or None when it can.

    Restrictions are *semantic*, not plumbing: state the target cannot
    reconstruct faithfully refuses migration instead of silently drifting.
    The controller treats a refusal as "pick another victim"."""
    params = seq.params
    if seq.finished:
        return "sequence already finished"
    if seq.in_prefill:
        return "still prefilling (nothing to move; a retry re-prefills)"
    if not seq.output_ids:
        return "no tokens emitted yet"
    if params.max_tokens - len(seq.output_ids) < 1:
        return "about to finish (no remaining token budget)"
    if seq.lora_slot:
        return "LoRA sequences are not migratable (adapter-salted KV)"
    if params.logprobs is not None:
        return "logprobs streams are not migratable"
    if params.logit_bias:
        return "logit_bias streams are not migratable"
    if params.presence_penalty != 0.0 or params.frequency_penalty != 0.0:
        # these penalize GENERATED tokens only; the target sees the emitted
        # output as prompt, so the penalty state cannot be reconstructed
        # (repetition_penalty spans prompt+output and migrates fine)
        return "presence/frequency penalties are not migratable"
    return None
