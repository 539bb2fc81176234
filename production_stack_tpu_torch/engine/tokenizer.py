"""Tokenizer abstraction.

Serving pods load a HuggingFace tokenizer from the model directory (mounted
PVC — the reference caches weights on a PVC the same way, tutorials/03). In
hermetic environments (tests, random-weight benchmarks) a built-in byte-level
tokenizer is used so the whole stack runs with zero downloads.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


def _generic_chat_template(messages: list[dict], tools: Optional[list] = None) -> str:
    """Dependency-free fallback template. Renders tool schemas into a system
    preamble (hermes-tag convention, matched by engine/tool_parser.py) and
    serializes assistant tool_calls / tool-result turns so multi-step tool
    conversations round-trip."""
    parts = []
    if tools:
        schemas = "\n".join(
            json.dumps(t.get("function", t), sort_keys=True) for t in tools
        )
        parts.append(
            "<|system|>\nYou may call functions. Available tools:\n"
            f"{schemas}\n"
            "To call one, reply with "
            '<tool_call>{"name": <name>, "arguments": {...}}</tool_call>\n'
        )
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content") or ""
        if m.get("tool_calls"):
            calls = []
            for c in m["tool_calls"]:
                if c.get("type", "function") != "function":
                    continue
                raw = c["function"].get("arguments") or "{}"
                try:
                    args = json.loads(raw)
                except ValueError:
                    args = raw  # pass malformed arguments through verbatim
                calls.append(
                    "<tool_call>"
                    + json.dumps(
                        {"name": c["function"]["name"], "arguments": args},
                        sort_keys=True,
                    )
                    + "</tool_call>"
                )
            content = f"{content}{''.join(calls)}"
        parts.append(f"<|{role}|>\n{content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte value; specials above 255."""

    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258
    vocab_size = 512

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list] = None
    ) -> str:
        return _generic_chat_template(messages, tools)


class HFTokenizer:
    """Wrapper over a local HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        # a directory with a config.json and no tokenizer files can still
        # give a tokenizer (with an empty vocabulary, in some transformers
        # versions) whose ids are None: refuse it, so the caller falls back
        probe = self._tok.encode("a b", add_special_tokens=False)
        if not probe or not all(isinstance(i, int) for i in probe):
            raise ValueError(f"{path}: the tokenizer found there encodes 'a b' as {probe}")
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list] = None
    ) -> str:
        try:
            kw = {"tools": tools} if tools else {}
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True, **kw
            )
        except Exception as e:
            # a malformed template (or a tools-rendering bug) must not
            # degrade output silently
            logger.warning(
                "HF chat template failed (%s: %s); falling back to the "
                "generic <|role|> template", type(e).__name__, e,
            )
            return _generic_chat_template(messages, tools)


def load_tokenizer(model_path: Optional[str]):
    """HF tokenizer if `model_path` holds one locally, else the byte tokenizer."""
    if model_path:
        try:
            return HFTokenizer(model_path)
        except Exception as e:  # noqa: BLE001 - no transformers, no files, or an unusable tokenizer
            logger.info("no usable tokenizer at %s (%s: %s); using the byte tokenizer",
                        model_path, type(e).__name__, e)
    return ByteTokenizer()
