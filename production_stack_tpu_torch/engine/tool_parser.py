"""Streaming tool-call extraction from model output (the port's own copy of
the JAX package's engine/tool_parser.py, which is framework-neutral).

The upstream stack gets tool calling from vLLM engine flags
(`--enable-auto-tool-choice --tool-call-parser ...`; its tool-enabled
installation tutorial simply turns them on). We own the engine, so the
parser lives here: it splits the token stream
into user-visible content and OpenAI `tool_calls` objects, incrementally, so
the chat endpoint can stream deltas.

Two wire formats cover the mainstream open models:

- ``hermes``: ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>``
  (Hermes/Qwen family). Content may surround the tagged blocks.
- ``json``: the whole completion is a bare JSON object or array of objects —
  ``{"name": ..., "parameters": {...}}`` — the Llama-3.x chat-template
  convention.

``auto`` watches for either trigger: a ``<tool_call>`` tag anywhere, or a
completion whose first non-whitespace character opens a JSON container. If a
candidate never parses as a tool call, the buffered text is flushed back as
ordinary content — a model that happens to answer with JSON still works.
"""

from __future__ import annotations

import json
import uuid

_HERMES_OPEN = "<tool_call>"
_HERMES_CLOSE = "</tool_call>"


def _mk_call(name: str, args) -> dict:
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {
            "name": name,
            # arguments is a JSON *string* per the OpenAI schema
            "arguments": args if isinstance(args, str) else json.dumps(args),
        },
    }


def _parse_call_obj(obj) -> "dict | None":
    """{"name": ..., "arguments"|"parameters": ...} -> tool_call, else None."""
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    return _mk_call(obj["name"], args)


def parse_tool_calls(text: str, style: str = "auto") -> "tuple[str, list[dict]]":
    """Non-streaming split of a full completion into (content, tool_calls)."""
    p = StreamingToolParser(style)
    events = p.push(text) + p.finish()
    content = "".join(e[1] for e in events if e[0] == "content")
    return content, p.tool_calls


class StreamingToolParser:
    """Incremental splitter. ``push(delta)``/``finish()`` return event lists:
    ``("content", str)`` for pass-through text and ``("call", tool_call)``
    for each completed call (also appended to ``self.tool_calls``)."""

    def __init__(self, style: str = "auto"):
        if style not in ("auto", "hermes", "json", "off"):
            raise ValueError(f"unknown tool parser style {style!r}")
        self.style = style
        self.tool_calls: list[dict] = []
        self._buf = ""          # text not yet classified
        self._mode = "scan"     # scan | hermes_body | json_tail
        self._seen_content = False

    # -- internals ----------------------------------------------------------

    def _emit_calls(self, objs) -> list:
        calls = [_parse_call_obj(obj) for obj in objs]
        if any(c is None for c in calls):
            return []  # any malformed member voids the whole candidate
        self.tool_calls.extend(calls)
        return [("call", c) for c in calls]

    def _try_json(self, text: str) -> list:
        """Parse a complete json-style candidate; [] if it isn't one."""
        try:
            obj = json.loads(text)
        except ValueError:
            return []
        objs = obj if isinstance(obj, list) else [obj]
        if not objs:
            return []
        return self._emit_calls(objs)

    # -- api ----------------------------------------------------------------

    def push(self, delta: str) -> list:
        if self.style == "off" or not delta:
            return [("content", delta)] if delta else []
        self._buf += delta
        events: list = []
        while True:
            if self._mode == "hermes_body":
                end = self._buf.find(_HERMES_CLOSE)
                if end < 0:
                    return events  # wait for the closing tag
                body = self._buf[: end]
                self._buf = self._buf[end + len(_HERMES_CLOSE):]
                got = self._try_json(body.strip())
                if not got:
                    # not a tool call after all: surface the block verbatim
                    events.append(("content", _HERMES_OPEN + body + _HERMES_CLOSE))
                events.extend(got)
                self._mode = "scan"
                continue

            if self._mode == "json_tail":
                return events  # everything buffers until finish()

            # scan mode: watch for a hermes tag / leading JSON container
            if self.style in ("auto", "hermes"):
                start = self._buf.find(_HERMES_OPEN)
                if start >= 0:
                    if start:
                        self._seen_content = True
                        events.append(("content", self._buf[:start]))
                    self._buf = self._buf[start + len(_HERMES_OPEN):]
                    self._mode = "hermes_body"
                    continue
            if (
                self.style in ("auto", "json")
                and not self._seen_content
                and self._buf.lstrip()[:1] in ("{", "[")
            ):
                self._mode = "json_tail"
                return events
            # plain content — but hold back any suffix that could be the
            # start of a hermes tag (or, pre-content, leading whitespace
            # that may precede a JSON container)
            hold = 0
            if self.style in ("auto", "hermes"):
                for k in range(min(len(_HERMES_OPEN) - 1, len(self._buf)), 0, -1):
                    if _HERMES_OPEN.startswith(self._buf[-k:]):
                        hold = k
                        break
            if not self._seen_content and not self._buf.strip():
                return events  # all-whitespace so far: keep buffering
            out = self._buf[: len(self._buf) - hold]
            if out:
                self._seen_content = True
                events.append(("content", out))
            self._buf = self._buf[len(self._buf) - hold:]
            return events

    def finish(self) -> list:
        """Flush at end-of-stream; unresolved candidates revert to content."""
        events: list = []
        if self._mode == "json_tail":
            events = self._try_json(self._buf.strip())
        elif self._mode == "hermes_body":
            # unclosed tag: give the raw text back
            self._buf = _HERMES_OPEN + self._buf
        if not events and self._buf:
            events = [("content", self._buf)]
        self._buf = ""
        self._mode = "scan"
        return events
