"""OpenAI-compatible HTTP server for the port's engine (aiohttp).

The JAX server's request and response JSON, trimmed to the routes of the
serving path: ``/health``, ``/ping``, ``/version``, ``/v1/models``,
``/metrics`` (``vllm:*`` names for what the port implements), ``/abort``,
``/tokenize``, ``/detokenize``, ``/v1/completions`` and
``/v1/chat/completions``, streaming and not, with ``n`` parallel samples,
logprobs, penalties, logit bias and stop strings. Tool calls, embeddings,
LoRA adapters, sleep mode and live migration are not ported; a chat request
that carries ``tools`` is refused with a 400.

Run: ``python -m production_stack_tpu_torch.engine.api_server --model
llama-3.2-1b`` (a preset), or ``--model /path/to/hf-dir`` (a local
HuggingFace checkpoint, served under that path as its name unless
``--served-model-name`` gives another), on the card; the engine raises
without one.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import signal
import time
import uuid
from typing import Optional

from aiohttp import web

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.engine.config import EngineConfig, add_engine_args, config_from_args
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.ops.sampling import TOP_LOGPROBS
from production_stack_tpu_torch.tracing import (
    get_flightrecorder,
    offload_restore_hist,
    render_flightrecorder_metrics,
)
from production_stack_tpu_torch.utils.logging import init_logger
from production_stack_tpu_torch.utils.metrics import LATENCY_BUCKETS, TTFT_BUCKETS, Histogram

logger = init_logger(__name__)

# Per-request TTFT hop samples for streaming requests, in ms:
# (accept->engine-submit, submit->first engine output, first output->first
# SSE write); /metrics exposes p50/p99 per hop.
_ttft_hops: collections.deque = collections.deque(maxlen=2048)
_ttft_hist = Histogram(
    "vllm:time_to_first_token_seconds", TTFT_BUCKETS, "Time to first token distribution"
)
_latency_hist = Histogram(
    "vllm:e2e_request_latency_seconds", LATENCY_BUCKETS,
    "End-to-end request latency distribution",
)


def _quantiles(vals) -> dict:
    s = sorted(vals)
    return {"p50": s[len(s) // 2], "p99": s[min(len(s) - 1, int(len(s) * 0.99))]}


def _ttft_hop_quantiles() -> dict:
    if not _ttft_hops:
        return {}
    names = ("accept_to_submit", "submit_to_first_token", "first_token_to_write")
    return {name: _quantiles(vals) for name, vals in zip(names, zip(*_ttft_hops))}


async def _tag_stream(i, gen):
    async for out in gen:
        yield i, out


async def _merge_streams(gens):
    """Merge n RequestOutput streams into (choice_index, output) tuples,
    preserving per-stream order."""
    q: asyncio.Queue = asyncio.Queue()

    async def pump(i, g):
        try:
            async for out in g:
                await q.put((i, out))
        except Exception as e:  # surface stream errors to the consumer
            await q.put((i, e))
        finally:
            await q.put((i, None))

    tasks = [asyncio.ensure_future(pump(i, g)) for i, g in enumerate(gens)]
    try:
        open_streams = len(gens)
        while open_streams:
            i, out = await q.get()
            if out is None:
                open_streams -= 1
                continue
            if isinstance(out, Exception):
                raise out
            yield i, out
    finally:
        for t in tasks:
            t.cancel()


def _chat_lp_content(tok, token_ids, entries):
    """OpenAI chat logprobs format: choices[].logprobs.content[]."""
    content = []
    for tid, e in zip(token_ids, entries):
        s = tok.decode([tid])
        content.append({
            "token": s,
            "logprob": e["logprob"],
            "bytes": list(s.encode("utf-8", errors="replace")),
            "top_logprobs": [
                {
                    "token": tok.decode([i]),
                    "logprob": lp,
                    "bytes": list(tok.decode([i]).encode("utf-8", errors="replace")),
                }
                for i, lp in zip(e["top_ids"], e["top_logprobs"])
            ],
        })
    return content


def _completion_lp(tok, token_ids, entries, offset0):
    """OpenAI completions logprobs format; returns (dict, next_offset)."""
    toks, tlps, tops, offs = [], [], [], []
    off = offset0
    for tid, e in zip(token_ids, entries):
        s = tok.decode([tid])
        toks.append(s)
        tlps.append(e["logprob"])
        top: dict = {}
        for i, lp in zip(e["top_ids"], e["top_logprobs"]):
            # distinct ids can decode to the same string (byte fragments);
            # entries arrive best-first, so keep the first (highest) lp
            top.setdefault(tok.decode([i]), lp)
        tops.append(top)
        offs.append(off)
        off += len(s)
    return (
        {"tokens": toks, "token_logprobs": tlps, "top_logprobs": tops, "text_offset": offs},
        off,
    )


def _sampling_params(body: dict, default_max: int = 256, vocab_size: Optional[int] = None) -> SamplingParams:
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return SamplingParams(
        max_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or default_max),
        temperature=float(body.get("temperature", 1.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        stop=list(stop),
        ignore_eos=bool(body.get("ignore_eos", False)),
        min_tokens=int(body.get("min_tokens", 0)),
        seed=body.get("seed"),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        logit_bias=_parse_logit_bias(body.get("logit_bias"), vocab_size),
    )


def _parse_logit_bias(raw, vocab_size: Optional[int] = None) -> Optional[dict]:
    """OpenAI logit_bias: {"<token_id>": bias in [-100, 100]}, <= 300 keys."""
    if not raw:
        return None
    if not isinstance(raw, dict) or len(raw) > 300:
        raise ValueError("logit_bias must be a dict of at most 300 entries")
    out = {}
    for k, v in raw.items():
        try:
            tid, bv = int(k), float(v)
        except (TypeError, ValueError):
            raise ValueError(f"invalid logit_bias entry {k!r}: {v!r}") from None
        if tid < 0:
            raise ValueError(f"logit_bias token id {tid} is negative")
        if vocab_size is not None and tid >= vocab_size:
            raise ValueError(f"logit_bias token id {tid} out of range for vocab size {vocab_size}")
        if not -100.0 <= bv <= 100.0:
            raise ValueError(f"logit_bias value {bv} outside [-100, 100]")
        out[tid] = bv
    return out


def _error(message: str, status: int = 400, **extra) -> web.Response:
    return web.json_response({"error": {"message": message, **extra}}, status=status)


def _shed_response(retry_after_s: float, message: str) -> web.Response:
    """Load-shed contract: 429 with a Retry-After hint instead of queueing
    the request into unbounded TTFT."""
    retry = max(1, int(-(-retry_after_s // 1)))  # ceil, floor 1 s
    return web.json_response(
        {"error": {"message": message, "type": "overloaded_error", "code": 429}},
        status=429,
        headers={"Retry-After": str(retry)},
    )


def _request_priority(headers, body) -> str:
    """Per-request SLO class: the X-Priority header wins, then the body's
    "priority" field; anything else is interactive."""
    p = headers.get("X-Priority") or (body.get("priority") if isinstance(body, dict) else None)
    p = str(p).strip().lower() if p else "interactive"
    return p if p in ("interactive", "batch") else "interactive"


def _usage(out) -> dict:
    return {
        "prompt_tokens": out.prompt_tokens,
        "completion_tokens": out.completion_tokens,
        "total_tokens": out.prompt_tokens + out.completion_tokens,
        "prompt_tokens_details": {"cached_tokens": out.cached_tokens},
    }


def _summed_usage(lasts) -> dict:
    """Usage of a request: prompt counted once, completion tokens summed
    over its choices."""
    usage = _usage(lasts[0])
    if len(lasts) > 1:
        usage["completion_tokens"] = sum(l.completion_tokens for l in lasts if l)
        usage["total_tokens"] = usage["prompt_tokens"] + usage["completion_tokens"]
    return usage


class EngineServer:
    def __init__(self, cfg: EngineConfig, engine: Optional[LLMEngine] = None, device="cuda"):
        self.cfg = cfg
        self.engine = engine or LLMEngine(cfg, device=device)
        self.start_time = time.time()
        # SIGTERM: /health flips to 503, new generation requests are refused
        # and in-flight ones finish
        self.draining = False
        # request id -> engine sequence ids, for POST /abort
        self._live_requests: dict[str, list[str]] = {}

    # -- handlers -----------------------------------------------------------

    async def health(self, request: web.Request) -> web.Response:
        if self.draining:
            return web.Response(status=503, text="draining")
        return web.Response(text="")

    async def abort(self, request: web.Request) -> web.Response:
        """POST /abort {"request_id": ...}: free a request's slot and KV
        pages; an unknown or finished request is a no-op (aborted=false)."""
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 - malformed abort is harmless
            body = {}
        req_id = body.get("request_id") or request.query.get("request_id")
        if not req_id:
            return _error("request_id required")
        sub_ids = self._live_requests.pop(req_id, None)
        for sid in sub_ids or [req_id]:
            self.engine.abort(sid)
        return web.json_response({"request_id": req_id, "aborted": sub_ids is not None})

    async def drain(self, timeout: float = 30.0) -> None:
        """Stop accepting generation work and wait for in-flight requests to
        finish or ``timeout`` to pass."""
        self.draining = True
        get_flightrecorder().dump("sigterm_drain", force=True)
        deadline = time.time() + timeout
        while time.time() < deadline and self.engine.scheduler.has_work():
            await asyncio.sleep(0.2)

    async def version(self, request: web.Request) -> web.Response:
        return web.json_response({"version": __version__})

    async def models(self, request: web.Request) -> web.Response:
        return web.json_response({
            "object": "list",
            "data": [{
                "id": self.cfg.name,
                "object": "model",
                "created": int(self.start_time),
                "owned_by": "production-stack-tpu",
                "max_model_len": self.cfg.max_model_len,
            }],
        })

    async def tokenize(self, request: web.Request) -> web.Response:
        body = await request.json()
        text = body.get("prompt")
        if text is None and "messages" in body:
            text = self.engine.tokenizer.apply_chat_template(body["messages"])
        ids = self.engine.tokenizer.encode(text or "")
        return web.json_response({"tokens": ids, "count": len(ids), "max_model_len": self.cfg.max_model_len})

    async def detokenize(self, request: web.Request) -> web.Response:
        body = await request.json()
        return web.json_response({"prompt": self.engine.tokenizer.decode(body.get("tokens", []))})

    async def metrics(self, request: web.Request) -> web.Response:
        s = self.engine.stats()
        m = self.cfg.name
        lines = []

        def emit(name: str, kind: str, value, help_: str = ""):
            lines.append(f"# HELP vllm:{name} {help_ or name}")
            lines.append(f"# TYPE vllm:{name} {kind}")
            lines.append(f'vllm:{name}{{model_name="{m}"}} {value}')

        emit("num_requests_running", "gauge", s["num_requests_running"])
        emit("num_requests_waiting", "gauge", s["num_requests_waiting"])
        emit("num_requests_swapped", "gauge", s["num_requests_swapped"])
        emit("num_preemptions_total", "counter", s["num_preemptions_total"])
        emit("engine_saturated", "gauge", s["engine_saturated"],
             "1 while the waiting queue is at its max_waiting_seqs bound")
        emit("num_requests_shed_total", "counter", s["num_requests_shed_total"],
             "generation requests shed with 429 (queue full or queue deadline)")
        emit("gpu_cache_usage_perc", "gauge", s["gpu_cache_usage_perc"])
        emit("gpu_prefix_cache_hit_rate", "gauge", s["gpu_prefix_cache_hit_rate"])
        emit("gpu_prefix_cache_hits_total", "counter", s["gpu_prefix_cache_hits_total"])
        emit("gpu_prefix_cache_queries_total", "counter", s["gpu_prefix_cache_queries_total"])
        emit("prompt_tokens_total", "counter", s["prompt_tokens_total"])
        emit("generation_tokens_total", "counter", s["generation_tokens_total"])
        emit("decode_dispatches_total", "counter", s["decode_dispatches_total"])
        for k in sorted(s):  # kv eviction, int8 KV, offload and engine-loop sections
            if k.startswith(("kv_", "engine_loop_")):
                emit(k, "counter" if k.endswith("_total") else "gauge", s[k])
        hops = _ttft_hop_quantiles()
        waits = list(self.engine.admission_wait_ms)
        if waits:
            hops["admission_wait"] = _quantiles(waits)
        for hop, qs in hops.items():
            lines.append(f"# TYPE vllm:ttft_hop_{hop}_ms gauge")
            for q, v in qs.items():
                lines.append(f'vllm:ttft_hop_{hop}_ms{{model_name="{m}",quantile="{q}"}} {round(v, 3)}')
        lines.extend(_ttft_hist.render(f'model_name="{m}"'))
        lines.extend(_latency_hist.render(f'model_name="{m}"'))
        lines.extend(render_flightrecorder_metrics(f'model_name="{m}"'))
        if self.engine._offload is not None:
            lines.extend(offload_restore_hist.render(f'model_name="{m}"'))
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
            messages = body.get("messages", [])
            if not isinstance(messages, list):
                raise ValueError("'messages' must be a list")
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        if body.get("tools") and body.get("tool_choice", "auto") != "none":
            return _error("tool calls are not supported by the PyTorch port yet")
        prompt = self.engine.tokenizer.apply_chat_template(messages)
        return await self._generate(request, body, prompt, chat=True)

    async def completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        return await self._generate(request, body, prompt, chat=False)

    async def _generate(self, request: web.Request, body: dict, prompt: str, chat: bool) -> web.StreamResponse:
        t_accept = time.perf_counter()
        if self.draining:
            return _error("engine is draining for shutdown", 503)
        priority = _request_priority(request.headers, body)
        if self.engine.saturated(priority):
            self.engine.api_requests_shed += 1
            return _shed_response(
                self.engine.shed_retry_after(),
                f"engine saturated: {self.engine.scheduler.num_waiting()} requests already waiting",
            )
        model = body.get("model", self.cfg.name)
        if model != self.cfg.name:
            return _error(f"model {model!r} does not exist", 404, type="NotFoundError", code=404)
        req_id = request.headers.get("X-Request-Id") or f"req-{uuid.uuid4().hex[:16]}"
        try:
            params = _sampling_params(body, vocab_size=self.engine.model_cfg.vocab_size)
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        if not (-2.0 <= params.presence_penalty <= 2.0
                and -2.0 <= params.frequency_penalty <= 2.0
                and params.repetition_penalty > 0):
            return _error("penalties out of range: presence/frequency in [-2, 2], repetition > 0")
        # logprobs: completions takes an int (top count), chat takes
        # logprobs=true + top_logprobs=N
        lp_count = None
        if chat:
            if body.get("logprobs"):
                lp_count = int(body.get("top_logprobs") or 0)
        elif body.get("logprobs") is not None:
            lp_count = int(body["logprobs"])
        if lp_count is not None:
            if not 0 <= lp_count <= TOP_LOGPROBS:
                return _error(f"logprobs must be in [0, {TOP_LOGPROBS}]")
            params.logprobs = lp_count
        stream = bool(body.get("stream", False))
        created = int(time.time())
        kind = "chat.completion" if chat else "text_completion"
        oid = ("chatcmpl-" if chat else "cmpl-") + req_id

        # tokenize and validate before streaming starts: errors inside the
        # generator would surface after the 200
        prompt_ids = self.engine.tokenizer.encode(prompt)
        if not prompt_ids and self.engine.tokenizer.bos_token_id is None:
            return _error("the prompt is empty and the tokenizer has no BOS token to start from")
        if len(prompt_ids) + 1 > self.cfg.max_model_len:
            return _error(f"prompt has {len(prompt_ids)} tokens, max_model_len is {self.cfg.max_model_len}")
        n = 1 if body.get("n") is None else int(body["n"])
        best_of = n if body.get("best_of") is None else int(body["best_of"])
        if not 1 <= n <= 64 or best_of != n:
            return _error(f"n must be in [1, 64] and best_of == n, got n={n} best_of={best_of}")
        # n parallel samples: one engine sequence per choice. Siblings start
        # after choice 0's first output, when its prompt pages are in the
        # prefix cache, so they share the prompt KV.
        sub_ids = [req_id] if n == 1 else [f"{req_id}#{i}" for i in range(n)]
        self._live_requests[req_id] = sub_ids

        def _gen(sid):
            return self.engine.generate(sid, prompt_token_ids=prompt_ids, params=params, priority=priority)

        def _abort_all() -> None:
            self._live_requests.pop(req_id, None)
            for sid in sub_ids:
                self.engine.abort(sid)

        def _shed_whole_request() -> web.Response:
            _abort_all()
            return _shed_response(
                self.engine.shed_retry_after(), "request shed: queue deadline exceeded before dispatch"
            )

        t_submit = time.perf_counter()
        if n == 1:
            gens = [_gen(sub_ids[0])]
        else:
            prefilled = asyncio.Event()

            async def first(sid):
                try:
                    async for out in _gen(sid):
                        prefilled.set()
                        yield out
                finally:
                    prefilled.set()  # error/abort must not wedge siblings

            async def sibling(sid):
                await prefilled.wait()
                async for out in _gen(sid):
                    yield out

            gens = [first(sub_ids[0])] + [sibling(sid) for sid in sub_ids[1:]]

        if not stream:
            t_first_box = [None]

            async def collect(i, g):
                text, finish_reason, last = [], None, None
                tok_ids, lp_entries = [], []
                async for out in g:
                    if t_first_box[0] is None:
                        t_first_box[0] = time.perf_counter()
                    text.append(out.text_delta)
                    last = out
                    if out.logprobs is not None:
                        tok_ids.extend(out.token_ids)
                        lp_entries.extend(out.logprobs)
                    if out.finished:
                        finish_reason = out.finish_reason
                return i, "".join(text), finish_reason, last, tok_ids, lp_entries

            try:
                results = await asyncio.gather(*(collect(i, g) for i, g in enumerate(gens)))
            except (Exception, asyncio.CancelledError):
                _abort_all()
                raise
            if any(r[2] == "shed" for r in results):
                return _shed_whole_request()
            choices, lasts = [], []
            for i, full, finish_reason, last, tok_ids, lp_entries in results:
                lasts.append(last)
                lp_obj = None
                if lp_count is not None:
                    if chat:
                        lp_obj = {"content": _chat_lp_content(self.engine.tokenizer, tok_ids, lp_entries)}
                    else:
                        lp_obj, _ = _completion_lp(self.engine.tokenizer, tok_ids, lp_entries, 0)
                if chat:
                    choices.append({
                        "index": i,
                        "message": {"role": "assistant", "content": full},
                        "logprobs": lp_obj,
                        "finish_reason": finish_reason,
                    })
                else:
                    choices.append({"index": i, "text": full, "logprobs": lp_obj, "finish_reason": finish_reason})
            usage = _summed_usage(lasts) if lasts[0] else {}
            if t_first_box[0] is not None:
                _ttft_hist.observe(t_first_box[0] - t_accept)
            _latency_hist.observe(time.perf_counter() - t_accept)
            self._live_requests.pop(req_id, None)
            return web.json_response(
                {"id": oid, "object": kind, "created": created, "model": model,
                 "choices": choices, "usage": usage},
                headers={"X-Request-Id": req_id},
            )

        merged = _tag_stream(0, gens[0]) if n == 1 else _merge_streams(gens)
        # when the engine may shed queued requests, hold the headers until
        # the first engine output: a shed then is a clean 429
        first_item = None
        if self.engine.can_shed_queued():
            try:
                first_item = await merged.__anext__()
            except StopAsyncIteration:
                first_item = None
            except (Exception, asyncio.CancelledError):
                _abort_all()
                raise
            if first_item is not None and first_item[1].finished and first_item[1].finish_reason == "shed":
                await merged.aclose()
                return _shed_whole_request()

        async def _chain_first(first, agen):
            if first is not None:
                yield first
            async for item in agen:
                yield item

        resp = web.StreamResponse(
            status=200,
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache", "X-Request-Id": req_id},
        )
        await resp.prepare(request)

        async def send(obj: dict):
            await resp.write(f"data: {json.dumps(obj)}\n\n".encode())

        # chat role chunks go out with each choice's first engine output, so
        # the first streamed bytes track prefill completion
        role_sent = [not chat] * n
        lasts: list = [None] * n
        try:
            lp_offsets = [0] * n
            t_first_out = None
            for_first_hop = True
            async for i, out in _chain_first(first_item, merged):
                lasts[i] = out
                if i == 0 and t_first_out is None:
                    t_first_out = time.perf_counter()
                if not role_sent[i]:
                    role_sent[i] = True
                    await send({
                        "id": oid, "object": "chat.completion.chunk", "created": created, "model": model,
                        "choices": [{"index": i, "delta": {"role": "assistant"}, "finish_reason": None}],
                    })
                lp_obj = None
                if lp_count is not None and out.logprobs is not None:
                    if chat:
                        lp_obj = {"content": _chat_lp_content(self.engine.tokenizer, out.token_ids, out.logprobs)}
                    else:
                        lp_obj, lp_offsets[i] = _completion_lp(
                            self.engine.tokenizer, out.token_ids, out.logprobs, lp_offsets[i]
                        )
                # one chunk per engine output, even an empty one: the first
                # chunk is what clients measure TTFT against
                if chat:
                    choice = {
                        "index": i,
                        "delta": {"content": out.text_delta} if out.text_delta else {},
                        "logprobs": lp_obj,
                        "finish_reason": out.finish_reason,
                    }
                    await send({"id": oid, "object": "chat.completion.chunk", "created": created,
                                "model": model, "choices": [choice]})
                else:
                    await send({
                        "id": oid, "object": "text_completion", "created": created, "model": model,
                        "choices": [{"index": i, "text": out.text_delta, "logprobs": lp_obj,
                                     "finish_reason": out.finish_reason}],
                    })
                if i == 0 and for_first_hop:
                    for_first_hop = False
                    _ttft_hops.append((
                        (t_submit - t_accept) * 1000,
                        (t_first_out - t_submit) * 1000,
                        (time.perf_counter() - t_first_out) * 1000,
                    ))
                    _ttft_hist.observe(t_first_out - t_accept)
            if lasts[0] is not None:
                await send({
                    "id": oid, "object": f"{kind}.chunk" if chat else kind, "created": created,
                    "model": model, "choices": [], "usage": _summed_usage(lasts),
                })
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            _abort_all()
            raise
        self._live_requests.pop(req_id, None)
        _latency_hist.observe(time.perf_counter() - t_accept)
        await resp.write_eof()
        return resp

    # -- app ---------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 << 20)
        r = app.router
        r.add_get("/health", self.health)
        r.add_get("/ping", self.health)
        r.add_get("/version", self.version)
        r.add_get("/v1/models", self.models)
        r.add_get("/metrics", self.metrics)
        r.add_post("/abort", self.abort)
        r.add_post("/tokenize", self.tokenize)
        r.add_post("/detokenize", self.detokenize)
        r.add_post("/v1/chat/completions", self.chat_completions)
        r.add_post("/v1/completions", self.completions)
        return app


async def serve(cfg: EngineConfig, engine: Optional[LLMEngine] = None, device="cuda"):
    """Build the engine (unless given), start its loop and the HTTP site;
    returns (server, aiohttp AppRunner). The caller stops both."""
    server = EngineServer(cfg, engine, device=device)
    server.engine.start()
    runner = web.AppRunner(server.build_app())
    await runner.setup()
    await web.TCPSite(runner, cfg.host, cfg.port).start()
    logger.info("engine API listening on %s:%d (model=%s)", cfg.host, cfg.port, cfg.name)
    return server, runner


async def _wait_for_termination() -> None:
    """Block until the first SIGTERM/SIGINT."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()


def main():
    import os

    p = argparse.ArgumentParser("torch-engine")
    add_engine_args(p)
    cfg = config_from_args(p.parse_args())

    async def _run():
        server, runner = await serve(cfg)
        await _wait_for_termination()
        await server.drain(float(os.environ.get("PSTPU_DRAIN_TIMEOUT", "30")))
        await runner.cleanup()
        server.engine.stop()

    asyncio.run(_run())


if __name__ == "__main__":
    main()
