"""OpenAI-compatible HTTP server for the port's engine (aiohttp).

The JAX server's request and response JSON for the routes the port serves:
``/health``, ``/ping``, ``/version``, ``/v1/models``, ``/metrics``
(``vllm:*`` names for what the port implements, the device telemetry of
engine/devicemon.py among them), ``/stats``, ``/slo_records``, ``/abort``,
``/tokenize``, ``/detokenize``, ``/v1/completions`` and
``/v1/chat/completions`` (streaming and not, with ``n`` parallel samples,
logprobs, penalties, logit bias, stop strings and tool calls, parsed by
engine/tool_parser.py in the ``--tool-call-parser`` style, "auto" by default;
"off" renders and parses no tools), ``/v1/embeddings``,
``/v1/rerank``, ``/v2/rerank``, ``/v1/score``, sleep mode's ``/sleep``,
``/wake_up`` and ``/is_sleeping``, and with ``--enable-lora``
``/v1/load_lora_adapter`` and ``/v1/unload_lora_adapter`` (the bodies the
reference's LoraAdapter controller posts): a loaded adapter is a model of
``/v1/models`` with its ``parent``, a completion or chat request names it in
``model``, and the pooling routes refuse it (they run the base weights).
With ``--enable-debug-endpoints`` the debug routes are registered too:
``/v1/traces`` (the span ring: each request's ``engine.request`` span under
the caller's ``traceparent``, or under a root this server makes, and the
engine's queue, prefill and decode spans under it), ``/v1/debug/flightrecorder``
(the engine's event ring, filterable by request id, trace id, kind and step)
and ``POST /metrics/reset`` (empties the TTFT hop windows, the latency and
phase histograms, the span ring and the flight recorder). On SIGTERM the
server drains, then spills the warm-start manifest (``--warm-start``).
``GET /kv_fabric`` answers the engine's KV fabric listener (its address,
generation, dtype family and page size, or ``enabled: false``), which a
disaggregated-prefill producer's ``--kv-fabric-peer`` URL resolves, and
``/metrics`` carries the fabric's push and pull histograms and the probed
per-peer bandwidth the router's disaggregated_prefill mode scrapes to pick
a decode engine. Live migration, as the JAX server serves it (the engine's
``migration``, on by default; with ``--no-migration`` the routes answer
501): ``GET /migratable`` lists the live single-choice streams with their
progress and whether each can move (the fleet controller's victim listing);
``POST /migrate_out`` freezes a stream, ships its snapshot to the target's
``POST /migrate_in`` (its pages over the fabric when both engines run one,
else through the offload tiers), and on the target's acceptance ends the
stream's leg with the ``pstpu_migration`` control event instead of
``[DONE]``, which the unchanged router splices; a refused or failed ship
rolls back and the stream goes on here. The target parks the continuation
until ``POST /migrate_attach`` streams it (aborted past
``--migrate-attach-timeout-s``), in the client's wire shape, with a final
usage block that counts the whole request across every hop. ``/metrics``
carries the migration counters and ``vllm:migration_duration_seconds``, and,
with ``--kv-directory-url``, the ``vllm:kv_directory_*`` series.

Run: ``python -m production_stack_tpu_torch.engine.api_server --model
llama-3.2-1b`` (a preset), or ``--model /path/to/hf-dir`` (a local
HuggingFace checkpoint, served under that path as its name unless
``--served-model-name`` gives another), on the card; the engine raises
without one. ``--tensor-parallel-size N`` (alias ``--tensor-parallel``)
serves with N processes, one per tp rank, which the engine starts and, on
shutdown, ends; ``--data-parallel-size M`` makes M such groups, M x N
processes, each group serving its share of every batch's rows;
``--expert-parallel-size K`` splits a MoE model's experts over K ranks in
each group (M x K x N processes; a dense model is replicated over them);
``--tp-backend`` (nccl, the default, or gloo) and ``--tp-device-ids`` (say
``0,0``: two ranks on the first card, with gloo) are the port's own knobs
for all of them. ``--decode-pipeline N`` chains up to N decode bursts a
dispatch; ``--speculative-k K`` (with ``--speculative-ngram``) decodes by
n-gram draft and verify, and then answers 400 to a request with penalties,
logit_bias, min_tokens or logprobs, as the JAX server does.
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
from production_stack_tpu_torch.engine.devicemon import DeviceMonitor
from production_stack_tpu_torch.engine.distributed import follower_host_main, resolve_process_id
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.engine.tool_parser import StreamingToolParser, parse_tool_calls
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError
from production_stack_tpu_torch.migration import (
    MigrationError,
    continuation_params,
    snapshot_from_wire,
    snapshot_to_wire,
    unmigratable_reason,
)
from production_stack_tpu_torch.ops.sampling import TOP_LOGPROBS
from production_stack_tpu_torch.tracing import (
    configure_tracing,
    export_for_query,
    flightrecorder,
    get_collector,
    get_flightrecorder,
    render_collector_metrics,
    render_flightrecorder_metrics,
    render_phase_histograms,
    reset_phase_histograms,
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


def _resolve_tools(body: dict, parser: str = "auto") -> "tuple[Optional[list], Optional[str]]":
    """(tools to render into the chat template, parser style or None), as
    the JAX server resolves them. Malformed ``tools`` or message
    ``tool_calls`` raise ValueError (a 400). ``tool_choice``: "none"
    drops the schemas, a named function narrows them to that tool,
    "auto"/"required" render all. ``parser`` is the server's
    ``tool_call_parser``: "off" renders and parses no tools."""
    tools = body.get("tools")
    if tools is not None:
        if not isinstance(tools, list):
            raise ValueError("'tools' must be a list")
        for t in tools:
            if not (isinstance(t, dict) and isinstance(t.get("function"), dict)
                    and isinstance(t["function"].get("name"), str)):
                raise ValueError("each tool must be {'type': 'function', 'function': {'name': ..., ...}}")
    for msg in body.get("messages", []):
        for c in (msg.get("tool_calls") or []) if isinstance(msg, dict) else []:
            fn = c.get("function") if isinstance(c, dict) else None
            if not (isinstance(fn, dict) and isinstance(fn.get("name"), str)
                    and isinstance(fn.get("arguments", ""), str)):
                raise ValueError("message tool_calls must carry function.name and string function.arguments")
    choice = body.get("tool_choice", "auto" if tools else "none")
    if not tools or choice == "none" or parser == "off":
        return None, None
    if isinstance(choice, dict):
        name = (choice.get("function") or {}).get("name")
        tools = [t for t in tools if (t.get("function") or {}).get("name") == name]
        if not tools:
            raise ValueError(f"tool_choice names unknown tool {name!r}")
    elif choice not in ("auto", "required"):
        raise ValueError(f"invalid tool_choice {choice!r}")
    return tools, parser


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
    def __init__(self, cfg: EngineConfig, engine: Optional[LLMEngine] = None, device="cuda", params=None):
        self.cfg = cfg
        self.engine = engine or LLMEngine(cfg, device=device, params=params)
        self.start_time = time.time()
        # SIGTERM: /health flips to 503, new generation requests are refused
        # and in-flight ones finish
        self.draining = False
        # request id -> (engine sequence ids, accept time, streaming, meta),
        # for POST /abort and live migration: the meta carries what a
        # migration target needs to go on in the client's wire shape (the
        # response id, chat or completion, created, model, prompt tokens,
        # priority) and, on a migrated-in stream, the tokens earlier hops
        # emitted ("prior_completion")
        self._live_requests: dict[str, tuple] = {}
        # live migration, all owned by the event loop: request id ->
        # {"target", "request_id"} set by a committed /migrate_out (the
        # control event), and request id -> a parked migrated-in
        # continuation ({"q", "task", "snap", "t"}) awaiting /migrate_attach
        self._migrated_out: dict[str, dict] = {}
        self._parked: dict[str, dict] = {}
        self._mig_session = None  # aiohttp client for /migrate_in ships
        self.devmon = DeviceMonitor(self.engine)

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
        entry = self._live_requests.pop(req_id, None)
        for sid in entry[0] if entry else [req_id]:
            self.engine.abort(sid)
        return web.json_response({"request_id": req_id, "aborted": entry is not None})

    async def drain(self, timeout: float = 30.0) -> None:
        """Stop accepting generation work and wait for in-flight requests to
        finish or ``timeout`` to pass."""
        self.draining = True
        get_flightrecorder().dump("sigterm_drain", force=True)
        deadline = time.time() + timeout
        while time.time() < deadline and self.engine.scheduler.has_work():
            await asyncio.sleep(0.2)
        # the warm-start manifest, after in-flight requests finished (their
        # pages are registered by now), so the next incarnation restores it
        n = await asyncio.get_running_loop().run_in_executor(None, self.engine.warm_spill)
        if n:
            logger.info("drain: warm-start manifest spilled (%d pages)", n)

    async def version(self, request: web.Request) -> web.Response:
        return web.json_response({"version": __version__})

    async def models(self, request: web.Request) -> web.Response:
        base = {
            "id": self.cfg.name,
            "object": "model",
            "created": int(self.start_time),
            "owned_by": "production-stack-tpu",
            "max_model_len": self.cfg.max_model_len,
        }
        # loaded adapters are models too, each with its parent (vLLM's
        # convention, read by the LoraAdapter controller and the router)
        adapters = [
            {**base, "id": name, "parent": self.cfg.name}
            for name in self.engine.list_lora_adapters()
        ]
        return web.json_response({"object": "list", "data": [base] + adapters})

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
        # per-SLO-class overload surface: shed order, batch-early saturation
        # and the interactive latency the fleet controller's latency
        # protection scrapes
        emit("num_requests_shed_interactive_total", "counter", s["num_requests_shed_interactive_total"],
             "interactive-class requests shed with 429")
        emit("num_requests_shed_batch_total", "counter", s["num_requests_shed_batch_total"],
             "batch-class requests shed with 429")
        emit("engine_saturated_batch", "gauge", s["engine_saturated_batch"],
             "1 while batch-class admission is shedding (interactive reserve)")
        emit("interactive_ttft_p99_ms", "gauge", s["interactive_ttft_p99_ms"],
             "p99 TTFT over the recent interactive ok-request window")
        emit("interactive_itl_p99_ms", "gauge", s["interactive_itl_p99_ms"],
             "p99 inter-token latency over the recent interactive window")
        emit("tensor_parallel_degree", "gauge", s["tensor_parallel"],
             "tp mesh-axis size of the serving mesh (chips per replica)")
        emit("gpu_cache_usage_perc", "gauge", s["gpu_cache_usage_perc"])
        emit("gpu_prefix_cache_hit_rate", "gauge", s["gpu_prefix_cache_hit_rate"])
        emit("gpu_prefix_cache_hits_total", "counter", s["gpu_prefix_cache_hits_total"])
        emit("gpu_prefix_cache_queries_total", "counter", s["gpu_prefix_cache_queries_total"])
        emit("prompt_tokens_total", "counter", s["prompt_tokens_total"])
        emit("generation_tokens_total", "counter", s["generation_tokens_total"])
        emit("decode_dispatches_total", "counter", s["decode_dispatches_total"])
        emit("decode_chained_dispatches_total", "counter", s["decode_chained_dispatches_total"])
        emit("runahead_prefill_dispatches_total", "counter", s["runahead_prefill_dispatches_total"])
        for k in sorted(s):  # kv eviction, int8 KV, offload, speculative decode and engine-loop sections
            if k.startswith(("kv_", "spec_decode_", "engine_loop_", "warm_start_")):
                emit(k, "counter" if k.endswith("_total") else "gauge", s[k])
        hops = _ttft_hop_quantiles()
        waits = list(self.engine.admission_wait_ms)
        if waits:
            hops["admission_wait"] = _quantiles(waits)
        for hop, qs in hops.items():
            lines.append(f"# TYPE vllm:ttft_hop_{hop}_ms gauge")
            for q, v in qs.items():
                lines.append(f'vllm:ttft_hop_{hop}_ms{{model_name="{m}",quantile="{q}"}} {round(v, 3)}')
        fab = self.engine._fabric_client
        if fab is not None:
            # the fabric's latency histograms and the per-peer probed
            # bandwidth the router's decode pick scrapes (its kv_fabric_*
            # counters came with the kv_ sweep)
            lines.extend(fab.push_hist.render(f'model_name="{m}"'))
            lines.extend(fab.pull_hist.render(f'model_name="{m}"'))
            lines.append("# HELP vllm:kv_fabric_peer_bandwidth_bytes_per_sec "
                         "probed engine-to-engine fabric bandwidth per peer")
            lines.append("# TYPE vllm:kv_fabric_peer_bandwidth_bytes_per_sec gauge")
            peers = fab.probe_cache.snapshot()
            if not peers:
                # a zero placeholder keeps the name scrapeable before the
                # first probe
                lines.append(f'vllm:kv_fabric_peer_bandwidth_bytes_per_sec{{model_name="{m}",peer="none"}} 0')
            for addr, link in sorted(peers.items()):
                lines.append(f'vllm:kv_fabric_peer_bandwidth_bytes_per_sec{{model_name="{m}",peer="{addr}"}} '
                             f"{round(link.bandwidth, 1)}")
        mig = self.engine.migration
        if mig is not None:
            # live migration: its counters and the freeze-to-commit histogram
            for k, v in sorted(mig.stats().items()):
                emit(k, "counter", v)
            lines.extend(mig.duration_hist.render(f'model_name="{m}"'))
        lines.extend(_ttft_hist.render(f'model_name="{m}"'))
        lines.extend(_latency_hist.render(f'model_name="{m}"'))
        lines.extend(render_phase_histograms(f'model_name="{m}"'))
        # span loss (ring wrap, unsampled) and the flight recorder's health
        lines.extend(render_collector_metrics(f'model_name="{m}"'))
        lines.extend(render_flightrecorder_metrics(f'model_name="{m}"'))
        lines.extend(self.devmon.metrics_lines(m))
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    async def kv_fabric_info(self, request: web.Request) -> web.Response:
        """Fabric discovery: a disagg producer resolves this engine's fabric
        listener (and its generation and dtype facts) here."""
        srv = self.engine._fabric_server
        if srv is None:
            return web.json_response({"enabled": False})
        return web.json_response({
            "enabled": True,
            "addr": srv.address,
            "generation": srv.generation,
            "quant": srv.quant,
            "page_size": srv.page_size,
        })

    # -- live sequence migration ------------------------------------------------

    async def _mig_client(self):
        """The shared client session that ships snapshots to targets."""
        import aiohttp

        if self._mig_session is None or self._mig_session.closed:
            self._mig_session = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=30, sock_connect=5))
        return self._mig_session

    async def _close_mig_client(self, app=None) -> None:
        if self._mig_session is not None and not self._mig_session.closed:
            await self._mig_session.close()
        self._mig_session = None

    async def migratable(self, request: web.Request) -> web.Response:
        """The fleet controller's victim listing: live single-choice
        streaming requests, their progress and whether each can move. A
        read of scheduler state off the loop thread: a race can mis-list a
        request for one tick; the freeze checks again."""
        out: list = []
        if self.engine.migration is not None:
            running = {s.seq_id: s for s in list(self.engine.scheduler.running)}
            for rid, (sub_ids, _, streaming, meta) in list(self._live_requests.items()):
                if not streaming or len(sub_ids) != 1:
                    continue
                seq = running.get(sub_ids[0])
                if seq is None or seq.finished:
                    continue
                reason = unmigratable_reason(seq)
                out.append({
                    "request_id": rid,
                    "output_tokens": len(seq.output_ids),
                    "prompt_tokens": len(seq.prompt_ids),
                    "age_s": round(time.monotonic() - seq.arrival_time, 3),
                    "migratable": reason is None,
                    "reason": reason,
                    # the SLO class, for the controller's latency protection
                    "priority": meta.get("priority") or "interactive",
                })
        return web.json_response({"requests": out})

    async def migrate_out(self, request: web.Request) -> web.Response:
        """Freeze a running stream, ship its snapshot to the target engine's
        /migrate_in, then commit (the stream's leg ends with the control
        event the router splices on) or roll back (the sequence decodes on
        here; the client saw nothing)."""
        mig = self.engine.migration
        if mig is None:
            return web.json_response({"migrated": False, "error": "migration disabled"}, status=501)
        try:
            body = await request.json()
            rid = body["request_id"]
            target = str(body["target_url"]).rstrip("/")
        except (KeyError, TypeError, ValueError):
            return web.json_response({"migrated": False, "error": "request_id and target_url required"},
                                     status=400)
        entry = self._live_requests.get(rid)
        if entry is None:
            return web.json_response({"migrated": False, "error": f"request {rid!r} is not live"}, status=409)
        sub_ids, _, streaming, meta = entry
        if not streaming or len(sub_ids) != 1:
            return web.json_response({"migrated": False, "error": "only single-choice streaming requests migrate"},
                                     status=409)
        loop = asyncio.get_running_loop()
        snap_meta = {**meta, "request_id": rid}
        # the target's fabric listener first, so the freeze can ship the
        # page chain engine to engine; a target without one (or that does
        # not answer) gets the pages through the tiers
        fabric_addr = None
        if self.engine._fabric_client is not None:
            try:
                session = await self._mig_client()
                async with session.get(f"{target}/kv_fabric") as resp:
                    if resp.status == 200:
                        info = await resp.json()
                        if info.get("enabled"):
                            fabric_addr = info.get("addr")
            except Exception as e:  # noqa: BLE001 - the tier path covers it
                logger.debug("fabric resolve for %s failed: %s", target, e)
        try:
            # the loop thread's work, off the event loop
            snap = await loop.run_in_executor(
                None, lambda: mig.freeze_and_snapshot(sub_ids[0], snap_meta, fabric_addr)
            )
        except MigrationError as e:
            return web.json_response({"migrated": False, "error": str(e)}, status=409)
        ok, detail = False, ""
        try:
            session = await self._mig_client()
            async with session.post(
                f"{target}/migrate_in", data=snapshot_to_wire(snap),
                headers={"Content-Type": "application/octet-stream"},
            ) as resp:
                detail = (await resp.text())[:200]
                ok = resp.status == 200
        except Exception as e:  # noqa: BLE001 - any failed ship rolls back
            detail = repr(e)
        if not ok:
            # the sequence goes back into the running set and streams on
            await loop.run_in_executor(None, mig.rollback, sub_ids[0])
            logger.warning("migrate_out %s -> %s refused: %s", rid, target, detail)
            return web.json_response({"migrated": False, "error": detail or "target refused"}, status=502)
        # the control event's data before the commit, whose terminal emit
        # races the streaming loop's read of it; dropped after a minute if
        # the client left between freeze and commit and nothing reads it
        self._migrated_out[rid] = {"target": target, "request_id": rid}
        loop.call_later(60.0, self._migrated_out.pop, rid, None)
        await loop.run_in_executor(None, mig.commit, sub_ids[0], len(snap.page_hashes))
        logger.info("migrated %s -> %s (%d pages restorable)", rid, target, len(snap.page_hashes))
        return web.json_response({"migrated": True, "target": target, "pages_moved": len(snap.page_hashes)})

    async def migrate_in(self, request: web.Request) -> web.Response:
        """Accept a sealed snapshot and park the continuation: its KV blobs
        are fetched into the local tiers, the sequence is admitted again
        through the ordinary prefix-cache path (the shipped pages restore,
        the tail is prefilled), and its outputs wait for /migrate_attach."""
        mig = self.engine.migration
        if mig is None:
            return web.json_response({"accepted": False, "error": "migration disabled"}, status=501)
        if self.draining:
            return web.json_response({"accepted": False, "error": "draining"}, status=503)
        if self.engine.is_sleeping:
            return web.json_response({"accepted": False, "error": "sleeping"}, status=503)
        if self.engine.saturated():
            # a saturated target refuses: 429 tells the controller to pick a
            # cooler one
            return _shed_response(self.engine.shed_retry_after(),
                                  "engine saturated; pick a cooler migration target")
        data = await request.read()
        try:
            snap = snapshot_from_wire(data)
            params = continuation_params(snap)
        except (KVIntegrityError, ValueError, KeyError, TypeError) as e:
            return web.json_response({"accepted": False, "error": f"bad snapshot: {e}"}, status=400)
        if snap.model != self.cfg.name:
            return web.json_response(
                {"accepted": False, "error": f"model mismatch: {snap.model!r} != {self.cfg.name!r}"}, status=409
            )
        rid = snap.request_id
        if rid in self._parked or rid in self._live_requests:
            return web.json_response({"accepted": False, "error": f"{rid!r} already live here"}, status=409)
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        task = loop.create_task(self._pump_migrated(snap, params, q))
        self._parked[rid] = {"q": q, "task": task, "snap": snap, "t": time.monotonic()}
        # the continuation is itself a live stream that can move again; its
        # meta counts the tokens of every earlier hop, since a later freeze
        # snapshots only this engine's output
        self._live_requests[rid] = (
            [rid], time.monotonic(), True,
            {**snap.meta,
             "prior_completion": snap.output_len + int(snap.meta.get("prior_completion") or 0)},
        )
        # a router that died mid-handoff must not leave a sequence decoding
        loop.call_later(max(1.0, self.cfg.migrate_attach_timeout_s), self._expire_parked, rid)
        mig.note_migrate_in()
        return web.json_response({"accepted": True, "request_id": rid, "restorable_pages": len(snap.page_hashes)})

    async def _pump_migrated(self, snap, params, q: asyncio.Queue) -> None:
        """A parked continuation's pump: the snapshot's blobs into the
        local tiers (in an executor: tier reads block), then decoding, its
        outputs buffered for the attach. Shed-exempt: the stream is
        mid-flight."""
        loop = asyncio.get_running_loop()
        try:
            if snap.page_hashes and snap.page_size == self.cfg.page_size:
                await loop.run_in_executor(None, self.engine.migration.prefetch_pages, snap.page_hashes)
            p = snap.meta.get("priority")
            # every earlier leg's ids (a chained migration's snapshot counts
            # the legs before its source in prior_completion): the text goes
            # on from theirs
            emitted = snap.output_len + int(snap.meta.get("prior_completion") or 0)
            async for out in self.engine.generate(
                snap.request_id, prompt_token_ids=snap.tokens, params=params, shed_exempt=True,
                priority=p if p in ("interactive", "batch") else "interactive",
                text_context=snap.tokens[len(snap.tokens) - emitted:],
            ):
                await q.put(out)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - surfaced on the attach stream
            await q.put(e)
        finally:
            self._live_requests.pop(snap.request_id, None)
            await q.put(None)

    def _expire_parked(self, rid: str) -> None:
        parked = self._parked.pop(rid, None)
        if parked is None:
            return  # attached, or already expired
        parked["task"].cancel()
        self.engine.abort(rid)
        self.engine.migration.failures += 1
        logger.warning("migrated-in continuation %s expired unattached; aborted", rid)

    async def migrate_attach(self, request: web.Request) -> web.StreamResponse:
        """Stream a parked continuation in the client's wire shape. The
        final usage block counts the whole request (every hop's tokens), so
        the spliced stream reads as an unmigrated one."""
        if self.engine.migration is None:
            return _error("migration disabled", 501)
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 - an attach may name its id in the query
            body = {}
        rid = body.get("request_id") or request.query.get("request_id")
        if not rid:
            return _error("request_id required")
        # a short grace for reordering: the source commits (ending its leg)
        # only after /migrate_in answered, so the entry is normally here
        deadline = time.monotonic() + 10.0
        parked = self._parked.pop(rid, None)
        while parked is None and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
            parked = self._parked.pop(rid, None)
        if parked is None:
            return _error(f"no parked continuation for {rid!r}", 404)
        snap, q = parked["snap"], parked["q"]
        meta = snap.meta
        chat = bool(meta.get("chat"))
        oid = meta.get("oid") or (("chatcmpl-" if chat else "cmpl-") + rid)
        created = int(meta.get("created") or time.time())
        model = meta.get("model") or snap.model
        kind = "chat.completion" if chat else "text_completion"
        resp = web.StreamResponse(
            status=200, headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache", "X-Request-Id": rid},
        )
        await resp.prepare(request)

        async def send(obj: dict):
            await resp.write(f"data: {json.dumps(obj)}\n\n".encode())

        new_tokens = 0
        try:
            while True:
                out = await q.get()
                if out is None:
                    break
                if isinstance(out, Exception):
                    await send({"error": {"message": f"migrated continuation failed: {out}",
                                          "type": "upstream_error", "code": 502}})
                    await resp.write_eof()
                    return resp
                if (
                    out.finished
                    and out.finish_reason == "migrated"
                    and (mi := self._migrated_out.pop(rid, None)) is not None
                ):
                    # the continuation moved again: hand the splice the
                    # next hop and end this leg
                    await send({"pstpu_migration": mi})
                    await resp.write_eof()
                    return resp
                new_tokens = out.completion_tokens
                if out.finished and out.finish_reason in ("abort", "error", "shed"):
                    await send({"error": {"message": f"migrated continuation ended with {out.finish_reason!r}",
                                          "type": "upstream_error", "code": 502}})
                    await resp.write_eof()
                    return resp
                if chat:
                    delta = {"content": out.text_delta} if out.text_delta else {}
                    choice = {"index": 0, "delta": delta, "finish_reason": out.finish_reason}
                    obj = "chat.completion.chunk"
                else:
                    choice = {"index": 0, "text": out.text_delta, "logprobs": None,
                              "finish_reason": out.finish_reason}
                    obj = "text_completion"
                await send({"id": oid, "object": obj, "created": created, "model": model, "choices": [choice]})
            prompt_tokens = int(meta.get("prompt_tokens") or snap.prompt_len)
            # the whole request: every earlier hop's tokens, the tokens
            # emitted when this hop froze, and this continuation's
            completion = int(meta.get("prior_completion") or 0) + snap.output_len + new_tokens
            await send({
                "id": oid, "object": f"{kind}.chunk" if chat else kind, "created": created, "model": model,
                "choices": [],
                "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": completion,
                          "total_tokens": prompt_tokens + completion},
            })
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            # the splicing router (or the client) went away: free the sequence
            parked["task"].cancel()
            self.engine.abort(rid)
            raise
        await resp.write_eof()
        return resp

    async def slo_records(self, request: web.Request) -> web.Response:
        """The engine's SLO terminal records after a cursor (``?since=<seq>``),
        as the JAX server gives them: the router's scraper polls with its
        last ``next`` and reads ``head`` below its cursor as an engine
        restart. The log is a bounded ring: a scraper further behind than
        its capacity sees a gap."""
        try:
            since = int(request.query.get("since", "0"))
        except (TypeError, ValueError):
            return web.json_response({"error": "since must be an int"}, status=400)
        log = self.engine.slo_records
        records: list = []
        # a snapshot that keeps racing appends answers head = the caller's
        # cursor ("nothing new"), never 0, which the scraper would read as a
        # restart and count every kept record again
        head = since
        if log:
            for _ in range(3):  # iterating a deque another thread appends to can raise
                try:
                    snap = list(log)
                    # max, not the last: the loop thread and the event loop
                    # (API sheds) both append, so the tail can be out of order
                    head = max((r["seq"] for r in snap), default=0)
                    records = [r for r in snap if r["seq"] > since]
                    break
                except RuntimeError:
                    continue
        else:
            head = 0  # an empty log: a fresh counter, truly
        return web.json_response({
            "model": self.cfg.name,
            "since": since,
            "next": max((r["seq"] for r in records), default=since),
            "head": head,
            "records": records,
        })

    async def stats(self, request: web.Request) -> web.Response:
        """JSON engine state (the machine-readable twin of /metrics for
        autoscalers and the router's shed-aware logic)."""
        s = dict(self.engine.stats())
        s["saturation"] = {
            "saturated": bool(s["engine_saturated"]),
            "max_waiting_seqs": self.cfg.max_waiting_seqs,
            "queue_deadline_s": self.cfg.queue_deadline_s,
            "retry_after_s": self.engine.shed_retry_after(),
            "draining": self.draining,
        }
        return web.json_response(s)

    # -- debug routes (--enable-debug-endpoints) ----------------------------

    async def traces(self, request: web.Request) -> web.Response:
        """The span ring's export: ?trace_id= filters to one trace, ?limit=
        caps the trace count (default 50)."""
        payload, status = export_for_query(request.query)
        return web.json_response(payload, status=status)

    async def flightrecorder(self, request: web.Request) -> web.Response:
        """The flight recorder's export. Filters: ?request_id= ?trace_id=
        ?kind= ?since_step= ?until_step= ?limit=."""
        payload, status = flightrecorder.export_for_query(request.query)
        return web.json_response(payload, status=status)

    async def metrics_reset(self, request: web.Request) -> web.Response:
        """Empty the TTFT hop windows, the latency and phase histograms, the
        span ring and the flight recorder, so a benchmark phase's quantiles
        are its own. Counters and serving stats are untouched."""
        _ttft_hops.clear()
        _ttft_hist.reset()
        _latency_hist.reset()
        reset_phase_histograms()
        get_collector().reset()
        get_flightrecorder().reset()
        self.engine.admission_wait_ms.clear()
        return web.json_response({"status": "ok"})

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
            messages = body.get("messages", [])
            if not isinstance(messages, list):
                raise ValueError("'messages' must be a list")
            tools, tool_style = _resolve_tools(body, self.cfg.tool_call_parser)
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        prompt = self.engine.tokenizer.apply_chat_template(messages, tools=tools)
        return await self._generate(request, body, prompt, chat=True, tool_style=tool_style)

    async def completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        return await self._generate(request, body, prompt, chat=False)

    async def _generate(
        self, request: web.Request, body: dict, prompt: str, chat: bool, tool_style: Optional[str] = None,
    ) -> web.StreamResponse:
        t_accept = time.perf_counter()
        t_accept_wall = time.time()
        # adopt the caller's traceparent (its sampled flag wins) or root a
        # trace here: this request's engine.request span, whose context
        # parents the queue, prefill and decode spans the engine records
        collector = get_collector()
        trace_ctx = collector.root_from_headers(request.headers).child()
        if self.draining:
            return _error("engine is draining for shutdown", 503)
        if self.engine.is_sleeping:
            return web.json_response({"error": "engine is sleeping"}, status=503)
        priority = _request_priority(request.headers, body)
        if self.engine.saturated(priority):
            self.engine.api_requests_shed += 1
            self.engine.note_api_shed(request.headers.get("X-Request-Id"), priority=priority)
            return _shed_response(
                self.engine.shed_retry_after(),
                f"engine saturated: {self.engine.scheduler.num_waiting()} requests already waiting",
            )
        model = body.get("model", self.cfg.name)
        lora_name = None
        if model != self.cfg.name:
            if self.engine.lora is not None and self.engine.lora.is_adapter(model):
                lora_name = model
            else:
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
        if (params.wants_penalties or params.logit_bias or params.min_tokens > 0) and self.cfg.speculative_k:
            return _error("sampling penalties, logit_bias, and min_tokens are not supported with "
                          "speculative decoding")
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
            if self.cfg.speculative_k:
                return _error("logprobs are not supported with speculative decoding")
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
        self._live_requests[req_id] = (
            sub_ids, time.monotonic(), stream,
            {"oid": oid, "chat": chat, "created": created, "model": model,
             "prompt_tokens": len(prompt_ids), "priority": priority},
        )

        def _gen(sid):
            # with n > 1 only choice 0 carries the context: sibling phase
            # spans under one engine.request would sum past its wall time
            return self.engine.generate(
                sid, prompt_token_ids=prompt_ids, params=params, priority=priority, lora_name=lora_name,
                trace=trace_ctx if sid == sub_ids[0] else None,
            )

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
                    message = {"role": "assistant", "content": full}
                    if tool_style is not None:
                        content, tool_calls = parse_tool_calls(full, tool_style)
                        if tool_calls:
                            message = {"role": "assistant", "content": content or None, "tool_calls": tool_calls}
                            if finish_reason == "stop":
                                finish_reason = "tool_calls"
                    choices.append({
                        "index": i,
                        "message": message,
                        "logprobs": lp_obj,
                        "finish_reason": finish_reason,
                    })
                else:
                    choices.append({"index": i, "text": full, "logprobs": lp_obj, "finish_reason": finish_reason})
            usage = _summed_usage(lasts) if lasts[0] else {}
            if t_first_box[0] is not None:
                _ttft_hist.observe(t_first_box[0] - t_accept)
            _latency_hist.observe(time.perf_counter() - t_accept)
            collector.record(
                "engine.request", trace_ctx, t_accept_wall, time.perf_counter() - t_accept,
                request_id=req_id, model=model, stream=False, n=n,
            )
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
        parsers = tool_idx = None
        if chat and tool_style is not None:
            parsers = [StreamingToolParser(tool_style) for _ in range(n)]
            tool_idx = [0] * n
        migrated_away = False
        try:
            lp_offsets = [0] * n
            t_first_out = None
            for_first_hop = True
            async for i, out in _chain_first(first_item, merged):
                lasts[i] = out
                if (
                    out.finished
                    and out.finish_reason == "migrated"
                    and (mi := self._migrated_out.pop(req_id, None)) is not None
                ):
                    # the continuation decodes on the target now: the
                    # control event the router's splice watches for ends
                    # this leg without [DONE], and the router (or a client
                    # talking to the engine) attaches to the target's
                    # /migrate_attach for the rest of the stream
                    await send({"pstpu_migration": mi})
                    migrated_away = True
                    break
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
                    finish_reason = out.finish_reason
                    if parsers is None:
                        deltas = [{"content": out.text_delta} if out.text_delta else {}]
                    else:
                        # candidate tool-call text is held back until it
                        # parses (a tool_calls delta) or the stream ends
                        # without a parse (flushed back as content)
                        p = parsers[i]
                        events = p.push(out.text_delta or "")
                        if out.finished:
                            events.extend(p.finish())
                            if p.tool_calls and finish_reason == "stop":
                                finish_reason = "tool_calls"
                        deltas = []
                        for ev in events:
                            if ev[0] == "content" and ev[1]:
                                deltas.append({"content": ev[1]})
                            elif ev[0] == "call":
                                deltas.append({"tool_calls": [{"index": tool_idx[i], **ev[1]}]})
                                tool_idx[i] += 1
                        deltas = deltas or [{}]  # a chunk per engine output, for TTFT
                    for j, d in enumerate(deltas):
                        last_d = j == len(deltas) - 1
                        choice = {
                            "index": i,
                            "delta": d,
                            "logprobs": lp_obj if last_d else None,
                            "finish_reason": finish_reason if last_d else None,
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
            if lasts[0] is not None and not migrated_away:
                await send({
                    "id": oid, "object": f"{kind}.chunk" if chat else kind, "created": created,
                    "model": model, "choices": [], "usage": _summed_usage(lasts),
                })
            if not migrated_away:
                await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            _abort_all()
            self._migrated_out.pop(req_id, None)
            raise
        self._live_requests.pop(req_id, None)
        self._migrated_out.pop(req_id, None)
        _latency_hist.observe(time.perf_counter() - t_accept)
        collector.record(
            "engine.request", trace_ctx, t_accept_wall, time.perf_counter() - t_accept,
            request_id=req_id, model=model, stream=True, n=n,
        )
        await resp.write_eof()
        return resp

    # -- pooling routes -------------------------------------------------------

    def _check_pooling_model(self, body: dict) -> Optional[web.Response]:
        """404 for a model name this server does not serve, 400 for a LoRA
        adapter's (the pooling routes run the base weights only)."""
        model = body.get("model", self.cfg.name)
        if model == self.cfg.name:
            return None
        if self.engine.lora is not None and self.engine.lora.is_adapter(model):
            return _error(f"model {model!r} is a LoRA adapter; pooling endpoints serve the base model")
        return _error(f"model {model!r} does not exist", 404, type="NotFoundError", code=404)

    def _tokenize_inputs(self, raw) -> list[list[int]]:
        """OpenAI ``input``: str | [str] | [int] | [[int]] -> token lists."""
        if isinstance(raw, str):
            raw = [raw]
        if not isinstance(raw, list):
            raise ValueError("'input' must be a string or a list")
        if raw and isinstance(raw[0], int):
            raw = [raw]
        out = []
        for item in raw:
            if isinstance(item, str):
                out.append(self.engine.tokenizer.encode(item))
            elif isinstance(item, list):
                out.append([int(t) for t in item])
            else:
                raise ValueError("'input' items must be strings or token-id lists")
        return out

    async def embeddings(self, request: web.Request) -> web.Response:
        """OpenAI /v1/embeddings: mean-pooled, L2-normalized last hidden
        states."""
        if self.draining:
            return _error("engine is draining for shutdown", 503)
        try:
            body = await request.json()
            inputs = self._tokenize_inputs(body.get("input", []))
        except (ValueError, TypeError) as e:
            return _error(f"invalid request: {e}")
        err = self._check_pooling_model(body)
        if err is not None:
            return err
        if not inputs:
            return _error("'input' is required")
        try:
            vecs = await self.engine.embed(inputs)
        except (ValueError, RuntimeError) as e:
            return _error(str(e))
        total = sum(len(i) for i in inputs)
        return web.json_response({
            "object": "list",
            "model": body.get("model", self.cfg.name),
            "data": [{"object": "embedding", "index": i, "embedding": v.tolist()} for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    async def rerank(self, request: web.Request) -> web.Response:
        """/v1/rerank and /v2/rerank: documents ordered by cosine relevance
        to the query."""
        if self.draining:
            return _error("engine is draining for shutdown", 503)
        try:
            body = await request.json()
            query = body["query"]
            documents = list(body["documents"])
            top_n = max(0, int(body.get("top_n", len(documents))))
        except (KeyError, ValueError, TypeError) as e:
            return _error(f"invalid request (need query, documents): {e}")
        err = self._check_pooling_model(body)
        if err is not None:
            return err
        if not documents:
            return _error("'documents' is empty")
        try:
            vecs = await self.engine.embed(self._tokenize_inputs([query] + documents))
        except (ValueError, RuntimeError) as e:
            return _error(str(e))
        scores = vecs[1:] @ vecs[0]
        order = sorted(range(len(documents)), key=lambda i: -float(scores[i]))[:top_n]
        return web.json_response({
            "id": f"rerank-{uuid.uuid4().hex[:16]}",
            "model": body.get("model", self.cfg.name),
            "results": [
                {"index": i, "document": {"text": documents[i]}, "relevance_score": float(scores[i])}
                for i in order
            ],
        })

    async def score(self, request: web.Request) -> web.Response:
        """/v1/score: cosine similarity of (text_1, text_2) pairs; one
        text_1 scores against every text_2."""
        if self.draining:
            return _error("engine is draining for shutdown", 503)
        try:
            body = await request.json()
            t1, t2 = body["text_1"], body["text_2"]
        except (KeyError, ValueError, TypeError) as e:
            return _error(f"invalid request (need text_1, text_2): {e}")
        err = self._check_pooling_model(body)
        if err is not None:
            return err

        def as_items(x):
            """str -> [str]; [int, ...] -> [[int, ...]]; [str | list, ...] -> itself."""
            if isinstance(x, str):
                return [x]
            if isinstance(x, list) and x and isinstance(x[0], int):
                return [x]
            if isinstance(x, list):
                return x
            raise TypeError("text fields must be strings or token-id lists")

        try:
            left, right = as_items(t1), as_items(t2)
        except TypeError as e:
            return _error(str(e))
        if len(left) == 1:
            left = left * len(right)
        if len(left) != len(right):
            return _error("text_1 and text_2 lengths do not match")
        try:
            inputs = self._tokenize_inputs(left + right)
            vecs = await self.engine.embed(inputs)
        except (ValueError, RuntimeError) as e:
            return _error(str(e))
        n = len(left)
        return web.json_response({
            "id": f"score-{uuid.uuid4().hex[:16]}",
            "object": "list",
            "model": body.get("model", self.cfg.name),
            "data": [{"index": i, "object": "score", "score": float(vecs[i] @ vecs[n + i])} for i in range(n)],
            "usage": {"prompt_tokens": sum(len(i) for i in inputs)},
        })

    # -- sleep mode -----------------------------------------------------------

    async def sleep(self, request: web.Request) -> web.Response:
        if not self.cfg.enable_sleep_mode:
            return web.json_response({"error": "sleep mode disabled"}, status=400)
        try:
            level = int(request.query.get("level", "1"))
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        # in an executor: sleep waits for the loop thread to finish its step,
        # and this loop must keep answering probes meanwhile
        await asyncio.get_running_loop().run_in_executor(None, self.engine.sleep, level)
        return web.Response(text="")

    async def wake_up(self, request: web.Request) -> web.Response:
        if not self.cfg.enable_sleep_mode:
            return web.json_response({"error": "sleep mode disabled"}, status=400)
        await asyncio.get_running_loop().run_in_executor(None, self.engine.wake_up)
        return web.Response(text="")

    async def is_sleeping(self, request: web.Request) -> web.Response:
        return web.json_response({"is_sleeping": self.engine.is_sleeping})

    # -- LoRA adapters (the LoraAdapter controller's calls) ---------------------

    async def load_lora_adapter(self, request: web.Request) -> web.Response:
        """POST {"lora_name", "lora_path"}: 200 with the adapter's slot, 400
        with the reason (missing field, no LoRA, bad checkpoint, no free
        slot, already loaded)."""
        body = await request.json()
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            return web.json_response({"error": "lora_name and lora_path are required"}, status=400)
        try:
            slot = await asyncio.get_running_loop().run_in_executor(None, self.engine.load_lora_adapter, name, path)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"status": "success", "lora_name": name, "slot": slot})

    async def unload_lora_adapter(self, request: web.Request) -> web.Response:
        """POST {"lora_name"}: 200, or 400 when it is not loaded or requests
        that use it are in flight."""
        body = await request.json()
        name = body.get("lora_name")
        if not name:
            return web.json_response({"error": "lora_name is required"}, status=400)
        try:
            await asyncio.get_running_loop().run_in_executor(None, self.engine.unload_lora_adapter, name)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"status": "success", "lora_name": name})

    # -- app ---------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 << 20)
        r = app.router
        r.add_get("/health", self.health)
        r.add_get("/ping", self.health)
        r.add_get("/version", self.version)
        r.add_get("/v1/models", self.models)
        r.add_get("/metrics", self.metrics)
        r.add_get("/stats", self.stats)
        r.add_get("/slo_records", self.slo_records)
        r.add_get("/kv_fabric", self.kv_fabric_info)
        if self.cfg.enable_debug_endpoints:
            # unauthenticated debug surfaces, for benchmark and test runs:
            # the traces and the recorder expose request ids and timings,
            # and a reset wipes live observability windows
            r.add_get("/v1/traces", self.traces)
            r.add_get("/v1/debug/flightrecorder", self.flightrecorder)
            r.add_post("/metrics/reset", self.metrics_reset)
        r.add_post("/abort", self.abort)
        # live migration: registered with --no-migration too (the handlers
        # answer 501), so the route surface stays the JAX server's
        r.add_get("/migratable", self.migratable)
        r.add_post("/migrate_out", self.migrate_out)
        r.add_post("/migrate_in", self.migrate_in)
        r.add_post("/migrate_attach", self.migrate_attach)
        r.add_post("/tokenize", self.tokenize)
        r.add_post("/detokenize", self.detokenize)
        r.add_post("/v1/chat/completions", self.chat_completions)
        r.add_post("/v1/completions", self.completions)
        r.add_post("/v1/embeddings", self.embeddings)
        r.add_post("/v1/rerank", self.rerank)
        r.add_post("/v2/rerank", self.rerank)
        r.add_post("/v1/score", self.score)
        r.add_post("/sleep", self.sleep)
        r.add_post("/wake_up", self.wake_up)
        r.add_get("/is_sleeping", self.is_sleeping)
        r.add_post("/v1/load_lora_adapter", self.load_lora_adapter)
        r.add_post("/v1/unload_lora_adapter", self.unload_lora_adapter)
        app.on_cleanup.append(self._close_mig_client)
        return app


async def serve(cfg: EngineConfig, engine: Optional[LLMEngine] = None, device="cuda", params=None):
    """Build the engine (unless given; ``params`` a whole parameter dict to
    serve instead of the preset's seeded weights), start its loop and the
    HTTP site; returns (server, aiohttp AppRunner). The caller stops both.

    With ``distributed_num_processes`` > 1 (and no engine given), the
    JAX server's multi-host branch: a process whose id
    (distributed.resolve_process_id) is not 0 is a follower host. It runs
    its block of ranks (distributed.follower_host_main), with no HTTP site
    and with the offload tiers, the controller, the remote cache and the KV
    role switched off (they are the leader's), blocks until the leader
    closes the step stream, and then raises ``SystemExit(0)``. Process 0
    builds the engine over every host's ranks and serves as one host does;
    its LoRA manager and offload connector hold the broadcasting runner, so
    their page moves and slot writes reach every host. Across hosts work the
    offload tiers (the replicated page calls), sleep levels 1 and 2, LoRA
    (the adapter crosses the step stream: no shared filesystem),
    disaggregated prefill over TCP blobs and the fabric (the device path is
    refused), and the KV-index controller (fed by the leader alone)."""
    if cfg.distributed_num_processes > 1 and engine is None:
        pid = resolve_process_id(cfg)
        if pid != 0:
            await asyncio.get_running_loop().run_in_executor(None, follower_host_main, cfg, pid, device, params)
            raise SystemExit(0)
    configure_tracing(sample_rate=cfg.trace_sample_rate, capacity=cfg.trace_buffer_size)
    server = EngineServer(cfg, engine, device=device, params=params)
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
