"""The engine surface the rest of the stack reads and calls, held against the
JAX engine: a port server and a JAX server on the f32 twin preset, serving
the same weights (JAX's init_params carried over with params_from_jax), get
the same requests in the same order, then

- ``/slo_records``: the same records field for field (timings, request ids
  and trace ids aside: timings only for None-ness), and the same cursor
  answers at ``since`` 0, mid-log, at the head, past the head, for an empty
  log and for a snapshot that keeps racing appends;
- ``/stats`` and ``/metrics``: the same keys and series, but for those of
  features the port refuses, each listed with the switch that refuses it;
- the router's own ``EngineStats.from_scrape`` and ``SLOMonitor.ingest``, the
  JAX router's and the port's, read both engines alike;
- sleep level 1 and level 2: 503 while asleep, then the greedy text of
  before the sleep and of the JAX engine; level 2 puts back every parameter
  byte for byte, with a tied head still the embedding itself;
- tool calls: ``parse_tool_calls`` and ``StreamingToolParser`` give the JAX
  module's results on the JAX tests' strings, and the chat route returns
  the JAX server's message and stream deltas for the same scripted engine
  output.

Engines are module-scoped; no Pallas kernel runs in interpret mode here.
"""

import asyncio
import dataclasses
import json
import threading
import types

import aiohttp
import jax
import pytest
import torch

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine import tool_parser as jtool
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import RequestOutput as JaxRequestOutput
from production_stack_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.router.engine_stats import EngineStats
from production_stack_tpu.router.slo import SLOMonitor
from production_stack_tpu.router.utils import SingletonMeta
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine import tool_parser as ptool
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.engine import RequestOutput as PortRequestOutput
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.runner import ModelRunner, StepInput
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer as PortByteTokenizer
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.router.engine_stats import EngineStats as PortEngineStats
from production_stack_tpu_torch.router.slo import SLOMonitor as PortSLOMonitor
from production_stack_tpu_torch.router.utils import SingletonMeta as PortSingletonMeta

MODEL = "llama-debug-4kv-f32"
# the CPU tier is on in both, so the offload series are compared too; an
# explicit I/O budget skips the link probe, whose result differs by package
SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=8, num_pages=64, page_size=8,
             prefill_chunk=32, kv_cache_memory_gb=0.01, enable_sleep_mode=True, kv_offload_cpu_gb=0.01,
             kv_offload_max_io_pages=0)
PROMPT = "The quick brown fox jumps over the lazy dog, twice over and back."  # 65 bytes: 3 prefill chunks
GREEDY = {"prompt": PROMPT, "max_tokens": 12, "temperature": 0.0, "ignore_eos": True}
# the same requests, one after another, to both servers: (path, body, headers)
REQUESTS = [
    ("/v1/completions", GREEDY, {}),
    ("/v1/completions", GREEDY, {}),  # the prefix cache serves its first chunks
    ("/v1/completions", {"prompt": "hello", "max_tokens": 20, "temperature": 0.0, "ignore_eos": True,
                         "logit_bias": {"120": 100}, "stop": ["xx"]}, {}),  # finish_reason "stop"
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}], "max_tokens": 5,
                              "temperature": 0.0, "ignore_eos": True}, {"X-Priority": "batch"}),
    ("/v1/completions", dict(GREEDY, prompt="A different prompt, streamed.", stream=True), {}),
]
# record fields that are times or ids: compared by None-ness only
TIMINGS = {"queue_ms", "ttft_ms", "e2e_ms", "itl_p99_ms", "t"}
IDS = {"request_id", "trace_id"}

# /stats keys and /metrics series the JAX engine gives for features the port
# refuses, each with the port's EngineConfig switch that refuses it
# (engine/config._UNSUPPORTED) or, where the port has no switch, the part
# not ported. Every /stats key of these servers' features is served (the
# chained-decode keys since the port chains bursts)
REFUSED_STATS: dict = {}
REFUSED_SERIES = {
    **{f"vllm:{k}": v for k, v in REFUSED_STATS.items()},
}


def _series(text: str) -> set:
    out = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            for suffix in ("_bucket", "_count", "_sum"):
                if name.endswith(suffix) and f"# TYPE {name[: -len(suffix)]} histogram" in text:
                    name = name[: -len(suffix)]
            out.add(name)
    return out


class _Loop:
    """An event loop on a thread of its own, for servers the tests call
    over HTTP from the test thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()


def _port_engine(cfg):
    params = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return LLMEngine(cfg, device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))


async def _request(session, base, method, path, body=None, headers=None):
    async with session.request(method, base + path, json=body, headers=headers or {}) as r:
        if body is not None and body.get("stream"):
            text = []
            async for raw in r.content:
                line = raw.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    text.extend(c.get("text", "") for c in json.loads(line[6:])["choices"])
            return r.status, "".join(text)
        ctype = r.headers.get("Content-Type", "")
        return r.status, (await r.json()) if "json" in ctype else await r.text()


def call(base, method, path, body=None, headers=None):
    async def run():
        async with aiohttp.ClientSession() as s:
            return await _request(s, base, method, path, body, headers)

    return asyncio.run(run())


@pytest.fixture(scope="module")
def servers():
    """Both servers, the empty log's answers, then REQUESTS sent to each and
    their /slo_records, /stats and /metrics taken before any other test."""
    lp = _Loop()
    jcfg, pcfg = JaxEngineConfig(**SMALL, port=free_port()), EngineConfig(**SMALL, port=free_port())
    jsrv, jrun = lp.run(jax_server.serve(jcfg))
    psrv, prun = lp.run(port_server.serve(pcfg, _port_engine(pcfg), device="cpu"))
    urls = {"jax": f"http://127.0.0.1:{jcfg.port}", "port": f"http://127.0.0.1:{pcfg.port}"}
    got = {}
    # the phase histograms are the process's: an engine of an earlier test
    # file in this worker process would have counted its requests there
    from production_stack_tpu_torch.tracing import reset_phase_histograms

    reset_phase_histograms()
    for tag, base in urls.items():
        g = got[tag] = {"empty": [call(base, "GET", f"/slo_records?since={n}")[1] for n in (0, 3)]}
        g["answers"] = [call(base, "POST", path, body, headers) for path, body, headers in REQUESTS]
        head = call(base, "GET", "/slo_records")[1]["head"]
        g["slo"] = {n: call(base, "GET", f"/slo_records?since={n}")[1] for n in (0, 2, head, head + 5)}
        g["stats"] = call(base, "GET", "/stats")[1]
        g["metrics"] = call(base, "GET", "/metrics")[1]
    yield types.SimpleNamespace(urls=urls, got=got, jax=jsrv, port=psrv)
    lp.run(prun.cleanup())
    psrv.engine.stop()
    lp.run(jrun.cleanup())
    jsrv.engine.stop()
    lp.close()


def _untimed(rec: dict) -> dict:
    return {k: (v is None if k in TIMINGS else v) for k, v in rec.items() if k not in IDS}


def _text(answer) -> str:
    status, body = answer
    assert status == 200
    if isinstance(body, str):  # streamed
        return body
    choice = body["choices"][0]
    return choice["message"]["content"] if "message" in choice else choice["text"]


def test_both_servers_answered_the_requests_alike(servers):
    j, p = servers.got["jax"]["answers"], servers.got["port"]["answers"]
    assert [_text(a) for a in p] == [_text(a) for a in j]


def test_slo_records_match_the_jax_engine_field_for_field(servers):
    j, p = servers.got["jax"]["slo"][0], servers.got["port"]["slo"][0]
    assert len(p["records"]) == len(REQUESTS)
    assert [_untimed(r) for r in p["records"]] == [_untimed(r) for r in j["records"]]
    assert sorted(p["records"][0]) == sorted(j["records"][0])
    outcomes = [(r["outcome"], r["finish_reason"], r["priority"]) for r in p["records"]]
    assert outcomes[2] == ("ok", "stop", "interactive") and outcomes[3] == ("ok", "length", "batch")
    assert p["records"][1]["cached_tokens"] > 0 and p["records"][0]["ttft_ms"] > 0


@pytest.mark.parametrize("which", ["empty_since_0", "empty_since_3", "since_0", "mid", "at_head", "past_head"])
def test_slo_records_cursor_answers_match(servers, which):
    def answer(tag):
        g = servers.got[tag]
        if which.startswith("empty"):
            a = g["empty"][0 if which.endswith("0") else 1]
        else:
            a = list(g["slo"].values())[["since_0", "mid", "at_head", "past_head"].index(which)]
        return {**a, "records": [_untimed(r) for r in a["records"]]}

    p, j = answer("port"), answer("jax")
    assert p == j
    if which.startswith("empty"):
        assert p["head"] == 0 and p["records"] == []  # a fresh counter, truly
    if which in ("at_head", "past_head"):
        assert p["records"] == [] and p["next"] == p["since"]


class _Racing:
    """A log whose every snapshot races an append (iterating raises)."""

    def __len__(self):
        return 1

    def __iter__(self):
        raise RuntimeError("deque mutated during iteration")


def test_a_snapshot_that_keeps_racing_appends_answers_the_callers_cursor(servers):
    from aiohttp.test_utils import make_mocked_request

    answers = {}
    for tag in ("jax", "port"):
        srv = getattr(servers, tag)
        log, srv.engine.slo_records = srv.engine.slo_records, _Racing()
        try:
            resp = asyncio.run(srv.slo_records(make_mocked_request("GET", "/slo_records?since=7")))
        finally:
            srv.engine.slo_records = log
        answers[tag] = json.loads(resp.body)
    assert answers["port"] == answers["jax"] == {
        "model": MODEL, "since": 7, "next": 7, "head": 7, "records": [],
    }


def test_an_api_shed_leaves_the_jax_engines_record():
    """The record a request shed by the API layer leaves (no sequence was
    made for it), on engines of their own."""
    from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine

    recs = []
    for eng in (JaxLLMEngine(JaxEngineConfig(**SMALL)), LLMEngine(EngineConfig(**SMALL), device="cpu")):
        try:
            eng.note_api_shed("req-shed", priority="batch")
            eng.note_api_shed(None, priority="nonsense")
            recs.append([{k: v for k, v in r.items() if k != "t"} for r in eng.slo_records])
            assert eng.stats()["num_requests_shed_batch_total"] == 1
            assert eng.stats()["num_requests_shed_interactive_total"] == 1
        finally:
            eng.stop()
    assert recs[0] == recs[1] and recs[1][1]["priority"] == "interactive" and recs[1][0]["request_id"] == "req-shed"


def test_stats_keys_match_but_for_refused_features(servers):
    from production_stack_tpu_torch.engine.config import _UNSUPPORTED

    j, p = servers.got["jax"]["stats"], servers.got["port"]["stats"]
    assert set(p) == set(j) - set(REFUSED_STATS)
    assert set(REFUSED_STATS) <= set(j)
    assert all(v in _UNSUPPORTED for v in REFUSED_STATS.values())
    for k in ("num_requests_shed_interactive_total", "num_requests_shed_batch_total", "engine_saturated_batch",
              "tensor_parallel", "mesh_devices", "prompt_tokens_total", "generation_tokens_total",
              "gpu_prefix_cache_hits_total", "kv_evicted_pages_total", "decode_chained_dispatches_total",
              "runahead_prefill_dispatches_total"):
        assert p[k] == j[k], k
    assert p["saturation"] == j["saturation"]
    assert p["interactive_ttft_p99_ms"] > 0 and p["interactive_itl_p99_ms"] > 0


def test_metrics_series_match_but_for_refused_features(servers):
    from production_stack_tpu_torch.engine.config import _UNSUPPORTED

    j, p = _series(servers.got["jax"]["metrics"]), _series(servers.got["port"]["metrics"])
    assert p == j - set(REFUSED_SERIES)
    assert set(REFUSED_SERIES) <= j
    for series, switch in REFUSED_SERIES.items():
        assert switch in _UNSUPPORTED or switch.startswith("no switch: "), series
    text = servers.got["port"]["metrics"]
    for hist in ("request_queue_time_seconds", "request_prefill_time_seconds", "time_per_output_token_seconds"):
        assert f'vllm:{hist}_count{{model_name="{MODEL}"}} {len(REQUESTS)}' in text  # one per finished request
    assert f'vllm:prefill_chunk_seconds_count{{model_name="{MODEL}"}} 0' not in text
    assert 'vllm:tpu_hbm_bytes_in_use{model_name="%s",device="host"}' % MODEL in text
    assert f'vllm:tensor_parallel_degree{{model_name="{MODEL}"}} 1' in text
    # one pool shard row at tp = 1, the JAX engine's device label and bytes
    rows = [line for line in text.splitlines() if line.startswith("vllm:kv_pool_shard_bytes{")]
    jrows = [line for line in servers.got["jax"]["metrics"].splitlines() if line.startswith("vllm:kv_pool_shard_bytes{")]
    assert rows == jrows and len(rows) == 1


def test_the_routers_scraper_reads_a_port_engine_as_a_jax_engine(servers):
    """The JAX router's scraper and the port's read both engines alike."""
    got = []
    for stats in (EngineStats, PortEngineStats):
        j = stats.from_scrape(servers.got["jax"]["metrics"])
        p = stats.from_scrape(servers.got["port"]["metrics"])
        assert p == j
        assert p.tensor_parallel == 1.0 and p.kv_cache_dtype_bytes_per_token > 0 and p.gpu_prefix_cache_hits_total > 0
        got.append(dataclasses.asdict(p))
    assert got[1] == got[0]


def test_the_routers_slo_monitor_reads_a_port_engine_as_a_jax_engine(servers):
    """The JAX router's SLO monitor and the port's read both engines alike."""
    renders = []
    for monitor, singletons in ((SLOMonitor, SingletonMeta), (PortSLOMonitor, PortSingletonMeta)):
        saved = singletons._instances.pop(monitor, None)
        try:
            mon = monitor(ttft_ms=1e9, itl_ms=1e9)  # every ok record attains: times differ by package
            counts = {tag: mon.ingest(tag, servers.got[tag]["slo"][0]) for tag in ("jax", "port")}
            assert counts["port"] == counts["jax"] == len(REQUESTS)
            assert mon.cursor("port") == mon.cursor("jax") == len(REQUESTS)
            lines = {tag: sorted(l.replace(f'server="{tag}"', "server=S") for l in mon.render() if f'"{tag}"' in l)
                     for tag in ("jax", "port")}
            assert lines["port"] == lines["jax"] and lines["port"]
            assert mon.interactive_attainment("port") == mon.interactive_attainment("jax") == 1.0
            # a head below the cursor is an engine restart: the cursor resets
            assert mon.ingest("port", servers.got["port"]["empty"][0]) == 0 and mon.cursor("port") == 0
            renders.append(lines)
        finally:
            singletons._instances.pop(monitor, None)
            if saved is not None:
                singletons._instances[monitor] = saved
    assert renders[1] == renders[0]


def _param_bytes(model) -> dict:
    return {n: p.detach().clone().view(torch.uint8) for n, p in model.named_parameters()}


@pytest.mark.parametrize("level", [1, 2])
def test_sleep_and_wake_keep_the_greedy_text(servers, level):
    before = servers.got["port"]["answers"][0][1]["choices"][0]["text"]
    model = servers.port.engine.runner.model
    params = _param_bytes(model) if level == 2 else None
    texts = {}
    for tag, base in servers.urls.items():
        assert call(base, "POST", f"/sleep?level={level}")[0] == 200
        assert call(base, "GET", "/is_sleeping")[1] == {"is_sleeping": True}
        status, body = call(base, "POST", "/v1/completions", GREEDY)
        assert status == 503 and body == {"error": "engine is sleeping"}
        if tag == "port":
            runner = servers.port.engine.runner
            assert runner.k_pages is None and runner.v_pages is None
            if level == 2:
                assert all(p.numel() == 0 for p in model.parameters())
            assert call(base, "GET", "/metrics")[1].count(f'vllm:kv_pool_device_bytes{{model_name="{MODEL}"}} 0') == 1
        assert call(base, "POST", "/wake_up")[0] == 200
        assert call(base, "GET", "/is_sleeping")[1] == {"is_sleeping": False}
        status, body = call(base, "POST", "/v1/completions", GREEDY)
        assert status == 200
        texts[tag] = body["choices"][0]["text"]
        assert body["usage"]["prompt_tokens_details"]["cached_tokens"] == 0  # the prefix cache went with the pools
    assert texts["port"] == texts["jax"] == before
    if level == 2:
        after = _param_bytes(model)
        assert after.keys() == params.keys() and all(torch.equal(after[n], params[n]) for n in params)


def test_sleep_level_2_keeps_a_tied_head_one_tensor_with_the_embedding():
    cfg = dataclasses.replace(tllama.PRESETS["llama-debug"], tie_word_embeddings=True, dtype=torch.float32)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    tllama.init_params(model, torch.Generator().manual_seed(3))
    runner = ModelRunner(model, num_pages=8, page_size=8, device="cpu")
    inp = StepInput([[1, 2, 3, 4]], [[0, 1, 2, 3]], [[0, 1, 2, 3]], [4], [0.0], [0], [1.0])
    _, logits = runner.step(inp)
    names = [n for n, _ in model.named_parameters()]
    params = _param_bytes(model)
    runner.offload_params()
    assert all(p.numel() == 0 for p in model.parameters())
    runner.restore_params()
    assert [n for n, _ in model.named_parameters()] == names and "lm_head" not in names
    after = _param_bytes(model)
    assert all(torch.equal(after[n], params[n]) for n in names)
    runner.reset_kv()
    _, again = runner.step(inp)
    assert torch.equal(again, logits)


def test_sleep_mode_is_accepted_and_gated():
    from production_stack_tpu_torch.engine.config import _UNSUPPORTED, check_supported

    assert "enable_sleep_mode" not in _UNSUPPORTED
    check_supported(EngineConfig(enable_sleep_mode=True))


# -- tool calls --------------------------------------------------------------------

# the JAX tests' strings (tests/test_tool_calls.py) and the style each parses in
TOOL_STRINGS = [
    ('Sure! <tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}</tool_call> done', "auto"),
    ('hi <tool_call>{"name": "f", "arguments": {}}</tool_call>', "auto"),
    ("a <tool wrench", "auto"),
    ('<tool_call>{"name": "f"', "auto"),
    ('{"name": "get_weather", "parameters": {"city": "Paris"}}', "auto"),
    ('[{"name": "a", "arguments": {}}, {"name": "b", "arguments": {"x": 1}}]', "auto"),
    ('{"answer": 42}', "auto"),
    ("{not json at all", "auto"),
    ('[{"name": "a", "arguments": {}}, {"no_name": 1}]', "auto"),
    ('The answer is {"name": "f", "arguments": {}}', "json"),
    ('<tool_call>{"name": "f", "arguments": {}}</tool_call>', "off"),
    ('<tool_call>{"name": "a", "arguments": {}}</tool_call><tool_call>{"name": "b", "arguments": {}}</tool_call>',
     "auto"),
]


def _no_ids(obj):
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "id" else _no_ids(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_no_ids(v) for v in obj]
    return obj


@pytest.mark.parametrize("text,style", TOOL_STRINGS)
def test_tool_call_parses_match_the_jax_module(text, style):
    assert _no_ids(ptool.parse_tool_calls(text, style)) == _no_ids(jtool.parse_tool_calls(text, style))
    streamed = []
    for mod in (ptool, jtool):
        p = mod.StreamingToolParser(style)
        events = [e for ch in text for e in p.push(ch)] + p.finish()
        streamed.append((_no_ids(events), _no_ids(p.tool_calls)))
    assert streamed[0] == streamed[1]


class _ScriptedEngine:
    """An engine that answers every request with fixed text deltas through
    the RequestOutput contract of its package, so each server's chat route
    is what runs."""

    def __init__(self, deltas, tokenizer, output_cls):
        self.deltas, self.tokenizer, self.output_cls = deltas, tokenizer, output_cls
        self.is_sleeping, self.lora, self.prompts = False, None, []
        self.model_cfg = types.SimpleNamespace(vocab_size=tokenizer.vocab_size)

    def start(self):
        pass

    def stop(self):
        pass

    def abort(self, sid):
        pass

    def saturated(self, priority="interactive"):
        return False

    def can_shed_queued(self):
        return False

    async def generate(self, seq_id, prompt=None, prompt_token_ids=None, params=None, **kw):
        self.prompts.append(list(prompt_token_ids))
        n = len(self.deltas)
        for i, d in enumerate(self.deltas):
            yield self.output_cls(
                seq_id=seq_id, text_delta=d, token_ids=[i], finished=i == n - 1,
                finish_reason="stop" if i == n - 1 else None, prompt_tokens=len(prompt_token_ids),
                completion_tokens=i + 1,
            )
            await asyncio.sleep(0)


CALL_TEXT = '<tool_call>{"name": "get_weather", "arguments": {"city": "SF"}}</tool_call>'
TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {
    "type": "object", "properties": {"city": {"type": "string"}}}}}]


@pytest.mark.parametrize("deltas", [
    ["I'll check. ", CALL_TEXT[:20], CALL_TEXT[20:]],
    ['{"name": "get_weather", ', '"parameters": {"city": "Paris"}}'],
    ["no call here, ", "just text"],
], ids=["hermes", "json", "content"])
def test_the_chat_route_returns_the_jax_servers_tool_calls(deltas):
    async def chat(base, stream):
        body = {"messages": [{"role": "user", "content": "weather in SF?"}], "tools": TOOLS, "stream": stream}
        async with aiohttp.ClientSession() as s:
            async with s.post(base + "/v1/chat/completions", json=body) as r:
                assert r.status == 200
                if not stream:
                    return (await r.json())["choices"]
                lines = [raw.decode().strip() async for raw in r.content]
        return [json.loads(x[6:])["choices"] for x in lines if x.startswith("data: ") and x != "data: [DONE]"]

    lp = _Loop()
    out, prompts = {}, {}
    try:
        for tag, mod, tok, cls, cfg_cls in (
            ("jax", jax_server, JaxByteTokenizer(), JaxRequestOutput, JaxEngineConfig),
            ("port", port_server, PortByteTokenizer(), PortRequestOutput, EngineConfig),
        ):
            cfg = cfg_cls(model="llama-debug", host="127.0.0.1", port=free_port())
            eng = _ScriptedEngine(deltas, tok, cls)
            _, run = lp.run(mod.serve(cfg, engine=eng))
            try:
                base = f"http://127.0.0.1:{cfg.port}"
                out[tag] = (lp.run(chat(base, False)), lp.run(chat(base, True)))
            finally:
                lp.run(run.cleanup())
            prompts[tag] = eng.prompts
    finally:
        lp.close()
    assert _no_ids(out["port"]) == _no_ids(out["jax"])
    assert prompts["port"] == prompts["jax"]  # the tool schemas rendered into the same prompt
    whole = out["port"][0][0]
    if deltas[0] != "no call here, ":
        assert whole["finish_reason"] == "tool_calls" and whole["message"]["tool_calls"]
    else:
        assert whole["finish_reason"] == "stop" and "tool_calls" not in whole["message"]
