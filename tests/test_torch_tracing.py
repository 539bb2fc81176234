"""The port's trace and debug surface (production_stack_tpu_torch/tracing/,
the server's debug routes) against the JAX package's.

The unit cases of tests/test_tracing.py (traceparent, the span ring under
concurrent writers, head sampling, export, the loss counters) and of
tests/test_flightrecorder.py (the event ring, its filters, dumps and rate
limits) run on the port's copies. Then the servers: a port and a JAX server
on the f32 twin answer the same request under one caller's traceparent with
``/v1/traces`` exports of the same span names, parent links and attribute
keys; the port's flight recorder carries the trace id on its "sched" events;
``/metrics/reset`` empties the windows; the debug routes exist only with
``enable_debug_endpoints``; and the port's router (a subprocess) in
front of a JAX engine and a port engine gets both to answer, each engine's
spans nested under the router's, which scripts/trace_report merges.
"""

import asyncio
import json
import os
import sys
import threading
import time

import aiohttp
import jax
import pytest
import requests

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import free_port, start_proc, stop_proc, wait_healthy
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.tracing import (
    TRACEPARENT_HEADER,
    FlightRecorder,
    Span,
    SpanCollector,
    SpanContext,
    render_collector_metrics,
)
from production_stack_tpu_torch.tracing import flightrecorder as fr_mod

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "scripts"))
import trace_report  # noqa: E402

MODEL = "llama-debug-4kv-f32"


# -- context (tests/test_tracing.py) --------------------------------------------


def test_traceparent_roundtrip_and_children():
    ctx = SpanContext.new_root()
    parsed = SpanContext.parse(ctx.to_traceparent())
    assert (parsed.trace_id, parsed.span_id, parsed.sampled) == (ctx.trace_id, ctx.span_id, True)
    assert SpanContext.parse(SpanContext.new_root(sampled=False).to_traceparent()).sampled is False
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id and child.span_id != ctx.span_id
    assert ctx.child().child().sampled == ctx.sampled


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-shorttrace-0011223344556677-01",
    "00-" + "0" * 32 + "-0011223344556677-01", "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "a" * 32 + "-0011223344556677-01", "00-" + "a" * 32 + "-0011223344556677",
])
def test_malformed_traceparent_is_ignored(header):
    assert SpanContext.parse(header) is None


def test_from_headers_never_raises():
    class Boom:
        def get(self, _):
            raise RuntimeError("broken header mapping")

    assert SpanContext.from_headers(Boom()) is None


# -- the span ring ----------------------------------------------------------------


def test_ring_buffer_bounded_under_concurrent_writers():
    col = SpanCollector(capacity=64, sample_rate=1.0)
    ctx = SpanContext.new_root()

    def writer(i):
        for j in range(500):
            col.record(f"w{i}", ctx.child(), time.time(), 0.001, j=j)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert col.recorded == 8 * 500
    spans = col.spans()
    assert len(spans) == 64 and all(isinstance(s, Span) and s.trace_id == ctx.trace_id for s in spans)


def test_ring_overwrites_the_oldest_and_counts_its_losses():
    col = SpanCollector(capacity=4, sample_rate=1.0)
    ctx = SpanContext.new_root()
    for i in range(10):
        col.record("s", ctx.child(), float(i), 0.1, i=i)
    assert sorted(s.attrs["i"] for s in col.spans()) == [6, 7, 8, 9]
    assert col.overwritten == 6
    unsampled = SpanContext.new_root(sampled=False)
    for _ in range(3):
        col.record("s", unsampled.child(), 0.0, 0.1)
    assert col.sampling_rejected == 3 and col.recorded == 10
    lines = "\n".join(render_collector_metrics('model_name="m"'))
    assert 'vllm:trace_spans_dropped_total{model_name="m",reason="ring_wrap"}' in lines
    assert 'vllm:trace_spans_dropped_total{model_name="m",reason="unsampled"}' in lines
    assert 'vllm:trace_buffer_capacity{model_name="m"}' in lines
    col.reset()
    assert col.overwritten == 0 and col.sampling_rejected == 0
    floor = SpanCollector(capacity=0)
    floor.record("s", SpanContext.new_root(), time.time(), 0.1)
    assert len(floor.spans()) == 1


# -- head sampling --------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_sample_rate_edges(rate):
    col = SpanCollector(capacity=256, sample_rate=rate)
    for _ in range(50):
        ctx = SpanContext.new_root(sampled=col.sample())
        assert ctx.sampled is bool(rate)
        col.record("s", ctx, time.time(), 0.1)
    assert col.recorded == (50 if rate else 0)
    assert col.root_from_headers({}).sampled is bool(rate)


def test_sample_rate_is_clamped_and_deterministic_in_the_trace_id():
    assert SpanCollector(sample_rate=-0.5).sample_rate == 0.0
    assert SpanCollector(sample_rate=1.5).sample_rate == 1.0
    col = SpanCollector(sample_rate=0.5)
    for _ in range(3):
        assert col.sample("7fffffff" + "0" * 24) is True
        assert col.sample("80000000" + "0" * 24) is False


@pytest.mark.parametrize("rate,remote_sampled", [(0.0, True), (1.0, False)], ids=["kill_switch", "unsampled"])
def test_the_remote_flag_and_the_kill_switch(rate, remote_sampled):
    """Rate 0 beats a sampled remote flag; an unsampled remote flag beats
    rate 1. The trace id is adopted either way."""
    col = SpanCollector(capacity=16, sample_rate=rate)
    remote = SpanContext.new_root(sampled=remote_sampled)
    ctx = col.root_from_headers({TRACEPARENT_HEADER: remote.to_traceparent()})
    assert ctx.trace_id == remote.trace_id and ctx.sampled is False
    col.record("s", ctx.child(), time.time(), 0.1)
    assert col.spans() == []


def test_export_groups_filters_and_limits():
    col = SpanCollector(capacity=32, sample_rate=1.0)
    a, b = SpanContext.new_root(), SpanContext.new_root()
    col.record("root_a", a, 1.0, 0.5)
    col.record("child_a", a.child(), 1.1, 0.2)
    col.record("root_b", b, 2.0, 0.5)
    export = col.export()
    assert [t["trace_id"] for t in export["traces"]] == [b.trace_id, a.trace_id]
    only_a = col.export(trace_id=a.trace_id)["traces"]
    assert len(only_a) == 1 and len(only_a[0]["spans"]) == 2
    assert len(col.export(limit=1)["traces"]) == 1


# -- the flight recorder (tests/test_flightrecorder.py) ----------------------------


def test_recorder_ring_bounded_and_ordered_under_concurrent_writers():
    fr = FlightRecorder(capacity=64, enabled=True)

    def writer(i):
        for j in range(400):
            fr.record("sched", step=j, writer=i)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fr.recorded == 8 * 400 and fr.dropped == 8 * 400 - 64
    seqs = [e["seq"] for e in fr.events()]
    assert len(seqs) == 64 and seqs == sorted(seqs)


def test_a_disabled_recorder_records_nothing():
    fr = FlightRecorder(capacity=16, enabled=False)
    for _ in range(10):
        fr.record("kv", op="evict")
    assert fr.recorded == 0 and fr.events() == []
    fr.set_enabled(True)
    fr.record("kv", op="evict")
    assert fr.recorded == 1


def test_recorder_event_filters():
    fr = FlightRecorder(capacity=128)
    tid = "a" * 32
    fr.record("sched", step=1, trace_id=tid, seq_ids=["req-1", "req-2"])
    fr.record("kv", step=2, op="evict")
    fr.record("sched", step=3, seq_id="req-3")
    fr.record("slo", step=4, request_id="req-1")
    assert [e["step"] for e in fr.events(kind="sched")] == [1, 3]
    assert [e["step"] for e in fr.events(trace_id=tid)] == [1]
    assert [e["step"] for e in fr.events(request_id="req-1")] == [1, 4]
    assert [e["step"] for e in fr.events(since_step=2, until_step=3)] == [2, 3]
    assert len(fr.events(limit=2)) == 2
    fr.record("compile", event="backend_compile", seconds=0.5)  # step-less: in every window
    assert "compile" in {e["kind"] for e in fr.events(since_step=2, until_step=3)}
    payload, status = fr_mod.export_for_query({"since_step": "bogus"})
    assert status == 400 and "error" in payload


def test_recorder_dumps_and_rate_limits(tmp_path):
    fr = FlightRecorder(capacity=32, dump_dir=str(tmp_path))
    fr.record("sched", step=1)
    p1 = fr.dump("test_reason")
    with open(p1) as f:
        payload = json.load(f)
    assert payload["reason"] == "test_reason"
    assert {"sched", "anomaly"} <= {e["kind"] for e in payload["events"]}
    assert fr.dump("test_reason") is None  # rate-limited
    assert fr.dump("test_reason", force=True) is not None
    assert fr.dumps_total == 2
    no_dir = FlightRecorder(capacity=8)
    assert no_dir.dump("anything", force=True) is None and no_dir.dumps_total == 0


# -- servers: the port's against the JAX package's -----------------------------

SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=8, num_pages=64, page_size=8,
             prefill_chunk=32, kv_cache_memory_gb=0.01)
REQUEST = {"prompt": "Trace this request through the engine, please.", "max_tokens": 8, "temperature": 0.0,
           "ignore_eos": True}


def _port_engine(cfg):
    params = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return LLMEngine(cfg, device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))


def _shape(trace: dict) -> dict:
    """A trace's spans by name: (parent's name, sorted attribute keys)."""
    by_id = {s["span_id"]: s for s in trace["spans"]}
    return {
        s["name"]: (by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id else s["parent_id"],
                    sorted(s["attrs"]))
        for s in trace["spans"]
    }


def test_both_servers_export_the_same_spans_under_the_callers_traceparent(tmp_path):
    """One request under a caller's traceparent to each server: the same
    span names, parent links and attribute keys; the engine.request span a
    child of the caller's span; the port's /slo_records and flight recorder
    carry the trace id; /metrics/reset empties the windows."""
    remote = SpanContext.new_root()

    async def run():
        jcfg = JaxEngineConfig(**SMALL, port=free_port(), enable_debug_endpoints=True)
        pcfg = EngineConfig(**SMALL, port=free_port(), enable_debug_endpoints=True)
        jsrv, jrun = await jax_server.serve(jcfg)
        psrv, prun = await port_server.serve(pcfg, _port_engine(pcfg), device="cpu")
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                for name, cfg in (("jax", jcfg), ("port", pcfg)):
                    base = f"http://127.0.0.1:{cfg.port}"
                    headers = {TRACEPARENT_HEADER: remote.to_traceparent()}
                    async with s.post(base + "/v1/completions", json=REQUEST, headers=headers) as r:
                        assert r.status == 200
                        text = (await r.json())["choices"][0]["text"]
                    async with s.get(base + "/v1/traces", params={"trace_id": remote.trace_id}) as r:
                        traces = await r.json()
                    async with s.get(base + "/v1/debug/flightrecorder",
                                     params={"trace_id": remote.trace_id, "kind": "sched"}) as r:
                        sched = await r.json()
                    async with s.get(base + "/slo_records") as r:
                        slo = await r.json()
                    async with s.post(base + "/metrics/reset") as r:
                        reset = await r.json()
                    async with s.get(base + "/metrics") as r:
                        metrics = await r.text()
                    async with s.get(base + "/v1/traces") as r:
                        after = await r.json()
                    out[name] = (text, traces, sched, slo, reset, metrics, after)
        finally:
            await prun.cleanup()
            psrv.engine.stop()
            await jrun.cleanup()
            jsrv.engine.stop()
        return out

    got = asyncio.run(run())
    (ptext, ptraces, psched, pslo, preset, pmetrics, pafter) = got["port"]
    (jtext, jtraces, _, _, jreset, _, _) = got["jax"]
    assert ptext == jtext
    assert [t["trace_id"] for t in ptraces["traces"]] == [remote.trace_id]
    shape = _shape(ptraces["traces"][0])
    assert shape == _shape(jtraces["traces"][0])
    assert {"engine.request", "engine.queue", "engine.prefill", "engine.decode"} <= set(shape)
    assert shape["engine.request"][0] == remote.span_id  # a child of the caller's span
    assert all(shape[n][0] == "engine.request" for n in ("engine.queue", "engine.prefill", "engine.decode"))
    assert psched["events"] and all(e["trace_id"] == remote.trace_id and remote.trace_id in e["data"]["trace_ids"]
                                    for e in psched["events"])
    assert [r["trace_id"] for r in pslo["records"]] == [remote.trace_id]
    assert preset == jreset == {"status": "ok"}
    assert "vllm:ttft_hop_" not in pmetrics  # the hop windows are empty
    assert 'vllm:e2e_request_latency_seconds_count{model_name="' + MODEL + '"} 0' in pmetrics
    assert pafter["traces"] == []


@pytest.mark.parametrize("debug", [False, True])
def test_debug_routes_exist_only_with_enable_debug_endpoints(debug):
    cfg = EngineConfig(**dict(SMALL, model="llama-debug"), port=free_port(), enable_debug_endpoints=debug)
    app = port_server.EngineServer(cfg, LLMEngine(cfg, device="cpu"), device="cpu").build_app()
    routes = {(r.method, r.resource.canonical) for r in app.router.routes()}
    debug_routes = {("GET", "/v1/traces"), ("GET", "/v1/debug/flightrecorder"), ("POST", "/metrics/reset")}
    assert debug_routes & routes == (debug_routes if debug else set())


def test_tool_call_parser_off_renders_and_parses_no_tools():
    tools = [{"type": "function", "function": {"name": "f", "parameters": {}}}]
    body = {"messages": [{"role": "user", "content": "hi"}], "tools": tools}
    assert port_server._resolve_tools(body, "off") == (None, None)
    assert port_server._resolve_tools(body, "hermes") == (tools, "hermes")
    assert port_server._resolve_tools(body) == (tools, "auto")


def test_the_ttft_watermark_and_a_shed_burst_dump_the_recorder(tmp_path):
    cfg = EngineConfig(**dict(SMALL, model="llama-debug"), flight_recorder_dump_dir=str(tmp_path),
                       flight_recorder_ttft_watermark_ms=0.001, flight_recorder_shed_burst=2)
    eng = LLMEngine(cfg, device="cpu")
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    async def one():
        async for _ in eng.generate("w", prompt="watermark", params=SamplingParams(max_tokens=2)):
            pass

    eng.start()
    try:
        asyncio.run(one())
        eng.note_api_shed("s1")
        eng.note_api_shed("s2")
        deadline = time.time() + 10
        while time.time() < deadline and len(list(tmp_path.iterdir())) < 2:
            time.sleep(0.05)
    finally:
        eng.stop()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert any("ttft_breach" in n for n in names) and any("shed_burst" in n for n in names), names


def test_the_jax_router_nests_a_jax_and_a_port_engines_spans_under_its_own(tmp_path):
    """The port's router (the JAX router once, hence the name; a subprocess,
    round robin) in front of a JAX engine and a port engine serving the same
    model name: both answer, and in every routed trace the engine's request
    span is the child of the router's proxy span; trace_report merges the
    three exports."""

    class _Loop:
        def __init__(self):
            self.loop = asyncio.new_event_loop()
            self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
            self.thread.start()

        def run(self, coro, timeout=120):
            return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    loop = _Loop()
    jcfg = JaxEngineConfig(**dict(SMALL, model="llama-debug"), port=free_port(), served_model_name="m",
                           enable_debug_endpoints=True)
    pcfg = EngineConfig(**dict(SMALL, model="llama-debug"), port=free_port(), served_model_name="m",
                        enable_debug_endpoints=True)
    pengine = LLMEngine(pcfg, device="cpu")
    jsrv, jrun = loop.run(jax_server.serve(jcfg))
    psrv, prun = loop.run(port_server.serve(pcfg, pengine, device="cpu"))
    urls = [f"http://127.0.0.1:{jcfg.port}", f"http://127.0.0.1:{pcfg.port}"]
    rport = free_port()
    router = start_proc(["-m", "production_stack_tpu_torch.router.app", "--port", str(rport),
                         "--static-backends", ",".join(urls), "--static-models", "m,m",
                         "--routing-logic", "roundrobin", "--engine-stats-interval", "1",
                         "--enable-debug-endpoints"])
    router_url = f"http://127.0.0.1:{rport}"
    try:
        wait_healthy(f"{router_url}/health", router, timeout=60)
        for u in urls:  # each package's span ring holds only this test's traces
            assert requests.post(f"{u}/metrics/reset", timeout=10).status_code == 200
        ids = []
        for i in range(4):
            r = requests.post(f"{router_url}/v1/completions",
                              json={"model": "m", "prompt": f"routed {i}", "max_tokens": 4, "temperature": 0.0,
                                    "ignore_eos": True}, timeout=60)
            assert r.status_code == 200, r.text
            ids.append(r.headers["X-Request-Id"])
        served = {
            "jax": {rec["request_id"] for rec in jsrv.engine.slo_records},
            "port": {rec["request_id"] for rec in psrv.engine.slo_records},
        }
        assert served["jax"] and served["port"] and set(ids) == served["jax"] | served["port"]
        exports = [requests.get(f"{u}/v1/traces?limit=100", timeout=10).json() for u in [router_url] + urls]
        merged = trace_report.merge_exports(*exports)
        engine_traces = {which: {t["trace_id"] for t in exp["traces"]}
                         for which, exp in zip(("jax", "port"), exports[1:])}
        assert engine_traces["jax"] and engine_traces["port"]
        for which, tids in engine_traces.items():
            for tid in tids:
                spans = merged[tid]
                by_id = {s["span_id"]: s for s in spans}
                proxy = next(s for s in spans if s["name"] == "router.proxy")
                eng_req = next(s for s in spans if s["name"] == "engine.request")
                assert eng_req["parent_id"] == proxy["span_id"]
                roots = [s for s in spans if s["parent_id"] not in by_id]
                assert [s["name"] for s in roots] == ["router.request"]
                assert {"engine.queue", "engine.prefill", "engine.decode"} <= {s["name"] for s in spans}
                b = trace_report.trace_breakdown(spans)
                assert sum(b["self_ms"].values()) == pytest.approx(b["e2e_ms"], rel=1e-6)
    finally:
        stop_proc(router)
        loop.run(prun.cleanup())
        psrv.engine.stop()
        loop.run(jrun.cleanup())
        jsrv.engine.stop()
        loop.loop.call_soon_threadsafe(loop.loop.stop)
        loop.thread.join(10)
