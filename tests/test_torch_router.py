"""The port's router (production_stack_tpu_torch/router/) and fleet controller
(production_stack_tpu_torch/migration/controller.py and
scripts/fleet_controller_torch.py) against the JAX package's, on the CPU.

- Every routing logic (roundrobin, session, prefixaware, kvaware against the
  port's cache server and its directory, disaggregated_prefill with and
  without the fabric scores) picks what the JAX router picks, request for
  request, over a seeded stream of 200 requests on four endpoints, one
  removed and one added midway.
- HashRing and HashTrie; parse_args on a set of argvs (equal ``vars()``,
  equal refusals, config-JSON seeding); EngineStats.from_scrape on a port
  engine's /metrics and SLOMonitor.ingest on its /slo_records; the breaker
  state machine and the retry backoff under a seeded ``random``; PII
  redaction, the n-gram semantic cache, feature gates and the rewriter.
- Over HTTP, two port engine servers behind each router in turn (session
  routing on ``x-user-id``, a subprocess): the same "Routing request ... to"
  sequence, the same streamed ids and the same ``vllm_router:*`` series. The
  JAX router's run is the one place the JAX router still serves port
  engines in the port's tests.
- scripts/fleet_controller_torch.py --once migrates a stream off a port
  engine onto the other.

Each package keeps its own singletons, so both live in this process. The
cache server and the engine servers run on a loop thread of this process,
engines on their own loop threads, the routers and the controller as
subprocesses.
"""

import asyncio
import dataclasses
import functools
import importlib
import json
import random
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import requests

from production_stack_tpu_torch.testing.procs import REPO_ROOT, cpu_env, free_port, start_proc, stop_proc, wait_healthy
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
from production_stack_tpu_torch.kvoffload import cache_server
from production_stack_tpu_torch.kvoffload.protocol import BlockingClient
from production_stack_tpu_torch.kvoffload.serde import get_serde

PKGS = {"jax": "production_stack_tpu", "port": "production_stack_tpu_torch"}
MODEL = "llama-debug-4kv-f32"


def _mods(name):
    """The JAX package's module ``name`` and the port's."""
    return tuple(importlib.import_module(f"{pkg}.{name}") for pkg in PKGS.values())


# module globals a test may set, put back after it (the JAX router's own
# tests share this process's singletons)
_GLOBALS = {"routing_logic": ("_router",), "service_discovery": ("_global_service_discovery",),
            "resilience": ("_policy", "_registry", "_saturation", "_session_pins"), "pii": ("_analyzer",),
            "rewriter": ("_rewriter",), "feature_gates": ("_gates",)}


@pytest.fixture(autouse=True)
def isolated():
    saved = []
    for mods in zip(*(_mods(f"router.{name}") for name in _GLOBALS)):
        for m, names in zip(mods, _GLOBALS.values()):
            saved.append((m, {n: getattr(m, n) for n in names}))
            for n in names:
                setattr(m, n, None)
    singletons = [(u.SingletonMeta._instances, dict(u.SingletonMeta._instances)) for u in _mods("router.utils")]
    for inst, _ in singletons:
        inst.clear()
    yield
    for m, values in saved:
        for n, v in values.items():
            setattr(m, n, v)
    for inst, values in singletons:
        inst.clear()
        inst.update(values)


# -- the routing logics ----------------------------------------------------------

URLS = [f"http://e{i}:8100" for i in range(5)]
LABELS = ["prefill", "decode", "prefill", "decode", "decode"]
# six system prompts that differ from their first page on
PREFIXES = [f"{w}: you answer questions about {w.lower()} in detail, citing sources. " * 3
            for w in ("Alpha", "Bravo", "Charlie", "Delta", "Echo", "Foxtrot")]


def _requests(seed=0, n=200):
    """A seeded stream: (urls, session, body, qps by url) a request. e1
    leaves at request 70, e4 joins at 140."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        urls = [u for u in URLS[:4] if i < 70 or u != URLS[1]] + URLS[4:] * (i >= 140)
        user = f"user-{rng.randrange(12)}" if rng.random() < 0.8 else None
        prompt = PREFIXES[rng.randrange(len(PREFIXES))] + f"question {rng.randrange(1000)}"
        body = ({"model": "m", "prompt": prompt} if rng.random() < 0.7
                else {"model": "m", "messages": [{"role": "user", "content": prompt}]})
        out.append((urls, user, body, {u: rng.randrange(4) for u in urls}))
    return out


def _scrape(max_io=None, bw=0.0, depth=0.0):
    text = f"vllm:kv_fabric_peer_bandwidth_bytes_per_sec {bw}\nvllm:kv_fabric_queue_depth {depth}\n"
    return text + (f"vllm:kv_offload_max_io_pages {max_io}\n" if max_io is not None else "")


@pytest.fixture(scope="module")
def directory():
    """The port's cache server (its directory on) on a loop thread: e0 holds
    PREFIXES[0] resident, e1 PREFIXES[1], e2 two pages of PREFIXES[2] and e3
    all of it, e4 PREFIXES[5]; PREFIXES[3]'s blobs are in the shared tier;
    PREFIXES[4] is cold."""
    loop = _Loop()
    port = free_port()
    loop.run(cache_server.serve("127.0.0.1", port, 1 << 24))
    addr = f"127.0.0.1:{port}"
    tok = ByteTokenizer()
    hexes = [[h.hex() for h in prefix_hashes(tok.encode(p), 8)] for p in PREFIXES]
    c = BlockingClient("127.0.0.1", port, timeout=5)
    blob = get_serde("naive").serialize(np.ones((1, 8, 1, 2), np.float32), np.zeros((1, 8, 1, 2), np.float32))
    try:
        for url in URLS:
            c.request({"op": "dir_register", "url": url, "page_size": 8, "generation": 1})
        for url, k, n in ((URLS[0], 0, None), (URLS[1], 1, None), (URLS[2], 2, 2), (URLS[3], 2, None),
                          (URLS[4], 5, None)):
            c.request({"op": "dir_publish", "url": url, "generation": 1, "tier": "hbm", "page_size": 8,
                       "entries": [[h, i, 1.0] for i, h in enumerate(hexes[k][:n])]})
        c.request({"op": "dir_publish", "url": URLS[2], "generation": 1, "tier": "shared", "page_size": 8,
                   "entries": [[h, i, 1.0] for i, h in enumerate(hexes[3])]})
        for h in hexes[3]:
            c.request({"op": "put", "key": h}, blob)
    finally:
        c.close()
    yield addr
    loop.close()


async def _picks(logic, addr, stream):
    """Each package's picks over ``stream``, request by request, the two
    routers taking turns; with kvaware, then each one's route classes."""
    scrapes = {URLS[0]: _scrape(0), URLS[1]: _scrape(1), URLS[2]: _scrape(), URLS[3]: _scrape(2)}
    both = {}
    for name, rl, sd, es in zip(PKGS, _mods("router.routing_logic"), _mods("router.service_discovery"),
                                _mods("router.engine_stats")):
        router = rl.initialize_routing_logic(logic, session_key="x-user-id", kv_directory_url=addr,
                                             prefill_model_labels=["prefill"], decode_model_labels=["decode"])
        both[name] = (router, sd.EndpointInfo, es, {u: es.EngineStats.from_scrape(s) for u, s in scrapes.items()})
    out = {name: [] for name in PKGS}
    for i, (urls, user, body, qps) in enumerate(stream):
        rstats = {u: types.SimpleNamespace(qps=q) for u, q in qps.items()}
        request = types.SimpleNamespace(headers={"x-user-id": user} if user else {})
        for name, (router, endpoint, es, estats) in both.items():
            eps = [endpoint(url=u, model_names=["m"], added_timestamp=0.0, model_label=LABELS[URLS.index(u)])
                   for u in urls]
            if logic == "disaggregated_prefill":
                # the second half scores the decode pool by fabric bandwidth
                es.get_engine_stats_scraper().engine_stats = {
                    u: es.EngineStats.from_scrape(_scrape(bw=1e9 * (1 + (i + k) % 3), depth=(i * k) % 4))
                    for k, u in enumerate(URLS) if i >= 100}
                out[name].append((router.route_prefill(eps), router.route_decode(eps)))
            else:
                out[name].append(await router.route_request(eps, estats, rstats, request, body))
    if logic == "kvaware":
        for name, (router, _, _, _) in both.items():
            out[name].append(dict(router.route_class_counts))
            await router._dir_client.close()
    return out


@pytest.mark.parametrize("logic", ["roundrobin", "session", "prefixaware", "kvaware", "disaggregated_prefill"])
def test_every_routing_logic_picks_what_the_jax_router_picks(logic, directory):
    out = asyncio.run(_picks(logic, directory, _requests()))
    assert out["port"] == out["jax"]
    picks = out["port"]
    if logic == "kvaware":
        classes = picks.pop()
        assert classes["resident"] > 0 and classes["restorable"] > 0 and classes["cold"] > 0, classes
    assert len(picks) == 200
    flat = [u for p in picks for u in (p if isinstance(p, tuple) else (p,))]
    per = len(flat) // 200
    assert URLS[1] in flat[: 70 * per] and URLS[1] not in flat[70 * per:]  # e1 left at request 70
    if logic != "prefixaware":  # (which keeps each prefix on the endpoint that saw it first)
        assert URLS[4] in flat[140 * per:]  # e4 joined at request 140
    if logic == "disaggregated_prefill":
        fabric = [m._router.fabric_routes for m in _mods("router.routing_logic")]
        assert fabric[0] == fabric[1] > 0


def test_hashring_and_hashtrie_are_the_jax_routers():
    rings = [m.HashRing([f"n{i}" for i in range(4)]) for m in _mods("router.routing_logic")]
    got = {name: [] for name in PKGS}
    for step in range(6):
        for ring, name in zip(rings, PKGS):
            if step == 2:
                ring.remove_node("n1")
            if step == 4:
                ring.add_node("n9")
            got[name].append([ring.get_node(f"key{k}") for k in range(300)])
            got[name].append(sorted(ring.get_nodes()))
    assert got["port"] == got["jax"]

    rng = random.Random(2)
    texts = ["".join(rng.choice("abc") for _ in range(rng.randrange(8, 80))) for _ in range(60)]

    async def trie_run(mod):
        trie, out = mod.HashTrie(chunk_size=16), []
        for k, text in enumerate(texts):
            await trie.insert(text, f"e{k % 5}")
            n, eps = await trie.longest_prefix_match(texts[(k * 7) % len(texts)][:40], {f"e{j}" for j in range(5)})
            out.append((n, sorted(eps)))
            if k == 30:
                await trie.remove_endpoint("e2")
        return out

    results = [asyncio.run(trie_run(mod)) for mod in _mods("router.hashtrie")]
    assert results[0] == results[1] and any(n > 0 for n, _ in results[0])


# -- the parser ------------------------------------------------------------------

_BASE = ["--static-backends", "http://a,http://b", "--static-models", "m,m"]
ARGVS = [
    _BASE,
    _BASE + ["--routing-logic", "session", "--session-key", "x-user-id", "--port", "1234"],
    _BASE + ["--routing-logic", "kvaware", "--kv-directory-url", "127.0.0.1:8200", "--engine-stats-interval", "1"],
    _BASE + ["--routing-logic", "disaggregated_prefill", "--static-model-labels", "prefill,decode",
             "--prefill-model-labels", "prefill", "--decode-model-labels", "decode"],
    _BASE + ["--retry-max-attempts", "4", "--deadline-ttft", "2.5", "--breaker-failure-threshold", "7",
             "--feature-gates", "SemanticCache=true,PIIDetection=true", "--slo-ttft-ms", "500"],
    # refused
    ["--service-discovery", "static"],
    ["--static-backends", "http://a,http://b", "--static-models", "m"],
    _BASE + ["--routing-logic", "session"],
    _BASE + ["--routing-logic", "kvaware"],
    _BASE + ["--routing-logic", "disaggregated_prefill"],
    _BASE + ["--retry-max-attempts", "0"],
    _BASE + ["--deadline-ttft", "-1"],
    _BASE + ["--trace-sample-rate", "2"],
    _BASE + ["--saturation-queue-ref", "0"],
    _BASE + ["--routing-logic", "random"],
]


def _parse(mod, argv):
    try:
        return "ok", vars(mod.parse_args(list(argv)))
    except (ValueError, SystemExit) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_the_parser_gives_the_jax_routers_args_and_refusals(argv, capsys):
    j, p = (_parse(m, argv) for m in _mods("router.parser"))
    assert p == j


def test_the_parser_seeds_from_a_config_json_as_the_jax_router(tmp_path):
    cfg = tmp_path / "router.json"
    cfg.write_text(json.dumps({"port": 7777, "static_backends": "http://a", "static_models": "m",
                               "routing_logic": "session", "session_key": "x-user-id",
                               "static_backend_health_checks": True, "log_stats": False}))
    for argv in (["--config", str(cfg)], ["--config", str(cfg), "--port", "8888"]):
        j, p = (_parse(m, argv) for m in _mods("router.parser"))
        assert p == j and p[0] == "ok"
    assert p[1]["port"] == 8888 and p[1]["static_backend_health_checks"] is True


# -- resilience ------------------------------------------------------------------


def test_the_breaker_and_the_retry_backoff_are_the_jax_routers():
    ops = random.Random(3)
    script = [(ops.choice(["fail", "ok", "probe", "allow", "peek"]), round(ops.uniform(0, 60), 3)) for _ in range(300)]
    got = []
    for res in _mods("router.resilience"):
        b, reg, out = res.CircuitBreaker(failure_threshold=3, cooldown=10.0), res.BreakerRegistry(2, 5.0), []
        t = 0.0
        for op, dt in script:
            t += dt / 10
            if op == "fail":
                b.record_failure(now=t)
                reg.record_failure(f"http://e{int(dt) % 3}")
            elif op == "ok":
                b.record_success()
                reg.record_success(f"http://e{int(dt) % 3}")
            elif op == "probe":
                b.record_probe_success()
            elif op == "allow":
                out.append(b.allow(now=t))
            else:
                out.append(b.peek_state(now=t))
            out.append((b.state, b.consecutive_failures, b.open_events, b.state_name))
        out.append(reg.open_urls())
        policy = res.RetryPolicy(backoff_base=0.1, backoff_max=0.5, deadline_request=1.0)
        random.seed(11)
        out.append([policy.backoff(a) for a in range(1, 12) for _ in range(5)])
        out.append(policy.remaining(100.0, now=100.4))
        got.append(out)
    assert got[1] == got[0]
    assert "open" in {x[3] for x in got[0] if isinstance(x, tuple)}


# -- the leaf features -----------------------------------------------------------

PII_TEXTS = [
    "email me at alice@example.com or call +1 (555) 123-4567, ssn 123-45-6789",
    "card 4111 1111 1111 1111, ip 10.0.0.12, nothing else",
    "no personal data here at all",
    "two mails: a.b@c.org; d_e@f.co.uk and 987-65-4321",
]


def test_pii_semantic_cache_feature_gates_and_the_rewriter_are_the_jax_routers():
    got = []
    for pii, sc, fg, rw in zip(*(_mods(f"router.{n}") for n in ("pii", "semantic_cache", "feature_gates",
                                                                 "rewriter"))):
        out = []
        analyzer = pii.RegexAnalyzer()
        for text in PII_TEXTS:
            out.append([dataclasses.astuple(m) for m in pii.check_pii_content(text, analyzer)])
            out.append(pii.redact(text, analyzer=analyzer))

        async def cache_run():
            cache = sc.SemanticCache(threshold=0.9, max_entries=8, embed=sc.ngram_hash_embed,
                                     index=sc.NumpyIndex(sc.DIM))
            res = []
            for k in range(12):
                body = json.dumps({"messages": [{"role": "user", "content": f"what is the capital of country {k}"}]})
                res.append(await cache.check(body.encode()))
                await cache.store(body.encode(), {"id": k})
                again = json.dumps({"messages": [{"role": "user", "content": f"what is the capital of country {k}"}]})
                res.append(await cache.check(again.encode()))
            res.append(await cache.check(json.dumps({"messages": [{"role": "user", "content": "x"}],
                                                    "stream": True}).encode()))
            return res + [cache.hits, cache.misses, len(cache.entries)]

        out.append(asyncio.run(cache_run()))
        out.append(sc.ngram_hash_embed("the same text").tolist())
        for spec in ("SemanticCache=true,PIIDetection=false", "PIIDetection=true", ""):
            g = fg.FeatureGates(spec)
            out.append([g.is_enabled(k) for k in ("SemanticCache", "PIIDetection")])
        for spec in ("Bogus=true", "SemanticCache"):
            try:
                fg.FeatureGates(spec)
                out.append("accepted")
            except ValueError as e:
                out.append(str(e))
        out.append(rw.initialize_rewriter("noop").rewrite_request(b'{"a": 1}', "m", "/v1/completions"))
        with pytest.raises(ValueError):
            rw.initialize_rewriter("upper")
        got.append(out)
    assert got[1] == got[0]
    assert "[EMAIL]" in got[0][1] and got[0][8][3] == {"id": 1}  # a repeat hits the cache


# -- over HTTP: port engines behind both routers ---------------------------------


class _Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _recorded(engine, log, slow):
    """Record the ids each sequence of ``engine`` emits (``log[seq_id]``),
    the terminal "migrated" output's repeat of its last id left out; while
    ``slow[0]`` is set, each output costs that many seconds on the loop
    thread, so a stream stays live long enough to be migrated."""
    orig, emit = engine.generate, engine._emit

    @functools.wraps(orig)
    async def generate(seq_id, *args, **kwargs):
        async for out in orig(seq_id, *args, **kwargs):
            if not (out.finished and out.finish_reason == "migrated"):
                log.setdefault(seq_id, []).extend(out.token_ids)
            yield out

    def slow_emit(*args, **kwargs):
        time.sleep(slow[0])
        return emit(*args, **kwargs)

    engine.generate, engine._emit = generate, slow_emit
    return engine


@pytest.fixture(scope="module")
def fleet():
    """Two port servers (served as "m") on a loop thread over one port cache
    server, the shared tier a migration ships through."""
    loop = _Loop()
    cport = free_port()
    loop.run(cache_server.serve("127.0.0.1", cport, 1 << 26))
    log, slow, servers = {}, [0.0], []
    for _ in range(2):
        cfg = EngineConfig(model=MODEL, host="127.0.0.1", port=free_port(), served_model_name="m",
                           max_model_len=512, num_pages=64, page_size=16, prefill_chunk=64, decode_steps=2,
                           kv_remote_url=f"127.0.0.1:{cport}", kv_offload_cpu_gb=0.05, kv_offload_max_io_pages=0)
        eng = _recorded(LLMEngine(cfg, device="cpu"), log, slow)
        servers.append((loop.run(port_server.serve(cfg, eng, device="cpu")), f"http://127.0.0.1:{cfg.port}"))
    yield types.SimpleNamespace(urls=[u for _, u in servers], log=log, slow=slow)
    for (srv, run), _ in servers:
        loop.run(run.cleanup())
        srv.engine.stop()
    loop.close()


def _series(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line.startswith("vllm_router:")}


def _stream(base, rid, user, prompt):
    """A streamed completion through ``base``: whether it ended in [DONE]."""
    body = {"model": "m", "prompt": prompt, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True,
            "stream": True}
    with requests.post(f"{base}/v1/completions", json=body, headers={"X-Request-Id": rid, "x-user-id": user},
                       stream=True, timeout=120) as r:
        assert r.status_code == 200, r.text
        return [line for line in r.iter_lines() if line.startswith(b"data: ")][-1] == b"data: [DONE]"


def test_both_routers_route_and_stream_the_same_over_two_port_engines(fleet):
    # three sessions, the first two on different engines (the ring hashes
    # the servers' ports, which change from run to run)
    ring = _mods("router.routing_logic")[1].HashRing(fleet.urls)
    names = (f"user-{k}" for k in range(100))
    users = [next(names)]
    users.append(next(u for u in names if ring.get_node(u) != ring.get_node(users[0])))
    users.append(next(names))
    runs = {}
    for name, pkg in PKGS.items():
        rport = free_port()
        router = start_proc(["-m", f"{pkg}.router.app", "--port", str(rport), "--static-backends",
                             ",".join(fleet.urls), "--static-models", "m,m", "--routing-logic", "session",
                             "--session-key", "x-user-id", "--engine-stats-interval", "1"])
        base = f"http://127.0.0.1:{rport}"
        try:
            wait_healthy(f"{base}/health", router, timeout=60)
            fleet.log.clear()
            done = [_stream(base, f"r{k}", users[k % 3], f"prompt {k % 3} " * (4 + k)) for k in range(6)]
            assert all(done)
            ids = [fleet.log[f"r{k}"] for k in range(6)]
            # the stats scraper (every second) has read the six SLO records
            deadline = time.time() + 30
            while (text := requests.get(f"{base}/metrics", timeout=10).text) and time.time() < deadline:
                if sum(float(v) for v in re.findall(r"^vllm_router:slo_records_total\{.*\} (\S+)$", text, re.M)) >= 6:
                    break
                time.sleep(0.2)
            series = _series(text)
        finally:
            log = stop_proc(router)
        routed = re.findall(r"Routing request (\S+) for model m to (\S+) at", log)
        runs[name] = (routed, ids, series)
    (routed, ids, series), (jrouted, jids, jseries) = runs["port"], runs["jax"]
    assert routed == jrouted and ids == jids
    assert series ^ jseries == set()
    assert [r for r, _ in routed] == [f"r{k}" for k in range(6)] and len({u for _, u in routed}) == 2
    assert all(len(x) == 8 for x in ids) and routed[0][1] == routed[3][1]  # a session stays put
    assert {"vllm_router:time_to_first_token_seconds_bucket", "vllm_router:finished_requests",
            "vllm_router:session_repins_total"} <= series


def test_the_ports_stats_and_slo_monitor_read_a_port_engine_as_the_jax_routers(fleet):
    url = fleet.urls[0]
    requests.post(f"{url}/v1/completions", json={"model": "m", "prompt": "a b c d", "max_tokens": 4}, timeout=60)
    text = requests.get(f"{url}/metrics", timeout=10).text
    payload = requests.get(f"{url}/slo_records?since=0", timeout=10).json()
    stats = [dataclasses.asdict(m.EngineStats.from_scrape(text)) for m in _mods("router.engine_stats")]
    assert stats[1] == stats[0] and stats[0]["kv_offload_max_io_pages"] == 0
    renders = []
    for slo in _mods("router.slo"):
        mon = slo.SLOMonitor(ttft_ms=1e9, itl_ms=1e9)
        n = mon.ingest(url, payload)
        renders.append((n, mon.cursor(url), mon.render(fleet_saturation=0.25), mon.interactive_attainment(url)))
    assert renders[1] == renders[0] and renders[0][0] >= 1


def test_the_ports_fleet_controller_migrates_a_stream_off_a_port_engine(fleet):
    """scripts/fleet_controller_torch.py --once over the two port servers:
    it reads both /migratable listings and rebalances the live stream from
    the engine serving it to the idle one, which finishes the stream; the
    client gets all 120 tokens, and the two engines' ids are an unmigrated
    run's."""
    ua, ub = fleet.urls
    prompt = "The quick brown fox jumps over the lazy dog. " * 3
    body = {"model": "m", "prompt": prompt, "max_tokens": 120, "temperature": 0.0, "ignore_eos": True,
            "stream": True}
    lines, ready = [], threading.Event()

    def read():
        with requests.post(f"{ua}/v1/completions", json=body, headers={"X-Request-Id": "ctl"}, stream=True,
                           timeout=240) as r:
            for line in r.iter_lines():
                if line:
                    lines.append(line)
                    if len(lines) >= 4:
                        ready.set()
        ready.set()

    ref = requests.post(f"{ub}/v1/completions", json=dict(body, stream=False), headers={"X-Request-Id": "ctl-ref"},
                        timeout=120)
    assert ref.status_code == 200, ref.text
    fleet.slow[0] = 0.05
    reader = threading.Thread(target=read, daemon=True)
    try:
        reader.start()
        assert ready.wait(120)
        out = subprocess.run(
            [sys.executable, "scripts/fleet_controller_torch.py", "--engines", f"{ua},{ub}", "--once",
             "--saturation-queue-ref", "1", "--rebalance-high-delta", "0.05", "--cooldown", "0"],
            cwd=REPO_ROOT, env=cpu_env(), capture_output=True, text=True, timeout=120,
        )
        reader.join(120)
    finally:
        fleet.slow[0] = 0.0
    assert out.returncode == 0, out.stderr[-2000:]
    actions = json.loads(out.stdout[out.stdout.index("["):])
    assert [(a["kind"], a["source"], a["target"], a["request_ids"]) for a in actions] == [
        ("rebalance", ua, ub, ["ctl"])]
    assert b"pstpu_migration" in lines[-1]
    with requests.post(f"{ub}/migrate_attach", json={"request_id": "ctl"}, stream=True, timeout=240) as r:
        lines += [x for x in r.iter_lines() if x]
    usage = json.loads([x for x in lines if b'"usage"' in x][-1][len(b"data: "):])["usage"]
    assert usage["completion_tokens"] == 120 and any(b"[DONE]" in x for x in lines)
    assert fleet.log["ctl"] == fleet.log["ctl-ref"]  # the source's ids and the target's: the unmigrated run's
    for url, series in ((ua, "vllm:migrations_out_total"), (ub, "vllm:migrations_in_total")):
        assert re.search(rf"^{series}(\{{[^}}]*\}})? 1(\.0)?$", requests.get(f"{url}/metrics", timeout=10).text,
                         re.M), series
