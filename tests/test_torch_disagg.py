"""Disaggregated prefill in the port (engine roles, kvoffload/transfer.py,
the KV fabric) against the JAX package's, on the CPU.

The cases of tests/test_disagg_prefill.py and TestInt8FabricPair that need
no device, run on the port (the JAX tests are marked slow and run here only
as the reference):

- a port producer and consumer over TCP blobs give the JAX monolithic
  engine's greedy tokens, as a JAX pair does, with the JAX test's counters;
- across the packages, a JAX producer into a port consumer and a port
  producer into a JAX consumer, over TCP blobs and over the fabric: the same
  keys land as from a producer of the consumer's own package, with the same
  headers but the checksum and K/V within 2e-5 (the engines' f32 K/V differ
  by rounding), and the consumer decodes the JAX monolithic engine's tokens;
- int8 pools over the fabric (pushed and received pages, no corrupt frame,
  a monolithic int8 engine's tokens) and their refusal without the fabric;
- ``kv_fabric_stream_layers`` 1 and 2 land the pages whole frames land;
- a fabric push to a dead peer falls back to TCP blobs per page;
- the device path's protocol with a stand-in endpoint defined here (the
  package's DeviceKVEndpoint with its CUDA IPC export and open replaced by a
  table of this process): page_query's reserve, have and refuse, promote
  and unreserve, the staging TTL and byte cap, a dead producer marked and
  failed fast, the per-page fallback to blobs, an offer retired with its
  answer or by age, and a pair whose every page went "device to device";
- the port's router in disaggregated_prefill mode over two port servers
  streams a monolithic port server's text; /kv_fabric answers as a
  JAX server's does and /metrics carries the fabric gauge the router reads;
- a TCP and fabric pair with a tp 2 (gloo) producer, then a tp 2 consumer;
- the refusals.

Engines run in this process, on the loop threads they start; servers on a
loop thread of the test, the router as a subprocess.
"""

import asyncio
import contextlib
import dataclasses
import json
import socket
import threading
import time
import types

import jax
import numpy as np
import pytest
import requests
import torch

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.kvoffload import serde as jserde
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import free_port, start_proc, stop_proc, wait_healthy
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload.protocol import BlockingClient
from production_stack_tpu_torch.kvoffload.serde import verify_blob
from production_stack_tpu_torch.kvoffload.transfer import DeviceKVEndpoint, DeviceStaging
from production_stack_tpu_torch.models import llama as tllama

MODEL = "llama-debug-4kv-f32"
SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=4, num_pages=64, page_size=8,
             prefill_chunk=32)
PROMPTS = {
    "tcp": "a fairly long shared prompt that spans multiple kv pages " * 3,
    "fabric": "kv pages crossing the fabric as layer windowed frames, " * 3,
}
N_TOKENS = 6


def _pages(prompt: str) -> int:
    return (len(prompt) + 1) // 8  # the byte tokenizer: a token a byte, and BOS


def _run(engine, prompt, rid, n=N_TOKENS):
    sp = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams

    async def go():
        toks = []
        async for out in engine.generate(rid, prompt=prompt, params=sp(max_tokens=n, temperature=0.0,
                                                                       ignore_eos=True)):
            toks.extend(out.token_ids)
        return toks

    return asyncio.run(go())


@pytest.fixture(scope="module")
def params():
    jparams = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return params_from_jax(jparams, tllama.PRESETS[MODEL])


def _port(params, **kw):
    eng = LLMEngine(EngineConfig(**SMALL, port=free_port(), **kw), device="cpu", params=params)
    eng.start()
    return eng


def _jax(**kw):
    eng = JaxEngine(JaxEngineConfig(**SMALL, port=free_port(), **kw))
    eng.start()
    return eng


@pytest.fixture(scope="module")
def mono():
    """The JAX monolithic engine's greedy tokens, per prompt."""
    eng = _jax()
    out = {}

    def tokens(prompt):
        if prompt not in out:
            out[prompt] = _run(eng, prompt, f"mono-{len(out)}")
        return out[prompt]

    yield tokens
    eng.stop()


@pytest.fixture(scope="module")
def engines(params):
    """A consumer and a producer of each package, the fabric on in all four
    (a producer with no fabric peer ships TCP blobs); ``_point`` aims a
    producer at a consumer over one wire."""
    pc = _port(params, kv_role="consumer", kv_transfer_port=0, kv_fabric=True)
    jc = _jax(kv_role="consumer", kv_transfer_port=0, kv_fabric=True)
    pp = _port(params, kv_role="producer", kv_peer_url=f"127.0.0.1:{pc._kv_receiver.bound_port}", kv_fabric=True)
    jp = _jax(kv_role="producer", kv_peer_url=f"127.0.0.1:{jc._kv_receiver.bound_port}", kv_fabric=True)
    yield {"port": (pp, pc), "jax": (jp, jc)}
    for e in (pp, jp, pc, jc):
        e.stop()


def _point(prod, cons, wire, **fabric_kw):
    """Aim ``prod`` at ``cons``: its sender at the consumer's receiver, its
    fabric peer at the consumer's listener (``wire="fabric"``) or at none
    (every page a TCP blob)."""
    prod._kv_sender.close()
    prod._kv_sender = type(prod._kv_sender)(f"127.0.0.1:{cons._kv_receiver.bound_port}")
    peer = cons._fabric_server.address if wire == "fabric" else None
    prod.cfg = dataclasses.replace(prod.cfg, kv_fabric_peer=peer, **fabric_kw)
    prod._fabric_peer_addr = None


@contextlib.contextmanager
def _landings(cons):
    """The blobs that land in ``cons``'s store while the block runs."""
    got = {}
    store = cons._offload.store
    orig = store.put_local

    def rec(key, blob, *a, **kw):
        got[key] = blob
        return orig(key, blob, *a, **kw)

    store.put_local = rec
    try:
        yield got
    finally:
        del store.put_local


def _transfer(prod, cons, wire, prompt, rid, **fabric_kw):
    """The router's two phases: the prompt with max_tokens=1 on ``prod``,
    then (on fresh pools, so the prompt's pages come from the shipped ones)
    the whole request on ``cons``. Returns (landed blobs, tokens)."""
    _point(prod, cons, wire, **fabric_kw)
    with _landings(cons) as got:
        _run(prod, prompt, rid + "-p", 1)
    cons.sleep(1)
    cons.wake_up()
    hits0 = cons.kv.offload_hits
    toks = _run(cons, prompt, rid + "-c")
    assert cons.kv.offload_hits - hits0 >= _pages(prompt) - 1
    return got, toks


def _kv(blob):
    return [np.asarray(a, np.float32) for a in jserde.deserialize(blob)]


# -- the pairs -------------------------------------------------------------------


def test_a_port_pair_over_tcp_gives_the_jax_engines_tokens(engines, mono):
    """TestDisaggPrefill.test_kv_ships_and_decode_continues on the port, beside
    the same flow on a JAX pair."""
    prompt = PROMPTS["tcp"]
    pp, pc = engines["port"]
    sent0, recv0 = pp._kv_sender.sent_chunks, pc._kv_receiver.received_chunks
    got, toks = _transfer(pp, pc, "tcp", prompt, "pair")
    n = _pages(prompt)
    assert pp._kv_sender.sent_chunks - sent0 == n == len(got)
    assert pc._kv_receiver.received_chunks - recv0 == n
    assert pc.stats()["kv_transfer_received_chunks_total"] >= n and pc.stats()["kv_offload_hit_pages_total"] >= n
    jp, jc = engines["jax"]
    _, jtoks = _transfer(jp, jc, "tcp", prompt, "jpair")
    assert toks == jtoks == mono(prompt)


@pytest.mark.parametrize("consumer", ["port", "jax"])
@pytest.mark.parametrize("wire", ["tcp", "fabric"])
def test_pairs_across_the_packages_interoperate(engines, mono, wire, consumer):
    """A producer of the other package lands the keys one of the consumer's
    own package lands, with the same headers but the checksum and K/V
    within 2e-5, and the consumer decodes the JAX monolithic tokens."""
    other = "jax" if consumer == "port" else "port"
    cons = engines[consumer][1]
    prompt = PROMPTS[wire]
    own, _ = _transfer(engines[consumer][0], cons, wire, prompt, f"own-{wire}-{consumer}")
    cross, toks = _transfer(engines[other][0], cons, wire, prompt, f"cross-{wire}-{consumer}")
    keys = [h.hex() for h in prefix_hashes(cons.tokenizer.encode(prompt), 8)]
    assert sorted(cross) == sorted(own) == sorted(keys)
    for key in keys:
        h_own, h_cross = verify_blob(own[key]), verify_blob(cross[key])
        assert {k: v for k, v in h_cross.items() if k != "crc"} == {k: v for k, v in h_own.items() if k != "crc"}
        for a, b in zip(_kv(cross[key]), _kv(own[key])):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert toks == mono(prompt)
    if wire == "fabric":
        fab = engines[other][0].stats()
        assert fab["kv_fabric_pushed_pages_total"] >= len(keys) and fab["kv_fabric_corrupt_frames_total"] == 0


@pytest.mark.parametrize("layers", [1, 2])
def test_streamed_layer_windows_land_what_whole_frames_land(engines, layers):
    pp, pc = engines["port"]
    prompt = PROMPTS["fabric"]
    whole, toks = _transfer(pp, pc, "fabric", prompt, f"whole-{layers}", kv_fabric_stream_layers=0)
    windows, toks_w = _transfer(pp, pc, "fabric", prompt, f"win-{layers}", kv_fabric_stream_layers=layers)
    assert windows == whole and len(whole) == _pages(prompt) and toks_w == toks
    assert pc._fabric_asm.dropped_partials == 0 and not pc._fabric_asm._pending
    pp.cfg = dataclasses.replace(pp.cfg, kv_fabric_stream_layers=0)


def test_a_fabric_push_to_a_dead_peer_falls_back_to_blobs(engines, mono):
    pp, pc = engines["port"]
    prompt = PROMPTS["fabric"]
    _point(pp, pc, "tcp")
    pp.cfg = dataclasses.replace(pp.cfg, kv_fabric_peer="127.0.0.1:1")  # nothing listens there
    st0 = pp.stats()
    with _landings(pc) as got:
        _run(pp, prompt, "dead-p", 1)
    st = pp.stats()
    n = _pages(prompt)
    assert st["kv_fabric_fallbacks_total"] - st0["kv_fabric_fallbacks_total"] == n
    assert st["kv_transfer_sent_chunks_total"] - st0["kv_transfer_sent_chunks_total"] == n == len(got)
    pc.sleep(1)
    pc.wake_up()
    assert _run(pc, prompt, "dead-c") == mono(prompt)
    pp.cfg = dataclasses.replace(pp.cfg, kv_fabric_peer=None)


def test_int8_pools_ship_over_the_fabric_and_are_refused_without_it(params):
    """TestInt8FabricPair.test_int8_disagg_prefill_over_fabric on the port,
    against monolithic int8 engines of both packages."""
    prompt = "quantized kv pages crossing the fabric with scales " * 3
    q = dict(kv_cache_dtype="int8", kv_fabric=True)
    cons = _port(params, kv_role="consumer", kv_transfer_port=0, **q)
    prod = _port(params, kv_role="producer", kv_peer_url=f"127.0.0.1:{cons._kv_receiver.bound_port}",
                 kv_fabric_peer=cons._fabric_server.address, **q)
    try:
        with _landings(cons) as got:
            _run(prod, prompt, "q-p", 1)
        n = _pages(prompt)
        assert prod._fabric_client.pushed_pages == n and cons._fabric_server.received_pages == n
        assert prod._fabric_client.corrupt_frames == 0 and cons.stats()["kv_fabric_corrupt_frames_total"] == 0
        assert prod._kv_sender.sent_chunks == 0 and all(verify_blob(b)["v"] == 3 for b in got.values())
        toks = _run(cons, prompt, "q-c")
        assert cons.kv.offload_hits >= n
    finally:
        prod.stop()
        cons.stop()
    pmono = _port(params, kv_cache_dtype="int8")
    jmono = _jax(kv_cache_dtype="int8")
    try:
        assert toks == _run(pmono, prompt, "q-pm") == _run(jmono, prompt, "q-jm")
    finally:
        pmono.stop()
        jmono.stop()
    words = "--kv-cache-dtype int8 with disaggregated-prefill or device KV transfer requires --kv-fabric"
    for role in ("consumer", "producer"):
        kw = dict(kv_role=role, kv_peer_url="127.0.0.1:9", kv_cache_dtype="int8")
        with pytest.raises(ValueError, match=words):
            LLMEngine(EngineConfig(**SMALL, **kw), device="cpu")
        with pytest.raises(ValueError, match=words):
            JaxEngine(JaxEngineConfig(**SMALL, **kw))


# -- the device path's protocol, with a stand-in endpoint ----------------------


class StandInEndpoint(DeviceKVEndpoint):
    """DeviceKVEndpoint with its CUDA IPC export and open replaced by a table
    of this process (an IPC handle cannot be opened in the process that made
    it, and the CPU has none): everything else, the listener, the handle
    fetch, dead-address marking, the offers' retirement and the copy, is the
    package's."""

    _table: dict = {}

    def _export(self, t):
        token = f"{id(self)}:{len(self._table)}"
        self._table[token] = t
        return {"token": token}

    def _open(self, handle):
        return self._table[handle["token"]]


def _arm(engine):
    engine.runner.kv_endpoint = StandInEndpoint(engine.runner.device)
    engine._arm_device_kv()


@pytest.fixture
def device_pair(params):
    cons = _port(params, kv_role="consumer", kv_transfer_port=0)
    prod = _port(params, kv_role="producer", kv_peer_url=f"127.0.0.1:{cons._kv_receiver.bound_port}")
    _arm(cons)
    _arm(prod)
    yield prod, cons
    prod.stop()
    cons.stop()


def test_the_device_path_ships_every_page_through_the_endpoints(device_pair, mono):
    prod, cons = device_pair
    prompt = PROMPTS["tcp"]
    n = _pages(prompt)
    _run(prod, prompt, "dev-p", 1)
    st, cst = prod.stats(), cons.stats()
    assert st["kv_transfer_device_pages_total"] == n and st["kv_transfer_sent_chunks_total"] == 0
    assert cst["kv_transfer_device_pages_total"] == n and cst["kv_transfer_received_chunks_total"] == 0
    # every offer retired with the consumer's answer: nothing stays pinned
    assert st["kv_transfer_pinned_offer_bytes"] == 0 and prod.runner.kv_endpoint.offered_pages == n
    assert len(cons.runner.kv_staged) == n
    assert _run(cons, prompt, "dev-c") == mono(prompt)
    cst = cons.stats()
    assert cst["kv_offload_device_loaded_pages_total"] == n and not cons.runner.kv_staged
    # the restored pages are the producer's, byte for byte
    keys = [h for h in prefix_hashes(cons.tokenizer.encode(prompt), 8)]
    pk, pv = prod.runner.get_pages([prod.kv.hash_to_page[h] for h in keys])
    ck, cv = cons.runner.get_pages([cons.kv.hash_to_page[h] for h in keys])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(pk + pv, ck + cv))


def test_a_dead_producer_is_marked_and_its_pages_ship_as_blobs(device_pair, mono):
    prod, cons = device_pair
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"  # closed again: nothing listens
    prod._kv_sender._dev_addr = dead
    prompt = PROMPTS["tcp"]
    n = _pages(prompt)
    t0 = time.perf_counter()
    _run(prod, prompt, "fb-p", 1)
    assert time.perf_counter() - t0 < DeviceKVEndpoint.PROBE_TIMEOUT_S
    ep = cons.runner.kv_endpoint
    assert ep._dead_addrs[dead] > time.monotonic() and ep.pulled_pages == 0
    assert prod._kv_sender.sent_chunks == n and prod._kv_sender.device_pages == 0
    assert cons._kv_receiver.received_chunks == n and cons._kv_receiver.device_pages == 0
    assert cons._kv_receiver.staging._bytes == 0 and not cons.runner.kv_staged  # every reservation released
    pep = prod.runner.kv_endpoint  # a failed pull's offer retires with its answer too
    assert pep.offered_pages == n and pep.pinned_offer_bytes() == 0 and pep.leaked_offers == 0
    with pytest.raises(ConnectionError, match="marked dead"):
        ep.pull(dead, 1, [1], "float32")
    assert _run(cons, prompt, "fb-c") == mono(prompt)
    assert cons._offload.device_loaded_pages == 0


def test_page_query_reserves_answers_have_and_refuses(device_pair):
    _, cons = device_pair
    cons._kv_receiver.staging.max_bytes = 3000
    cli = BlockingClient("127.0.0.1", cons._kv_receiver.bound_port)
    q = lambda key, n=1000: cli.request({"op": "page_query", "key": key, "nbytes": n})[0]  # noqa: E731
    assert q("a") == {"ok": True, "have": False}
    assert q("a") == {"ok": False, "have": False}  # in flight: the producer keeps its blob path
    cons._kv_receiver.staging.promote("a", 1000)
    assert q("a") == {"ok": False, "have": True}  # staged: the producer skips the page
    assert q("b")["ok"] and not q("c", 1001)["ok"]  # 2,000 of 3,000 bytes held: over the budget
    # a page_ready whose pull fails releases its reservation
    hdr, _ = cli.request({"op": "page_ready", "key": "b", "addr": "127.0.0.1:1", "uuid": 5,
                          "shape": [1], "dtype": "float32"})
    assert hdr == {"ok": False} and q("c", 1001)["ok"]
    cli.close()


def test_staging_promotes_unreserves_expires_and_keeps_its_byte_cap():
    fired = []
    st = DeviceStaging(max_bytes=2500, ttl=0.2, on_expire=fired.append)
    assert st.reserve("a", 1000) == "reserved" and st.reserve("b", 1000) == "reserved"
    assert st.reserve("c", 1000) == "full"  # the byte cap
    st.unreserve("b")
    assert st._bytes == 1000 and st.reserve("c", 1000) == "reserved"
    st.promote("a", 1000)
    assert st.contains("a") and st.reserve("a", 1000) == "have" and st._bytes == 2000
    st.promote("late", 500)  # its reservation expired mid-pull: charged now
    assert st._bytes == 2500 and st.pop("late") and st._bytes == 2000
    time.sleep(0.3)
    assert not st.contains("a") and st.expired_pages == 1 and st._bytes == 0
    deadline = time.time() + 5
    while not fired and time.time() < deadline:
        time.sleep(0.01)
    assert fired == ["a"]  # the runner drops its staged copy with the entry
    assert not st.pop("a")


def test_offers_retire_with_their_answer_or_by_age():
    ep = StandInEndpoint("cpu")
    try:
        page = torch.zeros(2, 2, 8, 4, 16)  # K and V of a page: [2, L, page, KH, D]
        nbytes = page.numel() * page.element_size()
        ep.OFFER_TTL = 0.1
        for u in range(3):
            ep.offer_fixed(u, page.clone())
        assert ep.pinned_offer_bytes() == 3 * nbytes
        ep.retire(0)  # answered: gone at once, not counted as leaked
        ep.retire(0)  # a second retirement is a no-op
        assert ep.pinned_offer_bytes() == 2 * nbytes and ep.handle(0) is None and ep.leaked_offers == 0
        time.sleep(0.2)
        ep.OFFER_TTL = 60.0
        ep.offer_fixed(3, page.clone())  # the sweep drops the two never retired
        assert ep.leaked_offers == 2 and ep.pinned_offer_bytes() == nbytes and ep.handle(1) is None
        ep.offer_fixed(4, page.clone())
        ep.retire(3)
        assert ep.stats() == {"kv_transfer_pinned_offer_bytes": nbytes, "kv_transfer_leaked_offers_total": 2,
                              "kv_transfer_cap_evicted_offers_total": 0}
        # the listener answers an offer's handle, and refuses a retired one
        cli = BlockingClient("127.0.0.1", int(ep.address.rsplit(":", 1)[1]))
        assert cli.request({"op": "ipc_handle", "uuid": 4})[0]["ok"]
        assert cli.request({"op": "ipc_handle", "uuid": 3})[0] == {"ok": False, "error": "unknown offer"}
        cli.close()
    finally:
        ep.close()


# -- the router and the servers --------------------------------------------------


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


def _stream_text(base, prompt):
    body = {"model": "m", "prompt": prompt, "max_tokens": N_TOKENS, "temperature": 0.0, "ignore_eos": True,
            "stream": True}
    text = ""
    with requests.post(f"{base}/v1/completions", json=body, stream=True, timeout=120) as r:
        assert r.status_code == 200, r.text
        for line in r.iter_lines():
            line = line.decode()
            if line.startswith("data: ") and line != "data: [DONE]":
                text += "".join(c.get("text", "") for c in json.loads(line[6:])["choices"])
    return text


def test_the_jax_router_streams_a_monolithic_servers_text_over_two_port_servers(params, engines):
    """The port's router (the JAX router once, hence the name) in
    disaggregated_prefill mode over a port producer and consumer streams a
    monolithic port server's text."""
    loop = _Loop()
    servers = []
    try:
        def serve(**kw):
            cfg = EngineConfig(**SMALL, port=free_port(), served_model_name="m", **kw)
            eng = LLMEngine(cfg, device="cpu", params=params)  # built off the loop
            servers.append(loop.run(port_server.serve(cfg, eng, device="cpu")))
            return eng, f"http://127.0.0.1:{cfg.port}"

        cons, curl = serve(kv_role="consumer", kv_transfer_port=0, kv_fabric=True)
        prod, purl = serve(kv_role="producer", kv_peer_url=f"127.0.0.1:{cons._kv_receiver.bound_port}",
                           kv_fabric=True, kv_fabric_peer=curl)  # resolved through GET /kv_fabric
        _, murl = serve()
        rport = free_port()
        router = start_proc(["-m", "production_stack_tpu_torch.router.app", "--port", str(rport),
                             "--static-backends", f"{purl},{curl}", "--static-models", "m,m",
                             "--static-model-labels", "prefill,decode", "--routing-logic", "disaggregated_prefill",
                             "--prefill-model-labels", "prefill", "--decode-model-labels", "decode",
                             "--engine-stats-interval", "1"])
        try:
            wait_healthy(f"http://127.0.0.1:{rport}/health", router, timeout=60)
            prompt = PROMPTS["fabric"]
            via_router = _stream_text(f"http://127.0.0.1:{rport}", prompt)
        finally:
            log = stop_proc(router)
        assert "to prefill=" + purl in log and f"decode={curl}" in log
        assert via_router == _stream_text(murl, prompt) and via_router
        n = _pages(prompt)
        assert prod.stats()["kv_fabric_pushed_pages_total"] == n and cons.stats()["kv_offload_hit_pages_total"] >= n
        # /kv_fabric as a JAX server answers it (the JAX consumer's listener)
        info = requests.get(f"{curl}/kv_fabric", timeout=10).json()
        jinfo = asyncio.run(jax_server.EngineServer.kv_fabric_info(types.SimpleNamespace(
            engine=engines["jax"][1]), None))
        jinfo = json.loads(jinfo.body)
        assert {k: type(v) for k, v in info.items()} == {k: type(v) for k, v in jinfo.items()}
        assert info["enabled"] and info["addr"] == cons._fabric_server.address and info["page_size"] == 8
        assert requests.get(f"{murl}/kv_fabric", timeout=10).json() == {"enabled": False}
        # the gauge the router's decode pick scrapes, as its scraper reads it
        from production_stack_tpu_torch.router.engine_stats import EngineStats

        text = requests.get(f"{purl}/metrics", timeout=10).text
        assert 'vllm:kv_fabric_peer_bandwidth_bytes_per_sec{model_name="m",peer="none"} 0' in text
        assert "vllm:kv_fabric_stream_latency_seconds_count" in text
        assert EngineStats.from_scrape(text).kv_fabric_peer_bandwidth_bytes_per_sec == 0.0
    finally:
        for srv, run in servers:
            loop.run(run.cleanup())
            srv.engine.stop()
        loop.close()


# -- tp 2 ------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["producer", "consumer"])
def test_a_tp2_engine_pairs_over_tcp_and_the_fabric(params, engines, mono, side):
    """One engine of the pair at tp 2 (gloo ranks; a process leads one tp
    group at a time), the other the module's tp 1 engine: the TCP and the
    fabric pair give tp 1's tokens."""
    pp, pc = engines["port"]
    tp2 = dict(tensor_parallel_size=2, tp_backend="gloo", kv_fabric=True)
    if side == "producer":
        eng = _port(params, kv_role="producer", kv_peer_url=f"127.0.0.1:{pc._kv_receiver.bound_port}", **tp2)
        pair = (eng, pc)
    else:
        eng = _port(params, kv_role="consumer", kv_transfer_port=0, **tp2)
        pair = (pp, eng)
    try:
        for wire in ("tcp", "fabric"):
            got, toks = _transfer(*pair, wire, PROMPTS[wire], f"tp2-{side}-{wire}")
            assert len(got) == _pages(PROMPTS[wire]) and toks == mono(PROMPTS[wire])
    finally:
        eng.stop()


# -- refusals --------------------------------------------------------------------


@pytest.mark.parametrize("kw,words", [
    (dict(kv_role="consumer", kv_transfer_device=True), "off the card"),
    (dict(kv_role="consumer", kv_transfer_device=True, tensor_parallel_size=2, tp_backend="gloo"),
     "with tp or dp ranks"),
    (dict(kv_role="consumer", kv_transfer_device=True, data_parallel_size=2, tp_backend="gloo"),
     "with tp or dp ranks"),
    (dict(kv_role="consumer", kv_transfer_device=True, distributed_num_processes=2), "across hosts"),
    (dict(kv_role="producer"), "kv_role=producer requires --kv-peer-url"),
    (dict(kv_role="decoder"), "unknown kv_role"),
], ids=["device-on-cpu", "device-tp2", "device-dp2", "device-multihost", "producer-without-peer", "bad-role"])
def test_the_refusals(kw, words):
    with pytest.raises(ValueError, match=words):
        LLMEngine(EngineConfig(**SMALL, **kw), device="cpu")
    if "producer" in kw.values():  # the JAX engine's own words
        with pytest.raises(ValueError, match=words):
            JaxEngine(JaxEngineConfig(**SMALL, **kw))
