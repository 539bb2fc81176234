"""The port's KV services (production_stack_tpu_torch/kvoffload/): the cache
server behind the remote tier, the KV-index controller and warm-start
manifests, against the JAX package's.

The unit cases of tests/test_kvoffload.py (TestCacheServer, TestController,
the remote-tier corruption cases) and tests/test_warm_restart.py
(TestWarmStartManager) run on the port's copies. Then the engines: a JAX and
a port engine on the f32 twin, each over its own cache server and
controller, put the same keys into their servers (blobs alike in headers
but the checksum, K/V within 2e-5), answer the same controller lookups and write
the same warm manifests but for times and generations; the port's
router's kvaware routing sends a prompt to the port engine that holds its
prefix; and a port engine restarted over the same disk tier or cache server,
at tp 1 and at tp 2, hits at least half of its prefix pages on its first
round with the same greedy tokens. Servers run on a loop thread of this
process; the router is a subprocess, each wait with its own timeout.
"""

import asyncio
import json
import re
import socket
import threading
import time

import jax
import numpy as np
import pytest
import requests

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.kvoffload import cache_server as jcache_server
from production_stack_tpu.kvoffload import controller as jcontroller
from production_stack_tpu.kvoffload import serde as jserde
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import free_port, start_proc, stop_proc, wait_healthy
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_manager import KVPageManager, prefix_hashes
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvoffload import cache_server, controller
from production_stack_tpu_torch.kvoffload.serde import get_serde, seal_bytes, verify_blob
from production_stack_tpu_torch.kvoffload.tiers import RemoteTier, TieredKVStore
from production_stack_tpu_torch.kvoffload.warmstart import WarmStartManager
from production_stack_tpu_torch.models import llama as tllama

MODEL = "llama-debug-4kv-f32"


class _Loop:
    """An asyncio loop on a thread of its own: servers live there while the
    test talks to them synchronously."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def host(self, handle) -> tuple[int, object]:
        """Serve ``handle`` (a frame server's connection callback) on an
        ephemeral port; returns (port, server)."""
        server = self.run(asyncio.start_server(handle, "127.0.0.1", 0))
        return server.sockets[0].getsockname()[1], server

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture
def loop():
    lp = _Loop()
    yield lp
    lp.close()


def _blob(seed=0):
    rng = np.random.RandomState(seed)
    k, v = rng.randn(2, 8, 2, 4).astype(np.float32), rng.randn(2, 8, 2, 4).astype(np.float32)
    return get_serde("naive").serialize(k, v)


# -- the cache server (tests/test_kvoffload.py TestCacheServer) -----------------


def test_remote_tier_puts_and_gets_over_tcp(loop):
    port, _ = loop.host(cache_server.CacheServer(1 << 20).handle)
    remote = RemoteTier(f"127.0.0.1:{port}")
    assert remote.get("nope") is None
    blob = seal_bytes(b"payload-bytes")
    remote.put("key1", blob)
    assert remote.get("key1") == blob and "key1" in remote
    remote.delete("key1")
    assert "key1" not in remote
    remote.close()


def test_two_stores_share_one_server(loop):
    port, _ = loop.host(cache_server.CacheServer(1 << 20).handle)
    a = TieredKVStore(cpu_bytes=1000, remote_url=f"127.0.0.1:{port}")
    b = TieredKVStore(cpu_bytes=1000, remote_url=f"127.0.0.1:{port}")
    blob = seal_bytes(b"kv-blob")
    a.put("shared", blob)
    assert b.get("shared") == blob and b.hits["remote"] == 1
    assert a.durable() and not TieredKVStore(cpu_bytes=1000).durable()


@pytest.mark.parametrize("server_mod", [cache_server, jcache_server], ids=["port", "jax"])
def test_cache_server_lru_stats_and_op_answers_match_the_jax_servers(server_mod, loop):
    """The same frames to both servers (the JAX one with its directory off,
    as the port has none) give the same answers, stats and LRU order."""
    from production_stack_tpu_torch.kvoffload.protocol import BlockingClient

    cs = server_mod.CacheServer(3 * len(_blob()) + 10)
    port, _ = loop.host(cs.handle)
    c = BlockingClient("127.0.0.1", port)
    answers = []
    for i in range(4):  # the fourth put evicts the oldest
        answers.append(c.request({"op": "put", "key": f"k{i}"}, _blob(i))[0])
    for key in ("k0", "k1", "k3"):
        hdr, body = c.request({"op": "get", "key": key})
        answers.append((hdr, body == _blob(int(key[1])) if body else None))
    for op in ({"op": "exists", "key": "k2"}, {"op": "delete", "key": "k2"}, {"op": "delete", "key": "k2"},
               {"op": "ping"}, {"op": "dir_lookup", "tokens": [1, 2]}, {"op": "bogus"}):
        answers.append(c.request(op)[0])
    answers.append(c.request({"op": "stats"})[0])
    c.close()
    assert answers == [
        {"ok": True}, {"ok": True}, {"ok": True}, {"ok": True},
        ({"ok": True, "found": False}, None), ({"ok": True, "found": True}, True),
        ({"ok": True, "found": True}, True),
        {"ok": True, "found": True}, {"ok": True, "found": True}, {"ok": True, "found": False}, {"ok": True},
        {"ok": False, "error": "directory disabled"}, {"ok": False, "error": "bad op 'bogus'"},
        {"ok": True, "entries": 2, "used_bytes": len(_blob(1)) + len(_blob(3)), "max_bytes": 3 * len(_blob()) + 10,
         "gets": 3, "hits": 2, "puts": 4, "corrupt": 0},
    ]


def test_cache_server_quarantines_a_corrupt_entry():
    cs = cache_server.CacheServer(max_bytes=1 << 20)
    bad = bytearray(_blob())
    bad[-2] ^= 0x10
    cs.put("k", bytes(bad))
    assert cs.get("k") is None and cs.corrupt == 1  # never fanned out to the fleet
    assert cs.get("k") is None and cs.corrupt == 1  # gone, not failed again
    assert cs.stats()["corrupt"] == 1 and cs.stats()["entries"] == 0


def test_disk_corruption_falls_back_to_the_remote_copy(loop, tmp_path):
    port, _ = loop.host(cache_server.CacheServer(1 << 20).handle)
    st = TieredKVStore(disk_path=str(tmp_path), disk_bytes=1 << 20, remote_url=f"127.0.0.1:{port}")
    blob = _blob()
    st.put("k", blob)  # disk, and written through to the server
    f = tmp_path / "k.kv"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    f.write_bytes(bytes(raw))
    assert st.get("k") == blob  # served from the remote copy
    assert st.corrupt_pages == 1 and st.hits["remote"] == 1


def test_a_corrupt_remote_blob_is_a_miss_and_a_dead_server_is_a_miss(loop):
    cs = cache_server.CacheServer(1 << 20)
    port, server = loop.host(cs.handle)
    st = TieredKVStore(remote_url=f"127.0.0.1:{port}")
    bad = bytearray(_blob())
    bad[-1] ^= 0xFF
    cs.put("k", bytes(bad))
    assert st.get("k") is None and cs.corrupt == 1  # the server quarantined it
    st.remote._client.close()

    async def close():
        # on the server's own loop: an asyncio server is not thread-safe (a
        # close from this thread raced the loop's teardown of the closed
        # connection: both woke the server's waiters, and the second raised)
        server.close()
        await server.wait_closed()

    loop.run(close())
    # the dead server's port, kept bound and never listening: a connect is
    # refused, and no other process (nor the client's own source port) can
    # take the port the way a freed one can be taken
    with socket.socket() as dead:
        dead.bind(("127.0.0.1", 0))
        st.remote._client.port = dead.getsockname()[1]
        assert st.get("other") is None and st.stats()["remote_errors"] >= 1  # recompute, not an error


# -- the controller (tests/test_kvoffload.py TestController) -------------------


def _controller_session(mod, port, tokens, page):
    """Register two engines, admit, lookup, evict, deregister: the answers."""
    hashes = [h.hex() for h in prefix_hashes(tokens, page)]
    w1 = mod.WorkerClient(f"127.0.0.1:{port}", "eng-1")
    w1.register("http://e1:8100", page)
    w1.admit(hashes[:3])
    w2 = mod.WorkerClient(f"127.0.0.1:{port}", "eng-2")
    w2.register("http://e2:8100", page)
    w2.admit(hashes[:1])

    async def lookup():
        c = mod.ControllerClient(f"127.0.0.1:{port}")
        try:
            return await c.lookup(tokens), await c.lookup_url(tokens), await c.stats()
        finally:
            await c.close()

    out = [asyncio.run(lookup())]
    w1.evict(hashes[:3])
    out.append(asyncio.run(lookup()))
    w2.deregister()
    out.append(asyncio.run(lookup()))
    w1.close()
    w2.close()
    return out


def test_controller_admit_lookup_evict_answers_match_the_jax_controllers(loop):
    tokens = list(range(32))  # 4 chunks of 8
    got = {}
    for name, mod in (("port", controller), ("jax", jcontroller)):
        port, _ = loop.host(mod.KVIndexController().handle)
        got[name] = _controller_session(mod, port, tokens, 8)
    assert got["port"] == got["jax"]
    (first, url, stats), (second, _, _), (third, _, _) = got["port"]
    assert first["instance_id"] == "eng-1" and url == "http://e1:8100" and first["matched_chunks"] == 3
    assert stats["instances"]["eng-1"]["chunks"] == 3
    assert second["instance_id"] == "eng-2" and second["matched_chunks"] == 1
    assert third["instance_id"] is None
    # the controller hashes with the port's own prefix_hashes, the JAX one's chain
    from production_stack_tpu.engine.kv_manager import prefix_hashes as jax_prefix_hashes

    assert prefix_hashes(tokens, 8) == jax_prefix_hashes(tokens, 8)


# -- warm-start manifests (tests/test_warm_restart.py TestWarmStartManager) -----


class _FakeConnector:
    """save_pages writes a valid sealed blob per hash (returning the
    confirmed set, like the connector), load_pages_sparse answers from the
    store."""

    def __init__(self, store=None, fail_after=None):
        self.store = store or TieredKVStore(cpu_bytes=1 << 20)
        self.fail_after = fail_after
        k = np.zeros((1, 4, 1, 2), np.float32)
        self._blob = get_serde("naive").serialize(k, k)

    def save_pages(self, pairs):
        ok = set()
        for _pid, h in pairs:
            if self.fail_after is not None and len(ok) >= self.fail_after:
                break  # a tier failure mid-batch: the rest never stored
            self.store.put(h.hex(), self._blob)
            ok.add(h)
        return ok

    def load_pages_sparse(self, pairs):
        return [self.store.get(h.hex()) is not None for _, h in pairs]


def _filled_kv(tokens, num_pages=16, page=4):
    kv = KVPageManager(num_pages, page)
    pages = kv.allocate(len(tokens) // page)
    kv.register_filled(tokens, pages)
    kv.free(pages)
    return kv


TOKS = list(range(32))  # 8 pages at page_size 4


def test_warm_spill_restore_roundtrip_rebuilds_the_prefix_cache():
    conn = _FakeConnector()
    a = WarmStartManager(_filled_kv(TOKS), conn, namespace="ns1")
    assert a.restore() == 0 and a.generation == 1  # a cold tier
    assert a.spill("drain") == 8
    kv_b = KVPageManager(16, 4)
    b = WarmStartManager(kv_b, conn, namespace="ns1")
    assert b.restore() == 8 and b.generation == 2 and b.restored_pages == 8
    assert b.restored_manifest_age_s is not None
    assert kv_b.num_free() == 16  # restored pages are evictable, not pinned
    assert kv_b.match_prefix(TOKS)[1] == 32


def test_generation_fencing_makes_the_old_incarnation_inert():
    conn = _FakeConnector()
    a = WarmStartManager(_filled_kv(TOKS), conn, namespace="ns2")
    a.restore()
    a.spill("drain")
    b = WarmStartManager(KVPageManager(16, 4), conn, namespace="ns2")
    b.restore()
    assert b.generation == a.generation + 1
    assert a.spill("late-flush") == 0 and a.fenced
    c = WarmStartManager(KVPageManager(16, 4), conn, namespace="ns2")
    c.restore()
    assert c.generation == b.generation + 1


@pytest.mark.parametrize("case", ["corrupt_manifest", "page_size_change"])
def test_an_unusable_manifest_is_a_cold_start(case):
    conn = _FakeConnector()
    a = WarmStartManager(_filled_kv(TOKS), conn, namespace="ns4")
    a.restore()
    a.spill("drain")
    if case == "corrupt_manifest":
        key = a.manifest_key(a.generation)
        raw = bytearray(conn.store.get(key))
        raw[-4] ^= 0xFF
        conn.store.cpu._data[key] = bytes(raw)
    b = WarmStartManager(KVPageManager(16, 4 if case == "corrupt_manifest" else 8), conn, namespace="ns4")
    assert b.restore() == 0
    assert b.generation == a.generation + 1  # the fence still advances
    assert b.stale_manifests_skipped == (case == "page_size_change")


def test_the_manifest_caps_at_the_hottest_chain_heads():
    conn = _FakeConnector()
    kv = _filled_kv(TOKS)
    for _ in range(3):
        shared, _ = kv.match_prefix(TOKS)
        kv.free(shared)
    m = WarmStartManager(kv, conn, namespace="ns6", max_pages=3)
    m.restore()
    assert m.spill("drain") == 3
    kv_b = KVPageManager(16, 4)
    WarmStartManager(kv_b, conn, namespace="ns6").restore()
    assert kv_b.match_prefix(TOKS)[1] == 3 * 4  # a contiguous head of the chain


def test_cpu_plus_disk_state_survives_process_death(tmp_path):
    store_a = TieredKVStore(cpu_bytes=1 << 20, disk_path=str(tmp_path), disk_bytes=1 << 20)
    a = WarmStartManager(_filled_kv(TOKS), _FakeConnector(store_a), namespace="nsd")
    a.restore()
    assert a.spill("drain") == 8
    store_b = TieredKVStore(cpu_bytes=1 << 20, disk_path=str(tmp_path), disk_bytes=1 << 20)  # DRAM gone
    kv_b = KVPageManager(16, 4)
    assert WarmStartManager(kv_b, _FakeConnector(store_b), namespace="nsd").restore() == 8
    assert kv_b.match_prefix(TOKS)[1] == 32


def test_a_partial_save_failure_keeps_unsaved_pages_restorable():
    kv = _filled_kv(TOKS)
    conn = _FakeConnector(fail_after=5)
    m = WarmStartManager(kv, conn, namespace="nsp")
    m.restore()
    assert m.spill("drain") == 5
    unsaved = [pid for pid in range(kv.num_pages) if kv.pages[pid].hash is not None and not kv.pages[pid].offloaded]
    assert len(unsaved) == 3
    conn.fail_after = None
    assert m.spill("retry") == 8


def test_a_stale_fencer_is_taken_over():
    conn = _FakeConnector()
    a = WarmStartManager(_filled_kv(TOKS), conn, namespace="nst", interval_s=1.0)
    a.restore()
    a.spill("drain")
    b = WarmStartManager(KVPageManager(16, 4), conn, namespace="nst")
    b.generation = 0  # the inverted-fence claim
    assert b.spill("x") == 0 and b.fenced
    assert not b._try_takeover()  # a fresh head: the fence holds
    head = b._read_json(b.head_key)
    head["ts"] = time.time() - 10_000
    conn.store.put(b.head_key, seal_bytes(json.dumps(head).encode(), kind="warmstart"))
    assert b._try_takeover() and not b.fenced and b.generation == 2


def test_the_fence_is_seen_through_a_private_local_cache(tmp_path):
    store_a = TieredKVStore(cpu_bytes=1 << 20, disk_path=str(tmp_path), disk_bytes=1 << 20)
    a = WarmStartManager(_filled_kv(TOKS), _FakeConnector(store_a), namespace="nsf")
    a.restore()
    a.spill("drain")
    store_b = TieredKVStore(cpu_bytes=1 << 20, disk_path=str(tmp_path), disk_bytes=1 << 20)
    b = WarmStartManager(KVPageManager(16, 4), _FakeConnector(store_b), namespace="nsf")
    b.restore()
    assert b.generation == a.generation + 1
    assert a.spill("late") == 0 and a.fenced


def test_the_fence_survives_transient_head_read_misses():
    conn = _FakeConnector()
    a = WarmStartManager(_filled_kv(TOKS), conn, namespace="nsb")
    a.restore()
    a.spill("drain")
    b = WarmStartManager(KVPageManager(16, 4), conn, namespace="nsb")
    b.generation = 0
    assert b.spill("x") == 0 and b.fenced
    conn.store.cpu.delete(b.head_key)
    for _ in range(WarmStartManager.FENCE_MISS_STREAK - 1):
        assert not b._try_takeover() and b.fenced
    assert b._try_takeover() and not b.fenced


def test_maybe_spill_defers_while_busy_then_forces():
    m = WarmStartManager(_filled_kv(TOKS), _FakeConnector(), namespace="ns7", interval_s=1e-6)
    m.restore()
    m._last_spill_mono = time.monotonic()
    m.interval_s = 3600.0
    assert m.maybe_spill(busy=False) == 0
    m._last_spill_mono = time.monotonic() - 3700.0
    assert m.maybe_spill(busy=True) == 0
    m._last_spill_mono = time.monotonic() - 7300.0
    assert m.maybe_spill(busy=True) > 0


# -- engines: the port's against the JAX package's ------------------------------

PROMPT = "The quick brown fox jumps over the lazy dog, twice over and back. " * 2  # 131 tokens: 16 full pages
ENGINE = dict(model=MODEL, host="127.0.0.1", max_model_len=256, max_num_seqs=4, num_pages=40, page_size=8,
              prefill_chunk=32, warm_start=True, warm_start_namespace="stack", kv_instance_id="e0",
              kv_offload_max_io_pages=0)


async def _greedy(engine, prompt, sp_cls, n=6, rid="r"):
    toks, cached = [], 0
    async for out in engine.generate(rid, prompt=prompt, params=sp_cls(max_tokens=n, temperature=0.0,
                                                                       ignore_eos=True)):
        toks.extend(out.token_ids)
        cached = out.cached_tokens
    return toks, cached


def _manifest(store: dict) -> dict:
    """The served manifest of a cache server's blobs, without its times and
    generation."""
    from production_stack_tpu.kvoffload.serde import unseal_bytes

    head = json.loads(unseal_bytes(store["ws-stack-head"])[1])
    doc = json.loads(unseal_bytes(store[head["manifest"]])[1])
    return {k: v for k, v in doc.items() if k not in ("ts", "generation")}


def test_engines_fill_their_cache_servers_and_controllers_alike(loop):
    """The same prompt through a JAX and a port engine, each over its own
    cache server and controller: the same keys (the chunk hashes and the
    warm-start keys), each page blob with the same header but its checksum
    (serde, shape, dtype, version, payload length) and K/V within 2e-5 (the
    engines' f32 K/V differ by rounding, so the bytes do not), the same manifest but for times and
    generation, and the same controller answers."""
    servers, ctls = {}, {}
    for name, cs_mod, ctl_mod in (("jax", jcache_server, jcontroller), ("port", cache_server, controller)):
        servers[name] = cs_mod.CacheServer(1 << 24)
        ctls[name] = ctl_mod.KVIndexController()
    ports = {name: (loop.host(servers[name].handle)[0], loop.host(ctls[name].handle)[0]) for name in servers}
    engine_port = free_port()  # both advertise the same URL

    def cfg(cls, name):
        return cls(**ENGINE, port=engine_port, kv_remote_url=f"127.0.0.1:{ports[name][0]}",
                   kv_controller_url=f"127.0.0.1:{ports[name][1]}")

    jeng = JaxEngine(cfg(JaxEngineConfig, "jax"))
    params = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    peng = LLMEngine(cfg(EngineConfig, "port"), device="cpu", params=params_from_jax(params, tllama.PRESETS[MODEL]))
    toks = {}
    for name, eng, sp in (("jax", jeng, JaxSamplingParams), ("port", peng, SamplingParams)):
        eng.start()
        try:
            toks[name] = asyncio.run(_greedy(eng, PROMPT, sp))[0]
            assert eng.warm_spill() > 0
        finally:
            eng.stop()  # the controller reporter deregisters after its reports
    assert toks["port"] == toks["jax"]
    jdata, pdata = servers["jax"]._data, servers["port"]._data
    assert set(pdata) == set(jdata) and len(pdata) > 16
    pages = sorted(k for k in pdata if not k.startswith("ws-"))
    assert len(pages) >= 16  # the prompt's full pages and the output's
    for key in pages:
        jh, ph = verify_blob(jdata[key]), verify_blob(pdata[key])
        assert {k: v for k, v in ph.items() if k != "crc"} == {k: v for k, v in jh.items() if k != "crc"}
        for a, b in zip(jserde.deserialize(pdata[key]), jserde.deserialize(jdata[key])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=2e-5)
    assert _manifest(pdata) == _manifest(jdata) and len(_manifest(pdata)["entries"]) == len(pages)

    # the same lookups; the engines deregistered on stop, so register their
    # reports again as a live engine's (the admits the reporters sent)
    tokens = peng.tokenizer.encode(PROMPT)
    hashes = [h.hex() for h in prefix_hashes(tokens, 8)]
    answers = {}
    for name, mod in (("jax", jcontroller), ("port", controller)):
        w = mod.WorkerClient(f"127.0.0.1:{ports[name][1]}", "e0")
        w.register(f"http://127.0.0.1:{engine_port}", 8)
        w.admit(hashes)

        async def ask(mod=mod, name=name):
            c = mod.ControllerClient(f"127.0.0.1:{ports[name][1]}")
            try:
                return await c.lookup(tokens), await c.lookup(tokens[:20]), await c.lookup([7, 7, 7])
            finally:
                await c.close()

        answers[name] = asyncio.run(ask())
        w.close()
    assert answers["port"] == answers["jax"]
    assert answers["port"][0]["url"] == f"http://127.0.0.1:{engine_port}" and answers["port"][0]["matched_chunks"] == 16


def test_the_engine_reports_admits_to_the_controller_under_its_advertised_url(loop):
    ctl = controller.KVIndexController()
    cport, _ = loop.host(ctl.handle)
    cfg = EngineConfig(**dict(ENGINE, model="llama-debug", warm_start=False), port=free_port(),
                       kv_controller_url=f"127.0.0.1:{cport}", advertise_host="10.1.2.3")
    eng = LLMEngine(cfg, device="cpu")
    assert eng._offload is not None and not eng._offload.store.enabled()  # the controller alone: index only
    eng.start()
    try:
        asyncio.run(_greedy(eng, PROMPT, SamplingParams))
        tokens = eng.tokenizer.encode(PROMPT)
        deadline = time.time() + 10
        while time.time() < deadline and not ctl.lookup(tokens)["matched_chunks"]:
            time.sleep(0.05)
        res = ctl.lookup(tokens)
        assert res["url"] == f"http://10.1.2.3:{cfg.port}" and res["instance_id"] == "e0"
        assert res["matched_chunks"] == 16
    finally:
        eng.stop()
    deadline = time.time() + 10
    while time.time() < deadline and ctl.instances:
        time.sleep(0.05)
    assert not ctl.instances  # stop deregisters


def test_kvaware_router_sends_a_prefix_to_the_port_engine_that_holds_it(loop):
    """The port's router with --routing-logic kvaware in front of two
    port engines that report to the port's controller: each of two long
    prompts, first served by one engine directly (so the router's own
    prefix trie knows nothing), goes through the router to that engine."""
    ctl = controller.KVIndexController()
    cport, _ = loop.host(ctl.handle)
    engines, urls = [], []
    for i in range(2):
        cfg = EngineConfig(**dict(ENGINE, model="llama-debug", warm_start=False, kv_instance_id=f"e{i}"),
                           port=free_port(), served_model_name="m", kv_controller_url=f"127.0.0.1:{cport}")
        engines.append(loop.run(port_server.serve(cfg, LLMEngine(cfg, device="cpu"), device="cpu")))
        urls.append(f"http://127.0.0.1:{cfg.port}")
    rport = free_port()
    router = start_proc(["-m", "production_stack_tpu_torch.router.app", "--port", str(rport),
                         "--static-backends", ",".join(urls), "--static-models", "m,m",
                         "--routing-logic", "kvaware", "--kv-controller-url", f"127.0.0.1:{cport}",
                         "--engine-stats-interval", "1"])
    try:
        wait_healthy(f"http://127.0.0.1:{rport}/health", router, timeout=60)
        prompts = [f"engine {i} holds this long shared system prompt, page after page of it. " * 2 for i in range(2)]
        body = {"model": "m", "max_tokens": 2, "temperature": 0.0, "ignore_eos": True}
        for i, p in enumerate(prompts):  # warm engine i directly
            assert requests.post(f"{urls[i]}/v1/completions", json=dict(body, prompt=p), timeout=60).ok
        for i, p in enumerate(prompts):
            tokens = engines[i][0].engine.tokenizer.encode(p)
            deadline = time.time() + 10
            while time.time() < deadline and ctl.lookup(tokens)["url"] != urls[i]:
                time.sleep(0.05)
            assert ctl.lookup(tokens)["url"] == urls[i]
        for rep in range(2):
            for i, p in enumerate(prompts):
                r = requests.post(f"http://127.0.0.1:{rport}/v1/completions",
                                  json=dict(body, prompt=p + f" question {rep}"), timeout=60)
                assert r.status_code == 200, r.text
                rid = r.headers["X-Request-Id"]
                holders = [j for j, (srv, _) in enumerate(engines)
                           if any(rec["request_id"] == rid for rec in srv.engine.slo_records)]
                assert holders == [i]
                rec = next(rec for rec in engines[i][0].engine.slo_records if rec["request_id"] == rid)
                assert rec["cached_tokens"] >= 8 * 16  # the held prefix was a hit
    finally:
        stop_proc(router)
        for srv, run in engines:
            loop.run(run.cleanup())
            srv.engine.stop()


# -- warm restarts --------------------------------------------------------------

PAGE = 8
SHARED = "S" * (8 * PAGE)  # an 8-page prefix every user shares
USER_PREFIX = {u: f"u{u:02d}" + chr(ord("a") + u) * (3 * PAGE - 3) for u in range(4)}


def _counters(base: str) -> dict:
    out = {}
    for line in requests.get(f"{base}/metrics", timeout=10).text.splitlines():
        m = re.match(r"(vllm:[a-z_]+)\{[^}]*\} ([0-9.eE+-]+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def _post(base, prompt):
    r = requests.post(f"{base}/v1/completions", json={"prompt": prompt, "max_tokens": 4, "temperature": 0.0,
                                                      "ignore_eos": True}, timeout=120)
    assert r.status_code == 200, r.text
    return r.json()["choices"][0]["text"]


@pytest.mark.parametrize("tier", ["disk", "remote"])
def test_a_restarted_port_engine_serves_its_warm_prefixes(tier, loop, tmp_path):
    """test_sigterm_restart_serves_warm_prefixes for the port: build a warm
    working set, drain (which spills the manifest) and stop, start a fresh
    engine over the same tier and namespace on the same port; its first
    round hits at least half of its prefix pages, with the same text."""
    if tier == "remote":
        port, _ = loop.host(cache_server.CacheServer(1 << 26).handle)
        tier_kw = dict(kv_remote_url=f"127.0.0.1:{port}")
    else:
        tier_kw = dict(kv_offload_dir=str(tmp_path / "kv"), kv_offload_disk_gb=1.0)
    cfg = EngineConfig(model="llama-debug", host="127.0.0.1", port=free_port(), max_model_len=256,
                       num_pages=64, page_size=PAGE, prefill_chunk=64, warm_start=True,
                       warm_start_namespace="restart-test", warm_start_interval_s=3600, **tier_kw)
    base = f"http://127.0.0.1:{cfg.port}"
    # each engine is built off the loop thread: its warm restore reads the
    # cache server, which lives on that loop
    server, runner = loop.run(port_server.serve(cfg, LLMEngine(cfg, device="cpu"), device="cpu"))
    try:
        texts = {u: _post(base, SHARED + USER_PREFIX[u] + "post") for u in range(4)}
        for rnd in range(2):
            for u in range(4):
                _post(base, SHARED + USER_PREFIX[u] + f"w{rnd}")
        loop.run(server.drain(timeout=30))
    finally:
        loop.run(runner.cleanup())
        server.engine.stop()
    assert server.engine.warm.last_manifest_ts is not None

    server, runner = loop.run(port_server.serve(cfg, LLMEngine(cfg, device="cpu"), device="cpu"))
    try:
        c0 = _counters(base)
        assert c0["vllm:warm_start_restored_pages"] > 0 and c0["vllm:warm_start_generation"] == 2
        assert c0.get("vllm:gpu_prefix_cache_queries_total", 0) == 0
        again = {u: _post(base, SHARED + USER_PREFIX[u] + "post") for u in range(4)}
        c1 = _counters(base)
    finally:
        loop.run(runner.cleanup())
        server.engine.stop()
    assert again == texts
    hit_rate = c1["vllm:gpu_prefix_cache_hits_total"] / c1["vllm:gpu_prefix_cache_queries_total"]
    assert hit_rate >= 0.5, hit_rate
    assert c1["vllm:kv_corrupt_pages_total"] == 0


def test_a_spill_after_sleep_and_wake_reads_the_new_pools_only(tmp_path):
    """Wake drops the pools and the prefix cache: the manifest must come
    from the new page manager, or a spill would save the dropped pools'
    zeros under the old pages' hashes."""
    eng = LLMEngine(EngineConfig(model="llama-debug", max_model_len=256, num_pages=40, page_size=PAGE,
                                 prefill_chunk=32, warm_start=True, warm_start_namespace="wake",
                                 kv_offload_dir=str(tmp_path), kv_offload_disk_gb=0.1), device="cpu")
    eng.start()
    try:
        asyncio.run(_greedy(eng, SHARED + USER_PREFIX[0], SamplingParams))
        eng.sleep(1)
        eng.wake_up()
        assert eng.warm.kv is eng.kv
        assert eng.warm_spill() == 0  # nothing is cached in the new pools
    finally:
        eng.stop()


def test_warm_start_and_the_remote_tier_hold_at_tp2(loop):
    """At tp 2 (gloo ranks on the CPU) the manifest's pages leave and come
    back through the runner's page calls on every rank: a restarted tp 2
    engine over the cache server restores them and repeats tp 1's greedy
    tokens, its first request a prefix hit."""
    port, _ = loop.host(cache_server.CacheServer(1 << 26).handle)
    kw = dict(model="llama-debug", max_model_len=256, num_pages=40, page_size=PAGE, prefill_chunk=32,
              warm_start=True, warm_start_namespace="tp2", kv_remote_url=f"127.0.0.1:{port}")
    prompt = SHARED + USER_PREFIX[0]
    ref = LLMEngine(EngineConfig(model="llama-debug", max_model_len=256, num_pages=40, page_size=PAGE,
                                 prefill_chunk=32), device="cpu")
    ref.start()
    try:
        want = asyncio.run(_greedy(ref, prompt, SamplingParams))[0]
    finally:
        ref.stop()
    results = []
    for _ in range(2):
        eng = LLMEngine(EngineConfig(**kw, tensor_parallel_size=2, tp_backend="gloo"), device="cpu")
        eng.start()
        try:
            restored = eng.warm.restored_pages
            results.append((restored,) + asyncio.run(_greedy(eng, prompt, SamplingParams)))
            assert eng.warm_spill() > 0
        finally:
            eng.stop()
    (r0, toks0, cached0), (r1, toks1, cached1) = results
    assert r0 == 0 and cached0 == 0
    assert r1 >= 8 and cached1 >= 8 * PAGE
    assert toks0 == toks1 == want
