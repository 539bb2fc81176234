"""The port's fleet KV directory (production_stack_tpu_torch/kvdirectory/ and
the cache server that hosts it) against the JAX package's, on the CPU.

- The directory: the same register, publish, withdraw, blob_evicted, expiry
  and TTL operations, on both packages' ``KVDirectory`` with the clock
  pinned, give equal lookups (hashes and tokens), top prefixes, stats, dumps
  and snapshot JSON (the cases of tests/test_kvdirectory.py TestKVDirectory);
  a snapshot of either package loads into the other.
- The cache server over the wire: a port and a JAX cache server take the
  same frames and give the JAX ``DirectoryClient`` the same answers, the
  port's router's kvaware v2 ranking the same pick, and their ``--metrics-port``
  pages the same ``vllm:kv_directory_*`` series.
- The publisher and the puller (TestPublisherWire, TestPublisherBounds,
  TestPullerWire, and tests/test_kvfabric.py TestDirectoryPullerFabric) on
  the port's copies, against both servers.
- The fleet: a port engine A builds a warm prefix and spills it; a cold port
  engine and a JAX engine each pull it through the shared tier on their
  first request (test_three_engine_fleet_warm_cross_engine_pull), a port
  engine with the fabric pulls A's resident pages engine to engine, and an
  engine booted with ``warm_prefetch_on_boot`` prefetches the fleet's chunks
  and restores them on its first request. Pulled pages land in the pools
  byte-identical to A's.
- A warm restart at dp 2 (gloo ranks) over the cache server.

Servers run on a loop thread of this process; engines on their own loop
threads.
"""

import asyncio
import json
import re
import threading
import time

import aiohttp
import jax
import numpy as np
import pytest

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams
from production_stack_tpu.kvdirectory import DirectoryClient as JaxDirectoryClient
from production_stack_tpu.kvdirectory import directory as jdirectory
from production_stack_tpu.kvoffload import cache_server as jcache_server
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import free_port
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_manager import KVPageManager, prefix_hashes
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams
from production_stack_tpu_torch.kvdirectory import DirectoryPublisher, DirectoryPuller, KVDirectory
from production_stack_tpu_torch.kvdirectory import directory as pdirectory
from production_stack_tpu_torch.kvfabric.wire import decode_frame, encode_frame
from production_stack_tpu_torch.kvoffload import cache_server
from production_stack_tpu_torch.kvoffload.protocol import BlockingClient
from production_stack_tpu_torch.kvoffload.serde import get_serde
from production_stack_tpu_torch.kvoffload.tiers import TieredKVStore
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.router.routing_logic import KvawareRouter
from production_stack_tpu_torch.router.service_discovery import EndpointInfo

MODEL = "llama-debug-4kv-f32"
A, B, C = "http://a:1", "http://b:1", "http://c:1"


def _entries(n, start=0):
    return [(f"h{start + i:02d}", start + i, 1.0 + i) for i in range(n)]


def _hexes(n, start=0):
    return [f"h{start + i:02d}" for i in range(n)]


class _Clock:
    """The directory modules' ``time``: pinned, moved by hand. Starts at
    the real monotonic clock, which an EngineRecord's default last_seen
    reads."""

    def __init__(self):
        self.mono = time.monotonic()
        self.wall = 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jdirectory, "time", c)
    monkeypatch.setattr(pdirectory, "time", c)
    return c


# -- the directory: one scenario per case of TestKVDirectory --------------------


def _publish_and_contiguous_lookup(cls, clock):
    d = cls()
    d.register(A, 8, 1)
    d.publish(A, 1, _entries(3), "hbm")
    out = [d.lookup_hashes(_hexes(4))]
    assert out[0]["resident"] == {A: 3}
    d.withdraw(A, ["h01"], "all")  # a hole breaks the chain
    out.append(d.lookup_hashes(_hexes(4)))
    assert out[-1]["resident"] == {A: 1}
    return d, out


def _shared_claims_and_withdraw_scopes(cls, clock):
    d = cls()
    d.register(A, 8, 1)
    d.publish(A, 1, _entries(2), "hbm")
    d.publish(A, 1, _entries(2), "shared")
    d.withdraw(A, ["h00"], "resident")
    out = [d.lookup_hashes(_hexes(2))]
    assert out[0]["resident"] == {} and out[0]["shared"] == [True, True]
    d.withdraw(A, _hexes(2), "all")
    out.append(d.lookup_hashes(_hexes(2)))
    assert out[-1]["shared"] == [False, False] and d.stats()["kv_directory_entries"] == 0
    return d, out


def _generation_fence(cls, clock):
    d = cls()
    d.publish(A, 1, _entries(4), "hbm", page_size=8)
    out = [d.lookup_hashes(_hexes(4))]
    d.register(A, 8, 2)
    out.append(d.lookup_hashes(_hexes(4)))
    assert out[-1]["resident"] == {} and d.expired_entries_total == 4
    d.publish(A, 1, _entries(4), "hbm")  # the fenced incarnation's late flush
    out.append(d.lookup_hashes(_hexes(4)))
    d.publish(A, 2, _entries(2), "hbm")
    out.append(d.lookup_hashes(_hexes(4)))
    assert out[-1]["resident"] == {A: 2}
    return d, out


def _lazy_stale_entry(cls, clock):
    d = cls()
    d.publish(A, 1, _entries(2), "hbm", page_size=8)
    d.engines[A].generation = 5  # a bump the eager fence walk never saw
    out = [d.lookup_hashes(_hexes(2)), d.lookup_hashes(_hexes(2))]
    assert out[0]["resident"] == {} and d.stale_hits_total > 0
    return d, out


def _ttl_drops_resident_keeps_shared(cls, clock):
    d = cls(engine_timeout=0.05)
    d.publish(A, 1, _entries(2), "hbm", page_size=8)
    d.publish(A, 1, _entries(2), "shared")
    d.publish(B, 1, _entries(1), "hbm", page_size=8)
    clock.mono += 0.08
    d.register(B, 8, 1)  # B stays alive
    out = [d.lookup_hashes(_hexes(2)), d.lookup_tokens(list(range(16)))]
    assert out[0]["resident"] == {B: 1} and out[0]["shared"] == [True, True] and d.expired_entries_total == 2
    return d, out


def _blob_check_governs_restorable(cls, clock):
    present = {"h00"}
    d = cls(blob_check=lambda k: k in present)
    d.publish(A, 1, _entries(2), "shared", page_size=8)
    out = [d.lookup_hashes(_hexes(2))]
    assert out[0]["shared"] == [True, False] and "h01" not in d.chunks
    return d, out


def _blob_evicted_clears_shared(cls, clock):
    d = cls()
    d.publish(A, 1, _entries(1), "shared", page_size=8)
    d.publish(A, 1, _entries(1), "hbm")
    d.blob_evicted("h00")
    out = [d.lookup_hashes(["h00"])]
    assert out[0]["shared"] == [False] and out[0]["resident"] == {A: 1}
    return d, out


def _lookup_tokens_per_page_size(cls, clock):
    d = cls()
    tokens = list(range(32))
    h8 = [h.hex() for h in prefix_hashes(tokens, 8)]
    h16 = [h.hex() for h in prefix_hashes(tokens, 16)]
    d.publish(A, 1, [(h, i, 1.0) for i, h in enumerate(h8[:3])], "hbm", page_size=8)
    d.publish(B, 1, [(h16[0], 0, 1.0)], "hbm", page_size=16)
    d.publish(B, 1, [(h16[0], 0, 1.0)], "shared")
    out = [d.lookup_tokens(tokens), d.lookup_tokens(tokens, salt_hex="ab")]
    assert out[0]["engines"][A]["resident_tokens"] == 24 and out[0]["engines"][B]["resident_tokens"] == 16
    assert out[0]["restorable"] == {"16": 16}
    return d, out


def _snapshot_roundtrip_keeps_fencing(cls, clock):
    d = cls()
    d.publish(A, 1, _entries(3), "shared", page_size=8)
    d.publish(A, 1, _entries(3), "hbm")
    d2 = cls()
    assert d2.load_snapshot(d.snapshot()) == 3
    out = [d2.lookup_hashes(_hexes(3))]
    assert out[0]["resident"] == {A: 3}
    d2.register(A, 8, 2)
    out.append(d2.lookup_hashes(_hexes(3)))
    assert out[-1]["resident"] == {}
    return d2, out


def _top_prefixes_heads_first(cls, clock):
    present = set(_hexes(6)) - {"h04"}
    d = cls(engine_timeout=10.0, blob_check=lambda k: k in present)
    d.publish(A, 1, _entries(4), "shared", page_size=8)
    d.publish(B, 1, [("h05", 0, 9.0), ("h04", 1, 1.0), ("h02", 0, 5.0)], "shared", page_size=16)
    d.publish(C, 1, _entries(2), "hbm", page_size=8)
    out = [d.top_prefixes(3), d.top_prefixes(10, page_size=8), d.top_prefixes(10, page_size=16)]
    clock.mono += 11.0  # every engine silent past the TTL: resident claims go
    out += [d.top_prefixes(10), d.lookup_hashes(_hexes(6)), d.expire_dead_engines()]
    assert out[0][0] in ("h00", "h05") and "h04" not in out[2]
    return d, out


SCENARIOS = [_publish_and_contiguous_lookup, _shared_claims_and_withdraw_scopes, _generation_fence,
             _lazy_stale_entry, _ttl_drops_resident_keeps_shared, _blob_check_governs_restorable,
             _blob_evicted_clears_shared, _lookup_tokens_per_page_size, _snapshot_roundtrip_keeps_fencing,
             _top_prefixes_heads_first]


def _answers(cls, scenario, clock):
    d, out = scenario(cls, clock)
    return out + [d.lookup_tokens(list(range(40))), d.top_prefixes(16), d.stats(), d.dump(), d.snapshot_json()]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__.strip("_") for s in SCENARIOS])
def test_the_directorys_answers_equal_the_jax_directorys(scenario, clock):
    mono0 = clock.mono
    jax_answers = _answers(jdirectory.KVDirectory, scenario, clock)
    clock.mono = mono0
    port_answers = _answers(KVDirectory, scenario, clock)
    assert port_answers == jax_answers
    assert port_answers[-1] == jax_answers[-1]  # the snapshot JSON, byte for byte


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_snapshot_loads_across_the_packages(writer, clock):
    """A snapshot either package wrote loads into the other's directory and
    answers as in the writer's: claims, generations and the fence."""
    src_cls, dst_cls = (jdirectory.KVDirectory, KVDirectory) if writer == "jax" else (KVDirectory,
                                                                                     jdirectory.KVDirectory)
    d = src_cls()
    d.publish(A, 1, _entries(3), "shared", page_size=8)
    d.publish(A, 1, _entries(3), "hbm")
    d.publish(B, 4, _entries(2, start=1), "hbm", page_size=8)
    doc = json.loads(d.snapshot_json())
    loaded = [cls() for cls in (src_cls, dst_cls)]
    assert [x.load_snapshot(doc) for x in loaded] == [5, 5]
    for x in loaded:
        x.register(B, 8, 5)  # B is reborn: its loaded claims are fenced
    got = [(x.lookup_hashes(_hexes(3)), x.top_prefixes(8), x.stats(), x.snapshot_json()) for x in loaded]
    assert got[0] == got[1]
    assert got[1][0]["resident"] == {A: 3} and got[1][0]["shared"] == [True] * 3


# -- the cache server's directory over the wire --------------------------------


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


def _serve_cache(loop, mod, **kw):
    """A cache server of package ``mod`` with its directory on, on the loop
    thread; returns its address."""
    port = free_port()
    loop.run(mod.serve("127.0.0.1", port, 1 << 26, directory=True, **kw))
    return f"127.0.0.1:{port}"


@pytest.fixture(scope="module")
def servers():
    """A port and a JAX cache server, each with a metrics port."""
    loop = _Loop()
    out = {}
    for name, mod in (("port", cache_server), ("jax", jcache_server)):
        mport = free_port()
        out[name] = (_serve_cache(loop, mod, metrics_port=mport), mport)
    yield out
    loop.close()


def _request(addr, hdr, payload=b""):
    host, port = addr.split(":")
    c = BlockingClient(host, int(port), timeout=5)
    try:
        return c.request(hdr, payload)[0]
    finally:
        c.close()


def test_the_jax_directory_client_and_router_get_the_same_answers_from_a_port_server(servers):
    tokens = list(range(48))
    h8 = [h.hex() for h in prefix_hashes(tokens, 8)]
    blob = get_serde("naive").serialize(np.ones((1, 8, 1, 2), np.float32), np.zeros((1, 8, 1, 2), np.float32))
    eps = [EndpointInfo(url=u, model_names=["m"], added_timestamp=0.0) for u in (A, B, C)]

    async def session(addr):
        frames = [
            {"op": "dir_register", "url": A, "page_size": 8, "generation": 3},
            {"op": "dir_publish", "url": A, "generation": 3, "tier": "hbm", "page_size": 8,
             "entries": [[h, i, 1.0] for i, h in enumerate(h8[:4])]},
            {"op": "dir_publish", "url": B, "generation": 1, "tier": "shared", "page_size": 8,
             "entries": [[h, i, 2.0] for i, h in enumerate(h8)]},
            {"op": "dir_withdraw", "url": A, "hashes": h8[3:4], "scope": "resident"},
        ]
        answers = [_request(addr, f) for f in frames]
        for h in h8[:5]:  # the shared blobs; the sixth never landed
            answers.append(_request(addr, {"op": "put", "key": h}, blob))
        client = JaxDirectoryClient(addr)
        router = KvawareRouter.__new__(KvawareRouter)
        router.directory_url, router._dir_client = addr, None
        router.route_class_counts = {"resident": 0, "restorable": 0, "cold": 0}
        try:
            answers.append(await client.lookup(tokens))
            answers.append(await client.lookup_hashes(h8))
            answers.append(await client.top_prefixes(4, 8))
            res = await router._dir_lookup(tokens)
            answers.append(router._rank_v2(res, eps, {}, {}))
            answers.append(router._rank_v2(res, eps[1:], {}, {}))
            answers.append(_request(addr, {"op": "delete", "key": h8[0]}))  # the chain's head leaves
            answers.append(await client.lookup(tokens))
            answers.append(router._rank_v2(await router._dir_lookup(tokens), eps[1:], {}, {}))
            answers.append(await client.stats())
            answers.append(await client.dump())
        finally:
            await client.close()
            await router._dir_client.close()
        return answers

    got = {name: asyncio.run(session(addr)) for name, (addr, _) in servers.items()}
    assert got["port"] == got["jax"]
    ranks = got["port"][-7:-5] + got["port"][-3:-2]
    assert ranks[0] == ("resident", A) and ranks[1] == ("restorable", B) and ranks[2] == ("cold", None)

    async def page(mport):
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{mport}/metrics") as r:
                return await r.text()

    pages = {name: asyncio.run(page(mport)) for name, (_, mport) in servers.items()}
    series = {name: re.findall(r"^(vllm:kv_directory_\w+)\{[^}]*\} (\S+)$", text, re.M)
              for name, text in pages.items()}
    assert series["port"] == series["jax"] and len(series["port"]) == 7
    assert dict(series["port"])["vllm:kv_directory_engines"] == "2"


def test_the_directory_survives_a_server_restart_through_its_snapshot(tmp_path):
    """``--directory-persist-path``: a port server writes its snapshot (the
    sealed JSON a JAX server writes) and a server started on it answers the
    same lookups."""
    loop = _Loop()
    try:
        path = str(tmp_path / "dir.snap")
        addr = _serve_cache(loop, cache_server, directory_persist_path=path, directory_persist_interval=0.05)
        _request(addr, {"op": "dir_publish", "url": A, "generation": 2, "tier": "hbm", "page_size": 8,
                        "entries": [[h, i, 1.0] for i, h in enumerate(_hexes(3))]})
        deadline = time.time() + 10
        while not (tmp_path / "dir.snap").exists() and time.time() < deadline:
            time.sleep(0.05)
        before = _request(addr, {"op": "dir_lookup_hashes", "hashes": _hexes(3)})
        for mod in (cache_server, jcache_server):
            again = _serve_cache(loop, mod, directory_persist_path=path)
            assert _request(again, {"op": "dir_lookup_hashes", "hashes": _hexes(3)}) == before
        assert before["resident"] == {A: 3}
    finally:
        loop.close()


# -- the publisher and the puller (TestPublisherWire, TestPullerWire) -----------


def _dir_dump(addr: str) -> dict:
    return _request(addr, {"op": "dir_dump"})


def _wait_dump(addr, url, pred, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        eng = _dir_dump(addr).get("engines", {}).get(url) or {}
        if pred(eng):
            return eng
        time.sleep(0.05)
    return _dir_dump(addr).get("engines", {}).get(url) or {}


@pytest.mark.parametrize("server", ["port", "jax"])
def test_the_publisher_batches_and_keeps_the_order(servers, server):
    addr = servers[server][0]
    hashes = prefix_hashes(list(range(16)), 4)
    url = f"http://pub-{server}:1"
    pub = DirectoryPublisher(addr, url, page_size=4, generation=3, flush_interval_s=0.1)
    try:
        pub.publish_resident([(h, i, 1.0) for i, h in enumerate(hashes)])
        pub.withdraw([hashes[-1]], "all")  # queued after the publish: it wins
        eng = _wait_dump(addr, url, lambda e: e.get("resident_chunks") == 3)
        assert eng["resident_chunks"] == 3 and eng["generation"] == 3
        # the publisher's thread counts a batch once the server has answered
        # it, which may be after the dump above already shows the batch
        deadline = time.time() + 10
        while (pub.publishes, pub.withdrawals) != (4, 1) and time.time() < deadline:
            time.sleep(0.01)
        assert pub.publishes == 4 and pub.withdrawals == 1
    finally:
        pub.stop()


def test_a_publisher_without_the_shared_tier_claims_no_shared_pages(servers):
    addr = servers["port"][0]
    pub = DirectoryPublisher(addr, "http://e:2", page_size=4, generation=1, flush_interval_s=0.1,
                             shared_enabled=False)
    try:
        pub.publish_shared([(b"\x01" * 16, 0, 1.0)])
        pub.publish_resident([(b"\x02" * 16, 0, 1.0)])
        eng = _wait_dump(addr, "http://e:2", lambda e: e.get("resident_chunks", 0) > 0)
        assert eng["shared_chunks"] == 0 and eng["resident_chunks"] == 1
    finally:
        pub.stop()


def test_the_publishers_backlog_is_bounded_by_entries():
    """TestPublisherBounds: the outage bound counts entries, not batches."""
    import queue as queue_mod

    batches = [("hbm", [("h", i, 1.0)] * 100) for i in range(10)]
    assert DirectoryPublisher._trim_entries(batches, 250) == batches[-2:]
    assert DirectoryPublisher._trim_entries(batches, 5000) == batches
    pub = DirectoryPublisher.__new__(DirectoryPublisher)
    pub._q = queue_mod.Queue()
    pub._queued_entries = 0
    pub._entries_lock = threading.Lock()
    big = [(bytes([i]) * 16, 0, 1.0) for i in range(200)]
    old_cap = DirectoryPublisher.MAX_PENDING
    try:
        DirectoryPublisher.MAX_PENDING = 300
        pub.publish_resident(big)
        pub.publish_resident(big)  # 400 entries: the oldest batch goes
        assert pub._queued_entries == 200 and pub._q.qsize() == 1
    finally:
        DirectoryPublisher.MAX_PENDING = old_cap


@pytest.mark.parametrize("server", ["port", "jax"])
def test_the_puller_fetches_shared_blobs_into_the_local_tier(servers, server):
    addr = servers[server][0]
    toks = list(range(100 + 12 * (server == "jax"), 112 + 12 * (server == "jax")))  # keys of its own
    hashes = prefix_hashes(toks, 4)
    blob = get_serde("naive").serialize(np.zeros((1, 4, 1, 2), np.float32), np.zeros((1, 4, 1, 2), np.float32))
    store = TieredKVStore(cpu_bytes=1 << 20, remote_url=addr)
    for h in hashes[:2]:
        store.remote.put(h.hex(), blob)
    _request(addr, {"op": "dir_publish", "url": "http://far:1", "generation": 1, "tier": "shared", "page_size": 4,
                    "entries": [[h.hex(), i, 1.0] for i, h in enumerate(hashes[:2])]})
    puller = DirectoryPuller(addr, KVPageManager(8, 4), store, page_size=4)
    assert asyncio.run(puller.maybe_prefetch(toks)) == 2
    assert all(store.contains_local(h.hex()) for h in hashes[:2])
    assert puller.stats() == {"kv_directory_lookups_total": 1, "kv_directory_lookup_hits_total": 1,
                              "kv_directory_pulled_pages_total": 2}
    assert asyncio.run(puller.maybe_prefetch(list(range(500, 512)))) == 0  # nothing restorable


def test_a_local_match_skips_the_directory(servers):
    addr = servers["port"][0]
    toks = list(range(8))
    kv = KVPageManager(8, 4)
    kv.register_filled(toks, kv.allocate(2))
    puller = DirectoryPuller(addr, kv, TieredKVStore(cpu_bytes=1 << 20, remote_url=addr), page_size=4)
    assert asyncio.run(puller.maybe_prefetch(toks)) == 0 and puller.lookups == 0


class _StubStore:
    def __init__(self):
        self.local, self.gets = {}, 0

    def put_local(self, key, blob):
        self.local[key] = blob

    def contains_local(self, key):
        return key in self.local

    def get(self, key):
        self.gets += 1
        return b"tier-blob"


class _StubDirClient:
    def __init__(self, res):
        self.res = res

    async def lookup_hashes(self, keys):
        return self.res


class _StubFabric:
    def __init__(self, frame):
        self.frame, self.fallbacks, self.pulls = frame, 0, []

    def pull(self, addr, keys, expect_generation=None):
        self.pulls.append((addr, list(keys), expect_generation))
        return self.frame

    def count_fallback(self, n=1):
        self.fallbacks += n


def _stub_puller(frame, resident, generations):
    class _KV:
        hash_to_page = {}

    store = _StubStore()
    puller = DirectoryPuller("http://dir:9", _KV(), store, page_size=4)
    fab = _StubFabric(frame)
    puller.enable_fabric(fab, "http://self:8000", serde=get_serde("naive"))
    puller._owner_fabric_addr = lambda url: "10.0.0.2:7000"
    puller._client = _StubDirClient({"shared": [True, True], "resident": resident, "generations": generations})
    return puller, store, fab


def _frame_for(keys):
    rng = np.random.RandomState(0)
    ks = [rng.randn(2, 4, 2, 8).astype(np.float32) for _ in keys]
    return decode_frame(encode_frame(keys, ks, [k + 1 for k in ks]))


@pytest.mark.parametrize("case", ["fabric_hit", "fabric_miss", "never_self"])
def test_the_pullers_fabric_path(case):
    """TestDirectoryPullerFabric on the port's puller: a resident owner's
    pages come over the fabric with no shared-tier read and the claim's
    generation on the pull; a miss counts a fallback and walks the tier;
    the engine never pulls from itself."""
    tokens = list(range(8))
    keys = [h.hex() for h in prefix_hashes(tokens, 4)]
    owner = "http://self:8000" if case == "never_self" else "http://peer:8001"
    frame = None if case == "fabric_miss" else _frame_for(keys)
    puller, store, fab = _stub_puller(frame, {owner: 2}, {owner: 42})
    got = asyncio.run(puller.maybe_prefetch(tokens))
    assert got == 2
    if case == "fabric_hit":
        assert sorted(store.local) == sorted(keys) and store.gets == 0 and puller.fabric_pulled_pages == 2
        assert fab.pulls == [("10.0.0.2:7000", keys, 42)]
    elif case == "fabric_miss":
        assert fab.fallbacks == 2 and store.gets > 0 and puller.fabric_pulled_pages == 0
    else:
        assert fab.pulls == [] and store.gets > 0


# -- the fleet --------------------------------------------------------------------

PAGE = 8
SHARED = "S" * (8 * PAGE)  # eight pages every user shares
SMALL = dict(host="127.0.0.1", max_model_len=256, num_pages=64, page_size=PAGE, prefill_chunk=64)


@pytest.fixture(scope="module")
def params():
    jparams = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return params_from_jax(jparams, tllama.PRESETS[MODEL])


def _greedy(engine, prompt, rid, n=4):
    sp = JaxSamplingParams if isinstance(engine, JaxEngine) else SamplingParams

    async def go():
        toks, cached = [], 0
        async for out in engine.generate(rid, prompt=prompt, params=sp(max_tokens=n, temperature=0.0,
                                                                       ignore_eos=True)):
            toks.extend(out.token_ids)
            cached = out.cached_tokens
        return toks, cached

    return asyncio.run(go())


def _pool_pages(engine, prompt):
    """The pool's K/V of the prompt's registered full pages, host arrays."""
    tokens = engine.tokenizer.encode(prompt)
    pids = [engine.kv.hash_to_page[h] for h in prefix_hashes(tokens, PAGE) if h in engine.kv.hash_to_page]
    ks, vs = engine._run_on_device_thread(lambda: engine.runner.get_pages(pids))
    return [np.asarray(k) for k in ks], [np.asarray(v) for v in vs]


@pytest.fixture(scope="module")
def fleet(params):
    """A port cache server and port engine A, served over HTTP with the
    fabric, the CPU tier and warm start: A has served the shared prefix and
    spilled it, so the directory holds its resident and shared claims."""
    loop = _Loop()
    addr = _serve_cache(loop, cache_server)
    fleet_kw = dict(kv_remote_url=addr, kv_directory_url=addr, kv_directory_flush_s=0.1, kv_offload_cpu_gb=0.05)
    cfg = EngineConfig(model=MODEL, port=free_port(), kv_fabric=True, warm_start=True,
                       warm_start_namespace="fleet-a", warm_start_interval_s=3600, **SMALL, **fleet_kw)
    server, runner = loop.run(port_server.serve(cfg, LLMEngine(cfg, device="cpu", params=params), device="cpu"))
    a = server.engine
    want = _greedy(a, SHARED + "a-user", "a0")[0]
    assert a.warm_spill() >= 8
    url = f"http://127.0.0.1:{cfg.port}"
    eng = _wait_dump(addr, url, lambda e: e.get("shared_chunks", 0) >= 8 and e.get("resident_chunks", 0) >= 8)
    assert eng["shared_chunks"] >= 8 and eng["resident_chunks"] >= 8, eng
    yield dict(addr=addr, a=a, url=url, want=want, kw=fleet_kw)
    loop.run(runner.cleanup())
    a.stop()
    loop.close()


def test_a_cold_port_engine_and_a_jax_engine_pull_the_fleet_warm_prefix(fleet, params):
    """test_three_engine_fleet_warm_cross_engine_pull with engines of both
    packages: a cold port engine and a cold JAX engine, each on its first
    request, pull the prefix the port engine A spilled through the shared
    tier and restore it instead of prefilling it, with A's tokens and A's
    page bytes; the directory sees a fleet of three."""
    port_c = LLMEngine(EngineConfig(model=MODEL, port=free_port(), **SMALL, **fleet["kw"]), device="cpu",
                       params=params)
    jax_c = JaxEngine(JaxEngineConfig(model=MODEL, port=free_port(), **SMALL, **fleet["kw"]))
    try:
        for eng in (port_c, jax_c):
            eng.start()
            toks, cached = _greedy(eng, SHARED + "a-user", "c0")
            assert toks == fleet["want"] and cached >= 8 * PAGE
            stats = eng.stats()
            assert stats["kv_directory_pulled_pages_total"] >= 8 and stats["kv_directory_lookup_hits_total"] == 1
            assert stats["kv_corrupt_pages_total"] == 0
            for got, ref in zip(_pool_pages(eng, SHARED), _pool_pages(fleet["a"], SHARED)):
                assert len(got) == len(ref) == 8 and all(np.array_equal(x, y) for x, y in zip(got, ref))
        assert len(_dir_dump(fleet["addr"])["engines"]) == 3
    finally:
        port_c.stop()
        jax_c.stop()


def test_a_port_engine_pulls_resident_pages_over_the_fabric(fleet, params):
    """The directory names A as the prefix's resident owner: a port engine
    with the fabric pulls the pages from A engine to engine, none from the
    shared tier, and restores them byte for byte."""
    eng = LLMEngine(EngineConfig(model=MODEL, port=free_port(), kv_fabric=True, **SMALL, **fleet["kw"]),
                    device="cpu", params=params)
    eng.start()
    try:
        remote_gets = eng._offload.store.hits["remote"]
        toks, cached = _greedy(eng, SHARED + "a-user", "f0")
        assert toks == fleet["want"] and cached >= 8 * PAGE
        assert eng._kvdir_pull.fabric_pulled_pages >= 8 and eng.stats()["kv_fabric_pulled_pages_total"] >= 8
        assert eng._offload.store.hits["remote"] == remote_gets
        for got, ref in zip(_pool_pages(eng, SHARED), _pool_pages(fleet["a"], SHARED)):
            assert all(np.array_equal(x, y) for x, y in zip(got, ref))
    finally:
        eng.stop()


def test_an_engine_booted_with_warm_prefetch_restores_the_fleets_chunks(fleet, params):
    """``warm_prefetch_on_boot``: the fleet's top chunks come into the local
    tiers while the engine is built, and its first request restores them
    (the admission pull is off, so only the boot prefetch can have)."""
    eng = LLMEngine(EngineConfig(model=MODEL, port=free_port(), warm_prefetch_on_boot=16, kv_directory_pull=False,
                                 **SMALL, **fleet["kw"]), device="cpu", params=params)
    eng.start()
    try:
        assert eng._kvdir_pull is None
        stats = eng.stats()
        assert stats["kv_directory_prefetched_pages_total"] >= 8
        loaded = stats["kv_offload_loaded_pages_total"]
        toks, cached = _greedy(eng, SHARED + "a-user", "b0")
        assert toks == fleet["want"] and cached >= 8 * PAGE
        assert eng.stats()["kv_offload_loaded_pages_total"] - loaded >= 8
    finally:
        eng.stop()


def test_a_directory_that_is_down_means_a_cold_boot_and_a_prefill(params):
    """The directory is a hint: an engine whose directory does not answer
    boots cold, prefills, counts the failed lookup and serves."""
    dead = f"127.0.0.1:{free_port()}"
    eng = LLMEngine(EngineConfig(model=MODEL, port=free_port(), kv_remote_url=dead, kv_directory_url=dead,
                                 warm_prefetch_on_boot=4, kv_offload_cpu_gb=0.01, **SMALL), device="cpu",
                    params=params)
    eng.start()
    try:
        assert eng.kv_directory_prefetched_pages == 0
        toks, cached = _greedy(eng, SHARED, "d0")
        assert len(toks) == 4 and cached == 0 and eng._kvdir_pull.errors == 1
    finally:
        eng.stop()


def test_a_dp2_engine_warm_starts_over_the_cache_server():
    """Warm start at dp 2 (gloo ranks on the CPU): the manifest's pages
    leave and come back through the runner's page calls on every rank and
    every dp replica; the restarted engine's first request is a prefix hit
    with dp 1's greedy tokens, and every replica holds the same pages."""
    loop = _Loop()
    try:
        addr = _serve_cache(loop, cache_server)
        kw = dict(model="llama-debug", max_model_len=256, num_pages=40, page_size=PAGE, prefill_chunk=32)
        prompt = SHARED + "u00" + "a" * 13
        ref = LLMEngine(EngineConfig(**kw), device="cpu")
        ref.start()
        try:
            want = _greedy(ref, prompt, "ref")[0]
        finally:
            ref.stop()
        results = []
        for _ in range(2):
            eng = LLMEngine(EngineConfig(**kw, data_parallel_size=2, tp_backend="gloo", warm_start=True,
                                         warm_start_namespace="dp2", kv_remote_url=addr), device="cpu")
            eng.start()
            try:
                restored = eng.warm.restored_pages
                results.append((restored,) + _greedy(eng, prompt, "w"))
                digests = eng._run_on_device_thread(eng.runner.replica_digest)
                assert (digests == digests[0]).all()
                assert eng.warm_spill() > 0
            finally:
                eng.stop()
    finally:
        loop.close()
    (r0, toks0, cached0), (r1, toks1, cached1) = results
    assert r0 == 0 and cached0 == 0
    assert r1 >= 8 and cached1 >= 8 * PAGE
    assert toks0 == toks1 == want
