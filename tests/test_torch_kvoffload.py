"""The port's local KV offload tiers (production_stack_tpu_torch/kvoffload/)
against the JAX package's: the same pages give the same blobs in every
serde, each package reads the other's blobs, the tiers spill, verify and
quarantine alike, and the port's engine spills evicted prefix pages and
restores them with its greedy output unchanged. Inputs come from numpy
seeds; debug presets only."""

import asyncio
import dataclasses
import json
import struct
import threading

import ml_dtypes
import numpy as np
import pytest

from production_stack_tpu.kvoffload import serde as jserde
from production_stack_tpu.kvoffload import tiers as jtiers
from production_stack_tpu_torch.kvoffload import serde as tserde
from production_stack_tpu_torch.kvoffload import tiers as ttiers
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError, get_serde, verify_blob
from production_stack_tpu_torch.kvoffload.tiers import CPUTier, DiskTier, RemoteTier, TieredKVStore

PAGE = 8


def _kv(shape=(2, 8, 2, 4), seed=0, dtype=ml_dtypes.bfloat16):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(dtype), rng.randn(*shape).astype(dtype)


def _quant_page(shape=(2, 8, 2, 4), seed=1):
    rng = np.random.RandomState(seed)
    L, _, KH, _ = shape
    return (
        rng.randint(-127, 128, shape).astype(np.int8), rng.uniform(1e-3, 0.1, (L, KH)).astype(np.float32),
        rng.randint(-127, 128, shape).astype(np.int8), rng.uniform(1e-3, 0.1, (L, KH)).astype(np.float32),
    )


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- serde ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["naive", "int8", "int8page"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fp_pages_serialize_to_the_jax_blobs_and_read_back_alike(name, dtype):
    k, v = _kv(dtype=ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    blob = get_serde(name).serialize(k, v)
    assert blob == jserde.get_serde(name).serialize(k, v)
    for read in (tserde.deserialize, jserde.deserialize):
        k2, v2 = read(blob)
        jk, jv = jserde.deserialize(blob)
        assert _same(k2, jk) and _same(v2, jv)
    if name == "naive":
        k2, v2 = tserde.deserialize(blob)
        assert _same(k2, k) and _same(v2, v)
    else:  # lossy transport: within a step of the page's int8 grid
        k2, _ = tserde.deserialize(blob)
        np.testing.assert_allclose(np.asarray(k2, np.float32), np.asarray(k, np.float32), atol=0.05, rtol=0.05)
        assert len(blob) < 0.75 * len(get_serde("naive").serialize(k, v)) or dtype == "float32"


def test_int8page_blobs_carry_the_pool_bytes_exactly_and_match_jax():
    qk, sk, qv, sv = _quant_page()
    for orig in (ml_dtypes.bfloat16, np.dtype(np.float32), None):
        blob = get_serde("int8page").serialize_quant(qk, sk, qv, sv, orig_dtype=orig)
        assert blob == jserde.get_serde("int8page").serialize_quant(qk, sk, qv, sv, orig_dtype=orig)
        assert verify_blob(blob)["v"] == 3
        for got in (get_serde("int8page").deserialize_quant(blob), jserde.get_serde("int8page").deserialize_quant(blob)):
            assert all(_same(a, b) for a, b in zip(got, (qk, sk, qv, sv)))
        # an fp reader dequantizes, the same in both packages
        assert all(_same(a, b) for a, b in zip(tserde.deserialize(blob), jserde.deserialize(blob)))


def test_unknown_serde_and_cross_serde_dispatch():
    with pytest.raises(ValueError):
        get_serde("bogus")
    k, v = _kv()
    k2, _ = tserde.deserialize(get_serde("int8").serialize(k, v))  # the blob names its serde
    np.testing.assert_allclose(np.asarray(k2, np.float32), np.asarray(k, np.float32), atol=0.05, rtol=0.05)


# -- integrity -----------------------------------------------------------------


def _blob():
    return get_serde("naive").serialize(*_kv())


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "future_version", "garbage"])
def test_damaged_blobs_are_rejected_by_both_packages(damage):
    blob = bytearray(_blob())
    if damage == "bitflip":
        blob[-3] ^= 0x40
    elif damage == "truncate":
        blob = blob[:-7]
    elif damage == "future_version":
        hdr = json.dumps({"v": 99, "serde": "naive"}).encode()
        blob = bytearray(struct.pack("!I", len(hdr)) + hdr + b"body")
    else:
        blob = bytearray(b"not a frame at all")
    for verify in (verify_blob, jserde.verify_blob):
        with pytest.raises(ValueError):  # KVIntegrityError in both
            verify(bytes(blob))
    with pytest.raises(KVIntegrityError):
        tserde.deserialize(bytes(blob))


def test_v1_blob_without_crc_still_parses():
    k, v = _kv()
    hdr = json.dumps({"serde": "naive", "shape": list(k.shape), "dtype": "bfloat16"}).encode()
    k2, v2 = tserde.deserialize(struct.pack("!I", len(hdr)) + hdr + k.tobytes() + v.tobytes())
    assert _same(k2, k) and _same(v2, v)


# -- tiers ---------------------------------------------------------------------


def test_cpu_tier_lru_eviction():
    t = CPUTier(max_bytes=100)
    assert t.put("a", b"x" * 60) == []
    assert t.put("b", b"y" * 60) == [("a", b"x" * 60)]
    assert t.get("a") is None and t.get("b") == b"y" * 60


def test_disk_tier_roundtrip_and_restart(tmp_path):
    DiskTier(str(tmp_path), max_bytes=1000).put("k1", b"hello")
    assert DiskTier(str(tmp_path), max_bytes=1000).get("k1") == b"hello"  # the index is rebuilt


def test_spill_cpu_to_disk_and_drop_as_the_jax_store_does(tmp_path):
    blobs = {k: get_serde("naive").serialize(*_kv(seed=i)) for i, k in enumerate("abc")}
    sz = len(blobs["a"])
    results = []
    for mod, sub in ((ttiers, "port"), (jtiers, "jax")):
        st = mod.TieredKVStore(cpu_bytes=sz + sz // 4, disk_path=str(tmp_path / sub), disk_bytes=2 * sz - sz // 4)
        st.put("a", blobs["a"])
        st.put("b", blobs["b"])  # a spills to disk
        assert st.get("a") == blobs["a"] and st.hits["disk"] == 1  # disk hit, promoted
        st.put("c", blobs["c"])  # b spills; the disk cap drops blobs
        assert st.dropped_evictions > 0 and st.stats()["disk_bytes"] <= 2 * sz - sz // 4
        results.append(st.stats())
    assert results[0] == results[1]


def test_cpu_tier_quarantines_and_counts():
    st = TieredKVStore(cpu_bytes=1 << 20)
    st.put("k", _blob())
    bad = bytearray(st.cpu._data["k"])
    bad[-1] ^= 0xFF
    st.cpu._data["k"] = bytes(bad)  # bit rot in host RAM
    assert st.get("k") is None and "k" not in st.cpu
    assert st.corrupt_pages == 1 == st.stats()["corrupt_pages"]


def test_truncated_disk_file_rejected(tmp_path):
    st = TieredKVStore(disk_path=str(tmp_path), disk_bytes=1 << 20)
    blob = _blob()
    st.put("k", blob)
    f = tmp_path / "k.kv"
    f.write_bytes(f.read_bytes()[: len(blob) // 2])  # a torn write
    assert st.get("k") is None and st.corrupt_pages == 1


def _jax_cache_server():
    """The JAX package's cache server in a thread; returns (port, stop)."""
    from production_stack_tpu.kvoffload import cache_server

    loop = asyncio.new_event_loop()
    box, ready = {}, threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def start():
            box["server"] = await cache_server.serve("127.0.0.1", 0, max_bytes=1 << 20)
            box["port"] = box["server"].sockets[0].getsockname()[1]
            ready.set()

        loop.run_until_complete(start())
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)

    def stop():
        async def shutdown():
            box["server"].close()
            await box["server"].wait_closed()
            loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), loop)
        th.join(timeout=5)

    return box["port"], stop


def test_remote_tier_speaks_the_cache_servers_frames(tmp_path):
    """The port's remote tier (unreachable from its engine until the cache
    server is ported) against the JAX cache server: put/get, and a corrupt
    disk copy falls through to the remote one."""
    port, stop = _jax_cache_server()
    try:
        remote = RemoteTier(f"127.0.0.1:{port}")
        assert remote.get("nope") is None
        blob = _blob()
        remote.put("key1", blob)
        assert remote.get("key1") == blob and "key1" in remote
        remote.close()
        st = TieredKVStore(disk_path=str(tmp_path), disk_bytes=1 << 20, remote_url=f"127.0.0.1:{port}")
        st.put("k", blob)  # disk, and written through to the server
        f = tmp_path / "k.kv"
        raw = bytearray(f.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        f.write_bytes(bytes(raw))
        assert st.get("k") == blob and st.corrupt_pages == 1 and st.hits["remote"] == 1
    finally:
        stop()


# -- the connector: fp pools through the naive serde ----------------------------


def test_fp_pages_give_the_jax_connectors_naive_blobs_and_restore_both_ways():
    from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
    from production_stack_tpu.kvoffload.connector import KVOffloadConnector as JaxConnector
    from production_stack_tpu.models import llama as jllama
    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.kvoffload.connector import KVOffloadConnector

    jr = JaxRunner(dataclasses.replace(jllama.PRESETS["llama-debug"], attn_impl="xla"), num_pages=8,
                   page_size=PAGE, seed=0)
    _, _, model = load_model("llama-debug", device="cpu")
    tr = ModelRunner(model, num_pages=8, page_size=PAGE, device="cpu")
    cfg = tr.cfg
    np_dt = ml_dtypes.bfloat16 if str(cfg.dtype) == "torch.bfloat16" else np.float32
    rng = np.random.RandomState(3)
    shape = (cfg.num_layers, PAGE, cfg.num_kv_heads, cfg.head_dim)
    ks = [rng.randn(*shape).astype(np_dt) for _ in range(3)]
    vs = [rng.randn(*shape).astype(np_dt) for _ in range(3)]
    for r in (jr, tr):
        r.set_pages([1, 4, 6], ks, vs)
    jc, tc = JaxConnector(jr, cpu_bytes=1 << 20), KVOffloadConnector(tr, cpu_bytes=1 << 20)
    assert tc.serde.name == "naive" and not tc.quant
    jblobs, tblobs = jc._serialize_pages([1, 4, 6]), tc._serialize_pages([1, 4, 6])
    assert jblobs == tblobs
    hashes = [bytes([i]) * 16 for i in range(3)]
    for dst, blobs in ((tc, jblobs), (jc, tblobs)):
        for h, blob in zip(hashes, blobs):
            dst.store.put(h.hex(), blob)
        assert dst.load_pages(list(zip([0, 2, 3], hashes))) == 3
        gk, gv = dst.runner.get_pages([0, 2, 3])
        assert all(_same(a, b) for a, b in zip(gk + gv, ks + vs))


def test_restore_stops_at_the_first_missing_page():
    from production_stack_tpu_torch.engine.model_loader import load_model
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.kvoffload.connector import KVOffloadConnector

    _, _, model = load_model("llama-debug", device="cpu")
    c = KVOffloadConnector(ModelRunner(model, num_pages=8, page_size=PAGE, device="cpu"), cpu_bytes=1 << 20)
    hashes = [bytes([i]) * 16 for i in range(3)]
    assert c.save_pages([(1, hashes[0]), (2, hashes[2])]) == {hashes[0], hashes[2]}
    assert c.load_pages(list(zip([5, 6, 7], hashes))) == 1  # the chain ends where a blob is missing
    assert c.stats()["saved_pages"] == 2 and c.stats()["loaded_pages"] == 1


# -- the engine ----------------------------------------------------------------


def _engine(**kw):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine

    base = dict(model="llama-debug", max_model_len=256, max_num_seqs=4, num_pages=28, page_size=8,
                prefill_chunk=32, kv_offload_max_io_pages=0)
    return LLMEngine(EngineConfig(**dict(base, **kw)), device="cpu")


def _greedy(engine, prompt, n=4):
    from production_stack_tpu_torch.engine.scheduler import SamplingParams

    async def run():
        toks = []
        async for out in engine.generate(
            f"off-{np.random.randint(1 << 30)}", prompt=prompt,
            params=SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True),
        ):
            toks.extend(out.token_ids)
        return toks

    return asyncio.run(run())


PROMPT = "the quick brown fox jumps over the lazy dog " * 3


@pytest.fixture(scope="module")
def no_offload_tokens():
    eng = _engine(num_pages=None, kv_cache_memory_gb=0.01, kv_offload_max_io_pages=-1)
    assert eng._offload is None and eng.kv.offload is None
    eng.start()
    try:
        return _greedy(eng, PROMPT)
    finally:
        eng.stop()


@pytest.mark.parametrize("tier", ["cpu", "disk"])
def test_engine_spills_evicted_pages_and_restores_them(tier, tmp_path, no_offload_tokens):
    kw = dict(kv_offload_cpu_gb=0.001) if tier == "cpu" else dict(kv_offload_dir=str(tmp_path), kv_offload_disk_gb=0.01)
    eng = _engine(**kw)
    assert eng._offload.serde.name == "naive"
    eng.start()
    try:
        first = _greedy(eng, PROMPT)
        for i in range(6):  # churn the pool so the prompt's pages are evicted to the tier
            _greedy(eng, f"filler prompt number {i} with padding text " * 3)
        assert eng._offload.saved_pages > 0
        again = _greedy(eng, PROMPT)
        s = eng.stats()
    finally:
        eng.stop()
    assert first == again == no_offload_tokens
    assert eng.kv.offload_hits > 0 and s["kv_offload_loaded_pages_total"] > 0 and s["kv_offload_hit_pages_total"] > 0
    assert s[f"kv_offload_{tier}_bytes"] > 0 and s["kv_corrupt_pages_total"] == 0


def test_corrupt_spilled_pages_recompute_token_identical():
    eng = _engine(kv_offload_cpu_gb=0.001)
    eng.start()
    try:
        prompt = "integrity check: the five boxing wizards jump quickly " * 3
        first = _greedy(eng, prompt)
        for i in range(6):
            _greedy(eng, f"corruption filler number {i} padding " * 3)
        store = eng._offload.store
        assert len(store.cpu) > 0
        for key in list(store.cpu._data):  # a flipped bit in every spilled blob
            raw = bytearray(store.cpu._data[key])
            raw[-1] ^= 0x01
            store.cpu._data[key] = bytes(raw)
        again = _greedy(eng, prompt)
        s = eng.stats()
    finally:
        eng.stop()
    assert again == first
    assert s["kv_corrupt_pages_total"] > 0 and s["kv_corrupt_pages_total"] == store.corrupt_pages


def test_the_link_probe_runs_only_for_an_offload_tier_with_a_derived_budget():
    from production_stack_tpu.engine.linkprobe import derive_max_io_pages as jax_derive
    from production_stack_tpu_torch.engine.linkprobe import derive_max_io_pages, probe_link_bandwidth

    for bw in (None, 0.0, 1e6, 2e7, 4e8, 1e9, 5e10):
        for page_bytes in (4096, 1 << 20):
            assert derive_max_io_pages(bw, page_bytes) == jax_derive(bw, page_bytes)
    assert probe_link_bandwidth("cpu") is None  # no CUDA device: no number
    probed = _engine(kv_offload_cpu_gb=0.001, kv_offload_max_io_pages=-1)
    assert probed.kv.max_io_pages == 0 and probed.stats()["kv_offload_max_io_pages"] == 0
    assert "kv_offload_link_bandwidth_bytes_per_sec" not in probed.stats()
    assert _engine(kv_offload_cpu_gb=0.001, kv_offload_max_io_pages=3).kv.max_io_pages == 3


# -- the capped offload I/O budget (engine/kv_manager.py) -----------------------


class _FakeOffload:
    def __init__(self):
        self.store, self.evicted = {}, []

    def save_pages(self, pairs):
        for pid, h in pairs:
            self.store.setdefault(h, pid)

    def report_evict(self, hs):
        self.evicted.extend(hs)

    def report_admit(self, hs):
        pass

    def has(self, h):
        return h in self.store

    def load_pages(self, pairs):
        return len(pairs)


@pytest.mark.parametrize("cap,stored,dropped,cached", [(2, 2, 6, 8), (0, 8, 0, 32)])
def test_spill_budget_keeps_chain_heads(cap, stored, dropped, cached):
    from production_stack_tpu_torch.engine.kv_manager import KVPageManager

    off = _FakeOffload()
    kv = KVPageManager(8, 4, offload=off, max_io_pages=cap)
    toks = list(range(32))
    pages = kv.allocate(8)
    kv.register_filled(toks, pages)
    kv.free(pages)
    kv.free(kv.allocate(8))  # evicts all 8: with a cap, the chain heads spill and the rest drop
    assert len(off.store) == stored and len(off.evicted) == dropped
    assert kv.match_prefix(toks)[1] == cached
