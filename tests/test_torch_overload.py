"""The port's twin of tests/test_overload.py (docs/failure-handling.md
"Overload"), holding the port's overload survival against the JAX package's.

- **Eviction**: every unit case of the reuse-score policy on the port's
  ``KVPageManager``, and seeded allocate / match / free / spill sequences
  replayed through the port's manager and the JAX one on one clock: the same
  pages evicted in the same order, the same chain heads spilled at the
  watermark, the same capped-spill choices and evict reports.
- **Admission**: the scheduler units on the port's scheduler, and seeded
  waiting queues through both schedulers: the same saturation decisions per
  class and the same queue-deadline expiries, under ``max_waiting_seqs``,
  ``queue_deadline_s``, ``batch_queue_deadline_s`` and
  ``interactive_reserve``.
- **The link-probe derivation**: its four cases on the port's function.
- **HTTP acceptance**: a port engine on the CPU at the JAX test's ~112%
  KV-page demand keeps a prefix hit rate >= 0.7 while every over-capacity
  request sheds with a clean 429 + Retry-After, streams with deferred
  headers, shows the saturation block in /stats, and sheds a queued request
  once its deadline passes.
"""

import asyncio
import concurrent.futures as cf
import json
import re
import threading
import time
import types

import numpy as np
import pytest
import requests

from production_stack_tpu.engine import kv_manager as jax_kv
from production_stack_tpu.engine import scheduler as jax_sched
from production_stack_tpu_torch.engine import kv_manager as port_kv
from production_stack_tpu_torch.engine import scheduler as port_sched
from production_stack_tpu_torch.engine.kv_manager import KVPageManager, prefix_hashes
from production_stack_tpu_torch.engine.linkprobe import derive_max_io_pages
from production_stack_tpu_torch.testing.procs import free_port


class _FakeOffload:
    """Offload stub counting save traffic (mirrors test_kvoffload's stub)."""

    def __init__(self):
        self.store = {}
        self.evicted = []
        self.save_calls = 0

    def save_pages(self, pairs):
        self.save_calls += 1
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


class TestEvictionPolicy:
    """Reuse-score eviction (hit count x recency, shared-prefix depth)."""

    def _fill_chain(self, kv, tokens):
        pages = kv.allocate(len(tokens) // kv.page_size)
        kv.register_filled(tokens, pages)
        return pages

    def test_hot_prefix_survives_cold_churn(self):
        """A shared prefix that keeps getting hit stays fully cached while
        one-shot cold chains churn through a pool 150% oversubscribed."""
        kv = KVPageManager(16, 4)
        hot = list(range(100, 116))  # 4 pages
        kv.free(self._fill_chain(kv, hot))
        for i in range(6):  # cold churn: 6 x 4 pages >> remaining 12 slots
            shared, cached = kv.match_prefix(hot)
            assert cached == len(hot), f"hot prefix lost at round {i}"
            cold = [1000 * (i + 1) + t for t in range(16)]
            kv.free(self._fill_chain(kv, cold))
            kv.free(shared)
        _, cached = kv.match_prefix(hot)
        assert cached == len(hot)
        assert kv.evicted_pages_total > 0  # churn really evicted

    def test_cold_tails_evict_before_chain_heads(self):
        """Among equally-cold pages, chain TAILS go first."""
        kv = KVPageManager(8, 4)
        toks = list(range(32))  # one 8-page chain fills the pool
        kv.free(self._fill_chain(kv, toks))
        kv.allocate(3)  # forces 3 evictions
        _, cached = kv.match_prefix(toks)
        # the 3 deepest pages died; the 5-page head still matches contiguously
        assert cached == 5 * 4

    def test_hits_trump_depth(self):
        """A deep page of a hot chain outlives the head of a cold one."""
        kv = KVPageManager(8, 4)
        hot = list(range(16))   # 4 pages
        cold = list(range(100, 116))  # 4 pages
        kv.free(self._fill_chain(kv, hot))
        kv.free(self._fill_chain(kv, cold))
        for _ in range(3):  # heat up the whole hot chain
            shared, _ = kv.match_prefix(hot)
            kv.free(shared)
        kv.allocate(4)  # evict 4: must all come from the cold chain
        _, cached_hot = kv.match_prefix(hot)
        _, cached_cold = kv.match_prefix(cold)
        assert cached_hot == len(hot)
        assert cached_cold == 0
        assert kv.evicted_hot_pages_total == 0  # no protected-page casualty

    def test_proactive_spill_at_watermark_then_free_eviction(self):
        """Past the high watermark the coldest evictable pages spill while
        still resident; their later eviction skips the blocking save."""
        off = _FakeOffload()
        kv = KVPageManager(8, 4, offload=off, spill_watermark=0.5)
        toks = list(range(32))
        kv.free(self._fill_chain(kv, toks))  # free_list empty -> past mark
        spilled = kv.proactive_spill()
        assert spilled == 8
        assert len(off.store) == 8
        assert kv.proactive_spilled_pages_total == 8
        # still resident: full match, no restore
        shared, cached = kv.match_prefix(toks)
        assert cached == 32
        kv.free(shared)
        # repeat call is a no-op (nothing unspilled)
        assert kv.proactive_spill() == 0
        saves_before = off.save_calls
        kv.allocate(8)  # evict everything
        assert off.save_calls == saves_before, "eviction re-saved spilled pages"
        assert not off.evicted  # blobs exist: no false evict reports

    def test_capped_spill_prefers_chain_heads(self):
        """Under a max_io_pages cap the HEADS are what spills — a chain
        restores only from its head."""
        off = _FakeOffload()
        kv = KVPageManager(8, 4, offload=off, max_io_pages=2,
                           spill_watermark=0.0)
        toks = list(range(32))
        kv.free(self._fill_chain(kv, toks))
        kv.free(kv.allocate(8))  # evict all 8: spill budget 2, rest dropped
        assert len(off.store) == 2
        assert len(off.evicted) == 6
        chain = prefix_hashes(toks, 4)
        assert set(off.store) == set(chain[:2]), "cap must keep chain heads"
        # the restorable head extends a fresh match through the offload tier
        _, cached = kv.match_prefix(toks)
        assert cached == 8


# -- the port's eviction against the JAX package's ------------------------------

class _Clock:
    """One monotonic clock for both managers: ``time`` in each kv_manager
    module reads it, so reuse scores and their decay are the same numbers in
    both. Every other ``time`` function is the real one."""

    def __init__(self):
        self.t = 1000.0

    def module(self):
        return types.SimpleNamespace(monotonic=lambda: self.t, time=time.time, perf_counter=time.perf_counter)


class _LogOffload(_FakeOffload):
    """Offload stub logging every save batch and evict report in order."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def save_pages(self, pairs):
        self.log.append(("save", [(pid, h.hex()) for pid, h in pairs]))
        super().save_pages(pairs)

    def report_evict(self, hs):
        self.log.append(("evict_report", [h.hex() for h in hs]))
        super().report_evict(hs)

    def load_pages(self, pairs):
        self.log.append(("load", [(pid, h.hex()) for pid, h in pairs]))
        return len(pairs)


PAGE_KV = 4
# four shared prefixes of 2-6 pages: requests share their heads, so chains
# collect hits at different depths
_PREFIXES = [[1000 * (p + 1) + t for t in range(PAGE_KV * n)] for p, n in enumerate((2, 3, 5, 6))]


def _drive(mod, clock, seed, steps, **kw):
    """Replay a seeded request mix through ``mod.KVPageManager``; return the
    log of everything it chose: each allocation's pages (the evicted ones in
    eviction order once the free list is dry), spill batches, evict reports,
    restores, match lengths, and the counters at the end."""
    log = []
    offload = _LogOffload(log) if kw.pop("offload", False) else None
    kv = mod.KVPageManager(24, PAGE_KV, offload=offload, **kw)
    rng = np.random.default_rng(seed)
    live, seen = [], []
    for step in range(steps):
        clock.t += float(rng.integers(1, 40))  # hits decay over minutes
        op = int(rng.integers(0, 10))
        if op < 5:  # a request: match its prefix, allocate the rest, fill
            p = int(rng.integers(0, len(_PREFIXES)))
            head = _PREFIXES[p][: PAGE_KV * int(rng.integers(1, len(_PREFIXES[p]) // PAGE_KV + 1))]
            tail = [int(x) for x in rng.integers(0, 50, size=PAGE_KV * int(rng.integers(1, 4)))]
            toks = head + tail
            shared, cached = kv.match_prefix(toks)
            new = kv.allocate(len(toks) // PAGE_KV - len(shared))
            log.append(("request", step, cached, new))
            if new is None:
                kv.free(shared)
                continue
            kv.register_filled(toks, shared + new)
            live.append(shared + new)
            seen.append(toks)
        elif op < 8 and live:  # a request finishes
            kv.free(live.pop(int(rng.integers(0, len(live)))))
        elif op == 8 and seen:  # a repeat of an earlier prompt
            shared, cached = kv.match_prefix(seen[int(rng.integers(0, len(seen)))])
            log.append(("touch", step, cached))
            kv.free(shared)
        else:
            log.append(("spill", step, kv.proactive_spill()))
    for pages in live:
        kv.free(pages)
    log.append(("drain", kv.allocate(kv.num_free())))
    log.append(("counters", kv.evicted_pages_total, kv.evicted_hot_pages_total, kv.proactive_spilled_pages_total,
                kv.prefix_hits, kv.prefix_queries, kv.offload_hits))
    return log


_KV_CASES = {
    "no_offload": {},
    "spill_watermark": {"offload": True, "spill_watermark": 0.7},
    "capped_spill": {"offload": True, "max_io_pages": 2, "spill_watermark": 0.0},
    "capped_spill_watermark": {"offload": True, "max_io_pages": 3, "spill_watermark": 0.8},
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(_KV_CASES))
def test_eviction_spill_and_restore_choices_match_jax(monkeypatch, case, seed):
    """The port's KVPageManager and the JAX one, given the same seeded
    sequence on one clock, evict the same pages in the same order, spill the
    same chain heads at the watermark, make the same capped-spill choices
    and evict reports, and restore the same pages."""
    clock = _Clock()
    monkeypatch.setattr(jax_kv, "time", clock.module())
    monkeypatch.setattr(port_kv, "time", clock.module())
    logs = []
    for mod in (jax_kv, port_kv):
        clock.t = 1000.0
        logs.append(_drive(mod, clock, seed, 300, **_KV_CASES[case]))
    jax_log, port_log = logs
    for i, (a, b) in enumerate(zip(jax_log, port_log)):
        assert a == b, (i, a, b)
    assert len(jax_log) == len(port_log)
    # the sequence really drove the policy: evictions, and with a tier, spills
    counters = port_log[-1]
    assert counters[1] > 0
    if _KV_CASES[case].get("offload"):
        assert any(e[0] == "save" for e in port_log)
    if _KV_CASES[case].get("max_io_pages"):
        assert any(e[0] == "evict_report" and e[1] for e in port_log)


class TestLinkProbeDerivation:
    def test_fast_link_unbounded(self):
        assert derive_max_io_pages(20e9, page_bytes=1 << 20) == 0

    def test_unknown_bandwidth_unbounded(self):
        assert derive_max_io_pages(None, page_bytes=1 << 20) == 0

    def test_slow_link_capped_by_stall_budget(self):
        # 20 MB/s link, 1 MB pages, 0.25 s stall budget -> 4 pages
        assert derive_max_io_pages(20e6, page_bytes=1 << 20) == 4

    def test_slow_link_floor_one_page(self):
        assert derive_max_io_pages(1e5, page_bytes=1 << 20) == 1


class TestSchedulerAdmission:
    def _sched(self, **kw):
        return port_sched.Scheduler(KVPageManager(64, 8), **kw)

    def _seq(self, sid, arrival=None):
        s = port_sched.Sequence(seq_id=sid, prompt_ids=list(range(16)), params=port_sched.SamplingParams())
        if arrival is not None:
            s.arrival_time = arrival
        return s

    def test_saturated_uses_free_seat_projection(self):
        """Free seats project forward: a queue momentarily at its bound
        while seats are open does NOT read as saturated."""
        sched = self._sched(max_waiting_seqs=2, max_num_seqs=1)
        sched.add(self._seq("a"))
        sched.add(self._seq("b"))
        assert not sched.saturated()  # 2 waiting, but 1 free seat absorbs one
        sched.add(self._seq("c"))
        assert sched.saturated()      # 3 >= 2 + 1 free seat
        sched.running.append(sched.waiting.pop())  # seat taken
        assert sched.saturated()      # 2 waiting >= 2 + 0 free seats

    def test_unbounded_never_saturates(self):
        sched = self._sched()
        for i in range(50):
            sched.add(self._seq(f"s{i}"))
        assert not sched.saturated()

    def test_expired_waiting_respects_deadline_and_preemption(self):
        now = time.monotonic()
        sched = self._sched(queue_deadline_s=1.0)
        fresh = self._seq("fresh", arrival=now)
        stale = self._seq("stale", arrival=now - 5.0)
        preempted = self._seq("preempted", arrival=now - 5.0)
        preempted.preempted = True  # already streamed: may not shed
        dispatched = self._seq("dispatched", arrival=now - 5.0)
        dispatched.first_dispatch_time = now - 4.0
        for s in (fresh, stale, preempted, dispatched):
            sched.add(s)
        assert [s.seq_id for s in sched.expired_waiting(now)] == ["stale"]


# -- the port's admission against the JAX package's ------------------------------

def _admission_log(mod, kv_mod, seed, **kw):
    """Replay a seeded arrival / admit / finish / expire mix through
    ``mod.Scheduler``; log each saturation decision for both classes before
    every arrival, whether the arrival was shed, and every expiry set."""
    sched = mod.Scheduler(kv_mod.KVPageManager(64, 8), **kw)
    rng = np.random.default_rng(seed)
    now, log = 1000.0, []
    for i in range(160):
        now += float(rng.uniform(0.0, 0.6))
        op = int(rng.integers(0, 8))
        if op < 4:  # an arrival; the API layer sheds it when saturated
            prio = "batch" if rng.random() < 0.4 else "interactive"
            sat = (sched.saturated("interactive"), sched.saturated("batch"))
            log.append(("arrive", i, prio, sat))
            if sat[prio == "batch"]:
                continue
            s = mod.Sequence(seq_id=f"s{i}", prompt_ids=list(range(16)), params=mod.SamplingParams())
            s.arrival_time, s.priority = now, prio
            if rng.random() < 0.1:
                s.preempted = True
            sched.add(s)
        elif op < 6 and sched.waiting and len(sched.running) < sched.max_num_seqs:  # admit the head
            s = sched.waiting.pop(0)
            s.first_dispatch_time = now
            sched.running.append(s)
        elif op == 6 and sched.running:  # a running request finishes
            sched.running.pop(int(rng.integers(0, len(sched.running))))
        else:  # the engine loop's deadline sweep
            gone = sched.expired_waiting(now)
            log.append(("expire", i, [s.seq_id for s in gone]))
            for s in gone:
                sched.waiting.remove(s)
    return log


_ADMISSION = {
    "bounded": dict(max_num_seqs=3, max_waiting_seqs=4, queue_deadline_s=2.0),
    "reserve": dict(max_num_seqs=2, max_waiting_seqs=5, interactive_reserve=3, queue_deadline_s=3.0),
    "batch_deadline": dict(max_num_seqs=2, max_waiting_seqs=6, interactive_reserve=1, queue_deadline_s=4.0,
                           batch_queue_deadline_s=1.0),
    "batch_deadline_only": dict(max_num_seqs=4, max_waiting_seqs=3, interactive_reserve=0,
                                batch_queue_deadline_s=1.5),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(_ADMISSION))
def test_admission_decisions_match_jax(case, seed):
    """The port's scheduler and the JAX one, given the same waiting queue
    and the same bounds, deadlines and reserve, make the same saturation
    decision for each class and expire the same requests."""
    jax_log = _admission_log(jax_sched, jax_kv, seed, **_ADMISSION[case])
    port_log = _admission_log(port_sched, port_kv, seed, **_ADMISSION[case])
    assert port_log == jax_log
    # the mix reached both decisions: sheds and expiries happened
    assert any(e[0] == "arrive" and any(e[3]) for e in port_log)
    assert any(e[0] == "expire" and e[2] for e in port_log)


# -- HTTP acceptance on a port engine --------------------------------------------

PAGE = 8           # tokens per page (byte tokenizer: 1 token per char)
NUM_PAGES = 56
SHARED = "S" * (8 * PAGE)           # 8-page fleet-wide shared prefix
USERS = 11                          # 11 x 5-page user histories
USER_PREFIX = {u: f"u{u:02d}" + chr(ord("a") + u) * (5 * PAGE - 3)
               for u in range(USERS)}
# hot-set demand: 8 shared + 55 user pages = 63 pages against a 56-page pool
# = 112% occupancy
HOT_SET_PAGES = 8 + 5 * USERS


@pytest.fixture(scope="module")
def overload_server():
    """A port engine on the CPU behind its API server, in-process, with a
    page pool ~12% smaller than the workload's hot set and admission control
    on: 3 seats, 3 waiting, 1 s Retry-After. queue_deadline_s is set
    (generously) so the deferred-headers shed path is live on every
    streaming request."""
    import torch

    from production_stack_tpu_torch.engine import api_server as engine_api
    from production_stack_tpu_torch.engine.config import EngineConfig

    # llama-debug's ops are too small to split: one intra-op thread keeps
    # the engine's steps from waiting on a thread pool that shares the
    # machine's cores with other test processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    port = free_port()
    cfg = EngineConfig(
        model="llama-debug", host="127.0.0.1", port=port,
        max_model_len=256, max_num_seqs=3, num_pages=NUM_PAGES,
        page_size=PAGE, prefill_chunk=64,
        max_waiting_seqs=3, queue_deadline_s=30.0, shed_retry_after_s=1.0,
        kv_cache_memory_gb=0.01,
    )
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server, runner = asyncio.run_coroutine_threadsafe(
        engine_api.serve(cfg, device="cpu"), loop
    ).result(300)
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if requests.get(f"{base}/health", timeout=2).status_code == 200:
                break
        except requests.RequestException:
            time.sleep(0.2)
    yield base, server
    asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
    server.engine.stop()
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=10)
    torch.set_num_threads(threads)


def _counters(base: str) -> dict:
    out = {}
    for line in requests.get(f"{base}/metrics", timeout=10).text.splitlines():
        m = re.match(r"(vllm:[a-z_]+)\{[^}]*\} ([0-9.eE+-]+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


@pytest.mark.usefixtures("overload_server")
class TestHTTPOverloadAcceptance:
    def _post(self, base, prompt, max_tokens=4, stream=False):
        return requests.post(
            f"{base}/v1/completions",
            json={"model": "llama-debug", "prompt": prompt,
                  "max_tokens": max_tokens, "temperature": 0.0,
                  "ignore_eos": True, "stream": stream},
            timeout=60,
        )

    def test_overload_survives_with_protected_hot_set(self, overload_server):
        """~112% KV-page demand, multi-user round-robin: sustained prefix
        hit rate >= 0.7, every over-capacity request shed with a clean 429 +
        Retry-After, zero hangs, zero non-429 client errors."""
        base, server = overload_server
        assert HOT_SET_PAGES / NUM_PAGES > 1.1  # the pool IS oversubscribed

        # warmup: register every user's chain once (low concurrency: no shed)
        for u in range(USERS):
            r = self._post(base, SHARED + USER_PREFIX[u] + f"warm{u:02d}" * 2)
            assert r.status_code == 200, r.text

        c0 = _counters(base)
        statuses = []
        sheds = []
        errors = []
        lock = threading.Lock()

        def one(u, rnd):
            try:
                r = self._post(
                    base, SHARED + USER_PREFIX[u] + f"r{rnd:02d}q{u:02d}" * 2,
                    max_tokens=24,  # hold the seat long enough to queue rivals
                )
                with lock:
                    statuses.append(r.status_code)
                    if r.status_code == 429:
                        sheds.append((r.headers.get("Retry-After"), r.text))
                    elif r.status_code != 200:
                        errors.append((r.status_code, r.text[:200]))
            except requests.RequestException as e:  # hang/timeout = failure
                with lock:
                    errors.append(("exception", repr(e)))

        for rnd in range(4):
            with cf.ThreadPoolExecutor(max_workers=USERS) as pool:
                # rotate start order so every user gets served some rounds
                list(pool.map(lambda u: one(u, rnd),
                              [(u + rnd * 3) % USERS for u in range(USERS)]))

        c1 = _counters(base)
        assert not errors, errors
        assert statuses and set(statuses) <= {200, 429}

        # the run genuinely overloaded the engine: sheds happened and the
        # pool churned (evictions prove demand exceeded capacity)
        assert any(s == 429 for s in statuses), statuses
        assert c1["vllm:num_requests_shed_total"] > c0.get(
            "vllm:num_requests_shed_total", 0
        )
        assert c1["vllm:kv_evicted_pages_total"] > c0.get(
            "vllm:kv_evicted_pages_total", 0
        )

        # every shed carried the retry contract: Retry-After header + typed
        # JSON error body
        for retry_after, text in sheds:
            assert retry_after is not None and float(retry_after) >= 1
            body = json.loads(text)
            assert body["error"]["type"] == "overloaded_error"

        hits = (c1["vllm:gpu_prefix_cache_hits_total"]
                - c0["vllm:gpu_prefix_cache_hits_total"])
        queries = (c1["vllm:gpu_prefix_cache_queries_total"]
                   - c0["vllm:gpu_prefix_cache_queries_total"])
        assert queries > 0
        hit_rate = hits / queries
        assert hit_rate >= 0.7, (
            f"prefix hit rate collapsed under overload: {hit_rate:.3f} "
            f"(hits={hits:.0f} queries={queries:.0f})"
        )

    def test_streaming_works_with_deferred_headers(self, overload_server):
        """queue_deadline_s > 0 defers response headers until the first
        engine output; a normal streaming request still delivers a
        well-formed SSE stream."""
        base, _ = overload_server
        r = self._post(base, SHARED + "stream-check", max_tokens=4,
                       stream=True)
        assert r.status_code == 200
        lines = [l for l in r.iter_lines() if l.startswith(b"data: ")]
        assert lines and lines[-1] == b"data: [DONE]"

    def test_stats_endpoint_reports_saturation_block(self, overload_server):
        base, _ = overload_server
        s = requests.get(f"{base}/stats", timeout=10).json()
        sat = s["saturation"]
        assert sat["max_waiting_seqs"] == 3
        assert sat["queue_deadline_s"] == 30.0
        assert sat["retry_after_s"] == 1.0
        assert isinstance(sat["saturated"], bool)
        assert "kv_evicted_pages_total" in s


class TestQueueDeadlineShed:
    """Engine-level queue-deadline shedding: a request stuck behind a full
    batch past the deadline finishes with reason 'shed'."""

    def test_queued_request_sheds_after_deadline(self):
        from production_stack_tpu_torch.engine.config import EngineConfig
        from production_stack_tpu_torch.engine.engine import LLMEngine
        from production_stack_tpu_torch.engine.scheduler import SamplingParams

        cfg = EngineConfig(
            model="llama-debug", max_model_len=512, max_num_seqs=1,
            num_pages=64, page_size=8, prefill_chunk=64,
            queue_deadline_s=0.1, shed_retry_after_s=1.0,
            kv_cache_memory_gb=0.01,
        )
        eng = LLMEngine(cfg, device="cpu")
        eng.start()
        try:
            async def run():
                async def collect(sid, prompt, n):
                    outs = []
                    async for out in eng.generate(
                        sid, prompt=prompt,
                        params=SamplingParams(
                            max_tokens=n, temperature=0.0, ignore_eos=True
                        ),
                    ):
                        outs.append(out)
                    return outs

                # A occupies the single seat for many tokens; B queues
                # behind it and must shed after ~0.1 s
                a = asyncio.ensure_future(collect("a", "x" * 64, 256))
                await asyncio.sleep(0.05)  # A reaches the scheduler first
                b = await collect("b", "y" * 64, 4)
                a.cancel()
                return b

            outs = asyncio.run(asyncio.wait_for(run(), 120))
            assert outs[-1].finished
            assert outs[-1].finish_reason == "shed"
            assert outs[-1].completion_tokens == 0
            assert eng.requests_shed["queue_deadline"] == 1
        finally:
            eng.stop()


def test_hit_rate_collapse_counterfactual_demand_math():
    """The acceptance workload's hot set really exceeds the pool by ~10-15%,
    and the per-request hit ceiling leaves room above the 0.7 bar."""
    assert 1.10 < HOT_SET_PAGES / NUM_PAGES < 1.15
    prompt_pages = len(SHARED + USER_PREFIX[0] + "r00q00" * 2) // PAGE
    matchable = (len(SHARED) + len(USER_PREFIX[0])) // PAGE
    assert matchable / prompt_pages > 0.85
