"""Live sequence migration in the port (production_stack_tpu_torch/migration/,
the engine's freeze and the server's /migratable and /migrate_* routes)
against the JAX package's, on the CPU.

- The snapshot wire (tests/test_migration.py TestSnapshotWire) on the port's
  state.py; a snapshot of the same sequence is byte-identical across the
  packages, and each reads the other's.
- test_greedy_continuation_bit_identical_across_cpu_engines on two port
  engines, with the pages shipped through the tiers and over the fabric:
  the spliced ids equal the unmigrated run's, and the target restores the
  shipped pages and prefills only the tail.
- Across the packages over HTTP, a JAX server to a port server and back,
  both over one cache server: the spliced ids equal the unmigrated run's,
  and with a port target the client's text too.
- The port's router splices a port engine's migrated stream into one
  stream whose text and usage equal an unmigrated run's
  (test_real_engine_http_migration_via_router); a ship to a dead target
  rolls back and the stream finishes on its source.
- The JAX package's fleet controller (scripts/fleet_controller.py --once)
  over a port engine and a JAX engine migrates a stream off the port engine
  (the port's own controller: tests/test_torch_router.py).
- int8 pools: a migration's explicit-page fabric handoff lands the source's
  int8 pages and scales bit for bit (test_int8_migration_handoff_bit_identical).
- A tp 2 source (gloo ranks) migrates to a tp 1 target with the f32 tokens
  of an unmigrated run.

Engines run in this process on their own loop threads; servers on a loop
thread of the test; the router and the controller as subprocesses.
"""

import asyncio
import functools
import json
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import requests

from production_stack_tpu.engine import api_server as jax_server
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.migration import state as jstate
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.testing.procs import REPO_ROOT, cpu_env, free_port, start_proc, stop_proc, wait_healthy
from production_stack_tpu_torch.engine import api_server as port_server
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_loader import params_from_jax
from production_stack_tpu_torch.engine.scheduler import SamplingParams, Sequence
from production_stack_tpu_torch.kvoffload import cache_server
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError, get_serde
from production_stack_tpu_torch.migration import (
    SequenceSnapshot,
    continuation_params,
    snapshot_from_wire,
    snapshot_to_wire,
    unmigratable_reason,
)
from production_stack_tpu_torch.migration import state as pstate
from production_stack_tpu_torch.models import llama as tllama

MODEL = "llama-debug-4kv-f32"
PAGE = 16
SMALL = dict(model=MODEL, host="127.0.0.1", max_model_len=256, num_pages=64, page_size=PAGE, prefill_chunk=64,
             decode_steps=2)
PROMPT = "The quick brown fox jumps over the lazy dog. " * 3  # 136 bytes and BOS: 8 full pages


# -- the snapshot wire (TestSnapshotWire) ----------------------------------------


def _params_doc(max_tokens=16, **over):
    doc = {"max_tokens": max_tokens, "temperature": 0.0, "top_k": 0, "top_p": 1.0, "stop": [], "ignore_eos": True,
           "min_tokens": 0, "seed": None, "presence_penalty": 0.0, "frequency_penalty": 0.0,
           "repetition_penalty": 1.0}
    doc.update(over)
    return doc


def _snap(mod=pstate, output_len=4, **over):
    kw = dict(request_id="r-1", model="llama-debug", page_size=16, tokens=list(range(32 + output_len)),
              prompt_len=32, output_len=output_len, params=_params_doc(), page_hashes=["ab" * 16],
              meta={"oid": "cmpl-r-1", "chat": False})
    kw.update(over)
    return mod.SequenceSnapshot(**kw)


def test_a_snapshot_round_trips_and_a_damaged_one_is_refused():
    s = _snap()
    s2 = snapshot_from_wire(snapshot_to_wire(s))
    assert s2 == s and s2.meta["oid"] == "cmpl-r-1"
    data = bytearray(snapshot_to_wire(s))
    data[len(data) // 2] ^= 0xFF  # a flipped bit inside the body
    with pytest.raises((KVIntegrityError, ValueError)):
        snapshot_from_wire(bytes(data))
    with pytest.raises((KVIntegrityError, ValueError)):
        snapshot_from_wire(bytes(data[: len(data) - 4]))  # truncated
    with pytest.raises(ValueError, match="format"):
        SequenceSnapshot.from_doc({**s.to_doc(), "format": 2})


def test_the_continuations_budget_shrinks_by_what_was_emitted():
    p = continuation_params(_snap(output_len=5, params=_params_doc(max_tokens=16, min_tokens=8)))
    assert isinstance(p, SamplingParams) and p.max_tokens == 11 and p.min_tokens == 3
    with pytest.raises(ValueError, match="nothing left"):
        continuation_params(_snap(output_len=16, params=_params_doc(max_tokens=16)))


def test_the_unmigratable_reasons():
    def seq(**over):
        s = Sequence(seq_id="s", prompt_ids=list(range(8)), params=SamplingParams(max_tokens=16))
        s.num_computed = 8  # decoding
        s.output_ids = [1, 2]
        for k, v in over.items():
            setattr(s, k, v)
        return s

    assert unmigratable_reason(seq()) is None
    assert "finished" in unmigratable_reason(seq(finished=True))
    assert "prefilling" in unmigratable_reason(seq(num_computed=4))
    assert "no tokens" in unmigratable_reason(seq(output_ids=[]))
    assert "LoRA" in unmigratable_reason(seq(lora_slot=2))
    for field, value, words in (("logprobs", 4, "logprobs"), ("logit_bias", {3: 1.0}, "logit_bias"),
                                ("presence_penalty", 0.5, "penalties"), ("frequency_penalty", 0.5, "penalties")):
        s = seq()
        setattr(s.params, field, value)
        assert words in unmigratable_reason(s)
    assert "about to finish" in unmigratable_reason(seq(output_ids=list(range(16))))
    s = seq()
    s.params.repetition_penalty = 1.2  # spans prompt and output: it migrates
    assert unmigratable_reason(s) is None


def test_a_snapshot_is_byte_identical_across_the_packages_and_each_reads_the_others():
    from production_stack_tpu.engine.scheduler import SamplingParams as JaxSamplingParams

    sp = dict(max_tokens=40, temperature=0.0, top_k=5, top_p=0.9, stop=["x"], ignore_eos=True, min_tokens=3,
              seed=7, repetition_penalty=1.1)
    port_doc, jax_doc = pstate.params_to_doc(SamplingParams(**sp)), jstate.params_to_doc(JaxSamplingParams(**sp))
    assert port_doc == jax_doc
    port_wire = snapshot_to_wire(_snap(pstate, params=port_doc))
    jax_wire = jstate.snapshot_to_wire(_snap(jstate, params=jax_doc))
    assert port_wire == jax_wire
    assert snapshot_from_wire(jax_wire) == _snap(pstate, params=port_doc)
    assert jstate.snapshot_from_wire(port_wire) == _snap(jstate, params=jax_doc)
    cp, cj = continuation_params(snapshot_from_wire(jax_wire)), jstate.continuation_params(
        jstate.snapshot_from_wire(port_wire))
    assert {f: getattr(cp, f) for f in pstate._PARAM_FIELDS} == {f: getattr(cj, f) for f in jstate._PARAM_FIELDS}


# -- engines ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jparams = jax.device_get(jllama.init_params(jllama.PRESETS[MODEL], jax.random.key(0)))
    return params_from_jax(jparams, tllama.PRESETS[MODEL])


def _port(params, **kw):
    eng = LLMEngine(EngineConfig(**{**SMALL, "port": free_port(), **kw}), device="cpu", params=params)
    eng.start()
    return eng


async def _collect(engine, seq_id, params, prompt=None, prompt_ids=None):
    ids, reason = [], None
    async for out in engine.generate(seq_id, prompt=prompt, prompt_token_ids=prompt_ids, params=params):
        ids.extend(out.token_ids)
        if out.finished:
            reason = out.finish_reason
    return ids, reason


def _migrate_in_process(src, dst, fabric_addr=None, max_tokens=40):
    """test_greedy_continuation_bit_identical_across_cpu_engines: the
    baseline on the source (the target stays cold), then the same request
    frozen after 6 tokens, its sealed snapshot carried to the target, its
    pages fetched there and the continuation decoded. Returns (baseline ids,
    snapshot, continuation ids, the target's restored pages and prefilled
    tokens)."""
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)

    async def run():
        loop = asyncio.get_running_loop()
        base_ids, reason = await _collect(src, "baseline", sp, prompt=PROMPT)
        assert len(base_ids) == max_tokens and reason == "length"
        got, frozen = [], asyncio.Event()

        async def source():
            async for out in src.generate("mig", prompt=PROMPT, params=sp):
                got.extend(out.token_ids)
                if len(got) >= 6:
                    frozen.set()
                if out.finished:
                    return out.finish_reason

        task = asyncio.create_task(source())
        await frozen.wait()
        snap = await loop.run_in_executor(None, src.migration.freeze_and_snapshot, "mig", {"request_id": "mig"},
                                          fabric_addr)
        snap = snapshot_from_wire(snapshot_to_wire(snap))
        await loop.run_in_executor(None, src.migration.commit, "mig", len(snap.page_hashes))
        assert await task == "migrated"
        assert await loop.run_in_executor(None, dst.migration.prefetch_pages, snap.page_hashes) == len(
            snap.page_hashes)
        hits0, prompt0 = dst.kv.offload_hits, dst.total_prompt_tokens
        cont, reason = await _collect(dst, snap.request_id, continuation_params(snap), prompt_ids=snap.tokens)
        assert reason == "length"
        return base_ids, snap, cont, dst.kv.offload_hits - hits0, dst.total_prompt_tokens - prompt0

    return asyncio.run(run())


@pytest.mark.parametrize("path", ["tiers", "fabric"])
def test_greedy_continuation_bit_identical_across_port_engines(params, tmp_path, path):
    if path == "tiers":
        kw = dict(kv_offload_dir=str(tmp_path / "kv"), kv_offload_disk_gb=1, kv_offload_max_io_pages=0)
        src, dst = _port(params, **kw), _port(params, **kw)
    else:
        src = _port(params, kv_fabric=True)
        dst = _port(params, kv_fabric=True, kv_offload_cpu_gb=0.05)
    try:
        addr = dst._fabric_server.address if path == "fabric" else None
        base, snap, cont, restored, prefilled = _migrate_in_process(src, dst, addr)
        assert snap.output_len >= 6 and snap.tokens[snap.prompt_len:] + cont == base
        n = (len(snap.tokens) - 1) // PAGE
        assert len(snap.page_hashes) == n >= 8
        # the shipped pages restore; only the tail chunk is prefilled
        assert restored == n and prefilled == len(snap.tokens) - n * PAGE
        stats = src.migration.stats()
        assert stats["migrations_out_total"] == 1 and stats["migration_pages_moved_total"] == n
        assert stats["migration_fabric_pages_total"] == (n if path == "fabric" else 0)
        assert src.migration.duration_hist._total == 1 and not src._frozen
        if path == "fabric":
            assert dst._fabric_server.stats()["received_pages"] == n and dst.stats()["kv_offload_saved_pages_total"] == 0
    finally:
        src.stop()
        dst.stop()


def test_a_rollback_puts_the_stream_back_and_an_abort_frees_a_frozen_one(params):
    """A refused ship: the frozen sequence decodes on with the baseline's
    tokens. A client that leaves while its sequence is frozen frees it."""
    eng = _port(params)
    sp = SamplingParams(max_tokens=24, temperature=0.0, ignore_eos=True)
    try:
        async def run():
            loop = asyncio.get_running_loop()
            base, _ = await _collect(eng, "base", sp, prompt=PROMPT)
            got, ready = [], asyncio.Event()

            async def stream(rid):
                async for out in eng.generate(rid, prompt=PROMPT, params=sp):
                    got.extend(out.token_ids)
                    ready.set()
                    if out.finished:
                        return out.finish_reason

            task = asyncio.create_task(stream("rb"))
            await ready.wait()
            await loop.run_in_executor(None, eng.migration.freeze_and_snapshot, "rb", {})
            assert "rb" in eng._frozen
            await loop.run_in_executor(None, eng.migration.rollback, "rb")
            assert await task == "length"
            free0 = eng.kv.num_free()
            ready.clear()
            task = asyncio.create_task(stream("ab"))
            await ready.wait()
            await loop.run_in_executor(None, eng.migration.freeze_and_snapshot, "ab", {})
            task.cancel()  # the client leaves: generate's finally aborts it
            for _ in range(100):
                if not eng._frozen:
                    break
                await asyncio.sleep(0.02)
            return base, got, free0

        base, got, free0 = asyncio.run(run())
        assert got[: len(base)] == base and not eng._frozen and eng.migration.failures == 1
        assert eng.kv.num_free() == free0
    finally:
        eng.stop()


def test_int8_migration_handoff_bit_identical(params):
    """A migration's explicit (pid, key) pages cross the fabric between two
    int8 port engines and land with the source's quantized bytes and scales
    exactly (no dequantize and requantize)."""
    kw = dict(kv_cache_dtype="int8", kv_fabric=True)
    src, dst = _port(params, **kw), _port(params, kv_offload_cpu_gb=0.05, **kw)
    try:
        asyncio.run(_collect(src, "q", SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True),
                             prompt="pages to hand off during a live migration " * 3))
        pairs = [(pid, h.hex()) for h, pid in list(src.kv.hash_to_page.items())[:3]]
        assert len(pairs) == 3
        assert sorted(src.fabric_ship_pairs(dst._fabric_server.address, pairs)) == sorted(k for _, k in pairs)
        qks, qvs, sks, svs = src._run_on_device_thread(lambda: src.runner.get_pages_quant([p for p, _ in pairs]))
        serde = get_serde("int8page")
        for i, (_, key) in enumerate(pairs):
            qk, sk, qv, sv = serde.deserialize_quant(dst._offload.store.get(key))
            for got, want in ((qk, qks[i]), (sk, sks[i]), (qv, qvs[i]), (sv, svs[i])):
                assert np.array_equal(got, want) and got.dtype == want.dtype
    finally:
        src.stop()
        dst.stop()


def test_a_tp2_source_migrates_to_a_tp1_target_with_equal_tokens(params):
    """The pages of a tp 2 engine (gloo ranks; each rank holds half the KV
    heads) leave through the runner's page calls over the fabric and
    restore into a tp 1 engine; the spliced f32 tokens equal the source's
    unmigrated run."""
    src = _port(params, kv_fabric=True, tensor_parallel_size=2, tp_backend="gloo")
    dst = _port(params, kv_fabric=True, kv_offload_cpu_gb=0.05)
    try:
        base, snap, cont, restored, _ = _migrate_in_process(src, dst, dst._fabric_server.address, max_tokens=24)
        assert snap.tokens[snap.prompt_len:] + cont == base
        assert restored == len(snap.page_hashes) >= 8
    finally:
        src.stop()
        dst.stop()


def _hop(src, seq_id, sp, fabric_addr=None, after=6, **prompt):
    """Start ``seq_id`` on ``src``, freeze it once ``after`` ids came, and
    ship it (over the fabric to ``fabric_addr``, else through the tiers).
    Returns (the ids ``src`` emitted, the terminal output's repeat of the
    last one included; the sealed snapshot)."""

    async def run():
        loop = asyncio.get_running_loop()
        got, frozen = [], asyncio.Event()

        async def stream():
            async for out in src.generate(seq_id, params=sp, **prompt):
                got.extend(out.token_ids)
                if len(got) >= after:
                    frozen.set()
                if out.finished:
                    return out.finish_reason

        task = asyncio.create_task(stream())
        await frozen.wait()
        snap = await loop.run_in_executor(None, src.migration.freeze_and_snapshot, seq_id, {"request_id": seq_id},
                                          fabric_addr)
        snap = snapshot_from_wire(snapshot_to_wire(snap))
        await loop.run_in_executor(None, src.migration.commit, seq_id, len(snap.page_hashes))
        assert await task == "migrated"
        return got, snap

    return asyncio.run(run())


def test_a_fabric_hop_then_a_tier_hop_leaves_the_pages_on_the_cache_server(params):
    """A stream goes A -> B over the fabric (its pages land in B's local
    tier alone), decodes on, and goes B -> C through the tiers, C sharing
    only the cache server with B. B's save finds the fabric-landed blobs
    local and counts them saved; the tier path writes them through before
    it claims them shared, so the cache server holds every page of the
    snapshot and C restores them all, with the unmigrated run's ids."""
    from production_stack_tpu_torch.kvoffload.tiers import RemoteTier

    loop = _Loop()
    cport = free_port()
    loop.run(cache_server.serve("127.0.0.1", cport, 1 << 26))
    addr = f"127.0.0.1:{cport}"
    a = _port(params, kv_fabric=True)
    b = _port(params, kv_fabric=True, kv_offload_cpu_gb=0.05, kv_remote_url=addr, kv_offload_max_io_pages=0)
    c = _port(params, kv_offload_cpu_gb=0.05, kv_remote_url=addr, kv_offload_max_io_pages=0)
    remote = RemoteTier(addr)
    sp = SamplingParams(max_tokens=40, temperature=0.0, ignore_eos=True)
    try:
        base, _ = asyncio.run(_collect(a, "baseline", sp, prompt=PROMPT))
        _, snap1 = _hop(a, "mig", sp, b._fabric_server.address, prompt=PROMPT)
        assert len(snap1.page_hashes) >= 8 and a.migration.fabric_pages == len(snap1.page_hashes)
        assert b.migration.prefetch_pages(snap1.page_hashes) == len(snap1.page_hashes)
        assert not any(h in remote for h in snap1.page_hashes)  # the fabric hop wrote B's local tier alone
        _, snap2 = _hop(b, "mig", continuation_params(snap1), after=8, prompt_token_ids=snap1.tokens)
        assert snap2.page_hashes[: len(snap1.page_hashes)] == snap1.page_hashes
        assert all(h in remote for h in snap2.page_hashes)
        hits0 = c.kv.offload_hits
        assert c.migration.prefetch_pages(snap2.page_hashes) == len(snap2.page_hashes)
        cont, reason = asyncio.run(_collect(c, "mig", continuation_params(snap2), prompt_ids=snap2.tokens))
        assert reason == "length" and c.kv.offload_hits - hits0 == len(snap2.page_hashes)
        assert snap2.tokens[: len(snap1.tokens)] == snap1.tokens
        assert snap2.tokens[snap1.prompt_len:] + cont == base
    finally:
        remote.close()
        for eng in (a, b, c):
            eng.stop()
        loop.close()


# -- over HTTP ------------------------------------------------------------------


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


def _recorded(engine, log, delay=0.0):
    """Record the ids every sequence of ``engine`` emits (``log[seq_id]``),
    the terminal "migrated" output's repeat of its last id left out; with
    ``delay`` each output costs that many seconds on the loop thread, so a
    stream stays live long enough to be migrated."""
    orig = engine.generate

    @functools.wraps(orig)  # the JAX server reads generate's keywords
    async def generate(seq_id, *args, **kwargs):
        async for out in orig(seq_id, *args, **kwargs):
            if not (out.finished and out.finish_reason == "migrated"):
                log.setdefault(seq_id, []).extend(out.token_ids)
            yield out

    engine.generate = generate
    if delay:
        emit = engine._emit

        def slow_emit(*args, **kwargs):
            time.sleep(delay)
            return emit(*args, **kwargs)

        engine._emit = slow_emit
    return engine


class _Stream:
    """A streamed completion read on a thread of its own: its data lines,
    the count of text chunks, and an event set once ``after`` chunks came."""

    def __init__(self, base, rid, max_tokens, after=6, model="m"):
        self.lines, self.status, self.chunks = [], None, 0
        self.ready, self.done = threading.Event(), threading.Event()
        self.body = {"model": model, "prompt": PROMPT, "max_tokens": max_tokens, "temperature": 0.0,
                     "ignore_eos": True, "stream": True}
        self.thread = threading.Thread(target=self._read, args=(base, rid, after), daemon=True)
        self.thread.start()

    def _read(self, base, rid, after):
        try:
            with requests.post(f"{base}/v1/completions", json=self.body, headers={"X-Request-Id": rid},
                               stream=True, timeout=240) as r:
                self.status = r.status_code
                for line in r.iter_lines():
                    if not line:
                        continue
                    self.lines.append(line)
                    if b'"text"' in line:
                        self.chunks += 1
                        if self.chunks >= after:
                            self.ready.set()
        finally:
            self.ready.set()
            self.done.set()

    def text(self):
        out = ""
        for line in self.lines:
            if line.startswith(b"data: {") and b'"choices": [{' in line:
                out += "".join(c.get("text", "") for c in json.loads(line[6:])["choices"])
        return out

    def usage(self):
        return json.loads([x for x in self.lines if b'"usage"' in x][-1][6:])["usage"]


def _counter(url, name):
    import re

    m = re.search(rf"^{re.escape(name)}(?:\{{[^}}]*\}})? ([0-9.eE+-]+)$",
                  requests.get(f"{url}/metrics", timeout=10).text, re.M)
    return float(m.group(1)) if m else 0.0


def _plain_text(base, max_tokens, prompt=PROMPT):
    body = {"model": "m", "prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0, "ignore_eos": True}
    r = requests.post(f"{base}/v1/completions", json=body, timeout=240)
    assert r.status_code == 200, r.text
    return r.json()["choices"][0]["text"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_greedy_continuation_across_the_packages_over_http(params, direction):
    """A stream migrated between a JAX server and a port server over HTTP,
    both engines over one (port) cache server: the source's ids and the
    target's equal the unmigrated run's, the target restores the shipped
    pages, and the client's two legs carry the whole text and usage."""
    loop = _Loop()
    cport = free_port()
    loop.run(cache_server.serve("127.0.0.1", cport, 1 << 26))
    addr = f"127.0.0.1:{cport}"
    log, servers = {}, []
    try:
        def serve(kind):
            common = dict(SMALL, port=free_port(), served_model_name="m", kv_remote_url=addr,
                          kv_offload_cpu_gb=0.05, kv_offload_max_io_pages=0)
            if kind == "jax":
                cfg = JaxEngineConfig(**common)
                eng = _recorded(JaxEngine(cfg), log, delay=0.01)
                servers.append(loop.run(jax_server.serve(cfg, eng)))
            else:
                cfg = EngineConfig(**common)
                eng = _recorded(LLMEngine(cfg, device="cpu", params=params), log, delay=0.01)
                servers.append(loop.run(port_server.serve(cfg, eng, device="cpu")))
            return eng, f"http://127.0.0.1:{cfg.port}"

        src_kind, dst_kind = direction.split("_to_")
        src, src_url = serve(src_kind)
        dst, dst_url = serve(dst_kind)
        want_text = _plain_text(src_url, 40)  # the baseline, on the source (the target stays cold)
        want = log.pop(next(k for k in log))
        stream = _Stream(src_url, "xmig", 40)
        assert stream.ready.wait(120)
        mr = requests.post(f"{src_url}/migrate_out", json={"request_id": "xmig", "target_url": dst_url}, timeout=120)
        assert mr.status_code == 200 and mr.json()["migrated"], mr.text
        assert stream.done.wait(120)
        assert b"pstpu_migration" in stream.lines[-1] and not any(b"[DONE]" in x for x in stream.lines)
        with requests.post(f"{dst_url}/migrate_attach", json={"request_id": "xmig"}, stream=True, timeout=240) as r:
            assert r.status_code == 200
            cont = [x for x in r.iter_lines() if x]
        stream.lines += cont
        assert log["xmig"] == want and len(want) == 40  # source ids + target ids, under one id on each side
        assert stream.usage()["completion_tokens"] == 40
        if dst_kind == "port":
            # a port target decodes its text on from the source's ids; the
            # JAX one from its own alone, so a character split across the
            # handoff comes out there as two broken ones
            assert stream.text() == want_text
        n = mr.json()["pages_moved"]
        assert n >= 8 and dst.kv.offload_hits >= n
        assert _counter(src_url, "vllm:migrations_out_total") == 1
        assert _counter(dst_url, "vllm:migrations_in_total") == 1
    finally:
        for srv, run in servers:
            loop.run(run.cleanup())
            srv.engine.stop()
        loop.close()


def _start_router(urls):
    port = free_port()
    proc = start_proc(["-m", "production_stack_tpu_torch.router.app", "--port", str(port), "--static-backends",
                       ",".join(urls), "--static-models", ",".join(["m"] * len(urls)), "--engine-stats-interval",
                       "1", "--retry-backoff-base", "0.01"])
    return proc, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def pair(params):
    """Two port servers (f32 twin, served as "m") on a loop thread, each
    output slowed by 10 ms, over one shared disk tier."""
    import tempfile

    loop = _Loop()
    log, servers = {}, []
    tmp = tempfile.mkdtemp(prefix="pstpu-mig-")
    for _ in range(2):
        cfg = EngineConfig(**dict(SMALL, port=free_port(), served_model_name="m", max_model_len=512,
                                  kv_offload_dir=tmp, kv_offload_disk_gb=1, kv_offload_max_io_pages=0))
        eng = _recorded(LLMEngine(cfg, device="cpu", params=params), log, delay=0.01)
        servers.append((loop.run(port_server.serve(cfg, eng, device="cpu")), f"http://127.0.0.1:{cfg.port}"))
    yield servers, log, loop
    for (srv, run), _ in servers:
        loop.run(run.cleanup())
        srv.engine.stop()
    loop.close()


def test_real_engine_http_migration_via_router(pair):
    """The port's router in front of two port servers: a stream
    migrated mid-decode reaches the client as one stream (no control
    event, [DONE] once) whose text and usage equal an unmigrated run's; the
    router counts the re-pin and the engines the migration."""
    servers, log, _ = pair
    (ua, ub) = [u for _, u in servers]
    want = _plain_text(ua, 96)
    router, base = _start_router([ua, ub])
    try:
        wait_healthy(f"{base}/health", router, timeout=60)
        stream = _Stream(base, "real-mig", 96)
        assert stream.ready.wait(120)
        src = next(u for u in (ua, ub) if any(
            r["request_id"] == "real-mig" and r["migratable"]
            for r in requests.get(f"{u}/migratable", timeout=10).json()["requests"]))
        tgt = ub if src == ua else ua
        mr = requests.post(f"{src}/migrate_out", json={"request_id": "real-mig", "target_url": tgt}, timeout=120)
        assert mr.status_code == 200 and mr.json()["migrated"] and mr.json()["pages_moved"] >= 8, mr.text
        assert stream.done.wait(240) and stream.status == 200
        assert sum(b"[DONE]" in x for x in stream.lines) == 1
        assert not any(b"pstpu_migration" in x for x in stream.lines)
        assert stream.text() == want and stream.usage()["completion_tokens"] == 96
        assert _counter(src, "vllm:migrations_out_total") >= 1 and _counter(tgt, "vllm:migrations_in_total") >= 1
        assert _counter(base, "vllm_router:session_repins_total") == 1
        assert _counter(base, "vllm_router:migration_splice_failures_total") == 0
    finally:
        stop_proc(router)


def test_a_failed_ship_rolls_back_and_the_stream_finishes_on_its_source(pair):
    servers, _, _ = pair
    ua = servers[0][1]
    want = _plain_text(ua, 48)
    failures = _counter(ua, "vllm:migration_failures_total")
    stream = _Stream(ua, "rollback", 48)
    assert stream.ready.wait(120)
    mr = requests.post(f"{ua}/migrate_out", json={"request_id": "rollback",
                                                  "target_url": f"http://127.0.0.1:{free_port()}"}, timeout=60)
    assert mr.status_code == 502 and mr.json()["migrated"] is False
    assert stream.done.wait(120)
    assert stream.text() == want and any(b"[DONE]" in x for x in stream.lines)
    assert not any(b"pstpu_migration" in x for x in stream.lines)
    assert _counter(ua, "vllm:migration_failures_total") == failures + 1
    # the routes' refusals, as the JAX server gives them
    assert requests.post(f"{ua}/migrate_out", json={}, timeout=10).status_code == 400
    assert requests.post(f"{ua}/migrate_out", json={"request_id": "gone", "target_url": ua},
                         timeout=10).status_code == 409
    assert requests.post(f"{ua}/migrate_in", data=b"junk", timeout=10).status_code == 400
    assert requests.post(f"{ua}/migrate_attach", json={}, timeout=10).status_code == 400


def test_the_fleet_controller_migrates_a_stream_off_a_port_engine(params):
    """scripts/fleet_controller.py --once, unchanged, over a port engine
    serving a stream and an idle JAX engine, both over one cache server: it
    reads both /migratable listings and rebalances the stream from the port
    engine to the JAX engine, which restores the shipped pages and finishes
    the stream. The ids the port engine sent are the unmigrated run's; the
    client gets all of them once (the JAX continuation's own ids are held to
    the unmigrated run in test_greedy_continuation_across_the_packages_over_http)."""
    loop = _Loop()
    cport = free_port()
    loop.run(cache_server.serve("127.0.0.1", cport, 1 << 26))
    plog, jlog, servers = {}, {}, []
    try:
        common = dict(SMALL, served_model_name="m", max_model_len=512, kv_remote_url=f"127.0.0.1:{cport}",
                      kv_offload_cpu_gb=0.05, kv_offload_max_io_pages=0)
        pcfg = EngineConfig(**common, port=free_port())
        peng = _recorded(LLMEngine(pcfg, device="cpu", params=params), plog, delay=0.05)
        servers.append(loop.run(port_server.serve(pcfg, peng, device="cpu")))
        jcfg = JaxEngineConfig(**common, port=free_port())
        jeng = _recorded(JaxEngine(jcfg), jlog)
        servers.append(loop.run(jax_server.serve(jcfg, jeng)))
        purl, jurl = (f"http://127.0.0.1:{c.port}" for c in (pcfg, jcfg))
        _plain_text(jurl, 8, "a warm-up of its own")  # the JAX engine's first compiles, before the stream
        _plain_text(purl, 120)
        want = plog.pop(next(iter(plog)))
        stream = _Stream(purl, "ctl-mig", 120)
        assert stream.ready.wait(120)
        out = subprocess.run(
            [sys.executable, "scripts/fleet_controller.py", "--engines", f"{purl},{jurl}", "--once",
             "--saturation-queue-ref", "1", "--rebalance-high-delta", "0.05", "--cooldown", "0"],
            cwd=REPO_ROOT, env=cpu_env(), capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        actions = json.loads(out.stdout[out.stdout.index("["):])
        assert [(a["kind"], a["source"], a["target"], a["request_ids"]) for a in actions] == [
            ("rebalance", purl, jurl, ["ctl-mig"])]
        assert stream.done.wait(120) and b"pstpu_migration" in stream.lines[-1]
        with requests.post(f"{jurl}/migrate_attach", json={"request_id": "ctl-mig"}, stream=True, timeout=240) as r:
            stream.lines += [x for x in r.iter_lines() if x]
        sent = plog["ctl-mig"]
        assert 6 <= len(sent) < 120 and sent == want[: len(sent)]
        assert len(sent) + len(jlog["ctl-mig"]) == 120 and stream.usage()["completion_tokens"] == 120
        assert any(b"[DONE]" in x for x in stream.lines) and jeng.kv.offload_hits >= 8
        assert _counter(purl, "vllm:migrations_out_total") == 1 and _counter(jurl, "vllm:migrations_in_total") == 1
    finally:
        for srv, run in servers:
            loop.run(run.cleanup())
            srv.engine.stop()
        loop.close()
