"""Fake engine: an OpenAI-API mock for router/stack testing with zero
accelerators — the keystone test fixture.

The port's copy of ``production_stack_tpu/testing/fake_engine.py``, with
every import and every ``-m`` it names pointed at the port; it imports
neither the JAX package nor torch, so it runs where neither is installed.

Parity: src/tests/perftest/fake-openai-server.py:1-170 of the upstream vLLM production stack
(streams tokens at --speed with injectable --ttft, tracks running requests),
extended with /metrics in the engine's vllm:* format, sleep/wake, optional
kv-transfer query params so disaggregated-prefill flows are testable, and
fault injection for the router's failure-domain layer (tests/test_chaos.py,
scripts/chaos_check.py):

- ``--fail-rate P``      each generation request 500s with probability P
- ``--fail-first-n N``   the first N generation requests 500, then recover
- ``--fail-after-chunks N``  streams N chunks then drops the connection
                         (mid-stream truncation)
- ``--hang``             accepts the request, never sends headers (hung
                         engine; only an abort or a router deadline frees it)
- ``--hang-after-chunks N``  streams N chunks then stalls forever
- ``--saturate-after-n N``  engine admission control: a generation request
                         arriving while N are already in flight is SHED
                         with 429 + Retry-After (bounded queue depth — the
                         in-flight count provably never exceeds N)
- ``--shed-rate P``      each generation request 429s (with Retry-After)
                         with probability P
- ``--retry-after S``    Retry-After seconds advertised on shed responses
- ``--crash-after-n N``  HARD crash: once N generation requests have been
                         accepted, the process ``os._exit``s abruptly —
                         mid-stream when streaming, before responding
                         otherwise. No drain, no manifest spill: models the
                         kill -9 / OOM half of restart chaos (SIGTERM models
                         the graceful half)
- ``--restart-restore-pages M``  models a WARM restart: /metrics advertises
                         ``vllm:warm_start_restored_pages M`` (+ manifest
                         age), so rolling-restart chaos runs can assert the
                         warm-start surface without a real engine
- ``--slo-itl-ms X``     the synthetic SLO terminal records report X as
                         their inter-token p99 (``GET /slo_records``, same
                         wire shape as the real engine) — set above the
                         router's objective to drive its violation counters
- ``--compile-stall-ms X``  the first generation stalls X ms and records a
                         flight-recorder ``compile`` event (cold-XLA model)
- ``--kv-directory-url``  fleet-wide KV directory emulation: the
                         fake registers with the cache server's directory
                         and, on every COMPLETED generation, publishes the
                         prompt's chunk hashes as resident claims. Hashes
                         are the real chain (engine/kv_manager.prefix_hashes
                         over ByteTokenizer tokens, page 16) — deterministic
                         per prompt and identical to what the router's
                         kvaware-v2 lookup computes, so router e2e/chaos
                         tests exercise resident ranking with no accelerator.
                         Generation = boot-time ms (monotonic across
                         restarts), so a reborn fake fences its old claims.
- ``--flight-dump-dir D``  arm flight-recorder anomaly dumps (SIGTERM
                         drain, shed bursts) into D; the synthetic
                         sched/kv/shed event feed matches the real engine's
- ``POST /abort``        cancels an in-flight request by X-Request-Id, like
                         the real engine's abort endpoint
- ``--migration``        live sequence migration (docs/migration.md)
                         in the REAL wire shapes: ``POST /migrate_out``
                         freezes a streaming request at a deterministic chunk
                         boundary, ships a sealed ``SequenceSnapshot``
                         (production_stack_tpu_torch/migration/state.py — the same
                         document a real engine ships) to the target's
                         ``POST /migrate_in``, and on acceptance ends the
                         source stream with the ``pstpu_migration`` control
                         event the router splices on; the target parks the
                         continuation and serves it via
                         ``POST /migrate_attach`` (same chunk/usage/[DONE]
                         shapes as the real engine), so router splice e2e and
                         the scale-cycle chaos scenario run without accelerators.
                         ``GET /migratable`` lists live streams for the fleet
                         controller. GC005 endpoint parity holds: the real
                         engine serves the same four routes.
- ``--warm-prefetch-on-boot N``  scale-up warm-up modelling: at startup pull
                         the directory's top-N fleet-warm chunk hashes
                         (``dir_top_prefixes``) and count a warm prefix hit
                         for every later request whose prompt chain starts in
                         that set.
- ``--fabric``           peer-to-peer KV fabric emulation (docs/kv-fabric.md)
                         in the REAL wire shapes: an asyncio TCP listener
                         speaking the four fabric ops (``fabric_hello`` /
                         ``fabric_probe`` / ``fabric_pull`` / ``fabric_push``)
                         with versioned CRC-framed ``kvfabric.wire`` frames
                         of deterministic synthetic pages, advertised on
                         ``GET /kv_fabric`` like the real engine. With
                         ``--kv-directory-url`` each generation first looks
                         its prompt chain up in the directory and PULLS
                         missing pages from the resident owner's fabric
                         (generation-fenced), so cross-engine resident pulls
                         and their tier fallback are chaos-testable without an accelerator.
- ``--fabric-fail-rate P``  each fabric op replies with an error with
                         probability P (peers count fallbacks)
- ``--fabric-hang``      fabric ops stall forever (peer deadlines + breaker)
- ``POST /fabric_down``  chaos hook: close the fabric listener mid-load
                         (the fabric-outage scenario's victim switch) while
                         the HTTP plane keeps serving

Observability used by chaos assertions: ``fake:running_peak`` (bounded-queue
proof), ``fake:served_total`` (generation requests accepted by THIS process —
resets on restart, which is how a chaos run detects traffic returning to a
reborn backend), ``fake:completed_total`` (generations that ran to the end —
fleet-wide sum proves an idempotent replay executed exactly once),
``fake:abort_requests_total`` (router-initiated reclaims received),
``fake:migrations_out_total`` / ``fake:migrations_in_total`` (live streams
moved out of / resumed on this process), ``fake:warm_prefetch_chunks``
(fleet-warm chunks pulled at boot), ``fake:warm_prefix_hits_total``
(requests whose prompt chain hit the prefetched set), and the per-SLO-class
split ``fake:served_by_class_total`` / ``fake:shed_by_class_total``
(priority label, docs/failure-handling.md — the mixed-class-overload chaos
scenario asserts every shed landed on batch).

SIGTERM drains like the real engine (api_server graceful drain): /health
flips to 503, new generation requests are refused, in-flight streams finish.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import signal
import time
import uuid

from aiohttp import web

import collections

from production_stack_tpu_torch.tracing import (
    configure_flightrecorder,
    decode_step_time_hist,
    export_for_query,
    flightrecorder,
    get_collector,
    get_flightrecorder,
    prefill_time_hist,
    queue_time_hist,
    render_collector_metrics,
    render_flightrecorder_metrics,
    render_phase_histograms,
)

# the fake is a pure-asyncio process: every handler, fault timer, and
# publisher task mutates this on the loop (GC007 guards the convention)
STATE = {  # owned-by: event-loop
    "running": 0,
    "running_peak": 0,      # high-watermark of concurrent in-flight requests
    "total": 0,
    "sleeping": False,
    "draining": False,
    "served": 0,            # generation requests seen (drives --fail-first-n)
    "completed": 0,         # generations that ran to the end (replay dedupe)
    "aborts": 0,            # POST /abort calls received (router reclaims)
    "shed": 0,              # 429s emitted (saturate-after-n / shed-rate)
    # per-SLO-class accounting (docs/failure-handling.md priority classes):
    # chaos mixed-class-overload asserts every shed lands on batch until the
    # interactive reserve is exhausted, through these counters
    "served_by_class": {"interactive": 0, "batch": 0},
    "shed_by_class": {"interactive": 0, "batch": 0},
    # rolling interactive-class latency windows backing the fake's
    # vllm:interactive_{ttft,itl}_p99_ms gauges (same names as the real
    # engine so the fleet controller's latency_protect scrapes identically)
    "interactive_ttft_ms": collections.deque(maxlen=64),
    "interactive_itl_ms": collections.deque(maxlen=64),
    "inflight": {},         # req_id -> handler asyncio.Task (for /abort)
    # per-request SLO terminal records (same wire shape as the real engine's
    # GET /slo_records) so router-side SLO aggregation is testable without an accelerator
    "slo_seq": 0,
    "slo_records": collections.deque(maxlen=2048),
    # shed timestamps feeding the flight recorder's shed-burst anomaly dump
    "shed_times": collections.deque(maxlen=64),
    "compile_stalled": False,  # --compile-stall-ms fires once, on request 1
    # live migration (--migration; all event-loop-owned)
    "migrations_out": 0,    # streams frozen + shipped off this process
    "migrations_in": 0,     # snapshots accepted + parked here
    "migrating": {},        # req_id -> freeze/ship coordination entry
    "parked": {},           # req_id -> {"snap", "remaining", "t"}
    "streams": set(),       # req_ids currently streaming (migratable set)
    "progress": {},         # req_id -> output tokens emitted so far
    "meta": {},             # req_id -> presentation meta (snapshot source)
    # scale-up warm-up modelling (--warm-prefetch-on-boot)
    "prefetched": set(),    # dir_top_prefixes hashes pulled at boot
    "warm_prefix_hits": 0,  # requests whose prompt chain hit that set
    # KV fabric emulation (--fabric; docs/kv-fabric.md, all event-loop-owned)
    "fabric_pulled": 0,     # pages pulled from peer fakes over the fabric
    "fabric_served": 0,     # pages this fake's listener served to peers
    "fabric_received": 0,   # pages landed here via fabric_push
    "fabric_fallbacks": 0,  # fabric fetches that failed over to the tier path
    "fabric_resident": set(),  # key hexes "resident" on this fake
    "fabric_down": False,   # POST /fabric_down chaos hook fired
}


def _push_slo_record(model: str, req_id: str, outcome: str, *,
                     ttft_ms=None, itl_p99_ms=None, output_tokens=0,
                     queue_ms=0.0, e2e_ms=None, trace_id=None,
                     priority: str = "interactive") -> None:
    """Synthetic terminal record, same fields the real engine attributes
    (engine.LLMEngine._record_slo) so the router's scraper cannot tell the
    difference."""
    STATE["slo_seq"] += 1
    # mirrored into the flight recorder too, like the real engine's
    # _record_slo — anomaly dumps carry the requests that were in flight
    get_flightrecorder().record(
        "slo", step=STATE["slo_seq"], trace_id=trace_id,
        request_id=req_id, outcome=outcome, ttft_ms=ttft_ms,
        itl_p99_ms=itl_p99_ms, output_tokens=output_tokens,
    )
    STATE["slo_records"].append({
        "seq": STATE["slo_seq"],
        "request_id": req_id,
        "model": model,
        "outcome": outcome,
        "finish_reason": "length" if outcome == "ok" else outcome,
        "queue_ms": round(queue_ms, 3),
        "ttft_ms": None if ttft_ms is None else round(ttft_ms, 3),
        "e2e_ms": None if e2e_ms is None else round(e2e_ms, 3),
        "prompt_tokens": 10,
        "output_tokens": output_tokens,
        "cached_tokens": 0,
        "itl_p99_ms": None if itl_p99_ms is None else round(itl_p99_ms, 3),
        "kv_pages_peak": max(1, output_tokens // 16 + 1),
        "priority": priority,
        "trace_id": trace_id,
        "t": time.time(),
    })


class _FakeDirectoryPublisher:
    """Minimal asyncio publisher for --kv-directory-url: one persistent frame
    connection, register-then-publish, reconnect-on-error. Publishes the
    REAL chunk-hash chain (ByteTokenizer tokens, page 16) so the directory's
    token lookups — fed by the router's own ByteTokenizer — match exactly."""

    PAGE = 16

    def __init__(self, directory_url: str, engine_url: str):
        from production_stack_tpu_torch.kvoffload.protocol import parse_hostport

        self.host, self.port = parse_hostport(directory_url, default_port=8200)
        self.engine_url = engine_url
        # boot epoch in ms: strictly higher on every rebirth, so the
        # directory fences the previous incarnation's claims
        self.generation = int(time.time() * 1000)
        self._reader = self._writer = None
        self._lock = asyncio.Lock()
        self.published = 0

    async def _request(self, header: dict, payload: bytes = b"") -> dict:
        from production_stack_tpu_torch.kvoffload.protocol import (
            read_frame,
            write_frame,
        )

        async with self._lock:
            try:
                if self._writer is None:
                    self._reader, self._writer = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port), 5.0
                    )
                    await write_frame(self._writer, {
                        "op": "dir_register", "url": self.engine_url,
                        "page_size": self.PAGE,
                        "generation": self.generation,
                    })
                    await asyncio.wait_for(read_frame(self._reader), 5.0)
                await write_frame(self._writer, header, payload)
                hdr, _ = await asyncio.wait_for(read_frame(self._reader), 5.0)
                return hdr
            except Exception:
                if self._writer is not None:
                    try:
                        self._writer.close()
                    except Exception:
                        pass
                self._reader = self._writer = None
                raise

    async def register(self) -> None:
        try:
            await self._request({"op": "ping"})  # opens + registers
        except Exception as e:  # noqa: BLE001 - directory may not be up yet
            print(f"fake-engine: directory register failed: {e}", flush=True)

    async def publish_prompt(self, prompt: str) -> None:
        """Deterministic claim publish on stream completion: resident (HBM)
        claims plus SHARED claims backed by tiny sealed blobs put into the
        co-hosted cache server — the directory verifies shared claims
        against the actual blob map at lookup time (blob_check), so shared
        visibility (restorable ranking, dir_top_prefixes warm-up) is only
        testable when the blobs really exist."""
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
        from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
        from production_stack_tpu_torch.kvoffload.serde import seal_bytes

        tokens = ByteTokenizer().encode(prompt)
        hashes = prefix_hashes(tokens, self.PAGE)
        if not hashes:
            return
        entries = [[h.hex(), d, 1.0] for d, h in enumerate(hashes)]
        try:
            await self._request({
                "op": "dir_publish", "url": self.engine_url,
                "generation": self.generation, "tier": "hbm",
                "page_size": self.PAGE, "entries": entries,
            })
            for h, _d, _s in entries:
                await self._request(
                    {"op": "put", "key": h},
                    seal_bytes(b"fake-kv", kind="page"),
                )
            await self._request({
                "op": "dir_publish", "url": self.engine_url,
                "generation": self.generation, "tier": "shared",
                "page_size": self.PAGE, "entries": entries,
            })
            self.published += len(hashes)
        except Exception as e:  # noqa: BLE001 - the directory is a hint
            print(f"fake-engine: directory publish failed: {e}", flush=True)

    async def top_prefixes(self, limit: int) -> list:
        """Scale-up warm-up: the fleet's warmest chunk hashes, heads-first
        (the same ``dir_top_prefixes`` op a real engine's
        --warm-prefetch-on-boot pulls)."""
        hdr = await self._request({
            "op": "dir_top_prefixes", "limit": limit, "page_size": self.PAGE,
        })
        return hdr.get("hashes") or []


def _prompt_text(body: dict, chat: bool) -> str:
    """Same prompt extraction as the router's PrefixAwareRouter._prompt_of,
    so the fake's published hashes align with the router's lookups."""
    if "prompt" in body:
        p = body["prompt"]
        return p if isinstance(p, str) else (p[0] if p else "")
    return "".join(str(m.get("content", "")) for m in body.get("messages", []) or [])


def make_app(model: str, speed: float, ttft: float, model_label: str | None = None,
             faults: dict | None = None):
    faults = faults or {}
    fail_rate = float(faults.get("fail_rate", 0.0))
    fail_first_n = int(faults.get("fail_first_n", 0))
    fail_after_chunks = faults.get("fail_after_chunks")
    hang = bool(faults.get("hang", False))
    hang_after_chunks = faults.get("hang_after_chunks")
    saturate_after_n = faults.get("saturate_after_n")
    # advertised serving-mesh tp degree (--tensor-parallel): chaos scenarios
    # run fleets of mixed-shape fakes to prove router scraping, migration,
    # and warm-start round-trip the sharded-engine advert unchanged
    tensor_parallel = int(faults.get("tensor_parallel") or 1)
    shed_rate = float(faults.get("shed_rate", 0.0))
    retry_after = f"{float(faults.get('retry_after') or 1):g}"
    crash_after_n = faults.get("crash_after_n")
    restore_pages = int(faults.get("restart_restore_pages") or 0)
    # synthetic observability feed: --slo-itl-ms sets the ITL p99
    # the terminal records report (drives router-side SLO violation paths);
    # --compile-stall-ms injects one compile stall + flight-recorder compile
    # event; --flight-dump-dir arms anomaly dumps (SIGTERM / shed burst)
    slo_itl_ms = faults.get("slo_itl_ms")
    # class-aware admission (docs/failure-handling.md priority classes):
    # batch sheds --interactive-reserve slots EARLIER than interactive, so
    # the last slots under saturate-after-n stay reserved for interactive
    interactive_reserve = int(faults.get("interactive_reserve") or 0)
    # --interactive-slo-degrade-ms: inflate every interactive request's
    # reported TTFT/ITL by this much — models an engine failing its
    # interactive SLO, driving the controller's latency_protect policy and
    # the router's batch-avoidance filter without real latency injection
    interactive_slo_degrade_ms = float(
        faults.get("interactive_slo_degrade_ms") or 0.0
    )
    compile_stall_ms = float(faults.get("compile_stall_ms") or 0.0)
    flight_dump_dir = faults.get("flight_dump_dir")
    if flight_dump_dir:
        configure_flightrecorder(dump_dir=flight_dump_dir)
    start_time = time.time()
    # fleet-wide KV directory emulation: register + deterministic
    # publish on stream completion, so router-v2 e2e runs without an accelerator
    dirpub = None
    dir_tasks: set = set()
    if faults.get("kv_directory_url"):
        dirpub = _FakeDirectoryPublisher(
            faults["kv_directory_url"],
            faults.get("self_url") or "http://127.0.0.1:0",
        )

    def _publish_bg(prompt: str) -> None:
        # the loop holds only WEAK refs to tasks: without a strong ref a
        # publish parked on the publisher lock can be GC'd mid-flight and
        # the claims silently never land (flaky chaos assertions)
        t = asyncio.ensure_future(dirpub.publish_prompt(prompt))
        dir_tasks.add(t)
        t.add_done_callback(dir_tasks.discard)
        if fabric_srv[0] is not None:
            # the published chain is now "resident" on this fake — its
            # fabric listener will serve these keys to pulling peers
            from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
            from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

            STATE["fabric_resident"].update(
                h.hex()
                for h in prefix_hashes(ByteTokenizer().encode(prompt), 16)
            )

    # -- KV fabric emulation (--fabric; real wire shapes, docs/kv-fabric.md) --
    fabric_enabled = bool(faults.get("fabric", False))
    fabric_fail_rate = float(faults.get("fabric_fail_rate", 0.0))
    fabric_hang = bool(faults.get("fabric_hang", False))
    # boot-epoch generation fences stale pulls, same scheme as the directory
    # publisher (a reborn fake's listener rejects claims on the old epoch)
    fabric_generation = int(time.time() * 1000)
    fabric_srv: list = [None]   # asyncio.Server once started
    fabric_port: list = [0]
    # tiny but structurally real page geometry: frames carry actual
    # [layers, page, kv_heads, head_dim] arrays through encode/decode_frame
    FAB_NLAYERS, FAB_PAGE, FAB_KH, FAB_D = 2, 16, 1, 8

    def _fabric_page(key: str):
        """Deterministic synthetic (k, v) page from the key hex — identical
        bytes on every fake, so cross-engine pull assertions can compare."""
        import hashlib

        import numpy as np

        def arr(tag: str):
            seed = hashlib.blake2b(
                f"{tag}:{key}".encode(), digest_size=8
            ).digest()
            rng = np.random.default_rng(int.from_bytes(seed, "big"))
            return rng.standard_normal(
                (FAB_NLAYERS, FAB_PAGE, FAB_KH, FAB_D), dtype=np.float32
            )

        return arr("k"), arr("v")

    async def _fabric_handle(reader, writer):
        """One fabric peer connection: the same four-op dispatch as the real
        KVFabricServer (kvfabric/server.py), frames via kvoffload.protocol."""
        from production_stack_tpu_torch.kvfabric.wire import (
            FabricWireError,
            decode_frame,
            encode_frame,
        )
        from production_stack_tpu_torch.kvoffload.protocol import (
            read_frame,
            write_frame,
        )

        try:
            while True:
                try:
                    hdr, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                if fabric_hang:
                    # stalled fabric: peers must hit their deadline/breaker
                    await asyncio.Event().wait()
                if fabric_fail_rate and random.random() < fabric_fail_rate:
                    await write_frame(writer, {
                        "ok": False, "error": "injected fabric failure",
                    })
                    continue
                op = hdr.get("op")
                rhdr, rpayload = {"ok": False, "error": f"bad op {op!r}"}, b""
                if op == "fabric_hello":
                    rhdr = {
                        "ok": True, "generation": fabric_generation,
                        "quant": False, "page_size": FAB_PAGE,
                        "nlayers": FAB_NLAYERS,
                    }
                elif op == "fabric_probe":
                    rhdr, rpayload = {"ok": True, "echo": len(payload)}, payload
                elif op == "fabric_pull":
                    expect = hdr.get("expect_generation")
                    if expect is not None and int(expect) != fabric_generation:
                        rhdr = {"ok": False, "error": "stale_generation",
                                "generation": fabric_generation}
                    else:
                        keys = [
                            k for k in (hdr.get("keys") or [])
                            if k in STATE["fabric_resident"]
                        ]
                        if keys:
                            pages = [_fabric_page(k) for k in keys]
                            rpayload = encode_frame(
                                keys,
                                [p[0] for p in pages],
                                [p[1] for p in pages],
                            )
                            STATE["fabric_served"] += len(keys)
                        rhdr = {"ok": True, "found": keys}
                elif op == "fabric_push":
                    try:
                        frame = decode_frame(payload)
                        for k in frame["keys"]:
                            STATE["fabric_resident"].add(k)
                        STATE["fabric_received"] += len(frame["keys"])
                        rhdr = {"ok": True, "stored": len(frame["keys"])}
                    except FabricWireError:
                        rhdr = {"ok": False, "error": "integrity"}
                await write_frame(writer, rhdr, rpayload)
        except Exception:  # noqa: BLE001 - one bad peer must not kill the app
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _fabric_fetch(owner: str, gen, keys: list) -> int:
        """Pull ``keys`` from ``owner``'s fabric listener (async, on the
        fake's own loop — no BlockingClient off-thread here)."""
        from production_stack_tpu_torch.kvfabric.wire import decode_frame
        from production_stack_tpu_torch.kvoffload.protocol import (
            read_frame,
            write_frame,
        )

        sess = await _mig_client()
        async with sess.get(f"{owner}/kv_fabric") as r:
            if r.status != 200:
                return 0
            info = await r.json()
        if not info.get("enabled"):
            return 0
        host, _, port = str(info["addr"]).rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            hdr = {"op": "fabric_pull", "keys": list(keys)}
            if gen is not None:
                hdr["expect_generation"] = int(gen)
            await write_frame(writer, hdr)
            rhdr, payload = await read_frame(reader)
            if not rhdr.get("ok") or not rhdr.get("found"):
                return 0
            frame = decode_frame(payload)
            for k in frame["keys"]:
                STATE["fabric_resident"].add(k)
            return len(frame["keys"])
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _fabric_pull_for_prompt(prompt: str) -> None:
        """Cross-engine resident pull, the fake's twin of the engine's
        DirectoryPuller fabric path: look the prompt chain up in the
        directory and fetch missing pages from the owning peer's fabric
        (generation-fenced). Any failure counts a tier fallback — the blobs
        are in the shared cache server anyway."""
        if dirpub is None or fabric_srv[0] is None:
            return
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
        from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

        hashes = [
            h.hex()
            for h in prefix_hashes(ByteTokenizer().encode(prompt), FAB_PAGE)
        ]
        keys = [h for h in hashes if h not in STATE["fabric_resident"]]
        if not keys:
            return
        try:
            res = await dirpub._request(
                {"op": "dir_lookup_hashes", "hashes": keys}
            )
        except Exception:  # noqa: BLE001 - directory outage: nothing to pull
            return
        resident = res.get("resident") or {}
        gens = res.get("generations") or {}
        owners = [(u, n) for u, n in resident.items() if u != self_url]
        if not owners:
            return
        owner, depth = max(owners, key=lambda kv: kv[1])
        want = keys[:depth]
        try:
            got = await asyncio.wait_for(
                _fabric_fetch(owner, gens.get(owner), want), 5.0
            )
        except Exception:  # noqa: BLE001 - dead/hung peer fabric
            got = 0
        if got:
            STATE["fabric_pulled"] += got
        else:
            STATE["fabric_fallbacks"] += len(want)

    # -- live migration (--migration; real wire shapes, docs/migration.md) --
    migration_enabled = bool(faults.get("migration", True))
    warm_prefetch_n = int(faults.get("warm_prefetch_on_boot") or 0)
    self_url = faults.get("self_url") or "http://127.0.0.1:0"
    mig_session: list = [None]  # lazy shared aiohttp client for ships

    async def _mig_client():
        import aiohttp

        if mig_session[0] is None or mig_session[0].closed:
            mig_session[0] = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=15, sock_connect=5)
            )
        return mig_session[0]

    def _prompt_warm_hit(prompt: str) -> None:
        """--warm-prefetch-on-boot accounting: a prompt whose chain HEAD is
        in the prefetched set would have served a warm prefix hit."""
        if not STATE["prefetched"]:
            return
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
        from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer

        hashes = prefix_hashes(ByteTokenizer().encode(prompt), 16)
        if hashes and hashes[0].hex() in STATE["prefetched"]:
            STATE["warm_prefix_hits"] += 1

    async def _maybe_migrate_out(resp, req_id: str, total_out: int) -> bool:
        """Streaming-loop migration hook (chunk-boundary deterministic):
        when /migrate_out froze this stream, report progress, wait for the
        ship decision, and on commit end the leg with the REAL control
        event (no [DONE] — the router's splice takes over). Returns True
        when the stream ended here."""
        mig = STATE["migrating"].get(req_id)
        if mig is None or mig.get("frozen"):
            return False
        mig["sent"] = total_out
        mig["frozen"] = True
        mig["ready"].set()
        await mig["done"].wait()
        STATE["migrating"].pop(req_id, None)
        if not mig.get("commit"):
            return False  # rolled back: keep streaming locally
        await resp.write(
            f"data: {json.dumps({'pstpu_migration': {'target': mig['target'], 'request_id': req_id}})}\n\n".encode()
        )
        STATE["migrations_out"] += 1
        _push_slo_record(model, req_id, "migrated")
        return True

    async def migratable(request):
        """Fleet-controller victim listing, same shape as the real engine."""
        out = [
            {
                "request_id": rid,
                "output_tokens": int(STATE["progress"].get(rid, 0)),
                "prompt_tokens": 10,
                "age_s": 0.0,
                "priority": (STATE["meta"].get(rid) or {}).get(
                    "priority", "interactive"
                ),
                "migratable": migration_enabled
                and rid not in STATE["migrating"],
                "reason": None if migration_enabled else "migration disabled",
            }
            for rid in list(STATE["streams"])
        ]
        return web.json_response({"requests": out})

    async def migrate_out(request):
        """Freeze -> ship (sealed real-shape snapshot) -> commit/rollback,
        mirroring the real engine's /migrate_out semantics."""
        if not migration_enabled:
            return web.json_response(
                {"migrated": False, "error": "migration disabled"}, status=501
            )
        try:
            body = await request.json()
            rid = body["request_id"]
            target = str(body["target_url"]).rstrip("/")
        except (KeyError, TypeError, ValueError):
            return web.json_response(
                {"migrated": False,
                 "error": "request_id and target_url required"}, status=400,
            )
        if rid not in STATE["streams"] or rid not in STATE["inflight"]:
            return web.json_response(
                {"migrated": False, "error": f"{rid!r} is not a live stream"},
                status=409,
            )
        if rid in STATE["migrating"]:
            return web.json_response(
                {"migrated": False, "error": "migration already in progress"},
                status=409,
            )
        entry = {
            "ready": asyncio.Event(), "done": asyncio.Event(),
            "commit": False, "target": target, "sent": 0, "frozen": False,
        }
        STATE["migrating"][rid] = entry
        try:
            await asyncio.wait_for(entry["ready"].wait(), 5.0)
        except asyncio.TimeoutError:
            STATE["migrating"].pop(rid, None)
            entry["done"].set()
            return web.json_response(
                {"migrated": False,
                 "error": "stream never reached a migration point"},
                status=409,
            )
        from production_stack_tpu_torch.migration import (
            SequenceSnapshot,
            snapshot_to_wire,
        )

        meta = dict(STATE["meta"].get(rid) or {})
        max_tokens = int(meta.get("max_tokens", entry["sent"] + 1))
        snap = SequenceSnapshot(
            request_id=rid, model=model, page_size=16,
            # synthetic but structurally real: 10 prompt ids + one id per
            # emitted token (the receiving fake only needs the lengths)
            tokens=list(range(10)) + [72] * entry["sent"],
            prompt_len=10, output_len=entry["sent"],
            params={
                "max_tokens": max_tokens, "temperature": 0.0, "top_k": 0,
                "top_p": 1.0, "stop": [], "ignore_eos": True,
                "min_tokens": 0, "seed": None, "presence_penalty": 0.0,
                "frequency_penalty": 0.0, "repetition_penalty": 1.0,
            },
            page_hashes=[], meta=meta,
        )
        ok, detail = False, ""
        try:
            sess = await _mig_client()
            async with sess.post(
                f"{target}/migrate_in", data=snapshot_to_wire(snap),
                headers={"Content-Type": "application/octet-stream"},
            ) as r2:
                detail = (await r2.text())[:200]
                ok = r2.status == 200
        except Exception as e:  # noqa: BLE001 - ship failure rolls back
            detail = repr(e)
        entry["commit"] = ok
        entry["done"].set()
        if not ok:
            return web.json_response(
                {"migrated": False, "error": detail or "target refused"},
                status=502,
            )
        return web.json_response(
            {"migrated": True, "target": target, "pages_moved": 0}
        )

    async def migrate_in(request):
        """Accept a sealed snapshot (REAL parse + validation path) and park
        the synthetic continuation for /migrate_attach."""
        if not migration_enabled:
            return web.json_response(
                {"accepted": False, "error": "migration disabled"}, status=501
            )
        if STATE["draining"]:
            return web.json_response(
                {"accepted": False, "error": "draining"}, status=503
            )
        from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError
        from production_stack_tpu_torch.migration import (
            continuation_params,
            snapshot_from_wire,
        )

        data = await request.read()
        try:
            snap = snapshot_from_wire(data)
            params = continuation_params(snap)
        except (KVIntegrityError, ValueError, KeyError, TypeError) as e:
            return web.json_response(
                {"accepted": False, "error": f"bad snapshot: {e}"}, status=400
            )
        if snap.model != model:
            return web.json_response(
                {"accepted": False,
                 "error": f"model mismatch: {snap.model!r} != {model!r}"},
                status=409,
            )
        rid = snap.request_id
        if rid in STATE["parked"] or rid in STATE["streams"]:
            return web.json_response(
                {"accepted": False, "error": f"{rid!r} already live here"},
                status=409,
            )
        STATE["parked"][rid] = {
            "snap": snap, "remaining": params.max_tokens,
            "t": time.monotonic(),
        }
        STATE["migrations_in"] += 1

        def _expire():
            if STATE["parked"].pop(rid, None) is not None:
                print(f"fake-engine: parked {rid} expired unattached",
                      flush=True)

        asyncio.get_running_loop().call_later(30.0, _expire)
        return web.json_response({
            "accepted": True, "request_id": rid,
            "restorable_pages": len(snap.page_hashes),
        })

    async def migrate_attach(request):
        """Stream a parked continuation in the real chunk/usage/[DONE] wire
        shapes; supports chained migration (the continuation can itself be
        migrated out again mid-attach)."""
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001
            body = {}
        rid = body.get("request_id") or request.query.get("request_id")
        deadline = time.monotonic() + 10.0
        parked = STATE["parked"].pop(rid, None)
        while parked is None and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
            parked = STATE["parked"].pop(rid, None)
        if parked is None:
            return web.json_response(
                {"error": {"message": f"no parked continuation for {rid!r}"}},
                status=404,
            )
        snap = parked["snap"]
        meta = snap.meta
        chat = bool(meta.get("chat"))
        oid = meta.get("oid") or (("chatcmpl-" if chat else "cmpl-") + rid)
        created = int(meta.get("created") or time.time())
        kind = "chat.completion" if chat else "text_completion"
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "X-Request-Id": rid}
        )
        await resp.prepare(request)
        # the continuation is a live, re-migratable stream on THIS process
        STATE["running"] += 1
        STATE["running_peak"] = max(STATE["running_peak"], STATE["running"])
        STATE["inflight"][rid] = asyncio.current_task()
        STATE["streams"].add(rid)
        STATE["meta"][rid] = {
            **meta, "max_tokens": int(snap.params.get("max_tokens", 1)),
        }
        emitted = 0
        try:
            for _j in range(parked["remaining"]):
                if await _maybe_migrate_out(
                    resp, rid, snap.output_len + emitted
                ):
                    await resp.write_eof()
                    return resp
                STATE["progress"][rid] = snap.output_len + emitted
                delta = {"content": "Hello "} if chat else None
                choice = (
                    {"index": 0, "delta": delta, "finish_reason": None}
                    if chat
                    else {"index": 0, "text": "Hello ", "finish_reason": None}
                )
                await resp.write(
                    f"data: {json.dumps({'id': oid, 'object': 'chat.completion.chunk' if chat else 'text_completion', 'created': created, 'model': model, 'choices': [choice]})}\n\n".encode()
                )
                emitted += 1
                await asyncio.sleep(1.0 / speed)
            prompt_tokens = int(meta.get("prompt_tokens") or snap.prompt_len)
            completion = snap.output_len + emitted
            await resp.write(
                f"data: {json.dumps({'id': oid, 'object': f'{kind}.chunk' if chat else kind, 'created': created, 'model': model, 'choices': [], 'usage': {'prompt_tokens': prompt_tokens, 'completion_tokens': completion, 'total_tokens': prompt_tokens + completion}})}\n\n".encode()
            )
            await resp.write(b"data: [DONE]\n\n")
            STATE["completed"] += 1
            _push_slo_record(
                model, rid, "ok", output_tokens=completion,
                priority=meta.get("priority", "interactive"),
            )
            await resp.write_eof()
            return resp
        except asyncio.CancelledError:
            _push_slo_record(model, rid, "abort",
                             priority=meta.get("priority", "interactive"))
            raise
        finally:
            STATE["running"] -= 1
            STATE["inflight"].pop(rid, None)
            STATE["streams"].discard(rid)
            STATE["progress"].pop(rid, None)
            STATE["meta"].pop(rid, None)
            STATE["migrating"].pop(rid, None)

    def _hard_crash():
        """kill -9 semantics: no drain, no flushed buffers, no cleanup —
        exactly what a warm-start manifest's periodic spill must survive."""
        import os
        import sys

        print("fake-engine: injected hard crash (--crash-after-n)", flush=True)
        sys.stdout.flush()
        os._exit(9)

    def shed_response(reason: str, req_id: str = "",
                      priority: str = "interactive"):
        STATE["shed"] += 1
        STATE["shed_by_class"][
            priority if priority in STATE["shed_by_class"] else "interactive"
        ] += 1
        # flight-recorder shed event + burst-triggered anomaly dump, same
        # trigger shape as the real engine (_note_shed): the overload chaos
        # scenario asserts a parseable dump lands during the shed storm
        fr = get_flightrecorder()
        now = time.monotonic()
        STATE["shed_times"].append(now)
        fr.record(
            "shed", step=STATE["served"], reason=reason, seq_id=req_id,
            running=STATE["running"],
        )
        if sum(1 for t in list(STATE["shed_times"]) if now - t <= 5.0) >= 5:
            fr.dump_async("shed_burst")  # keep the event loop serving
        _push_slo_record(model, req_id or "unknown", "shed",
                         priority=priority)
        return web.json_response(
            {"error": {"message": f"saturated (injected: {reason})",
                       "type": "overloaded_error", "code": 429}},
            status=429,
            headers={"Retry-After": retry_after},
        )

    async def health(request):
        if STATE["draining"]:
            return web.Response(status=503, text="draining")
        return web.Response(text="")

    async def models(request):
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": model,
                        "object": "model",
                        "created": int(time.time()),
                        "owned_by": "fake-engine",
                    }
                ],
            }
        )

    def _p99(window) -> float:
        snap = sorted(window)
        if not snap:
            return 0.0
        return round(snap[min(len(snap) - 1, int(len(snap) * 0.99))], 3)

    async def metrics(request):
        saturated = int(
            saturate_after_n is not None
            and STATE["running"] >= int(saturate_after_n)
        )
        saturated_batch = int(
            saturate_after_n is not None
            and STATE["running"]
            >= max(0, int(saturate_after_n) - interactive_reserve)
        )
        text = (
            f'vllm:num_requests_running{{model_name="{model}"}} {STATE["running"]}\n'
            f'vllm:num_requests_waiting{{model_name="{model}"}} 0\n'
            f'vllm:gpu_cache_usage_perc{{model_name="{model}"}} 0.42\n'
            f'vllm:gpu_prefix_cache_hits_total{{model_name="{model}"}} 10\n'
            f'vllm:gpu_prefix_cache_queries_total{{model_name="{model}"}} 20\n'
            f'vllm:engine_saturated{{model_name="{model}"}} {saturated}\n'
            # class-aware saturation + interactive latency surface, same
            # names as the real engine: the fleet controller's
            # latency_protect and the router's class routing scrape these
            f'vllm:engine_saturated_batch{{model_name="{model}"}} {saturated_batch}\n'
            f'vllm:interactive_ttft_p99_ms{{model_name="{model}"}} {_p99(STATE["interactive_ttft_ms"])}\n'
            f'vllm:interactive_itl_p99_ms{{model_name="{model}"}} {_p99(STATE["interactive_itl_ms"])}\n'
            # serving-mesh advert (--tensor-parallel): the router's scraper
            # and the fleet controller read capacity shape through this
            f'vllm:tensor_parallel_degree{{model_name="{model}"}} {tensor_parallel}\n'
            f'vllm:num_requests_shed_total{{model_name="{model}"}} {STATE["shed"]}\n'
            # fake-only observability: bounded-queue proof for overload tests,
            # per-process served/completed/abort counters for restart + replay
            # chaos assertions (served resets with the process, so a reborn
            # backend's counter climbing from 0 proves traffic returned)
            f'fake:running_peak{{model_name="{model}"}} {STATE["running_peak"]}\n'
            f'fake:served_total{{model_name="{model}"}} {STATE["served"]}\n'
            f'fake:completed_total{{model_name="{model}"}} {STATE["completed"]}\n'
            f'fake:abort_requests_total{{model_name="{model}"}} {STATE["aborts"]}\n'
            # per-class served/shed split: mixed-class-overload asserts the
            # shed distribution (batch absorbs everything until the
            # interactive reserve is exhausted) through these
            f'fake:served_by_class_total{{model_name="{model}",priority="interactive"}} {STATE["served_by_class"]["interactive"]}\n'
            f'fake:served_by_class_total{{model_name="{model}",priority="batch"}} {STATE["served_by_class"]["batch"]}\n'
            f'fake:shed_by_class_total{{model_name="{model}",priority="interactive"}} {STATE["shed_by_class"]["interactive"]}\n'
            f'fake:shed_by_class_total{{model_name="{model}",priority="batch"}} {STATE["shed_by_class"]["batch"]}\n'
            # live-migration + scale-up warm-up surface (chaos scale-cycle
            # assertions; real engines export vllm:migrations_*_total)
            f'fake:migrations_out_total{{model_name="{model}"}} {STATE["migrations_out"]}\n'
            f'fake:migrations_in_total{{model_name="{model}"}} {STATE["migrations_in"]}\n'
            f'fake:warm_prefetch_chunks{{model_name="{model}"}} {len(STATE["prefetched"])}\n'
            f'fake:warm_prefix_hits_total{{model_name="{model}"}} {STATE["warm_prefix_hits"]}\n'
        )
        if fabric_enabled:
            # KV fabric surface, same vllm: names as the real engine so the
            # router scraper, fleet controller, and chaos assertions read
            # the fake identically (docs/kv-fabric.md)
            fabric_up = fabric_srv[0] is not None and not STATE["fabric_down"]
            text += (
                f'vllm:kv_fabric_pushed_pages_total{{model_name="{model}"}} 0\n'
                f'vllm:kv_fabric_pulled_pages_total{{model_name="{model}"}} {STATE["fabric_pulled"]}\n'
                f'vllm:kv_fabric_served_pages_total{{model_name="{model}"}} {STATE["fabric_served"]}\n'
                f'vllm:kv_fabric_received_pages_total{{model_name="{model}"}} {STATE["fabric_received"]}\n'
                f'vllm:kv_fabric_fallbacks_total{{model_name="{model}"}} {STATE["fabric_fallbacks"]}\n'
                f'vllm:kv_fabric_queue_depth{{model_name="{model}"}} 0\n'
                # synthetic probed-bandwidth gauge: up = a fast deterministic
                # link, down = 0 — drives the router's transfer-cost pick
                f'vllm:kv_fabric_peer_bandwidth_bytes_per_sec{{model_name="{model}",peer="self"}} '
                f"{1000000000 if fabric_up else 0}\n"
            )
        if restore_pages:
            # warm-restart modelling (--restart-restore-pages): the same
            # surface a real --warm-start engine exports after restore
            text += (
                f'vllm:warm_start_restored_pages{{model_name="{model}"}} '
                f"{restore_pages}\n"
                f'vllm:warm_start_manifest_age_seconds{{model_name="{model}"}} '
                f"{time.time() - start_time:.3f}\n"
                f'vllm:kv_corrupt_pages_total{{model_name="{model}"}} 0\n'
            )
        # per-phase histograms, same names as the real engine's /metrics so
        # smoke tests and dashboard queries exercise the fake identically
        text += "\n".join(render_phase_histograms(f'model_name="{model}"')) + "\n"
        # span-loss + flight-recorder health, same surface as the real engine
        text += "\n".join(render_collector_metrics(f'model_name="{model}"')) + "\n"
        text += "\n".join(
            render_flightrecorder_metrics(f'model_name="{model}"')
        ) + "\n"
        return web.Response(text=text, content_type="text/plain")

    async def traces(request):
        payload, status = export_for_query(request.query)
        return web.json_response(payload, status=status)

    async def slo_records(request):
        """Same wire contract as the real engine's GET /slo_records."""
        try:
            since = int(request.query.get("since", "0"))
        except (TypeError, ValueError):
            return web.json_response({"error": "since must be an int"}, status=400)
        snap = list(STATE["slo_records"])
        head = snap[-1]["seq"] if snap else 0
        records = [r for r in snap if r["seq"] > since]
        return web.json_response({
            "model": model,
            "since": since,
            "next": max((r["seq"] for r in records), default=since),
            "head": head,
            "records": records,
        })

    async def flightrecorder_export(request):
        payload, status = flightrecorder.export_for_query(request.query)
        return web.json_response(payload, status=status)

    async def completions(request):
        return await _generate(request, chat=False)

    async def chat(request):
        return await _generate(request, chat=True)

    async def _generate(request, chat: bool):
        if STATE["sleeping"]:
            return web.json_response({"error": "sleeping"}, status=503)
        if STATE["draining"]:
            return web.json_response(
                {"error": {"message": "engine is draining for shutdown"}},
                status=503,
            )
        body = await request.json()
        max_tokens = int(body.get("max_tokens", 16))
        stream = bool(body.get("stream", False))
        prompt_text = _prompt_text(body, chat)
        req_id = request.headers.get("X-Request-Id", uuid.uuid4().hex)
        # SLO class, same resolution order as the real engine's api_server:
        # X-Priority header wins, then a body field, unknown -> interactive
        priority = str(
            request.headers.get("X-Priority")
            or body.get("priority") or "interactive"
        ).strip().lower()
        if priority not in ("interactive", "batch"):
            priority = "interactive"
        uid = request.headers.get("x-user-id")
        if uid:
            # visible marker for tests asserting user-id header propagation
            print(f"x-user-id={uid}", flush=True)
        # fault injection: 500s fire BEFORE a slot is held (connect-stage
        # failure from the router's point of view)
        STATE["served"] += 1
        STATE["served_by_class"][priority] += 1
        # hard crash: request N+1 and later never answer — the process dies
        # abruptly (mid-stream when streaming, pre-response otherwise)
        crashing = (
            crash_after_n is not None and STATE["served"] > int(crash_after_n)
        )
        if crashing and not stream:
            _hard_crash()
        if fail_first_n and STATE["served"] <= fail_first_n:
            return web.json_response(
                {"error": {"message": "injected failure (fail-first-n)"}}, status=500
            )
        if fail_rate and random.random() < fail_rate:
            return web.json_response(
                {"error": {"message": "injected failure (fail-rate)"}}, status=500
            )
        # admission control simulation: shed BEFORE taking a slot, so the
        # in-flight count is provably bounded by saturate_after_n (the
        # overload chaos scenario asserts on running_peak). Class-aware:
        # batch hits its bound --interactive-reserve slots early, so the
        # reserved tail of capacity only ever admits interactive work
        if saturate_after_n is not None:
            bound = int(saturate_after_n)
            if priority == "batch":
                bound = max(0, bound - interactive_reserve)
            if STATE["running"] >= bound:
                return shed_response("saturate-after-n", req_id, priority)
        if shed_rate and random.random() < shed_rate:
            return shed_response("shed-rate", req_id, priority)
        # distributed tracing, same span model as the real engine
        # (engine.request > queue/prefill/decode) so router e2e tests can
        # assert full-stack trace propagation without an accelerator
        collector = get_collector()
        trace_ctx = collector.root_from_headers(request.headers).child()
        t_accept = time.time()
        STATE["running"] += 1
        STATE["running_peak"] = max(STATE["running_peak"], STATE["running"])
        STATE["total"] += 1
        # synthetic flight-recorder feed, same event shapes as the real
        # engine loop (sched + kv per dispatch, cross-linked by trace id) so
        # anomaly-dump consumers are testable without an accelerator
        fr = get_flightrecorder()
        fr_trace = trace_ctx.trace_id if trace_ctx.sampled else None
        fr.record(
            "sched", step=STATE["served"], batch_kind="decode",
            rows=STATE["running"], bursts=1, chunk_tokens=0,
            seq_ids=[req_id], trace_ids=[fr_trace] if fr_trace else [],
            gate={"backlog_tokens": 0, "decode_demand": STATE["running"],
                  "alternate": False, "waiting": 0},
            running=STATE["running"], waiting=0,
            trace_id=fr_trace,
        )
        fr.record(
            "kv", step=STATE["served"], op="alloc",
            pages=max(1, max_tokens // 16), trace_id=fr_trace,
        )
        # registered while holding a slot so POST /abort can cancel this
        # handler and free the slot, like the real engine's abort endpoint
        STATE["inflight"][req_id] = asyncio.current_task()
        created = int(time.time())
        oid = ("chatcmpl-" if chat else "cmpl-") + req_id
        # presentation meta a migration snapshot carries (real-shape parity)
        STATE["meta"][req_id] = {
            "oid": oid, "chat": chat, "created": created, "model": model,
            "prompt_tokens": 10, "max_tokens": max_tokens,
            # rides the migration snapshot so the target resumes the stream
            # in the same SLO class (real api_server parity)
            "priority": priority,
        }
        _prompt_warm_hit(prompt_text)
        if fabric_srv[0] is not None and dirpub is not None:
            # fabric-first KV acquisition before "prefill" (the real
            # engine's DirectoryPuller fabric path): pull the prompt chain
            # from the resident owner, count a fallback on any failure
            await _fabric_pull_for_prompt(prompt_text)

        def _phase(name, start, dur, **attrs):
            collector.record(
                name, trace_ctx.child(), start, dur,
                seq_id=req_id, **attrs,
            )

        def _decode_done(t_first):
            t_done = time.time()
            _phase("engine.decode", t_first, t_done - t_first,
                   output_tokens=max_tokens, finish_reason="length")
            if max_tokens > 1:
                decode_step_time_hist.observe(
                    (t_done - t_first) / (max_tokens - 1)
                )
            # terminal SLO record: measured TTFT; ITL p99 is --slo-itl-ms
            # when injected (drives router-side violation counters), else
            # the stream's real pacing
            measured_itl = (
                (t_done - t_first) * 1000 / max(1, max_tokens - 1)
                if max_tokens > 1 else None
            )
            rec_ttft = (t_first - t_accept) * 1000
            rec_itl = (
                float(slo_itl_ms) if slo_itl_ms is not None else measured_itl
            )
            if priority == "interactive" and interactive_slo_degrade_ms > 0:
                # injected SLO degradation: the REPORTED interactive
                # latencies inflate (records + p99 gauges) without slowing
                # the stream — chaos drives latency_protect off this
                rec_ttft += interactive_slo_degrade_ms
                rec_itl = (rec_itl or 0.0) + interactive_slo_degrade_ms
            if priority == "interactive":
                STATE["interactive_ttft_ms"].append(rec_ttft)
                if rec_itl is not None:
                    STATE["interactive_itl_ms"].append(rec_itl)
            _push_slo_record(
                model, req_id, "ok",
                ttft_ms=rec_ttft,
                itl_p99_ms=rec_itl,
                output_tokens=max_tokens,
                queue_ms=0.0,
                e2e_ms=(t_done - t_accept) * 1000,
                trace_id=fr_trace,
                priority=priority,
            )

        try:
            if hang:
                # hung engine: the slot stays pinned until /abort (or process
                # death) — exactly the failure the router's TTFT deadline +
                # engine abort must reclaim
                await asyncio.Event().wait()
            t_q = time.time()
            _phase("engine.queue", t_accept, t_q - t_accept)
            queue_time_hist.observe(t_q - t_accept)
            if compile_stall_ms > 0 and not STATE["compile_stalled"]:
                # one injected compile stall on the first generation: the
                # first request of a real engine pays tracing + XLA compile,
                # and the recorder's compile event is how a postmortem tells
                # a compile stall from a scheduling stall
                STATE["compile_stalled"] = True
                fr.record(
                    "compile", step=STATE["served"],
                    event="backend_compile",
                    seconds=round(compile_stall_ms / 1000.0, 4),
                    trace_id=fr_trace,
                )
                await asyncio.sleep(compile_stall_ms / 1000.0)
            await asyncio.sleep(ttft)  # injected prefill time
            t_first = time.time()
            _phase("engine.prefill", t_q, t_first - t_q, prompt_tokens=10)
            prefill_time_hist.observe(t_first - t_q)
            if not stream:
                await asyncio.sleep(max_tokens / speed)
                _decode_done(t_first)
                STATE["completed"] += 1
                if dirpub is not None:
                    # deterministic publish on completion: this
                    # prompt's chunk chain is now "resident" on this fake
                    _publish_bg(prompt_text)
                text = "Hello " * max_tokens
                choice = (
                    {"index": 0, "message": {"role": "assistant", "content": text},
                     "finish_reason": "length"}
                    if chat
                    else {"index": 0, "text": text, "finish_reason": "length"}
                )
                return web.json_response(
                    {
                        "id": oid, "object": "chat.completion" if chat else "text_completion",
                        "created": created, "model": model, "choices": [choice],
                        "usage": {
                            "prompt_tokens": 10, "completion_tokens": max_tokens,
                            "total_tokens": 10 + max_tokens,
                        },
                    },
                    # X-Priority echo: e2e tests assert the class the engine
                    # actually resolved, not just what the client sent
                    headers={"X-Request-Id": req_id, "X-Priority": priority},
                )
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream",
                         "X-Request-Id": req_id, "X-Priority": priority}
            )
            await resp.prepare(request)
            STATE["streams"].add(req_id)  # migratable from the first chunk on
            for i in range(max_tokens):
                # live migration: a frozen stream hands off at this chunk
                # boundary (control event written, no [DONE]) or resumes
                if await _maybe_migrate_out(resp, req_id, i):
                    await resp.write_eof()
                    return resp
                STATE["progress"][req_id] = i
                # mid-stream hard crash: one chunk leaves first when the
                # stream has more than one, then the whole process vanishes
                # without a FIN or a drain; a single-token stream crashes on
                # its only chunk (the flag must fire for every request shape)
                if crashing and i >= min(1, max_tokens - 1):
                    _hard_crash()
                if fail_after_chunks is not None and i >= int(fail_after_chunks):
                    # mid-stream truncation: drop the TCP connection without
                    # a chunked terminator, so the proxy sees a payload error
                    request.transport.close()
                    return resp
                if hang_after_chunks is not None and i >= int(hang_after_chunks):
                    # mid-stream stall: chunks stop flowing but the
                    # connection stays up — only the router's inter-chunk
                    # deadline (or /abort) ends this
                    await asyncio.Event().wait()
                delta = {"content": "Hello "} if chat else None
                choice = (
                    {"index": 0, "delta": delta, "finish_reason": None}
                    if chat
                    else {"index": 0, "text": "Hello ", "finish_reason": None}
                )
                await resp.write(
                    f"data: {json.dumps({'id': oid, 'object': 'chat.completion.chunk' if chat else 'text_completion', 'created': created, 'model': model, 'choices': [choice]})}\n\n".encode()
                )
                await asyncio.sleep(1.0 / speed)
            _decode_done(t_first)
            STATE["completed"] += 1
            if dirpub is not None:
                _publish_bg(prompt_text)
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        except asyncio.CancelledError:
            # router-initiated abort (POST /abort) or client disconnect: the
            # real engine attributes these a terminal 'abort' record too
            _push_slo_record(model, req_id, "abort", trace_id=fr_trace,
                             priority=priority)
            raise
        finally:
            STATE["running"] -= 1
            STATE["inflight"].pop(req_id, None)
            STATE["streams"].discard(req_id)
            STATE["progress"].pop(req_id, None)
            STATE["meta"].pop(req_id, None)
            STATE["migrating"].pop(req_id, None)
            collector.record(
                "engine.request", trace_ctx, t_accept,
                time.time() - t_accept, request_id=req_id, model=model,
            )

    async def abort(request):
        """Router-initiated abort, same contract as the real engine's
        POST /abort: cancel the in-flight handler, freeing the slot."""
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001
            body = {}
        rid = body.get("request_id") or request.query.get("request_id")
        STATE["aborts"] += 1
        task = STATE["inflight"].pop(rid, None)
        if task is not None:
            task.cancel()
        return web.json_response({"request_id": rid, "aborted": task is not None})

    async def sleep(request):
        STATE["sleeping"] = True
        return web.Response(text="")

    async def wake_up(request):
        STATE["sleeping"] = False
        return web.Response(text="")

    async def is_sleeping(request):
        return web.json_response({"is_sleeping": STATE["sleeping"]})

    async def tokenize(request):
        body = await request.json()
        text = body.get("prompt", "")
        return web.json_response(
            {"tokens": list(text.encode()), "count": len(text.encode()), "max_model_len": 4096}
        )

    # -- real-engine route parity (graftcheck GC005): every engine route the
    # router proxies or probes must answer here too, or e2e runs against the
    # fake 404 where production would not. Deterministic dummy payloads in
    # the real wire shapes.

    async def detokenize(request):
        body = await request.json()
        toks = body.get("tokens", [])
        return web.json_response(
            {"prompt": bytes(t & 0xFF for t in toks).decode(errors="replace")}
        )

    def _fake_embedding(text: str, dim: int = 8) -> list[float]:
        """Deterministic unit vector from the text bytes — stable across
        processes so reranking/scoring assertions are reproducible."""
        import hashlib

        h = hashlib.blake2b(str(text).encode(), digest_size=dim).digest()
        v = [b / 255.0 + 1e-3 for b in h]
        n = sum(x * x for x in v) ** 0.5
        return [x / n for x in v]

    async def embeddings(request):
        body = await request.json()
        raw = body.get("input", [])
        items = [raw] if isinstance(raw, str) else list(raw)
        if not items:
            return web.json_response(
                {"error": {"message": "'input' is required"}}, status=400
            )
        return web.json_response({
            "object": "list",
            "model": body.get("model", model),
            "data": [
                {"object": "embedding", "index": i,
                 "embedding": _fake_embedding(t)}
                for i, t in enumerate(items)
            ],
            "usage": {"prompt_tokens": len(items), "total_tokens": len(items)},
        })

    def _cosine(a: list, b: list) -> float:
        return sum(x * y for x, y in zip(a, b))

    async def rerank(request):
        body = await request.json()
        try:
            query, documents = body["query"], list(body["documents"])
        except (KeyError, TypeError) as e:
            return web.json_response(
                {"error": {"message": f"invalid request: {e}"}}, status=400
            )
        qv = _fake_embedding(query)
        scores = [_cosine(qv, _fake_embedding(d)) for d in documents]
        top_n = int(body.get("top_n", len(documents)))
        order = sorted(range(len(documents)), key=lambda i: -scores[i])[:top_n]
        return web.json_response({
            "id": f"rerank-{uuid.uuid4().hex[:16]}",
            "model": body.get("model", model),
            "results": [
                {"index": i, "document": {"text": documents[i]},
                 "relevance_score": scores[i]}
                for i in order
            ],
        })

    async def score(request):
        body = await request.json()
        try:
            t1, t2 = body["text_1"], body["text_2"]
        except (KeyError, TypeError) as e:
            return web.json_response(
                {"error": {"message": f"invalid request: {e}"}}, status=400
            )
        left = [t1] if isinstance(t1, str) else list(t1)
        right = [t2] if isinstance(t2, str) else list(t2)
        if len(left) == 1:
            left = left * len(right)
        if len(left) != len(right):
            return web.json_response(
                {"error": {"message": "text_1 and text_2 lengths do not match"}},
                status=400,
            )
        return web.json_response({
            "id": f"score-{uuid.uuid4().hex[:16]}",
            "object": "list",
            "model": body.get("model", model),
            "data": [
                {"index": i, "object": "score",
                 "score": _cosine(_fake_embedding(a), _fake_embedding(b))}
                for i, (a, b) in enumerate(zip(left, right))
            ],
            "usage": {"prompt_tokens": len(left) + len(right)},
        })

    async def kv_fabric_info(request):
        """Same advert contract as the real engine's GET /kv_fabric:
        answers enabled:false when the fabric is off or downed."""
        if fabric_srv[0] is None or STATE["fabric_down"]:
            return web.json_response({"enabled": False})
        return web.json_response({
            "enabled": True,
            "addr": f"127.0.0.1:{fabric_port[0]}",
            "generation": fabric_generation,
            "quant": False,
            "page_size": FAB_PAGE,
        })

    async def fabric_down(request):
        """Chaos hook (fake-only): close the fabric listener mid-load while
        the HTTP plane keeps serving — peers' pulls must fall back to the
        tier path with zero client-visible errors."""
        STATE["fabric_down"] = True
        if fabric_srv[0] is not None:
            fabric_srv[0].close()
        print("fake-engine: fabric listener downed (/fabric_down)", flush=True)
        return web.json_response({"fabric": "down"})

    async def version(request):
        return web.json_response({"version": "fake-engine"})

    async def metrics_reset(request):
        """Same debug contract as the real engine's POST /metrics/reset:
        clear the per-phase sample windows so a bench phase's quantiles
        describe that phase (counters stay)."""
        from production_stack_tpu_torch.tracing import reset_phase_histograms

        reset_phase_histograms()
        get_collector().reset()
        get_flightrecorder().reset()
        return web.json_response({"status": "ok"})

    # same client_max_size as the real engine: /migrate_in snapshots for
    # long-context streams exceed aiohttp's 1 MiB default
    app = web.Application(client_max_size=64 << 20)
    if dirpub is not None:
        async def _dir_register(app):
            await dirpub.register()  # eager, so a reborn fake re-fences fast
            if warm_prefetch_n > 0:
                # scale-up warm-up modelling: pull the fleet's top warm
                # chunks at boot (the real engine does this BEFORE /ready)
                try:
                    hashes = await dirpub.top_prefixes(warm_prefetch_n)
                    STATE["prefetched"] = set(hashes)
                    print(
                        f"fake-engine: warm-prefetched {len(hashes)} "
                        "fleet-warm chunks", flush=True,
                    )
                except Exception as e:  # noqa: BLE001 - cold boot, not fatal
                    print(f"fake-engine: warm prefetch failed: {e}", flush=True)

        app.on_startup.append(_dir_register)

    if fabric_enabled:
        async def _fabric_start(app):
            fabric_srv[0] = await asyncio.start_server(
                _fabric_handle, "127.0.0.1", 0
            )
            fabric_port[0] = fabric_srv[0].sockets[0].getsockname()[1]
            print(
                f"fake-engine: kv fabric listening on "
                f"127.0.0.1:{fabric_port[0]}", flush=True,
            )

        async def _fabric_stop(app):
            if fabric_srv[0] is not None:
                fabric_srv[0].close()

        app.on_startup.append(_fabric_start)
        app.on_cleanup.append(_fabric_stop)

    async def _close_mig_session(app):
        if mig_session[0] is not None and not mig_session[0].closed:
            await mig_session[0].close()

    app.on_cleanup.append(_close_mig_session)
    app.router.add_get("/health", health)
    app.router.add_get("/v1/models", models)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/v1/traces", traces)
    app.router.add_get("/slo_records", slo_records)
    app.router.add_get("/v1/debug/flightrecorder", flightrecorder_export)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/chat/completions", chat)
    app.router.add_post("/abort", abort)
    app.router.add_get("/kv_fabric", kv_fabric_info)
    app.router.add_post("/fabric_down", fabric_down)
    app.router.add_get("/migratable", migratable)
    app.router.add_post("/migrate_out", migrate_out)
    app.router.add_post("/migrate_in", migrate_in)
    app.router.add_post("/migrate_attach", migrate_attach)
    app.router.add_post("/sleep", sleep)
    app.router.add_post("/wake_up", wake_up)
    app.router.add_get("/is_sleeping", is_sleeping)
    app.router.add_post("/tokenize", tokenize)
    app.router.add_post("/detokenize", detokenize)
    app.router.add_post("/v1/embeddings", embeddings)
    app.router.add_post("/v1/rerank", rerank)
    app.router.add_post("/v2/rerank", rerank)
    app.router.add_post("/v1/score", score)
    app.router.add_get("/version", version)
    app.router.add_post("/metrics/reset", metrics_reset)
    return app


async def _serve_until_sigterm(app, port: int) -> None:
    """Run the app; on SIGTERM/SIGINT drain like the real engine: /health
    flips 503 (readiness pulls the pod), in-flight requests get a bounded
    window to finish, then the server exits cleanly."""
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, port=port, shutdown_timeout=1.0)
    await site.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    STATE["draining"] = True
    # SIGTERM anomaly dump, same trigger as the real engine's drain path
    # (rolling-restart chaos parses these for the pre-restart window)
    get_flightrecorder().dump("sigterm_drain", force=True)
    deadline = time.time() + 5.0
    while STATE["running"] > 0 and time.time() < deadline:
        await asyncio.sleep(0.1)
    await runner.cleanup()


def main():
    p = argparse.ArgumentParser("fake-engine")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--model", default="fake/model")
    p.add_argument("--speed", type=float, default=100.0, help="tokens per second")
    p.add_argument("--ttft", type=float, default=0.0, help="injected TTFT seconds")
    p.add_argument("--model-label", default=None)
    # fault injection (router failure-domain tests)
    p.add_argument("--fail-rate", type=float, default=0.0,
                   help="probability a generation request 500s")
    p.add_argument("--fail-first-n", type=int, default=0,
                   help="first N generation requests 500, then recover")
    p.add_argument("--fail-after-chunks", type=int, default=None,
                   help="drop the connection after N streamed chunks")
    p.add_argument("--hang", action="store_true",
                   help="accept generation requests but never respond")
    p.add_argument("--hang-after-chunks", type=int, default=None,
                   help="stall the stream after N chunks (connection stays up)")
    p.add_argument("--saturate-after-n", type=int, default=None,
                   help="shed (429 + Retry-After) generation requests "
                        "arriving while N are already in flight")
    p.add_argument("--shed-rate", type=float, default=0.0,
                   help="probability a generation request is shed with "
                        "429 + Retry-After")
    p.add_argument("--retry-after", type=float, default=1.0,
                   help="Retry-After seconds advertised on shed responses")
    p.add_argument("--crash-after-n", type=int, default=None,
                   help="hard-crash the process (os._exit, no drain) once N "
                        "generation requests have been accepted — mid-stream "
                        "when streaming")
    p.add_argument("--restart-restore-pages", type=int, default=None,
                   help="model a warm restart: advertise "
                        "vllm:warm_start_restored_pages N on /metrics")
    p.add_argument("--interactive-reserve", type=int, default=0,
                   help="slots under --saturate-after-n reserved for "
                        "interactive requests: batch sheds this many slots "
                        "early (class-aware admission, docs/failure-"
                        "handling.md)")
    p.add_argument("--interactive-slo-degrade-ms", type=float, default=0.0,
                   help="inflate every interactive request's REPORTED "
                        "TTFT/ITL by this many ms (SLO records + "
                        "vllm:interactive_*_p99_ms gauges) — models an "
                        "engine failing its interactive SLO for "
                        "latency_protect / class-routing tests")
    p.add_argument("--slo-itl-ms", type=float, default=None,
                   help="inter-token p99 the synthetic SLO terminal records "
                        "report (default: the stream's real pacing) — set "
                        "above the router's --slo-itl-ms to drive its "
                        "violation counters")
    p.add_argument("--compile-stall-ms", type=float, default=0.0,
                   help="stall the FIRST generation this many ms and record "
                        "a flight-recorder compile event (models a cold "
                        "XLA compile)")
    p.add_argument("--flight-dump-dir", type=str, default=None,
                   help="arm flight-recorder anomaly dumps (SIGTERM drain, "
                        "shed bursts) into this directory")
    p.add_argument("--kv-directory-url", type=str, default=None,
                   help="fleet-wide KV directory (cache server) to register "
                        "with and publish deterministic per-prompt chunk "
                        "hashes to on stream completion (router-v2 e2e "
                        "without accelerators)")
    p.add_argument("--migration", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve the live-sequence-migration endpoints "
                        "(/migrate_out /migrate_in /migrate_attach "
                        "/migratable) in the real wire shapes "
                        "(docs/migration.md); --no-migration disables")
    p.add_argument("--warm-prefetch-on-boot", type=int, default=0,
                   help="pull this many top fleet-warm chunk hashes "
                        "(dir_top_prefixes) at startup and count warm "
                        "prefix hits against them; needs --kv-directory-url")
    p.add_argument("--fabric", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="run the peer-to-peer KV fabric emulation "
                        "(docs/kv-fabric.md): a real-wire-shape fabric "
                        "listener, GET /kv_fabric advert, and directory-"
                        "driven cross-engine pulls when --kv-directory-url "
                        "is set")
    p.add_argument("--fabric-fail-rate", type=float, default=0.0,
                   help="probability each fabric op replies with an error "
                        "(peers count fallbacks)")
    p.add_argument("--fabric-hang", action="store_true",
                   help="fabric ops stall forever (peer deadline/breaker "
                        "testing)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="advertised serving-mesh tp degree "
                        "(vllm:tensor_parallel_degree on /metrics), so "
                        "router scraping and fleet-capacity math can be "
                        "tested against sharded-engine fleets without accelerators")
    args = p.parse_args()
    app = make_app(
        args.model, args.speed, args.ttft, args.model_label,
        faults={
            "fail_rate": args.fail_rate,
            "fail_first_n": args.fail_first_n,
            "fail_after_chunks": args.fail_after_chunks,
            "hang": args.hang,
            "hang_after_chunks": args.hang_after_chunks,
            "saturate_after_n": args.saturate_after_n,
            "shed_rate": args.shed_rate,
            "retry_after": args.retry_after,
            "crash_after_n": args.crash_after_n,
            "restart_restore_pages": args.restart_restore_pages,
            "slo_itl_ms": args.slo_itl_ms,
            "interactive_reserve": args.interactive_reserve,
            "interactive_slo_degrade_ms": args.interactive_slo_degrade_ms,
            "compile_stall_ms": args.compile_stall_ms,
            "flight_dump_dir": args.flight_dump_dir,
            "kv_directory_url": args.kv_directory_url,
            "migration": args.migration,
            "warm_prefetch_on_boot": args.warm_prefetch_on_boot,
            "fabric": args.fabric,
            "fabric_fail_rate": args.fabric_fail_rate,
            "fabric_hang": args.fabric_hang,
            "tensor_parallel": args.tensor_parallel,
            "self_url": f"http://127.0.0.1:{args.port}",
        },
    )
    asyncio.run(_serve_until_sigterm(app, args.port))


if __name__ == "__main__":
    main()
