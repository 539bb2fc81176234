#!/usr/bin/env python3
"""Chaos smoke for the router's failure-domain layer (docs/failure-handling.md),
over the port's processes.

The port's copy of ``scripts/chaos_check.py``: the same seven scenarios,
assertions, budgets and flags, over the port's fake engine
(``production_stack_tpu_torch.testing.fake_engine``), router
(``production_stack_tpu_torch.router.app``), cache server and fleet
controller. It imports nothing of the JAX package; every process it starts
runs with neither jax nor torch loaded.

Launches three fake engines — one ``--fail-rate 1.0`` (every request 500s),
one ``--hang`` (accepts requests, never responds), one healthy — behind a
router with retry/failover, a TTFT deadline, and passive circuit breaking
enabled, then drives a request run through the router and asserts:

- zero client-visible 5xx (every failure failed over to the healthy engine),
- no request consumed more proxy attempts than the retry budget (checked
  against the router's /v1/traces span export),
- both broken backends' circuit breakers are open by the end (checked
  against vllm_router:circuit_state on /metrics).

A second scenario, ``run_overload()`` (``--scenario overload``), drives an
arrival rate above fleet capacity: two fake engines with bounded admission
(``--saturate-after-n``) behind a shed-aware router. Overflow requests must
shed CLEANLY — every client response is a 200 or a 429 with Retry-After
(zero other errors, zero hangs), per-engine in-flight depth stays bounded,
and the shedding engines' circuit breakers stay closed (a shed is capacity,
not failure).

A third scenario, ``run_rolling_restart()`` (``--scenario rolling-restart``),
models a rolling upgrade: three engines behind a retry/breaker/health-check
router, restarted ONE AT A TIME (SIGTERM drain -> exit -> new process on the
same port, advertising a warm restore via ``--restart-restore-pages``) while
sustained client load runs throughout. Asserts zero client non-429 errors
across the whole rotation and that routed traffic RETURNS to each reborn
backend within the breaker half-open window (the reborn process's
``fake:served_total`` climbs from 0).

A fourth scenario, ``run_directory_restart()``
(``--scenario directory-restart``), exercises the fleet-wide KV directory
(docs/kv-directory.md): three fake engines publishing deterministic
chunk hashes behind a KV-aware-v2 router and a directory-hosting cache
server; one engine is SIGTERM'd mid-load and reborn. Asserts zero client
non-429 errors, resident-class routing actually happened, and the reborn
engine re-registered under a higher generation (its stale claims expired)
and republished.

A seventh scenario, ``run_mixed_class_overload()``
(``--scenario mixed-class-overload``), drives a mixed interactive/batch
load past fleet capacity against class-aware admission
(docs/failure-handling.md priority classes): two fakes with an interactive
reserve, one injecting ``--interactive-slo-degrade-ms`` so its interactive
TTFT p99 breaches the fleet controller's latency watermark. Asserts zero
non-429 errors, every shed landed on the batch class (the reserve kept
interactive whole), bounded interactive TTFT, at least one
``latency_protect`` decision that migrated a batch stream off the degraded
engine, and zero dropped streams (the preempted batch stream was spliced,
not cut).

A sixth scenario, ``run_fabric_outage()`` (``--scenario fabric-outage``),
exercises the peer-to-peer KV fabric (docs/kv-fabric.md): three
fabric-enabled fakes cross-pull published chains from each other; one
fabric listener is killed mid-load (``POST /fabric_down``) and the run
asserts zero client non-429 errors, real cross-engine pulls, and counted
tier fallbacks (``vllm:kv_fabric_fallbacks_total`` > 0).

Importable as ``run_chaos()`` / ``run_overload()`` /
``run_rolling_restart()`` / ``run_directory_restart()`` /
``run_fabric_outage()`` / ``run_scale_cycle()`` /
``run_mixed_class_overload()`` (tests/test_torch_chaos.py wires them into
tier-1) or runnable standalone:

    python scripts/chaos_check_torch.py --num-requests 200
    python scripts/chaos_check_torch.py --scenario overload
    python scripts/chaos_check_torch.py --scenario rolling-restart
    python scripts/chaos_check_torch.py --scenario directory-restart
    python scripts/chaos_check_torch.py --scenario fabric-outage
    python scripts/chaos_check_torch.py --scenario scale-cycle
    python scripts/chaos_check_torch.py --scenario mixed-class-overload
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import threading

import requests

# allow running as a plain script from the repo root
sys.path.insert(0, ".")

from production_stack_tpu_torch.testing.procs import (  # noqa: E402
    free_port,
    start_proc,
    stop_proc,
    wait_healthy,
)

# The router every scenario starts with ``-m``.
ROUTER_MODULE = "production_stack_tpu_torch.router.app"
CIRCUIT_RE = re.compile(r'vllm_router:circuit_state\{backend="([^"]+)"\} (\d+)')


def _router_trace_ids(base: str, limit: int = 16384) -> set:
    """Trace ids currently in the router's span ring (needs
    --enable-debug-endpoints on the router)."""
    try:
        traces = requests.get(
            f"{base}/v1/traces", params={"limit": str(limit)}, timeout=10
        ).json()
    except requests.RequestException:
        return set()
    return {t["trace_id"] for t in traces.get("traces", [])}


def _check_anomaly_dumps(
    dump_dir: str, reason: str, router_trace_ids: set
) -> dict:
    """Validate the flight-recorder anomaly dumps a chaos event should have
    produced: at least one parseable dump for ``reason`` whose window holds
    scheduler AND KV events, cross-linked to at least one trace id the
    router also recorded. Returns a summary dict the scenarios assert on."""
    import glob
    import os

    paths = sorted(glob.glob(
        os.path.join(dump_dir, f"flightrecorder-{reason}-*.json")
    ))
    out = {
        "dump_dir": dump_dir, "reason": reason, "dumps": len(paths),
        "parseable": 0, "sched_events": 0, "kv_events": 0,
        "crosslinked_trace_ids": 0,
    }
    for path in paths:
        try:
            with open(path) as f:
                payload = json.load(f)
            events = payload["events"]
        except (OSError, ValueError, KeyError):
            continue
        out["parseable"] += 1
        out["sched_events"] += sum(1 for e in events if e["kind"] == "sched")
        out["kv_events"] += sum(1 for e in events if e["kind"] == "kv")
        dumped_ids = {
            e.get("trace_id") for e in events if e.get("trace_id")
        }
        out["crosslinked_trace_ids"] += len(dumped_ids & router_trace_ids)
    return out


def run_chaos(
    num_requests: int = 200,
    retry_budget: int = 3,
    ttft_deadline: float = 1.0,
    breaker_threshold: int = 3,
    max_tokens: int = 2,
) -> dict:
    """Run the chaos scenario; returns a summary dict (see keys below).
    Raises nothing itself — callers assert on the summary."""
    fakes, urls = [], []
    modes = [["--fail-rate", "1.0"], ["--hang"], []]
    try:
        for extra in modes:
            port = free_port()
            fakes.append(start_proc(
                ["-m", "production_stack_tpu_torch.testing.fake_engine",
                 "--port", str(port), "--model", "fake/model",
                 "--speed", "500"] + extra
            ))
            urls.append(f"http://127.0.0.1:{port}")
        fail_url, hang_url, healthy_url = urls
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--engine-stats-interval", "1",
            "--retry-max-attempts", str(retry_budget),
            "--retry-backoff-base", "0.01",
            "--deadline-ttft", str(ttft_deadline),
            "--deadline-inter-chunk", "2.0",
            "--breaker-failure-threshold", str(breaker_threshold),
            # longer than any sane run: an opened breaker must still be open
            # at the end for the assertion to be meaningful
            "--breaker-cooldown", "300",
            "--trace-buffer-size", "16384",
            "--enable-debug-endpoints",
        ])
        fakes.append(router)
        base = f"http://127.0.0.1:{router_port}"
        for proc, url in zip(fakes[:-1], urls):
            wait_healthy(f"{url}/health", proc, timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)

        sess = requests.Session()
        statuses: collections.Counter = collections.Counter()
        for _ in range(num_requests):
            r = sess.post(
                f"{base}/v1/completions",
                json={"model": "fake/model", "prompt": "x",
                      "max_tokens": max_tokens},
                timeout=60,
            )
            statuses[r.status_code] += 1

        metrics = sess.get(f"{base}/metrics", timeout=10).text
        circuit = {m.group(1): int(m.group(2))
                   for m in CIRCUIT_RE.finditer(metrics)}
        traces = sess.get(
            f"{base}/v1/traces", params={"limit": "16384"}, timeout=10
        ).json()
        attempts_per_request: collections.Counter = collections.Counter()
        for trace in traces.get("traces", []):
            for span in trace["spans"]:
                if span["name"] == "router.proxy":
                    attempts_per_request[span["attrs"].get("request_id")] += 1

        def _counter(name: str) -> float:
            m = re.search(rf"^{re.escape(name)} ([0-9.]+)$", metrics, re.M)
            return float(m.group(1)) if m else 0.0

        return {
            "statuses": dict(statuses),
            "client_5xx": sum(n for s, n in statuses.items() if s >= 500),
            "circuit_state": circuit,
            "fail_url": fail_url,
            "hang_url": hang_url,
            "healthy_url": healthy_url,
            "max_attempts_observed": max(attempts_per_request.values(), default=0),
            "traced_requests": len(attempts_per_request),
            "retry_budget": retry_budget,
            "retries_total": _counter("vllm_router:retries_total"),
            "failovers_total": _counter("vllm_router:failovers_total"),
        }
    finally:
        for p in fakes:
            stop_proc(p)


def run_overload(
    num_requests: int = 48,
    concurrency: int = 12,
    seats: int = 3,
    retry_budget: int = 3,
    max_tokens: int = 8,
) -> dict:
    """Overload scenario: arrival rate > fleet capacity.

    Two fake engines, each with bounded admission (``--saturate-after-n
    seats``), behind a shed-aware router. ``concurrency`` client threads
    drive ``num_requests`` — well past the fleet's 2 x seats in-flight
    capacity — so a slice of requests finds BOTH engines saturated and must
    come back as a clean 429 + Retry-After (never a 5xx, never a hang).
    Returns a summary dict; callers assert on it."""
    import concurrent.futures as cf
    import tempfile

    fakes, urls = [], []
    # per-engine flight-recorder dump dirs: the shed storm must trigger a
    # shed_burst anomaly dump whose window cross-links to router traces
    dump_dirs = []
    try:
        for _ in range(2):
            port = free_port()
            dump_dirs.append(tempfile.mkdtemp(prefix="pstpu-fr-overload-"))
            fakes.append(start_proc(
                ["-m", "production_stack_tpu_torch.testing.fake_engine",
                 "--port", str(port), "--model", "fake/model",
                 # slow enough that requests overlap and saturation is real
                 "--speed", "60",
                 "--saturate-after-n", str(seats),
                 "--retry-after", "1",
                 "--flight-dump-dir", dump_dirs[-1]]
            ))
            urls.append(f"http://127.0.0.1:{port}")
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--engine-stats-interval", "1",
            "--retry-max-attempts", str(retry_budget),
            "--retry-backoff-base", "0.01",
            "--breaker-failure-threshold", "3",
            "--breaker-cooldown", "300",
            # anomaly-dump cross-link check reads the router's span ring
            "--trace-buffer-size", "65536",
            "--enable-debug-endpoints",
        ])
        fakes.append(router)
        base = f"http://127.0.0.1:{router_port}"
        for proc, url in zip(fakes[:-1], urls):
            wait_healthy(f"{url}/health", proc, timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)

        statuses: collections.Counter = collections.Counter()
        missing_retry_after = 0
        hangs = 0
        lock = threading.Lock()

        def one(_i: int) -> None:
            nonlocal missing_retry_after, hangs
            try:
                r = requests.post(
                    f"{base}/v1/completions",
                    json={"model": "fake/model", "prompt": "x",
                          "max_tokens": max_tokens},
                    timeout=30,
                )
                with lock:
                    statuses[r.status_code] += 1
                    if r.status_code == 429 and "Retry-After" not in r.headers:
                        missing_retry_after += 1
            except requests.RequestException:
                with lock:
                    hangs += 1

        with cf.ThreadPoolExecutor(max_workers=concurrency) as pool:
            list(pool.map(one, range(num_requests)))

        metrics = requests.get(f"{base}/metrics", timeout=10).text
        circuit = {m.group(1): int(m.group(2))
                   for m in CIRCUIT_RE.finditer(metrics)}

        def _counter(name: str) -> float:
            m = re.search(rf"^{re.escape(name)} ([0-9.]+)$", metrics, re.M)
            return float(m.group(1)) if m else 0.0

        peaks = {}
        for url in urls:
            text = requests.get(f"{url}/metrics", timeout=10).text
            m = re.search(r"fake:running_peak\{[^}]*\} (\d+)", text)
            # None (metric missing) must FAIL the bounded-depth check, not
            # sail past it — a dropped metric is a broken invariant probe
            peaks[url] = int(m.group(1)) if m else None
        # shed-burst anomaly dumps: the storm must have produced at least
        # one parseable dump whose window carries scheduler + KV events
        # cross-linked (by trace id) to traces the router recorded
        router_ids = _router_trace_ids(base)
        anomaly_dumps = [
            _check_anomaly_dumps(d, "shed_burst", router_ids)
            for d in dump_dirs
        ]
        return {
            "anomaly_dumps": anomaly_dumps,
            "statuses": dict(statuses),
            "non_429_errors": sum(
                n for s, n in statuses.items() if s not in (200, 429)
            ) + hangs,
            "hangs": hangs,
            "missing_retry_after": missing_retry_after,
            "circuit_state": circuit,
            "urls": urls,
            "seats": seats,
            "running_peak": peaks,
            "sheds_total": _counter("vllm_router:sheds_total"),
            "failovers_total": _counter("vllm_router:failovers_total"),
        }
    finally:
        for p in fakes:
            stop_proc(p)


def run_mixed_class_overload(
    seats: int = 5,
    interactive_reserve: int = 3,
    batch_workers: int = 6,
    interactive_workers: int = 2,
    batch_tokens: int = 40,
    interactive_tokens: int = 4,
    speed: float = 25.0,
    load_s: float = 14.0,
    degrade_ms: float = 400.0,
    ttft_watermark_ms: float = 150.0,
    interactive_ttft_p99_bound_s: float = 5.0,
) -> dict:
    """Mixed-class overload scenario (docs/failure-handling.md
    priority classes): interactive + batch load past fleet capacity.

    Two fake engines with class-aware bounded admission
    (``--saturate-after-n`` + ``--interactive-reserve``: batch admission
    stops ``interactive_reserve`` seats early) behind the router; one
    engine additionally injects ``--interactive-slo-degrade-ms`` so its
    *recorded* interactive TTFT/ITL p99 breaches the fleet controller's
    ``interactive_ttft_watermark_ms`` and latency protection engages.
    ``batch_workers`` long SSE streams (tagged ``X-Priority: batch``)
    overload the fleet's batch share while ``interactive_workers`` short
    streams ride the reserve. The in-process fleet controller runs its
    latency_protect loop throughout (rebalance watermark parked out of
    reach so every migration is attributable to the policy under test).

    Caller-asserted: zero non-429 client errors, every engine-level shed
    landed on the batch class (interactive sheds == 0 — the reserve held),
    interactive TTFT p99 bounded, >= 1 latency_protect decision migrated a
    batch stream off the degraded engine, and zero dropped streams (the
    preempted batch stream spliced onto the peer, full token count)."""
    import time

    from production_stack_tpu_torch.migration.controller import (
        ControllerPolicy,
        FleetController,
    )

    ports = [free_port() for _ in range(2)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    degraded_url, peer_url = urls[1], urls[0]
    fakes: dict = {}
    router = None
    stop_load = threading.Event()
    lock = threading.Lock()
    statuses: collections.Counter = collections.Counter()
    client_sheds: collections.Counter = collections.Counter()
    errors: list = []
    dropped_streams: list = []
    ttfts: dict = {"interactive": [], "batch": []}

    def start_fake(port: int, extra: list):
        proc = start_proc([
            "-m", "production_stack_tpu_torch.testing.fake_engine",
            "--port", str(port), "--model", "fake/model",
            "--speed", str(speed),
            "--saturate-after-n", str(seats),
            "--interactive-reserve", str(interactive_reserve),
            "--retry-after", "0.5",
        ] + extra)
        # drain stdout: sustained load + a full 64 KB pipe wedges the
        # process's event loop
        threading.Thread(
            target=lambda: proc.stdout.read() if proc.stdout else None,
            daemon=True,
        ).start()
        return proc

    # only the controller's latency_protect policy may migrate in this
    # scenario: the rebalance watermark is parked above any reachable
    # pressure delta so every migration is attributable
    policy = ControllerPolicy(
        rebalance_high_delta=9.0, rebalance_low_delta=8.0,
        cooldown_s=1.0, max_concurrent_migrations=1, rebalance_k=1,
        saturation_queue_ref=seats,
        interactive_ttft_watermark_ms=ttft_watermark_ms,
        latency_release_ratio=0.7, latency_protect_k=1,
    )
    ctrl_box: dict = {}
    ctrl_stop = threading.Event()

    def controller_thread():
        import asyncio

        async def runner():
            ctrl = FleetController(
                engine_urls=urls, router_url=None, policy=policy,
                tick_interval_s=0.5,
            )
            ctrl_box["ctrl"] = ctrl
            try:
                while not ctrl_stop.is_set():
                    try:
                        await ctrl.tick()
                    except Exception:  # noqa: BLE001 - keep looping
                        pass
                    await asyncio.sleep(0.5)
            finally:
                await ctrl.close()

        asyncio.run(runner())

    try:
        fakes[peer_url] = start_fake(ports[0], [])
        fakes[degraded_url] = start_fake(
            ports[1], ["--interactive-slo-degrade-ms", str(degrade_ms)]
        )
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--engine-stats-interval", "1",
            "--retry-max-attempts", "3",
            "--retry-backoff-base", "0.01",
            "--breaker-failure-threshold", "3",
            "--breaker-cooldown", "300",
        ])
        base = f"http://127.0.0.1:{router_port}"
        for u in urls:
            wait_healthy(f"{u}/health", fakes[u], timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)
        threading.Thread(
            target=lambda: router.stdout.read() if router.stdout else None,
            daemon=True,
        ).start()

        def stream_worker(wid: int, priority: str, max_tokens: int):
            sess = requests.Session()
            i = 0
            while not stop_load.is_set():
                i += 1
                t0 = time.monotonic()
                try:
                    r = sess.post(
                        f"{base}/v1/completions",
                        json={"model": "fake/model",
                              "prompt": f"{priority}-{wid}-{i} " + "ctx " * 16,
                              "max_tokens": max_tokens, "stream": True},
                        headers={"X-Priority": priority},
                        stream=True, timeout=60,
                    )
                    with lock:
                        statuses[r.status_code] += 1
                    if r.status_code == 200:
                        first = None
                        content = 0
                        saw_done = saw_error = False
                        for line in r.iter_lines():
                            if not line.startswith(b"data: "):
                                continue
                            if first is None:
                                first = time.monotonic() - t0
                            if b"[DONE]" in line:
                                saw_done = True
                            elif b'"error"' in line and b'"choices"' not in line:
                                saw_error = True
                            elif b'"text"' in line:
                                content += 1
                        with lock:
                            if first is not None:
                                ttfts[priority].append(first)
                            if saw_error:
                                errors.append(("sse_error", priority, wid))
                            elif not saw_done or content != max_tokens:
                                dropped_streams.append(
                                    (priority, wid, i, content, saw_done)
                                )
                    elif r.status_code == 429:
                        with lock:
                            client_sheds[priority] += 1
                        time.sleep(0.2)
                    else:
                        with lock:
                            errors.append((r.status_code, r.text[:200]))
                except requests.RequestException as e:
                    with lock:
                        errors.append(("exception", repr(e)))
                time.sleep(0.05)

        threads = [
            threading.Thread(
                target=stream_worker, args=(w, "batch", batch_tokens)
            )
            for w in range(batch_workers)
        ] + [
            threading.Thread(
                target=stream_worker,
                args=(w, "interactive", interactive_tokens),
            )
            for w in range(interactive_workers)
        ]
        for t in threads:
            t.start()
        ctrl_thread = threading.Thread(target=controller_thread, daemon=True)
        ctrl_thread.start()

        # run until latency protection demonstrably fired (plus a minimum
        # soak so the shed path is exercised), bounded by load_s
        t0 = time.time()
        while time.time() - t0 < load_s:
            time.sleep(0.5)
            ctrl = ctrl_box.get("ctrl")
            if (
                ctrl is not None
                and ctrl.decider.decisions_total.get("latency_protect", 0) >= 1
                and time.time() - t0 > 4.0
            ):
                break
        time.sleep(1.0)  # let the spliced stream(s) finish cleanly
        stop_load.set()
        for t in threads:
            t.join(timeout=60)
        ctrl_stop.set()
        ctrl_thread.join(timeout=10)

        by_class_re = re.compile(
            r'^(fake:(?:served|shed)_by_class_total)\{[^}]*'
            r'priority="([a-z]+)"[^}]*\} ([0-9.]+)$', re.M,
        )
        served_by_class: collections.Counter = collections.Counter()
        shed_by_class: collections.Counter = collections.Counter()
        gauges: dict = {}
        for u in urls:
            text = requests.get(f"{u}/metrics", timeout=10).text
            for m in by_class_re.finditer(text):
                tgt = (
                    served_by_class if "served" in m.group(1)
                    else shed_by_class
                )
                tgt[m.group(2)] += float(m.group(3))
            vals = {}
            for m in re.finditer(
                r"^((?:vllm|fake):[a-z0-9_]+)(?:\{[^}]*\})? "
                r"([0-9.eE+-]+)$", text, re.M,
            ):
                vals[m.group(1)] = vals.get(m.group(1), 0.0) + float(
                    m.group(2)
                )
            gauges[u] = vals
        router_text = requests.get(f"{base}/metrics", timeout=10).text

        def _router_counter(name: str) -> float:
            m = re.search(
                rf"^{re.escape(name)} ([0-9.]+)$", router_text, re.M
            )
            return float(m.group(1)) if m else 0.0

        router_by_class = {
            m.group(1): float(m.group(2))
            for m in re.finditer(
                r'^vllm_router:requests_by_class_total\{priority="([a-z]+)"\}'
                r" ([0-9.]+)$", router_text, re.M,
            )
        }
        i_t = sorted(ttfts["interactive"])
        i_p99 = (
            i_t[min(len(i_t) - 1, int(len(i_t) * 0.99))] if i_t else None
        )
        ctrl = ctrl_box.get("ctrl")
        decisions = dict(ctrl.decider.decisions_total) if ctrl else {}
        return {
            "statuses": dict(statuses),
            "non_429_errors": len(errors),
            "errors": errors[:10],
            "dropped_streams": len(dropped_streams),
            "dropped_examples": dropped_streams[:5],
            "interactive_ttft_p99_s": i_p99,
            "interactive_ttft_p99_bound_s": interactive_ttft_p99_bound_s,
            "interactive_streams_ok": len(ttfts["interactive"]),
            "batch_streams_ok": len(ttfts["batch"]),
            "served_by_class": dict(served_by_class),
            "shed_by_class": dict(shed_by_class),
            "client_sheds_by_class": dict(client_sheds),
            "router_requests_by_class": router_by_class,
            "degraded_url": degraded_url,
            "degraded_interactive_ttft_p99_ms": gauges.get(
                degraded_url, {}
            ).get("vllm:interactive_ttft_p99_ms", 0.0),
            "latency_protect_decisions": decisions.get("latency_protect", 0),
            "controller_decisions": decisions,
            "degraded_migrations_out": gauges.get(degraded_url, {}).get(
                "fake:migrations_out_total", 0.0
            ),
            "peer_migrations_in": gauges.get(peer_url, {}).get(
                "fake:migrations_in_total", 0.0
            ),
            "session_repins_total": _router_counter(
                "vllm_router:session_repins_total"
            ),
            "splice_failures_total": _router_counter(
                "vllm_router:migration_splice_failures_total"
            ),
            "seats": seats,
            "interactive_reserve": interactive_reserve,
        }
    finally:
        stop_load.set()
        ctrl_stop.set()
        for p_ in fakes.values():
            stop_proc(p_)
        if router is not None:
            stop_proc(router)


def run_rolling_restart(
    engines: int = 3,
    workers: int = 6,
    breaker_cooldown: float = 1.5,
    return_window: float = 8.0,
    restore_pages: int = 32,
    max_tokens: int = 4,
) -> dict:
    """Rolling-restart scenario: restart every engine one at a time under
    sustained load. Returns a summary dict; callers assert on it.

    The reborn processes advertise ``--restart-restore-pages`` so the run
    also checks the warm-start metric surface a real ``--warm-start`` engine
    exports after restoring its manifest."""
    import signal as signal_mod
    import tempfile
    import time

    # one dump dir per engine SLOT, shared across its incarnations: the
    # SIGTERM drain of each dying process must leave a parseable anomaly
    # dump behind (timestamped filenames keep incarnations apart)
    dump_dirs = [
        tempfile.mkdtemp(prefix="pstpu-fr-restart-") for _ in range(engines)
    ]

    def start_fake(port: int, extra: list, dump_dir: str = "") -> "object":
        return start_proc(
            ["-m", "production_stack_tpu_torch.testing.fake_engine",
             "--port", str(port), "--model", "fake/model",
             "--speed", "200"]
            + (["--flight-dump-dir", dump_dir] if dump_dir else [])
            + extra
        )

    ports = [free_port() for _ in range(engines)]
    fakes = [start_fake(p, [], d) for p, d in zip(ports, dump_dirs)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    router = None
    stop_load = threading.Event()
    statuses: collections.Counter = collections.Counter()
    errors: list = []
    lock = threading.Lock()
    try:
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--engine-stats-interval", "1",
            "--retry-max-attempts", "3",
            "--retry-backoff-base", "0.01",
            "--breaker-failure-threshold", "2",
            "--breaker-cooldown", str(breaker_cooldown),
            # the active health loop fast-tracks an open breaker to
            # half-open the moment the reborn pod answers /health — the
            # path a K8s rotation takes (readiness gates + probes)
            "--static-backend-health-checks",
            "--health-check-interval", "0.25",
            # anomaly-dump cross-link check reads the router's span ring
            # (sized for the whole sustained-load run)
            "--trace-buffer-size", "65536",
            "--enable-debug-endpoints",
        ])
        base = f"http://127.0.0.1:{router_port}"
        for proc, url in zip(fakes, urls):
            wait_healthy(f"{url}/health", proc, timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)
        # drain the router's stdout for the whole run: it logs one routing
        # line per request, and minutes of sustained load overflow the 64 KB
        # subprocess pipe — a full pipe blocks the logging handler and
        # WEDGES the router's event loop (a harness artifact, not a router
        # bug; production stdout goes to the container runtime, which reads)
        threading.Thread(
            target=lambda: router.stdout.read() if router.stdout else None,
            daemon=True,
        ).start()

        def load_worker():
            sess = requests.Session()
            while not stop_load.is_set():
                try:
                    r = sess.post(
                        f"{base}/v1/completions",
                        json={"model": "fake/model", "prompt": "x",
                              "max_tokens": max_tokens},
                        timeout=30,
                    )
                    with lock:
                        statuses[r.status_code] += 1
                        if r.status_code not in (200, 429):
                            errors.append((r.status_code, r.text[:200]))
                except requests.RequestException as e:
                    with lock:
                        errors.append(("exception", repr(e)))
                time.sleep(0.02)  # sustained, not saturating: ~300 req/s

        threads = [threading.Thread(target=load_worker) for _ in range(workers)]
        for t in threads:
            t.start()
        time.sleep(1.0)  # steady-state traffic before the first restart

        def served_total(url: str) -> int:
            try:
                text = requests.get(f"{url}/metrics", timeout=5).text
            except requests.RequestException:
                return -1
            m = re.search(r"fake:served_total\{[^}]*\} (\d+)", text)
            return int(m.group(1)) if m else -1

        restarts = []
        for i, port in enumerate(ports):
            # graceful half of the rotation: SIGTERM -> drain -> exit
            fakes[i].send_signal(signal_mod.SIGTERM)
            rc = fakes[i].wait(timeout=20)
            # rebirth on the SAME address, warm (modelled manifest restore)
            fakes[i] = start_fake(
                port, ["--restart-restore-pages", str(restore_pages)],
                dump_dirs[i],
            )
            wait_healthy(f"{urls[i]}/health", fakes[i], timeout=30)
            # traffic must RETURN to the reborn backend within the breaker
            # half-open window: its per-process served counter climbs from 0
            t0 = time.time()
            returned_at = None
            while time.time() - t0 < return_window:
                if served_total(urls[i]) > 0:
                    returned_at = time.time() - t0
                    break
                time.sleep(0.1)
            warm = requests.get(f"{urls[i]}/metrics", timeout=5).text
            m = re.search(
                r"vllm:warm_start_restored_pages\{[^}]*\} (\d+)", warm
            )
            restarts.append({
                "url": urls[i],
                "exit_rc": rc,
                "traffic_returned_s": returned_at,
                "warm_restored_pages": int(m.group(1)) if m else 0,
            })
            time.sleep(0.5)  # settle before rotating the next engine

        stop_load.set()
        for t in threads:
            t.join(timeout=30)

        metrics = requests.get(f"{base}/metrics", timeout=10).text
        circuit = {m.group(1): int(m.group(2))
                   for m in CIRCUIT_RE.finditer(metrics)}
        # SIGTERM anomaly dumps: each rotated engine's drain must have left
        # a parseable flight-recorder dump carrying the pre-restart
        # scheduler + KV window, cross-linked to router-recorded trace ids
        router_ids = _router_trace_ids(base)
        anomaly_dumps = [
            _check_anomaly_dumps(d, "sigterm_drain", router_ids)
            for d in dump_dirs
        ]
        return {
            "anomaly_dumps": anomaly_dumps,
            "statuses": dict(statuses),
            "non_429_errors": len(errors),
            "errors": errors[:10],
            "restarts": restarts,
            "return_window": return_window,
            "restore_pages": restore_pages,
            "circuit_state": circuit,
            "urls": urls,
        }
    finally:
        stop_load.set()
        for p in fakes:
            stop_proc(p)
        if router is not None:
            stop_proc(router)


def run_directory_restart(
    engines: int = 3,
    workers: int = 4,
    prefixes: int = 4,
    settle_s: float = 2.5,
    republish_window: float = 10.0,
    directory_engine_timeout: float = 3.0,
    max_tokens: int = 4,
) -> dict:
    """Fleet-wide KV directory restart scenario.

    A cache server hosting the directory, three fake engines publishing
    deterministic per-prompt chunk hashes (``--kv-directory-url``), and a
    router in KV-aware v2 mode. Sustained load over a handful of long
    shared session prefixes concentrates each prefix on its publishing
    engine (resident routing); then one engine is SIGTERM'd mid-load and
    reborn on the same address. Asserted by the caller:

    - zero client non-429 errors across the whole rotation (the dead
      backend's resident claims must not poison routing — failover +
      directory TTL/generation fencing cover the gap),
    - the router actually routed by directory class (resident routes > 0),
    - the reborn engine re-registered under a HIGHER generation and
      republished (its stale claims were expired, not trusted).
    """
    import time

    import signal as signal_mod

    from production_stack_tpu_torch.kvoffload.protocol import BlockingClient

    cache_port = free_port()
    cache = start_proc([
        "-m", "production_stack_tpu_torch.kvoffload.cache_server",
        "--port", str(cache_port), "--host", "127.0.0.1",
        "--directory",
        "--directory-engine-timeout", str(directory_engine_timeout),
    ])
    dir_url = f"127.0.0.1:{cache_port}"

    def dir_dump() -> dict:
        client = BlockingClient("127.0.0.1", cache_port, timeout=5)
        try:
            hdr, _ = client.request({"op": "dir_dump"})
            return hdr
        finally:
            client.close()

    ports = [free_port() for _ in range(engines)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]

    def start_fake(port: int) -> "object":
        return start_proc([
            "-m", "production_stack_tpu_torch.testing.fake_engine",
            "--port", str(port), "--model", "fake/model", "--speed", "300",
            "--kv-directory-url", dir_url,
        ])

    fakes = [start_fake(p) for p in ports]
    router = None
    stop_load = threading.Event()
    statuses: collections.Counter = collections.Counter()
    errors: list = []
    lock = threading.Lock()
    try:
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--routing-logic", "kvaware",
            "--kv-directory-url", dir_url,
            "--engine-stats-interval", "1",
            "--retry-max-attempts", "3",
            "--retry-backoff-base", "0.01",
            "--breaker-failure-threshold", "2",
            "--breaker-cooldown", "1.0",
            # deliberately NO aggressive active health checks: the dead
            # backend is handled by retry/failover + its breaker + the
            # directory's TTL/fencing — and on a loaded CI host sub-second
            # health probes can time out against HEALTHY backends and pull
            # the whole fleet from rotation (client-visible 503s that have
            # nothing to do with the scenario under test)
        ])
        base = f"http://127.0.0.1:{router_port}"
        for proc, url in zip(fakes, urls):
            wait_healthy(f"{url}/health", proc, timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)
        # drain router stdout: sustained load logs one line per request and a
        # full 64 KB pipe wedges the event loop
        threading.Thread(
            target=lambda: router.stdout.read() if router.stdout else None,
            daemon=True,
        ).start()

        # long shared session prefixes (several 16-char chunks each) so the
        # fakes' published chains give the router real resident signal
        prompts = [
            f"session-{i:02d}-" + (chr(ord("a") + i) * 150) for i in range(prefixes)
        ]

        def load_worker(wid: int):
            sess = requests.Session()
            i = 0
            while not stop_load.is_set():
                i += 1
                prompt = prompts[(wid + i) % len(prompts)] + f"::{wid}-{i}"
                try:
                    r = sess.post(
                        f"{base}/v1/completions",
                        json={"model": "fake/model", "prompt": prompt,
                              "max_tokens": max_tokens},
                        timeout=30,
                    )
                    with lock:
                        statuses[r.status_code] += 1
                        if r.status_code not in (200, 429):
                            errors.append((r.status_code, r.text[:200]))
                except requests.RequestException as e:
                    with lock:
                        errors.append(("exception", repr(e)))
                time.sleep(0.03)

        threads = [
            threading.Thread(target=load_worker, args=(w,))
            for w in range(workers)
        ]
        for t in threads:
            t.start()
        time.sleep(settle_s)  # publishes + resident routing reach steady state

        victim = urls[0]
        pre = dir_dump()
        pre_gen = (pre.get("engines", {}).get(victim) or {}).get("generation", 0)
        # SIGTERM the publishing engine mid-load; rebirth on the same address
        fakes[0].send_signal(signal_mod.SIGTERM)
        rc = fakes[0].wait(timeout=20)
        fakes[0] = start_fake(ports[0])
        wait_healthy(f"{urls[0]}/health", fakes[0], timeout=30)
        # the reborn process must re-register under a HIGHER generation and
        # republish entries as it serves (its pre-restart claims expire).
        # While it was down the surviving engines took over the existing
        # session prefixes (their resident claims now win), so feed the
        # rotation NEW cold sessions — QPS routing sends those to the
        # least-loaded backend, which is exactly how a reborn engine earns
        # traffic (and directory entries) back in production
        t0 = time.time()
        reborn_gen, republished = 0, 0
        k = 0
        while time.time() - t0 < republish_window:
            k += 1
            prompts.append(f"post-restart-{k:02d}-" + ("z" * 150))
            d = dir_dump().get("engines", {}).get(victim) or {}
            reborn_gen = d.get("generation", 0)
            republished = d.get("resident_chunks", 0)
            if reborn_gen > pre_gen and republished > 0:
                break
            time.sleep(0.25)
        time.sleep(0.5)
        stop_load.set()
        for t in threads:
            t.join(timeout=30)

        metrics = requests.get(f"{base}/metrics", timeout=10).text

        def _counter(name: str) -> float:
            m = re.search(rf"^{re.escape(name)} ([0-9.]+)$", metrics, re.M)
            return float(m.group(1)) if m else 0.0

        final = dir_dump()
        return {
            "statuses": dict(statuses),
            "non_429_errors": len(errors),
            "errors": errors[:10],
            "victim": victim,
            "victim_exit_rc": rc,
            "pre_generation": pre_gen,
            "reborn_generation": reborn_gen,
            "republished_chunks": republished,
            "expired_entries_total": final.get(
                "kv_directory_expired_entries_total", 0
            ),
            "stale_hits_total": final.get("kv_directory_stale_hits_total", 0),
            "resident_routes": _counter(
                "vllm_router:kvaware_v2_resident_routes_total"
            ),
            "restorable_routes": _counter(
                "vllm_router:kvaware_v2_restorable_routes_total"
            ),
            "cold_routes": _counter("vllm_router:kvaware_v2_cold_routes_total"),
        }
    finally:
        stop_load.set()
        for p_ in fakes:
            stop_proc(p_)
        if router is not None:
            stop_proc(router)
        stop_proc(cache)


def run_fabric_outage(
    engines: int = 3,
    workers: int = 4,
    prefixes: int = 4,
    settle_s: float = 3.0,
    outage_window: float = 12.0,
    max_tokens: int = 4,
) -> dict:
    """KV fabric outage scenario (docs/kv-fabric.md).

    Three fake engines with the peer-to-peer KV fabric enabled
    (``--fabric --kv-directory-url``) behind a round-robin router: shared
    session prefixes rotate across engines, so each engine's first request
    for a prefix PULLS the published chain from the owning peer's fabric
    listener (generation-fenced, real wire frames). Mid-load the victim's
    fabric listener is killed via ``POST /fabric_down`` — its HTTP plane
    keeps serving — while NEW prefixes keep entering the rotation. Asserted
    by the caller:

    - zero client non-429 errors for the whole run (a fabric outage is
      invisible to clients — pulls degrade to the tier path),
    - cross-engine fabric pulls actually happened
      (``vllm:kv_fabric_pulled_pages_total`` > 0 fleet-wide),
    - the outage produced counted tier fallbacks
      (``vllm:kv_fabric_fallbacks_total`` > 0 fleet-wide).
    """
    import time

    cache_port = free_port()
    cache = start_proc([
        "-m", "production_stack_tpu_torch.kvoffload.cache_server",
        "--port", str(cache_port), "--host", "127.0.0.1",
        "--directory",
    ])
    dir_url = f"127.0.0.1:{cache_port}"
    ports = [free_port() for _ in range(engines)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    fakes = [
        start_proc([
            "-m", "production_stack_tpu_torch.testing.fake_engine",
            "--port", str(p), "--model", "fake/model", "--speed", "300",
            "--kv-directory-url", dir_url, "--fabric",
        ])
        for p in ports
    ]
    router = None
    stop_load = threading.Event()
    statuses: collections.Counter = collections.Counter()
    errors: list = []
    lock = threading.Lock()

    def fab_counter(url: str, name: str) -> float:
        try:
            text = requests.get(f"{url}/metrics", timeout=10).text
        except requests.RequestException:
            return 0.0
        m = re.search(
            rf"^{re.escape(name)}\{{[^}}]*\}} ([0-9.]+)$", text, re.M
        )
        return float(m.group(1)) if m else 0.0

    def fleet_counter(name: str) -> float:
        return sum(fab_counter(u, name) for u in urls)

    try:
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            # round-robin deliberately: every prefix visits every engine, so
            # cross-engine fabric pulls are guaranteed (kvaware would
            # concentrate each prefix on its owner and never pull)
            "--routing-logic", "roundrobin",
            "--engine-stats-interval", "1",
            "--retry-max-attempts", "3",
            "--retry-backoff-base", "0.01",
        ])
        base = f"http://127.0.0.1:{router_port}"
        for proc, url in zip(fakes, urls):
            wait_healthy(f"{url}/health", proc, timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)
        threading.Thread(
            target=lambda: router.stdout.read() if router.stdout else None,
            daemon=True,
        ).start()

        prompts = [
            f"fabric-{i:02d}-" + (chr(ord("a") + i) * 150)
            for i in range(prefixes)
        ]

        def load_worker(wid: int):
            sess = requests.Session()
            i = 0
            while not stop_load.is_set():
                i += 1
                prompt = prompts[(wid + i) % len(prompts)] + f"::{wid}-{i}"
                try:
                    r = sess.post(
                        f"{base}/v1/completions",
                        json={"model": "fake/model", "prompt": prompt,
                              "max_tokens": max_tokens},
                        timeout=30,
                    )
                    with lock:
                        statuses[r.status_code] += 1
                        if r.status_code not in (200, 429):
                            errors.append((r.status_code, r.text[:200]))
                except requests.RequestException as e:
                    with lock:
                        errors.append(("exception", repr(e)))
                time.sleep(0.03)

        threads = [
            threading.Thread(target=load_worker, args=(w,))
            for w in range(workers)
        ]
        for t in threads:
            t.start()
        time.sleep(settle_s)  # publishes + cross-engine pulls reach steady state
        pre_pulled = fleet_counter("vllm:kv_fabric_pulled_pages_total")

        # kill the victim's fabric listener mid-load; its HTTP plane (and
        # its directory publishes) keep running — peers that try to pull
        # its freshly-published chains must fall back to the tier path
        victim = urls[0]
        requests.post(f"{victim}/fabric_down", timeout=10)
        t0 = time.time()
        fallbacks = pulled = 0.0
        k = 0
        while time.time() - t0 < outage_window:
            k += 1
            # new prefixes keep entering the rotation: round-robin lands
            # some on the victim FIRST, so its (fabric-dead) claims are the
            # ones peers try to pull
            prompts.append(f"post-outage-{k:02d}-" + ("z" * 150))
            pulled = fleet_counter("vllm:kv_fabric_pulled_pages_total")
            fallbacks = fleet_counter("vllm:kv_fabric_fallbacks_total")
            if pulled > 0 and fallbacks > 0:
                break
            time.sleep(0.25)
        stop_load.set()
        for t in threads:
            t.join(timeout=30)
        return {
            "statuses": dict(statuses),
            "non_429_errors": len(errors),
            "errors": errors[:10],
            "victim": victim,
            "pre_outage_pulled_pages": pre_pulled,
            "fabric_pulled_pages": pulled,
            "fabric_fallbacks": fallbacks,
            "fabric_served_pages": fleet_counter(
                "vllm:kv_fabric_served_pages_total"
            ),
        }
    finally:
        stop_load.set()
        for p_ in fakes:
            stop_proc(p_)
        if router is not None:
            stop_proc(router)
        stop_proc(cache)


def run_scale_cycle(
    base_engines: int = 2,
    peak_engines: int = 4,
    workers: int = 4,
    max_tokens: int = 30,
    speed: float = 25.0,
    phase_s: float = 3.0,
    return_window: float = 12.0,
    warm_prefetch: int = 8,
    drain_deadline: float = 20.0,
    ttft_p99_bound_s: float = 8.0,
    tensor_parallel: int = 1,
) -> dict:
    """Scale-cycle scenario: 2 -> 4 -> 2 engines under sustained
    streaming load, driven by the fleet controller (docs/migration.md).

    A directory-hosting cache server, ``peak_engines`` router-known
    addresses (standby-pod model: the router health-checks all four and
    only routes to live ones), and ``base_engines`` fake engines with
    ``--migration`` publishing to the directory. Under continuous streaming
    load:

    - the fleet controller runs its rebalance loop throughout;
    - scale-UP starts the remaining engines with
      ``--warm-prefetch-on-boot`` (they pull the fleet's top warm chunks
      before serving — the directory-driven warm-up);
    - scale-DOWN evacuates each victim with live migration
      (``FleetController.evacuate``) DURING its SIGTERM drain, so every
      in-flight stream moves to a survivor and the process exits clean.

    Caller-asserted: zero non-429 client errors, zero dropped streams
    (every started SSE stream reaches [DONE] with the full token count —
    spliced streams included), bounded TTFT p99, every drained engine
    evacuated everything before exit, and the scaled-up engines pulled
    fleet-warm chunks and served warm prefix hits."""
    import asyncio
    import signal as signal_mod
    import time

    from production_stack_tpu_torch.migration.controller import (
        ControllerPolicy,
        FleetController,
    )

    cache_port = free_port()
    cache = start_proc([
        "-m", "production_stack_tpu_torch.kvoffload.cache_server",
        "--port", str(cache_port), "--host", "127.0.0.1", "--directory",
        "--directory-engine-timeout", "5",
    ])
    dir_url = f"127.0.0.1:{cache_port}"
    ports = [free_port() for _ in range(peak_engines)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]

    def start_fake(port: int, extra: list) -> "object":
        # with tensor_parallel > 1 every fake advertises a sharded serving
        # mesh (vllm:tensor_parallel_degree): the scenario then
        # proves router scraping, migration, and warm-start all round-trip
        # against a sharded-engine fleet unchanged
        tp_args = (
            ["--tensor-parallel", str(tensor_parallel)]
            if tensor_parallel != 1 else []
        )
        proc = start_proc([
            "-m", "production_stack_tpu_torch.testing.fake_engine",
            "--port", str(port), "--model", "fake/model",
            "--speed", str(speed), "--kv-directory-url", dir_url,
            "--migration",
        ] + tp_args + extra)
        # drain stdout: sustained load + a full 64 KB pipe wedges the
        # process's event loop
        threading.Thread(
            target=lambda: proc.stdout.read() if proc.stdout else None,
            daemon=True,
        ).start()
        return proc

    fakes: dict = {}
    for p_, u in zip(ports[:base_engines], urls[:base_engines]):
        fakes[u] = start_fake(p_, [])
    router = None
    stop_load = threading.Event()
    lock = threading.Lock()
    statuses: collections.Counter = collections.Counter()
    errors: list = []
    dropped_streams: list = []
    ttfts: list = []

    # shared controller (rebalance loop runs in its own thread/event loop;
    # evacuations reuse the same decider so decision counts accumulate)
    policy = ControllerPolicy(
        rebalance_high_delta=0.25, rebalance_low_delta=0.1,
        cooldown_s=1.0, max_concurrent_migrations=2, rebalance_k=1,
        saturation_queue_ref=4,
    )
    ctrl_box: dict = {}
    ctrl_stop = threading.Event()

    def controller_thread():
        async def runner():
            ctrl = FleetController(
                engine_urls=urls, router_url=None, policy=policy,
                tick_interval_s=0.5,
            )
            ctrl_box["ctrl"] = ctrl
            try:
                while not ctrl_stop.is_set():
                    try:
                        await ctrl.tick()
                    except Exception:  # noqa: BLE001 - keep looping
                        pass
                    await asyncio.sleep(0.5)
            finally:
                await ctrl.close()

        asyncio.run(runner())

    def scrape(url: str) -> dict:
        try:
            text = requests.get(f"{url}/metrics", timeout=5).text
        except requests.RequestException:
            return {}
        out = {}
        for m in re.finditer(
            r"^((?:vllm|vllm_router|fake):[a-z0-9_]+)(?:\{[^}]*\})? "
            r"([0-9.eE+-]+)$", text, re.M,
        ):
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
        return out

    try:
        router_port = free_port()
        router = start_proc([
            "-m", ROUTER_MODULE,
            "--port", str(router_port),
            # standby-pod model: the router knows every address; health
            # checks pull dead ones from rotation and admit them on boot
            "--static-backends", ",".join(urls),
            "--static-models", ",".join(["fake/model"] * len(urls)),
            "--engine-stats-interval", "1",
            "--retry-max-attempts", "4",
            "--retry-backoff-base", "0.01",
            "--breaker-failure-threshold", "3",
            "--breaker-cooldown", "1.0",
            "--static-backend-health-checks",
            "--health-check-interval", "0.3",
        ])
        base = f"http://127.0.0.1:{router_port}"
        for u in list(fakes):
            wait_healthy(f"{u}/health", fakes[u], timeout=30)
        wait_healthy(f"{base}/health", router, timeout=30)
        threading.Thread(
            target=lambda: router.stdout.read() if router.stdout else None,
            daemon=True,
        ).start()
        # the router health-checks ALL peak addresses (two are intentionally
        # dark standbys): wait until the live backends passed their first
        # probe, or the first load requests race an empty healthy set
        t0 = time.time()
        while time.time() - t0 < 20:
            try:
                r = requests.post(
                    f"{base}/v1/completions",
                    json={"model": "fake/model", "prompt": "probe",
                          "max_tokens": 1},
                    timeout=10,
                )
                if r.status_code == 200:
                    break
            except requests.RequestException:
                pass
            time.sleep(0.2)
        # shared session prefixes: publishes give the directory warm chains
        # the scaled-up engines prefetch
        prompts = [
            f"session-{i:02d}-" + (chr(ord("a") + i) * 120) for i in range(4)
        ]

        def load_worker(wid: int):
            sess = requests.Session()
            i = 0
            while not stop_load.is_set():
                i += 1
                prompt = prompts[(wid + i) % len(prompts)] + f"::{wid}-{i}"
                t0 = time.monotonic()
                try:
                    r = sess.post(
                        f"{base}/v1/completions",
                        json={"model": "fake/model", "prompt": prompt,
                              "max_tokens": max_tokens, "stream": True},
                        stream=True, timeout=60,
                    )
                    with lock:
                        statuses[r.status_code] += 1
                    if r.status_code == 200:
                        first = None
                        content = 0
                        saw_done = saw_error = False
                        for line in r.iter_lines():
                            if not line.startswith(b"data: "):
                                continue
                            if first is None:
                                first = time.monotonic() - t0
                            if b"[DONE]" in line:
                                saw_done = True
                            elif b'"error"' in line and b'"choices"' not in line:
                                saw_error = True
                            elif b'"text"' in line:
                                content += 1
                        with lock:
                            if first is not None:
                                ttfts.append(first)
                            if saw_error:
                                errors.append(("sse_error", prompt[:40]))
                            elif not saw_done or content != max_tokens:
                                dropped_streams.append(
                                    (prompt[:40], content, saw_done)
                                )
                    elif r.status_code != 429:
                        with lock:
                            errors.append((r.status_code, r.text[:200]))
                except requests.RequestException as e:
                    with lock:
                        errors.append(("exception", repr(e)))
                time.sleep(0.05)

        threads = [
            threading.Thread(target=load_worker, args=(w,))
            for w in range(workers)
        ]
        for t in threads:
            t.start()
        ctrl_thread = threading.Thread(target=controller_thread, daemon=True)
        ctrl_thread.start()
        time.sleep(phase_s)  # phase 1: 2 engines under load

        # -- scale UP: 2 -> 4, new engines warm-prefetch before serving ----
        scale_up = []
        for p_, u in zip(
            ports[base_engines:peak_engines], urls[base_engines:peak_engines]
        ):
            fakes[u] = start_fake(
                p_, ["--warm-prefetch-on-boot", str(warm_prefetch)]
            )
        for u in urls[base_engines:peak_engines]:
            wait_healthy(f"{u}/health", fakes[u], timeout=30)
        # traffic must reach each scaled-up engine, and its first servings
        # must hit the prefetched fleet-warm set
        for u in urls[base_engines:peak_engines]:
            t0 = time.time()
            served = 0.0
            while time.time() - t0 < return_window:
                m = scrape(u)
                served = m.get("fake:served_total", 0)
                if served > 0 and m.get("fake:warm_prefix_hits_total", 0) > 0:
                    break
                time.sleep(0.2)
            m = scrape(u)
            scale_up.append({
                "url": u,
                "served": m.get("fake:served_total", 0),
                "warm_prefetch_chunks": m.get("fake:warm_prefetch_chunks", 0),
                "warm_prefix_hits": m.get("fake:warm_prefix_hits_total", 0),
                "took_s": round(time.time() - t0, 2),
            })
        time.sleep(phase_s)  # phase 2: 4 engines steady state

        # -- scale DOWN: 4 -> 2, evacuate each victim during its drain -----
        drains = []
        for u in urls[base_engines:peak_engines]:
            victim_metrics: dict = {}
            stop_scrape = threading.Event()

            def victim_scraper(vu=u, box=victim_metrics, ev=stop_scrape):
                while not ev.is_set():
                    m = scrape(vu)
                    if m:
                        box.update(m)
                    time.sleep(0.15)

            scr = threading.Thread(target=victim_scraper, daemon=True)
            scr.start()
            # SIGTERM first (drain: health 503 pulls it from routing, new
            # requests refused, in-flight streams keep running), THEN
            # evacuate the in-flight streams onto the survivors
            fakes[u].send_signal(signal_mod.SIGTERM)
            survivors = [x for x in urls if x != u and x in fakes]
            report = asyncio.run(
                _evacuate_once(
                    survivors + [u], u, policy, drain_deadline
                )
            )
            rc = fakes[u].wait(timeout=30)
            stop_scrape.set()
            scr.join(timeout=5)
            fakes.pop(u)
            report.update({
                "exit_rc": rc,
                "victim_migrations_out": victim_metrics.get(
                    "fake:migrations_out_total", 0
                ),
                "victim_last_running": victim_metrics.get(
                    "vllm:num_requests_running", -1
                ),
            })
            drains.append(report)
            time.sleep(0.5)

        time.sleep(1.0)
        stop_load.set()
        for t in threads:
            t.join(timeout=60)
        ctrl_stop.set()
        ctrl_thread.join(timeout=10)

        router_m = scrape(base)
        fleet = {u: scrape(u) for u in fakes}
        # serving-mesh advert round trip: each engine's own
        # vllm:tensor_parallel_degree, and the router's SCRAPED view of it
        # (/engines engine_stats — what the fleet controller's capacity
        # math reads)
        engine_tp = {
            u: m.get("vllm:tensor_parallel_degree", 0.0)
            for u, m in fleet.items()
        }
        router_tp: dict = {}
        try:
            eng_view = requests.get(f"{base}/engines", timeout=10).json()
            for ep in eng_view.get("engines", []):
                es = ep.get("engine_stats")
                if es is not None and ep["url"] in fakes:
                    router_tp[ep["url"]] = es.get("tensor_parallel")
        except requests.RequestException:
            pass
        # out-count = confirmed migrate_out ships: the evacuation reports'
        # moved counts (a victim's own counter can be unreadable in the
        # instant between its last stream leaving and the process exiting)
        # plus the surviving fleet's rebalance-driven outs
        migrations_out = sum(
            m.get("fake:migrations_out_total", 0) for m in fleet.values()
        ) + sum(d["moved"] for d in drains)
        migrations_in = sum(
            m.get("fake:migrations_in_total", 0) for m in fleet.values()
        )
        s_t = sorted(ttfts)
        ttft_p99 = (
            s_t[min(len(s_t) - 1, int(len(s_t) * 0.99))] if s_t else None
        )
        ctrl = ctrl_box.get("ctrl")
        return {
            "statuses": dict(statuses),
            "non_429_errors": len(errors),
            "errors": errors[:10],
            "dropped_streams": len(dropped_streams),
            "dropped_examples": dropped_streams[:5],
            "ttft_p99_s": ttft_p99,
            "ttft_p99_bound_s": ttft_p99_bound_s,
            "scale_up": scale_up,
            "drains": drains,
            "migrations_out_total": migrations_out,
            "migrations_in_total": migrations_in,
            "session_repins_total": router_m.get(
                "vllm_router:session_repins_total", 0
            ),
            "splice_failures_total": router_m.get(
                "vllm_router:migration_splice_failures_total", 0
            ),
            "controller_decisions": (
                dict(ctrl.decider.decisions_total) if ctrl else {}
            ),
            "tensor_parallel_cfg": tensor_parallel,
            "engine_advertised_tp": engine_tp,
            "router_scraped_tp": router_tp,
        }
    finally:
        stop_load.set()
        ctrl_stop.set()
        for p_ in fakes.values():
            stop_proc(p_)
        if router is not None:
            stop_proc(router)
        stop_proc(cache)


async def _evacuate_once(engine_urls, victim, policy, deadline_s):
    """One-shot evacuation helper (its own event loop; the controller is a
    pure HTTP client so a fresh instance is fine)."""
    from production_stack_tpu_torch.migration.controller import FleetController

    ctrl = FleetController(engine_urls=engine_urls, policy=policy)
    try:
        return await ctrl.evacuate(victim, deadline_s=deadline_s)
    finally:
        await ctrl.close()


def main() -> int:
    p = argparse.ArgumentParser("chaos-check")
    p.add_argument("--scenario",
                   choices=["chaos", "overload", "rolling-restart",
                            "directory-restart", "scale-cycle",
                            "fabric-outage", "mixed-class-overload"],
                   default="chaos")
    p.add_argument("--num-requests", type=int, default=None)
    p.add_argument("--retry-budget", type=int, default=3)
    p.add_argument("--ttft-deadline", type=float, default=1.0)
    p.add_argument("--breaker-threshold", type=int, default=3)
    args = p.parse_args()
    from production_stack_tpu_torch.router.resilience import OPEN

    if args.scenario == "scale-cycle":
        s = run_scale_cycle()
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors: {s['errors']}"
            )
        if s["dropped_streams"]:
            failures.append(
                f"{s['dropped_streams']} dropped mid-flight streams: "
                f"{s['dropped_examples']}"
            )
        if s["ttft_p99_s"] is None or s["ttft_p99_s"] > s["ttft_p99_bound_s"]:
            failures.append(
                f"TTFT p99 {s['ttft_p99_s']} above bound "
                f"{s['ttft_p99_bound_s']}s"
            )
        if s["migrations_out_total"] < 1:
            failures.append("no live migration happened during the cycle")
        if s["migrations_in_total"] < sum(d["moved"] for d in s["drains"]):
            failures.append(
                f"migrations in {s['migrations_in_total']} < evacuated "
                f"{sum(d['moved'] for d in s['drains'])}"
            )
        if s["session_repins_total"] < 1:
            failures.append("router never spliced a migrated stream")
        if s["splice_failures_total"]:
            failures.append(
                f"{s['splice_failures_total']} migration splices failed"
            )
        for d in s["drains"]:
            if d["exit_rc"] != 0:
                failures.append(f"victim {d['victim']} exited rc={d['exit_rc']}")
            if d["residual_running"] or d["residual_migratable"]:
                failures.append(
                    f"victim {d['victim']} exited with work left: {d}"
                )
        for up in s["scale_up"]:
            if up["warm_prefetch_chunks"] <= 0 or up["warm_prefix_hits"] <= 0:
                failures.append(
                    f"scaled-up {up['url']} never warmed: {up}"
                )
            if up["served"] <= 0:
                failures.append(
                    f"scaled-up {up['url']} never took traffic: {up}"
                )
        if failures:
            print("SCALE-CYCLE CHECK FAILED: " + "; ".join(failures))
            return 1
        print("SCALE-CYCLE CHECK PASSED")
        return 0

    if args.scenario == "mixed-class-overload":
        s = run_mixed_class_overload()
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors: {s['errors']}"
            )
        if s["dropped_streams"]:
            failures.append(
                f"{s['dropped_streams']} dropped mid-flight streams: "
                f"{s['dropped_examples']}"
            )
        if s["shed_by_class"].get("batch", 0) < 1:
            failures.append("overload never shed a batch request")
        if s["shed_by_class"].get("interactive", 0):
            failures.append(
                f"{s['shed_by_class']['interactive']} interactive sheds "
                "(the reserve did not hold)"
            )
        if (
            s["interactive_ttft_p99_s"] is None
            or s["interactive_ttft_p99_s"] > s["interactive_ttft_p99_bound_s"]
        ):
            failures.append(
                f"interactive TTFT p99 {s['interactive_ttft_p99_s']} above "
                f"bound {s['interactive_ttft_p99_bound_s']}s"
            )
        if s["latency_protect_decisions"] < 1:
            failures.append(
                "latency protection never preempted a batch stream"
            )
        if s["degraded_migrations_out"] < 1:
            failures.append(
                "no batch stream migrated off the degraded engine"
            )
        if s["splice_failures_total"]:
            failures.append(
                f"{s['splice_failures_total']} migration splices failed"
            )
        if failures:
            print("MIXED-CLASS-OVERLOAD CHECK FAILED: " + "; ".join(failures))
            return 1
        print("MIXED-CLASS-OVERLOAD CHECK PASSED")
        return 0

    if args.scenario == "fabric-outage":
        s = run_fabric_outage()
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors/hangs: "
                f"{s['errors']}"
            )
        if s["fabric_pulled_pages"] <= 0:
            failures.append("no cross-engine fabric pull ever happened")
        if s["fabric_fallbacks"] <= 0:
            failures.append(
                "the fabric outage produced no counted tier fallbacks"
            )
        if failures:
            print("FABRIC-OUTAGE CHECK FAILED: " + "; ".join(failures))
            return 1
        print("FABRIC-OUTAGE CHECK PASSED")
        return 0

    if args.scenario == "directory-restart":
        s = run_directory_restart()
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors/hangs: "
                f"{s['errors']}"
            )
        if s["resident_routes"] <= 0:
            failures.append("router never routed a resident directory hit")
        if s["reborn_generation"] <= s["pre_generation"]:
            failures.append(
                f"reborn engine did not advance its directory generation "
                f"({s['pre_generation']} -> {s['reborn_generation']})"
            )
        if s["republished_chunks"] <= 0:
            failures.append("reborn engine never republished directory entries")
        if s["expired_entries_total"] <= 0:
            failures.append(
                "the restart expired no directory entries (stale claims "
                "were kept)"
            )
        if failures:
            print("DIRECTORY-RESTART CHECK FAILED: " + "; ".join(failures))
            return 1
        print("DIRECTORY-RESTART CHECK PASSED")
        return 0

    if args.scenario == "rolling-restart":
        s = run_rolling_restart()
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors/hangs: "
                f"{s['errors']}"
            )
        for r in s["restarts"]:
            if r["traffic_returned_s"] is None:
                failures.append(
                    f"traffic never returned to reborn {r['url']} within "
                    f"{s['return_window']}s"
                )
            if r["warm_restored_pages"] != s["restore_pages"]:
                failures.append(
                    f"{r['url']} reborn without warm-start surface "
                    f"({r['warm_restored_pages']} != {s['restore_pages']})"
                )
        for d in s["anomaly_dumps"]:
            if not (
                d["parseable"] > 0 and d["sched_events"] > 0
                and d["kv_events"] > 0 and d["crosslinked_trace_ids"] > 0
            ):
                failures.append(
                    f"missing/incomplete sigterm anomaly dump: {d}"
                )
        if failures:
            print("ROLLING-RESTART CHECK FAILED: " + "; ".join(failures))
            return 1
        print("ROLLING-RESTART CHECK PASSED")
        return 0

    if args.scenario == "overload":
        s = run_overload(
            num_requests=args.num_requests or 48,
            retry_budget=args.retry_budget,
        )
        print(json.dumps(s, indent=2))
        failures = []
        if s["non_429_errors"]:
            failures.append(
                f"{s['non_429_errors']} non-429 client errors/hangs"
            )
        if s["missing_retry_after"]:
            failures.append(
                f"{s['missing_retry_after']} 429s without Retry-After"
            )
        for url, peak in s["running_peak"].items():
            if peak is None or peak > s["seats"]:
                failures.append(
                    f"queue depth unbounded on {url}: peak {peak} > "
                    f"{s['seats']} seats"
                )
        for url in s["urls"]:
            if s["circuit_state"].get(url) == OPEN:
                failures.append(f"sheds tripped the breaker for {url}")
        if not any(
            d["parseable"] > 0 and d["sched_events"] > 0
            and d["kv_events"] > 0 and d["crosslinked_trace_ids"] > 0
            for d in s["anomaly_dumps"]
        ):
            failures.append(
                f"no complete shed-burst anomaly dump: {s['anomaly_dumps']}"
            )
        if failures:
            print("OVERLOAD CHECK FAILED: " + "; ".join(failures))
            return 1
        print("OVERLOAD CHECK PASSED")
        return 0

    s = run_chaos(
        num_requests=args.num_requests or 200,
        retry_budget=args.retry_budget,
        ttft_deadline=args.ttft_deadline,
        breaker_threshold=args.breaker_threshold,
    )
    print(json.dumps(s, indent=2))
    failures = []
    if s["client_5xx"]:
        failures.append(f"{s['client_5xx']} client-visible 5xx")
    if s["max_attempts_observed"] > s["retry_budget"]:
        failures.append(
            f"a request used {s['max_attempts_observed']} proxy attempts "
            f"(budget {s['retry_budget']})"
        )
    for label in ("fail_url", "hang_url"):
        if s["circuit_state"].get(s[label]) != OPEN:
            failures.append(f"breaker for {label}={s[label]} is not open")
    if failures:
        print("CHAOS CHECK FAILED: " + "; ".join(failures))
        return 1
    print("CHAOS CHECK PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
