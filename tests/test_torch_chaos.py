"""The port's twin of tests/test_chaos.py: the same chaos tests, with the
same thresholds, over the port's processes only — its fake engine
(production_stack_tpu_torch/testing/fake_engine.py --fail-rate/--hang/
--hang-after-chunks/--fail-first-n), its router, cache server and fleet
controller, driven by scripts/chaos_check_torch.py. As there, the flagship
failover run, overload shedding, the stall/deadline/breaker cases, the
fabric outage, the scale cycle and the mixed-class overload are tier-1; the
two heaviest subprocess-fleet rotations (rolling restart, directory restart)
carry the `slow` marker. One cross-package case puts the JAX package's
router in front of the port's fakes for the flagship run: its status counts
and breaker states must equal the port router's."""

import json
import os
import re
import sys
import time

import pytest
import requests

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "scripts")
)
import chaos_check_torch as chaos_check  # noqa: E402

from production_stack_tpu_torch.router.resilience import OPEN  # noqa: E402
from production_stack_tpu_torch.testing.procs import (  # noqa: E402
    free_port,
    start_proc,
    stop_proc,
    wait_healthy,
)

RUNNING_RE = re.compile(r"vllm:num_requests_running\{[^}]*\} (\d+)")


def _start_fake(extra, model="fake/model"):
    port = free_port()
    proc = start_proc(
        ["-m", "production_stack_tpu_torch.testing.fake_engine",
         "--port", str(port), "--model", model, "--speed", "500"] + extra
    )
    return proc, f"http://127.0.0.1:{port}"


def _start_router(urls, extra):
    port = free_port()
    proc = start_proc([
        "-m", "production_stack_tpu_torch.router.app",
        "--port", str(port),
        "--static-backends", ",".join(urls),
        "--static-models", ",".join(["fake/model"] * len(urls)),
        "--engine-stats-interval", "1",
    ] + extra)
    return proc, f"http://127.0.0.1:{port}"


def _running_count(url: str) -> int:
    m = RUNNING_RE.search(requests.get(f"{url}/metrics", timeout=5).text)
    return int(m.group(1)) if m else -1


_FLAGSHIP = dict(num_requests=200, retry_budget=3, ttft_deadline=1.0, breaker_threshold=3)


@pytest.fixture(scope="module")
def port_chaos_run():
    """The flagship run through the port's router, shared by its acceptance
    test and the cross-package comparison."""
    return chaos_check.run_chaos(**_FLAGSHIP)


def test_chaos_run_zero_client_5xx(port_chaos_run):
    """Acceptance: three fake engines (one --fail-rate 1.0, one --hang, one
    healthy), a 200-request run completes with zero client-visible 5xx,
    every request's trace shows at most retry_budget proxy attempts, and
    both broken backends' breakers are open at the end."""
    s = port_chaos_run
    assert s["client_5xx"] == 0, s["statuses"]
    assert s["statuses"].get(200, 0) == 200, s["statuses"]
    assert s["traced_requests"] > 0
    assert s["max_attempts_observed"] <= s["retry_budget"], s
    assert s["circuit_state"].get(s["fail_url"]) == OPEN, s["circuit_state"]
    assert s["circuit_state"].get(s["hang_url"]) == OPEN, s["circuit_state"]
    # the healthy backend's breaker (if it ever saw traffic) must be closed
    assert s["circuit_state"].get(s["healthy_url"], 0) != OPEN
    # the run actually exercised the layer
    assert s["retries_total"] > 0
    assert s["failovers_total"] > 0


def _by_role(s):
    """Breaker state of each fake by its fault (ports differ run to run)."""
    return {role: s["circuit_state"].get(s[f"{role}_url"], 0) for role in ("fail", "hang", "healthy")}


def test_jax_router_over_port_fakes_matches_the_port_router(port_chaos_run, monkeypatch):
    """Cross-package: the JAX package's router in front of the port's three
    fakes, with the flagship run's flags, gives the same status counts and
    the same breaker state for each fake as the port's router does, and
    keeps each request inside the retry budget."""
    monkeypatch.setattr(chaos_check, "ROUTER_MODULE", "production_stack_tpu.router.app")
    jax_run = chaos_check.run_chaos(**_FLAGSHIP)
    assert jax_run["statuses"] == port_chaos_run["statuses"], (jax_run["statuses"], port_chaos_run["statuses"])
    assert _by_role(jax_run) == _by_role(port_chaos_run) == {"fail": OPEN, "hang": OPEN, "healthy": 0}
    assert jax_run["max_attempts_observed"] <= jax_run["retry_budget"]
    assert jax_run["traced_requests"] == port_chaos_run["traced_requests"] == 200


def test_overload_sheds_cleanly_with_bounded_queue_depth():
    """Acceptance (overload survival): arrival rate > fleet capacity must
    degrade to clean sheds, not errors — every client response is a 200 or
    a 429 carrying Retry-After (zero 5xx, zero hangs), per-engine in-flight
    depth never exceeds the admission bound, and the shedding engines'
    breakers stay closed (sheds are capacity, not failure, so failover on
    429 must not trip them)."""
    s = chaos_check.run_overload(
        num_requests=48, concurrency=12, seats=3, retry_budget=3,
    )
    assert s["non_429_errors"] == 0, s["statuses"]
    assert s["hangs"] == 0, s
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    # the run actually overloaded the fleet: some requests were shed
    assert s["sheds_total"] > 0, s
    # every shed the client saw carried the retry contract
    assert s["missing_retry_after"] == 0, s
    # bounded queue depth: admission control held the in-flight line (a
    # missing peak metric is a failure, not a pass)
    for url, peak in s["running_peak"].items():
        assert peak is not None and 0 <= peak <= s["seats"], (url, peak, s)
    # sheds never feed the breaker
    for url in s["urls"]:
        assert s["circuit_state"].get(url, 0) != OPEN, s["circuit_state"]
    # acceptance: the shed burst produced a parseable anomaly
    # dump whose window carries scheduler + KV events, cross-linked to at
    # least one trace id the router also recorded
    assert any(
        d["parseable"] > 0 and d["sched_events"] > 0 and d["kv_events"] > 0
        and d["crosslinked_trace_ids"] > 0
        for d in s["anomaly_dumps"]
    ), s["anomaly_dumps"]


@pytest.mark.slow  # ~25 s subprocess fleet; chaos_run + scale-cycle
# keep fast-suite chaos coverage
def test_rolling_restart_under_load_zero_errors_and_traffic_returns():
    """Acceptance (zero-loss restarts): three engines restarted one
    at a time under sustained load — SIGTERM drain, exit, rebirth on the same
    address advertising a warm restore. Zero client non-429 errors across the
    whole rotation, every engine drains to a clean exit, routed traffic
    returns to each reborn backend within the breaker half-open window, and
    the reborn backends export the warm-start metric surface."""
    s = chaos_check.run_rolling_restart(
        engines=3, workers=6, breaker_cooldown=1.5, return_window=8.0,
        restore_pages=32,
    )
    assert s["non_429_errors"] == 0, s["errors"]
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    assert len(s["restarts"]) == 3
    for r in s["restarts"]:
        # SIGTERM drained to a clean exit (no in-flight stream was cut)
        assert r["exit_rc"] == 0, r
        # the reborn backend re-entered rotation inside the half-open window
        assert r["traffic_returned_s"] is not None, r
        assert r["traffic_returned_s"] <= s["return_window"], r
        # warm-start surface present on the reborn process
        assert r["warm_restored_pages"] == 32, r
    # acceptance: every rotated engine's SIGTERM drain left a
    # parseable flight-recorder dump with the pre-restart scheduler + KV
    # window, cross-linked to router-recorded trace ids
    for d in s["anomaly_dumps"]:
        assert d["parseable"] > 0, d
        assert d["sched_events"] > 0 and d["kv_events"] > 0, d
        assert d["crosslinked_trace_ids"] > 0, d


@pytest.mark.slow  # ~25 s subprocess fleet; directory expiry logic is
# unit-covered in test_kvdirectory
def test_directory_restart_expires_stale_claims_with_zero_routing_errors():
    """Acceptance (fleet-wide KV directory): a KV-aware-v2 router
    over three directory-publishing fake engines and a directory-hosting
    cache server; one engine SIGTERM'd mid-load and reborn on the same
    address. Zero client non-429 errors across the rotation, the router
    actually routed by directory class (resident hits), the restart expired
    the dead incarnation's claims (generation fencing / TTL), and the reborn
    engine re-registered under a higher generation and republished."""
    s = chaos_check.run_directory_restart()
    assert s["non_429_errors"] == 0, s["errors"]
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    assert s["victim_exit_rc"] == 0, s
    # the run exercised directory ranking, not just the fallback trie
    assert s["resident_routes"] > 0, s
    # stale-claim hygiene: the dead incarnation's entries expired...
    assert s["expired_entries_total"] > 0, s
    # ...and the reborn process fenced them with a strictly higher
    # generation, then earned entries back
    assert s["reborn_generation"] > s["pre_generation"], s
    assert s["republished_chunks"] > 0, s


def test_fabric_outage_falls_back_to_tier_with_zero_errors():
    """Acceptance (peer-to-peer KV fabric, docs/kv-fabric.md):
    three fabric-enabled fake engines behind a round-robin router cross-pull
    each other's published chains over the fabric in real wire frames; the
    victim's fabric listener is killed mid-load (POST /fabric_down) while
    its HTTP plane keeps serving. Clients never notice — zero non-429
    errors — because every failed fabric fetch degrades to the shared-tier
    path, and the degradation is COUNTED (vllm:kv_fabric_fallbacks_total),
    not silent."""
    s = chaos_check.run_fabric_outage()
    assert s["non_429_errors"] == 0, s["errors"]
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    # the fleet really moved pages engine-to-engine before (and around) the
    # outage — the scenario is meaningless if nothing ever pulled
    assert s["fabric_pulled_pages"] > 0, s
    assert s["fabric_served_pages"] > 0, s
    # the downed listener produced counted tier fallbacks on its peers
    assert s["fabric_fallbacks"] > 0, s


def test_scale_cycle_zero_loss_with_migration_and_warm_prefetch():
    """Acceptance (live migration + fleet control): 2 -> 4 -> 2
    engines under sustained streaming load. Zero non-429 client errors,
    zero dropped mid-flight streams (every started SSE stream reaches
    [DONE] with its full token count — live-migrated, router-spliced
    streams included), bounded TTFT p99, every drained engine evacuates all
    in-flight sequences before a clean exit, and each scaled-up engine
    pulls fleet-warm chunks via directory prefetch and serves warm prefix
    hits from its first requests.

    The whole cycle runs against a SHARDED-engine fleet: every
    fake advertises tensor_parallel=4, so router scraping, migration, and
    directory-driven warm-start are proven insensitive to the serving-mesh
    shape, and the advert round-trips engine -> router scrape (the shard
    gather/scatter of real page blobs at the serde boundary is covered by
    tests/test_kvoffload.py::TestShardBoundary and test_tp_serving)."""
    s = chaos_check.run_scale_cycle(tensor_parallel=4)
    assert s["non_429_errors"] == 0, s["errors"]
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    assert s["dropped_streams"] == 0, s["dropped_examples"]
    assert s["ttft_p99_s"] is not None
    assert s["ttft_p99_s"] <= s["ttft_p99_bound_s"], s["ttft_p99_s"]
    # zero-loss scale-down: both victims evacuated everything and exited 0
    assert len(s["drains"]) == 2
    for d in s["drains"]:
        assert d["exit_rc"] == 0, d
        assert d["residual_running"] == 0 and d["residual_migratable"] == 0, d
    # live migration actually carried streams across the cycle, and the
    # router spliced every handoff without a failure
    assert s["migrations_out_total"] >= 1, s
    assert s["migrations_in_total"] >= sum(d["moved"] for d in s["drains"]), s
    assert s["session_repins_total"] >= 1, s
    assert s["splice_failures_total"] == 0, s
    # directory-driven scale-up warm-up: prefetch + first-request warm hits
    assert len(s["scale_up"]) == 2
    for up in s["scale_up"]:
        assert up["served"] > 0, up
        assert up["warm_prefetch_chunks"] > 0, up
        assert up["warm_prefix_hits"] > 0, up
    # sharded-fleet advert round trip: every surviving engine advertises
    # tp=4 on its own /metrics, and the router's scraper surfaced the same
    # degree (what the fleet controller's capacity math reads — a tp=4
    # engine is ONE replica on 4 chips, not 4x the seats)
    assert s["engine_advertised_tp"], s
    for url, tp in s["engine_advertised_tp"].items():
        assert tp == 4, (url, tp)
    assert s["router_scraped_tp"], "router never scraped the tp gauge"
    for url, tp in s["router_scraped_tp"].items():
        assert tp == 4, (url, tp)


def test_mixed_class_overload_sheds_batch_first_and_preempts_batch():
    """Acceptance (multi-tenant SLO classes): a mixed
    interactive/batch load past fleet capacity against two class-aware
    fakes (interactive admission reserve) — one injecting an interactive
    SLO degradation so the fleet controller's latency protection engages.
    Zero non-429 client errors; every engine-level shed landed on the
    batch class (interactive sheds == 0 — the reserve held under
    overload); interactive TTFT p99 stays bounded; the controller issued
    at least one latency_protect decision that migrated a batch stream
    off the degraded engine; and zero streams dropped — the preempted
    batch stream was spliced onto the peer with its full token count,
    never cut."""
    s = chaos_check.run_mixed_class_overload()
    assert s["non_429_errors"] == 0, s["errors"]
    assert s["statuses"].get(200, 0) > 0, s["statuses"]
    assert s["dropped_streams"] == 0, s["dropped_examples"]
    # the overload was real, and class-aware: the fleet shed batch first
    # and the interactive reserve kept the interactive class whole
    assert s["shed_by_class"].get("batch", 0) >= 1, s["shed_by_class"]
    assert s["shed_by_class"].get("interactive", 0) == 0, s["shed_by_class"]
    # both classes actually served (the scenario is meaningless otherwise)
    assert s["served_by_class"].get("interactive", 0) > 0, s["served_by_class"]
    assert s["served_by_class"].get("batch", 0) > 0, s["served_by_class"]
    # the router tagged and counted both classes end-to-end
    assert s["router_requests_by_class"].get("interactive", 0) > 0, s
    assert s["router_requests_by_class"].get("batch", 0) > 0, s
    # interactive latency held while batch was shed/preempted around it
    assert s["interactive_ttft_p99_s"] is not None, s
    assert (
        s["interactive_ttft_p99_s"] <= s["interactive_ttft_p99_bound_s"]
    ), s["interactive_ttft_p99_s"]
    # latency protection preempted >= 1 batch stream off the degraded
    # engine, and the router spliced the handoff without loss
    assert s["latency_protect_decisions"] >= 1, s["controller_decisions"]
    assert s["degraded_migrations_out"] >= 1, s
    assert s["peer_migrations_in"] >= 1, s
    assert s["splice_failures_total"] == 0, s


def test_inter_chunk_stall_aborts_engine_and_sends_sse_error():
    """Acceptance: a stream stalled past the inter-chunk timeout is aborted
    on the engine (scheduler slot freed, verified via /metrics running-count)
    and the client receives a terminal SSE error event, not a silent
    truncation (and no [DONE], so truncation is distinguishable)."""
    fake, fake_url = _start_fake(["--hang-after-chunks", "2"])
    router = None
    try:
        wait_healthy(f"{fake_url}/health", fake, timeout=30)
        router, base = _start_router(
            [fake_url], ["--deadline-inter-chunk", "0.5"]
        )
        wait_healthy(f"{base}/health", router, timeout=30)
        r = requests.post(
            f"{base}/v1/chat/completions",
            json={"model": "fake/model",
                  "messages": [{"role": "user", "content": "hi"}],
                  "max_tokens": 16, "stream": True},
            stream=True, timeout=30,
        )
        assert r.status_code == 200
        lines = [l for l in r.iter_lines() if l.startswith(b"data: ")]
        assert lines, "no SSE events received"
        last = json.loads(lines[-1][len(b"data: "):])
        assert "error" in last, lines[-1]
        assert "stall" in last["error"]["message"]
        assert last["error"]["type"] == "upstream_error"
        assert not any(b"[DONE]" in l for l in lines)
        # at least one real content chunk preceded the stall
        assert any(b"choices" in l for l in lines[:-1])
        # the engine-side abort freed the scheduler slot
        deadline = time.time() + 5
        while time.time() < deadline and _running_count(fake_url) != 0:
            time.sleep(0.1)
        assert _running_count(fake_url) == 0
    finally:
        if router is not None:
            stop_proc(router)
        stop_proc(fake)


def test_ttft_deadline_fails_over_from_hung_engine_and_frees_slot():
    """A hung engine (accepts the request, never responds) is abandoned at
    the TTFT deadline, aborted engine-side, and the request fails over to
    the healthy replica — the client sees a clean 200."""
    hung, hung_url = _start_fake(["--hang"])
    healthy, healthy_url = _start_fake([])
    router = None
    try:
        wait_healthy(f"{hung_url}/health", hung, timeout=30)
        wait_healthy(f"{healthy_url}/health", healthy, timeout=30)
        router, base = _start_router(
            [hung_url, healthy_url],
            ["--deadline-ttft", "0.5", "--retry-backoff-base", "0.01"],
        )
        wait_healthy(f"{base}/health", router, timeout=30)
        for _ in range(4):
            r = requests.post(
                f"{base}/v1/completions",
                json={"model": "fake/model", "prompt": "x", "max_tokens": 2},
                timeout=30,
            )
            assert r.status_code == 200, r.text
        deadline = time.time() + 5
        while time.time() < deadline and _running_count(hung_url) != 0:
            time.sleep(0.1)
        assert _running_count(hung_url) == 0, "abort did not free the hung slot"
    finally:
        if router is not None:
            stop_proc(router)
        stop_proc(hung)
        stop_proc(healthy)


def test_fail_n_then_recover_closes_breaker_again():
    """fail-N-then-recover: the backend 500s its first N requests (breaker
    opens), recovers, and after the cooldown a half-open probe closes the
    breaker — traffic returns without a restart."""
    # fail-first-n == breaker threshold: the breaker opens exactly as the
    # backend recovers, so the first half-open probe succeeds
    flaky, flaky_url = _start_fake(["--fail-first-n", "2"])
    healthy, healthy_url = _start_fake([])
    router = None
    try:
        wait_healthy(f"{flaky_url}/health", flaky, timeout=30)
        wait_healthy(f"{healthy_url}/health", healthy, timeout=30)
        router, base = _start_router(
            [flaky_url, healthy_url],
            ["--breaker-failure-threshold", "2",
             "--breaker-cooldown", "1",
             "--retry-backoff-base", "0.01"],
        )
        wait_healthy(f"{base}/health", router, timeout=30)
        for _ in range(8):
            r = requests.post(
                f"{base}/v1/completions",
                json={"model": "fake/model", "prompt": "x", "max_tokens": 2},
                timeout=30,
            )
            assert r.status_code == 200, r.text
        # wait out the cooldown, then drive enough traffic that a half-open
        # probe lands on the recovered backend and closes its breaker
        time.sleep(1.2)
        for _ in range(8):
            assert requests.post(
                f"{base}/v1/completions",
                json={"model": "fake/model", "prompt": "x", "max_tokens": 2},
                timeout=30,
            ).status_code == 200
        metrics = requests.get(f"{base}/metrics", timeout=5).text
        m = re.search(
            rf'vllm_router:circuit_state\{{backend="{re.escape(flaky_url)}"\}} (\d+)',
            metrics,
        )
        assert m, metrics
        assert int(m.group(1)) != OPEN
    finally:
        if router is not None:
            stop_proc(router)
        stop_proc(flaky)
        stop_proc(healthy)


def test_kv_directory_report_json_matches_the_jax_script():
    """scripts/kv_directory_report_torch.py --json, against a port cache
    server holding a known directory (two engines, a resident chain, shared
    claims backed by blobs, one withdrawal), prints what
    scripts/kv_directory_report.py prints for the same directory."""
    import subprocess

    from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
    from production_stack_tpu_torch.kvoffload.protocol import BlockingClient
    from production_stack_tpu_torch.kvoffload.serde import seal_bytes
    from production_stack_tpu_torch.testing.procs import REPO_ROOT, cpu_env

    port = free_port()
    cache = start_proc(["-m", "production_stack_tpu_torch.kvoffload.cache_server", "--port", str(port),
                        "--host", "127.0.0.1", "--directory", "--directory-engine-timeout", "600"])
    try:
        deadline = time.time() + 30
        client = BlockingClient("127.0.0.1", port, timeout=5)
        while True:
            assert cache.poll() is None and time.time() < deadline, cache.stdout.read()[-2000:]
            try:
                client.request({"op": "ping"})
                break
            except OSError:
                time.sleep(0.2)
        chain = [h.hex() for h in prefix_hashes(list(range(16 * 5)), 16)]
        for url, gen, n in (("http://10.0.0.1:8100", 7, 5), ("http://10.0.0.2:8100", 9, 3)):
            client.request({"op": "dir_register", "url": url, "page_size": 16, "generation": gen})
            entries = [[h, d, 1.0] for d, h in enumerate(chain[:n])]
            client.request({"op": "dir_publish", "url": url, "generation": gen, "tier": "hbm", "page_size": 16,
                            "entries": entries})
        for h in chain[:2]:
            client.request({"op": "put", "key": h}, seal_bytes(b"kv", kind="page"))
        client.request({"op": "dir_publish", "url": "http://10.0.0.2:8100", "generation": 9, "tier": "shared",
                        "page_size": 16, "entries": [[h, d, 1.0] for d, h in enumerate(chain[:2])]})
        client.request({"op": "dir_withdraw", "url": "http://10.0.0.1:8100", "hashes": chain[4:], "scope": "all"})
        client.close()
        dumps = []
        for script in ("scripts/kv_directory_report_torch.py", "scripts/kv_directory_report.py"):
            out = subprocess.run([sys.executable, script, "--url", f"127.0.0.1:{port}", "--json"], cwd=REPO_ROOT,
                                 env=cpu_env(), capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
            dumps.append(json.loads(out.stdout))
    finally:
        stop_proc(cache)
    port_dump, jax_dump = dumps
    assert port_dump == jax_dump
    engines = port_dump["engines"]
    assert engines["http://10.0.0.1:8100"]["resident_chunks"] == 4
    assert engines["http://10.0.0.2:8100"]["resident_chunks"] == 3
    assert engines["http://10.0.0.2:8100"]["shared_chunks"] == 2
    assert engines["http://10.0.0.2:8100"]["generation"] == 9
    assert port_dump["depth_histogram"] == {"0": 2, "1": 2, "2": 2, "3": 1}
    assert port_dump["cache_server"]["entries"] == 2
