"""The metrics-coverage guard for the port (scripts/check_metrics_coverage.py
scans only the JAX package): a CPU port server's ``/metrics``, after one
streamed request, held in both directions against the dashboards and docs.

1. Every series the port emits (a disaggregated-prefill consumer and
   producer with the fabric on, in a fleet with the KV directory, and the
   port cache server's ``--metrics-port`` page) is documented (docs/ or
   README.md) and dashboarded, or in the script's own DASHBOARD_ALLOWLIST.
2. Every ``vllm:`` series the JAX package emits that the dashboards chart or
   the allowlist names is emitted by the port, unless it belongs to a
   feature the port refuses (listed below by name, beside the
   ``engine/config._UNSUPPORTED`` switch that refuses it, or the part of the
   JAX package with no switch in the port), to a setting both servers emit
   it at only (speculative decoding's series), or to another process than
   the engine and the cache server (the fleet controller, which stays the
   JAX package's).
3. A port server at decode_pipeline 4 and one at speculative_k 2 give the
   chained and speculative series and /stats keys a JAX server gives at the
   same settings.
"""

import asyncio
import os
import re
import sys
import threading

import aiohttp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "scripts"))
import check_metrics_coverage as cmc  # noqa: E402

from production_stack_tpu.engine import api_server as jax_server  # noqa: E402
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig  # noqa: E402
from production_stack_tpu_torch.testing.procs import free_port  # noqa: E402
from production_stack_tpu_torch.engine import api_server as port_server  # noqa: E402
from production_stack_tpu_torch.engine.config import _UNSUPPORTED, EngineConfig  # noqa: E402
from production_stack_tpu_torch.engine.engine import LLMEngine  # noqa: E402
from production_stack_tpu_torch.kvoffload import cache_server  # noqa: E402

_DIRECTORY = ("kv_directory_publishes_total", "kv_directory_withdrawals_total", "kv_directory_flush_errors_total",
              "kv_directory_lookups_total", "kv_directory_lookup_hits_total", "kv_directory_pulled_pages_total",
              "kv_directory_prefetched_pages_total")
_FABRIC = ("kv_fabric_breaker_opens_total", "kv_fabric_corrupt_frames_total", "kv_fabric_fallbacks_total",
           "kv_fabric_peer_bandwidth_bytes_per_sec", "kv_fabric_peer_probes_total", "kv_fabric_pulled_pages_total",
           "kv_fabric_pushed_pages_total", "kv_fabric_queue_depth", "kv_fabric_received_pages_total",
           "kv_fabric_served_pages_total", "kv_fabric_stale_generation_pulls_total")
_TRANSFER = ("kv_transfer_received_bytes_total", "kv_transfer_received_chunks_total", "kv_transfer_sent_bytes_total",
             "kv_transfer_sent_chunks_total", "kv_transfer_cap_evicted_offers_total", "kv_transfer_device_pages_total",
             "kv_transfer_leaked_offers_total", "kv_transfer_pinned_offer_bytes",
             "kv_offload_device_loaded_pages_total")
_WARM = ("warm_start_fenced", "warm_start_generation", "warm_start_manifest_age_seconds",
         "warm_start_restored_pages", "warm_start_spilled_pages_total", "warm_start_stale_manifests_skipped_total")
_CHAINED = ("decode_chained_dispatches_total", "runahead_prefill_dispatches_total",
            "engine_loop_chain_dispatch_seconds_total", "engine_loop_chain_fetch_seconds_total")
_SPEC = ("spec_decode_draft_acceptance_rate", "spec_decode_num_accepted_tokens_total",
         "spec_decode_num_draft_tokens_total")
_MIGRATION = ("migration_duration_seconds", "migration_failures_total", "migration_pages_moved_total",
              "migrations_in_total", "migrations_out_total")

# series of refused features -> the port's switch that refuses them (the
# fixture's servers emit the series of every feature the port serves)
REFUSED: dict = {}
# series both servers emit only at a setting other than the default
SETTING_ONLY = {f"vllm:{n}": "speculative_k" for n in _SPEC}
# series of JAX features the port has no switch for: not ported, and nothing
# to refuse
NOT_PORTED: dict = {}
# series other processes than the engine and the cache server emit (the
# fleet controller stays the JAX package's: the port's engines serve it)
OTHER_PROCESS = {
    "vllm:fleet_controller_decisions_total": "the fleet controller",
    "vllm:fleet_controller_fleet_saturation": "the fleet controller",
    "vllm:fleet_controller_migrations_started_total": "the fleet controller",
    "vllm:fleet_controller_migrations_failed_total": "the fleet controller",
    "vllm:fleet_controller_migrations_inflight": "the fleet controller",
}
# the KV directory service's own series, on the port cache server's
# --metrics-port page
_DIRECTORY_SERVICE = ("kv_directory_engines", "kv_directory_entries", "kv_directory_expired_entries_total",
                      "kv_directory_stale_hits_total")


@pytest.fixture(scope="module")
def port_series() -> set:
    """Every series name two port servers' /metrics give after one streamed
    request, and the port cache server's metrics page: a disaggregated-
    prefill consumer (the CPU tier, warm start, the fabric, the fleet
    directory with boot prefetch, and a measured link: the CPU has none to
    probe, so the figure is set by hand) and its producer, both with the
    device path armed on a stand-in endpoint (tests/test_torch_disagg.py;
    the CPU has no CUDA IPC), and the cache server hosting the directory."""
    from test_torch_disagg import _arm

    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    cport, mport = free_port(), free_port()
    asyncio.run_coroutine_threadsafe(
        cache_server.serve("127.0.0.1", cport, 1 << 24, directory=True, metrics_port=mport), loop).result(30)
    directory = dict(kv_remote_url=f"127.0.0.1:{cport}", kv_directory_url=f"127.0.0.1:{cport}",
                     warm_prefetch_on_boot=4)
    ccfg = EngineConfig(model="llama-debug", host="127.0.0.1", port=free_port(), num_pages=16, page_size=8,
                        max_model_len=128, prefill_chunk=32, kv_offload_cpu_gb=0.01, kv_offload_max_io_pages=4,
                        warm_start=True, kv_role="consumer", kv_transfer_port=0, kv_fabric=True, **directory)
    consumer = LLMEngine(ccfg, device="cpu")
    consumer.kv_link_bandwidth_bytes_per_s = 1e9
    pcfg = EngineConfig(model="llama-debug", host="127.0.0.1", port=free_port(), num_pages=16, page_size=8,
                        max_model_len=128, prefill_chunk=32, kv_role="producer", kv_fabric=True,
                        kv_peer_url=f"127.0.0.1:{consumer._kv_receiver.bound_port}",
                        kv_fabric_peer=consumer._fabric_server.address)
    producer = LLMEngine(pcfg, device="cpu")
    for eng in (consumer, producer):
        _arm(eng)

    async def scrape():
        served = [await port_server.serve(cfg, eng, device="cpu") for cfg, eng in ((ccfg, consumer), (pcfg, producer))]
        try:
            texts = []
            async with aiohttp.ClientSession() as s:
                for cfg in (pcfg, ccfg):  # the producer's prefill, then the consumer's request
                    base = f"http://127.0.0.1:{cfg.port}"
                    body = {"prompt": "hello, a prompt of two pages", "max_tokens": 4, "stream": True,
                            "ignore_eos": True}
                    async with s.post(base + "/v1/completions", json=body) as r:
                        assert r.status == 200
                        await r.read()
                for base in (f"http://127.0.0.1:{ccfg.port}", f"http://127.0.0.1:{pcfg.port}",
                             f"http://127.0.0.1:{mport}"):
                    async with s.get(f"{base}/metrics") as r:
                        texts.append(await r.text())
            return texts
        finally:
            for server, runner in served:
                await runner.cleanup()
                server.engine.stop()

    try:
        texts = asyncio.run_coroutine_threadsafe(scrape(), loop).result(120)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)
    return {line.split()[2] for text in texts for line in text.splitlines() if line.startswith("# TYPE ")}


def test_every_port_series_is_documented_and_dashboarded(port_series):
    dashboards, docs = cmc.coverage_texts()
    assert len(port_series) > 60
    undocumented = sorted(n for n in port_series if n not in docs)
    undashboarded = sorted(n for n in port_series if n not in dashboards and n not in cmc.DASHBOARD_ALLOWLIST)
    assert not undocumented and not undashboarded, (undocumented, undashboarded)


def test_every_charted_jax_series_of_a_served_feature_is_emitted_by_the_port(port_series):
    dashboards, _ = cmc.coverage_texts()
    jax_series = {n for n in cmc.emitted_metrics() if n.startswith("vllm:")}
    charted = set(cmc.METRIC_RE.findall(dashboards)) | cmc.DASHBOARD_ALLOWLIST
    missing = (jax_series & charted) - port_series
    assert missing == set(REFUSED) | set(NOT_PORTED) | set(OTHER_PROCESS) | set(SETTING_ONLY)
    assert not port_series & (set(REFUSED) | set(NOT_PORTED) | set(OTHER_PROCESS) | set(SETTING_ONLY))
    assert set(REFUSED.values()) <= set(_UNSUPPORTED)
    assert not set(SETTING_ONLY.values()) & set(_UNSUPPORTED)
    assert {f"vllm:{n}" for n in _CHAINED} <= port_series
    assert {f"vllm:{n}" for n in _WARM} <= port_series
    assert {f"vllm:{n}" for n in _FABRIC + _TRANSFER} <= port_series  # both groups, from a role with the fabric on
    # the fleet directory (the engine's side and the cache server's page)
    # and live migration, served now
    assert {f"vllm:{n}" for n in _DIRECTORY + _DIRECTORY_SERVICE + _MIGRATION} <= port_series
    assert {"vllm:trace_buffer_capacity", "vllm:trace_spans_dropped_total",
            "vllm:trace_spans_recorded_total"} <= port_series
    for name in ("vllm:tpu_hbm_bytes_in_use", "vllm:hbm_headroom_bytes", "vllm:kv_pool_device_bytes",
                 "vllm:compile_seconds_total", "vllm:request_queue_time_seconds", "vllm:prefill_chunk_seconds",
                 "vllm:interleaved_decode_step_seconds", "vllm:engine_saturated_batch",
                 "vllm:interactive_ttft_p99_ms", "vllm:tensor_parallel_degree", "vllm:kv_pool_shard_bytes"):
        assert name in port_series


# the JAX engine's /stats keys of chained and speculative decode
# (production_stack_tpu/engine/engine.py stats())
CHAIN_STATS = ("decode_chained_dispatches_total", "runahead_prefill_dispatches_total",
               "engine_loop_chain_dispatch_seconds_total", "engine_loop_chain_fetch_seconds_total")
SPEC_STATS = ("spec_decode_num_draft_tokens_total", "spec_decode_num_accepted_tokens_total",
              "spec_decode_draft_acceptance_rate")
_NEW = re.compile(r"^vllm:(spec_decode_|decode_chained|runahead_|engine_loop_chain_)")


@pytest.mark.parametrize("setting,keys", [({"decode_pipeline": 4}, CHAIN_STATS),
                                          ({"speculative_k": 2}, CHAIN_STATS + SPEC_STATS)],
                         ids=["decode_pipeline", "speculative_k"])
def test_chained_and_spec_servers_expose_the_jax_servers_series_and_stats(setting, keys):
    """After one greedy request, a port server and a JAX server at the same
    setting: the same chained and speculative ``vllm:`` series, and /stats
    with the JAX engine's keys of both features."""
    small = dict(model="llama-debug", host="127.0.0.1", num_pages=32, page_size=8, max_model_len=128,
                 prefill_chunk=32, decode_steps=2, **setting)

    async def scrape(server_mod, cfg, engine=None):
        srv, run = await (server_mod.serve(cfg, engine, device="cpu") if engine else server_mod.serve(cfg))
        try:
            base = f"http://127.0.0.1:{cfg.port}"
            async with aiohttp.ClientSession() as s:
                body = {"prompt": "ab ab ab ab", "max_tokens": 12, "temperature": 0.0, "ignore_eos": True}
                async with s.post(base + "/v1/completions", json=body) as r:
                    assert r.status == 200
                async with s.get(base + "/metrics") as r:
                    text = await r.text()
                async with s.get(base + "/stats") as r:
                    stats = await r.json()
        finally:
            await run.cleanup()
            srv.engine.stop()
        names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
        return {n for n in names if _NEW.match(n)}, stats

    async def both():
        pcfg = EngineConfig(**small, port=free_port())
        port = await scrape(port_server, pcfg, LLMEngine(pcfg, device="cpu"))
        jax = await scrape(jax_server, JaxEngineConfig(**small, port=free_port()))
        return port, jax

    (pnames, pstats), (jnames, jstats) = asyncio.run(both())
    assert pnames == jnames and {f"vllm:{k}" for k in keys} <= pnames
    assert {k for k in keys if k in pstats} == {k for k in keys if k in jstats} == set(keys)
    if "speculative_k" in setting:
        assert pstats["spec_decode_num_draft_tokens_total"] > 0
        assert 0.0 <= pstats["spec_decode_draft_acceptance_rate"] <= 1.0
