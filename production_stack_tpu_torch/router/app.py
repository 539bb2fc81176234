"""Router application: bootstrap + HTTP surface.

The port's copy of ``production_stack_tpu/router/app.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/app.py (initialize_all :107-242, main :265-285) and
routers/main_router.py + metrics_router.py + files_router.py +
batches_router.py of the upstream vLLM production stack. aiohttp replaces FastAPI/uvicorn.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

import psutil
from aiohttp import web

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.router import batch_service, files_service
from production_stack_tpu_torch.router.callbacks import get_callbacks, load_callbacks
from production_stack_tpu_torch.router.dynamic_config import DynamicConfigWatcher
from production_stack_tpu_torch.router.engine_stats import (
    get_engine_stats_scraper,
    initialize_engine_stats_scraper,
)
from production_stack_tpu_torch.router.feature_gates import get_feature_gates, initialize_feature_gates
from production_stack_tpu_torch.router.parser import parse_args
from production_stack_tpu_torch.router.request_service import (
    close_client_session,
    route_general_request,
    route_sleep_wakeup_request,
)
from production_stack_tpu_torch.router.resilience import (
    initialize_resilience,
    render_resilience_metrics,
)
from production_stack_tpu_torch.router.request_stats import (
    get_request_stats_monitor,
    initialize_request_stats_monitor,
)
from production_stack_tpu_torch.router.routing_logic import initialize_routing_logic
from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
    initialize_service_discovery,
)
from production_stack_tpu_torch.router.utils import parse_comma_separated, set_ulimit
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class RouterApp:
    def __init__(self, args):
        self.args = args
        self.model_aliases: Optional[dict] = (
            json.loads(args.model_aliases) if args.model_aliases else None
        )
        self._bg: list = []
        self.semantic_cache = None
        self.pii_analyzer = None
        # graceful drain: health flips 503 (LB pulls the pod) while aiohttp's
        # shutdown drains in-flight streaming proxies
        self.draining = False

    # -- bootstrap (parity app.py:initialize_all) ---------------------------

    async def initialize_all(self) -> None:
        args = self.args
        if getattr(args, "sentry_dsn", None):
            # error reporting parity (reference app.py:118-119). The SDK is
            # optional in this environment; the flag degrades gracefully.
            try:
                import sentry_sdk

                sentry_sdk.init(dsn=args.sentry_dsn, traces_sample_rate=0.1)
                logger.info("sentry error reporting initialized")
            except ImportError:
                logger.warning(
                    "--sentry-dsn set but sentry_sdk is not installed; "
                    "error reporting disabled"
                )
            except Exception as e:  # noqa: BLE001 - e.g. BadDsn
                # a typo'd DSN must not crash-loop the router pod
                logger.warning("sentry init failed (%s); error reporting disabled", e)
        if args.service_discovery == "static":
            sd = initialize_service_discovery(
                "static",
                urls=parse_comma_separated(args.static_backends),
                models=parse_comma_separated(args.static_models),
                aliases=parse_comma_separated(args.static_aliases) or None,
                model_labels=parse_comma_separated(args.static_model_labels) or None,
                model_types=parse_comma_separated(args.static_model_types) or None,
                static_backend_health_checks=args.static_backend_health_checks,
                health_check_interval=args.health_check_interval,
            )
        else:
            sd = initialize_service_discovery(
                "k8s",
                namespace=args.k8s_namespace,
                label_selector=args.k8s_label_selector,
                port=args.k8s_port,
                prefill_model_labels=parse_comma_separated(args.prefill_model_labels),
                decode_model_labels=parse_comma_separated(args.decode_model_labels),
            )
        await sd.start()
        initialize_resilience(
            retry_max_attempts=getattr(args, "retry_max_attempts", 3),
            retry_backoff_base=getattr(args, "retry_backoff_base", 0.05),
            retry_backoff_max=getattr(args, "retry_backoff_max", 2.0),
            deadline_request=getattr(args, "deadline_request", 0.0),
            deadline_ttft=getattr(args, "deadline_ttft", 0.0),
            deadline_inter_chunk=getattr(args, "deadline_inter_chunk", 0.0),
            breaker_failure_threshold=getattr(args, "breaker_failure_threshold", 5),
            breaker_cooldown=getattr(args, "breaker_cooldown", 30.0),
        )
        scraper = initialize_engine_stats_scraper(args.engine_stats_interval)
        await scraper.start()
        initialize_request_stats_monitor(args.request_stats_window)
        from production_stack_tpu_torch.router.slo import initialize_slo_monitor

        initialize_slo_monitor(
            ttft_ms=getattr(args, "slo_ttft_ms", 2000.0),
            itl_ms=getattr(args, "slo_itl_ms", 200.0),
            saturation_queue_ref=getattr(args, "saturation_queue_ref", 8),
        )
        from production_stack_tpu_torch.router.request_service import (
            set_batch_avoid_attainment,
        )

        set_batch_avoid_attainment(
            getattr(args, "batch_avoid_attainment", 0.9)
        )
        initialize_routing_logic(
            args.routing_logic,
            session_key=args.session_key,
            kv_controller_url=args.kv_controller_url,
            kv_directory_url=getattr(args, "kv_directory_url", None),
            tokenizer_path=args.tokenizer,
            prefill_model_labels=parse_comma_separated(args.prefill_model_labels),
            decode_model_labels=parse_comma_separated(args.decode_model_labels),
        )
        if args.callbacks:
            load_callbacks(args.callbacks)
        initialize_feature_gates(args.feature_gates)
        from production_stack_tpu_torch.tracing import configure_tracing

        configure_tracing(
            sample_rate=getattr(args, "trace_sample_rate", 1.0),
            capacity=getattr(args, "trace_buffer_size", None),
        )
        if get_feature_gates().is_enabled("SemanticCache"):
            from production_stack_tpu_torch.router import semantic_cache as sc

            choice = getattr(args, "semantic_cache_embedder", "auto")
            if choice == "ngram":
                embed = sc.ngram_hash_embed
            elif choice == "sentence-transformers":
                embed = sc.SentenceTransformerEmbedder()  # raises if absent
            else:  # auto: real encoder when installed + cached, else n-grams
                embed = None
            self.semantic_cache = sc.SemanticCache(
                threshold=args.semantic_cache_threshold, embed=embed
            )
        if get_feature_gates().is_enabled("PIIDetection"):
            from production_stack_tpu_torch.router.pii import make_analyzer

            # built ONCE at startup: the Presidio tier loads an NER model —
            # seconds of work that must not land on the first request
            self.pii_analyzer = make_analyzer(
                getattr(args, "pii_analyzer", "auto")
            )
        files_service.initialize_storage(args.file_storage_path)
        if args.enable_batch_api:
            proc = batch_service.initialize_batch_processor(
                args.batch_db_path,
                files_service.get_storage(),
                f"http://127.0.0.1:{args.port}",
            )
            await proc.start()
        if args.dynamic_config_json:
            watcher = DynamicConfigWatcher(args.dynamic_config_json)
            await watcher.start()
        if args.log_stats:
            self._bg.append(asyncio.create_task(self._log_stats_loop()))

    async def _log_stats_loop(self) -> None:
        """Periodic human-readable stats dump (parity stats/log_stats.py:37-115)."""
        while True:
            await asyncio.sleep(self.args.log_stats_interval)
            try:
                stats = get_request_stats_monitor().get_request_stats()
                engine = get_engine_stats_scraper().get_engine_stats()
                lines = ["", "==================== Router Stats ===================="]
                for url in sorted(set(stats) | set(engine)):
                    rs = stats.get(url)
                    es = engine.get(url)
                    lines.append(f"  {url}:")
                    if rs:
                        lines.append(
                            f"    qps={rs.qps:.2f} ttft={rs.ttft:.3f}s "
                            f"prefill={rs.in_prefill_requests} "
                            f"decode={rs.in_decoding_requests} "
                            f"finished={rs.finished_requests} itl={rs.avg_itl:.4f}"
                        )
                    if es:
                        lines.append(
                            f"    running={es.num_running_requests} "
                            f"waiting={es.num_queuing_requests} "
                            f"kv_usage={es.gpu_cache_usage_perc:.1%} "
                            f"kv_hit_rate={es.gpu_prefix_cache_hit_rate:.1%}"
                        )
                lines.append("======================================================")
                logger.info("\n".join(lines))
            except Exception:
                logger.exception("log stats failed")

    # -- handlers -----------------------------------------------------------

    async def _proxy(self, request: web.Request) -> web.StreamResponse:
        endpoint = request.path
        body = await request.read()
        try:
            request_json = json.loads(body) if body else {}
        except json.JSONDecodeError:
            request_json = {}
        cb = get_callbacks()
        if cb is not None:
            short = cb.pre_request(request, body, request_json)
            if short is not None:
                status, payload = short
                return web.json_response(payload, status=status)
        if self.pii_analyzer is not None:
            # NER analysis (Presidio tier) is CPU-bound: keep it off the
            # event loop so concurrent streams don't stall behind it
            blocked, body = await asyncio.get_event_loop().run_in_executor(
                None, self._apply_pii_policy, body, request_json
            )
            if blocked is not None:
                return blocked
        if self.semantic_cache is not None and endpoint == "/v1/chat/completions":
            hit = await self.semantic_cache.check(body)
            if hit is not None:
                return web.json_response(hit, headers={"X-Semantic-Cache": "hit"})

        capture = None
        wants_cache = (
            self.semantic_cache is not None
            and endpoint == "/v1/chat/completions"
            and not request_json.get("stream")
        )
        if wants_cache or (cb is not None):
            req_body = body

            async def capture(status: int, resp_body: bytes):
                if cb is not None:
                    try:
                        cb.post_request(request, resp_body)
                    except Exception:
                        logger.exception("post_request callback failed")
                if wants_cache and status == 200:
                    try:
                        await self.semantic_cache.store(req_body, json.loads(resp_body))
                    except json.JSONDecodeError:
                        pass

        return await route_general_request(
            request, endpoint, model_aliases=self.model_aliases,
            capture_body=capture, body_override=body,
        )

    def _apply_pii_policy(self, body: bytes, request_json: dict):
        """Scan prompt/messages for PII; redact or block per --pii-policy.
        Parity: experimental/pii/middleware.py:43-154 of the upstream vLLM production stack."""
        from production_stack_tpu_torch.router.pii import check_pii_content, redact

        analyzer = self.pii_analyzer
        texts = []
        if isinstance(request_json.get("prompt"), str):
            texts.append(request_json["prompt"])
        for m in request_json.get("messages", []) or []:
            if isinstance(m, dict) and isinstance(m.get("content"), str):
                texts.append(m["content"])
        matches = [m for t in texts for m in check_pii_content(t, analyzer)]
        if not matches:
            return None, body
        kinds = sorted({m.kind for m in matches})
        if self.args.pii_policy == "block":
            logger.warning("blocking request containing PII: %s", kinds)
            return (
                web.json_response(
                    {"error": {"message": f"request contains PII: {kinds}"}}, status=400
                ),
                body,
            )
        logger.info("redacting PII from request: %s", kinds)
        if isinstance(request_json.get("prompt"), str):
            request_json["prompt"] = redact(request_json["prompt"], analyzer=analyzer)
        for m in request_json.get("messages", []) or []:
            if isinstance(m, dict) and isinstance(m.get("content"), str):
                m["content"] = redact(m["content"], analyzer=analyzer)
        return None, json.dumps(request_json).encode()

    async def models(self, request: web.Request) -> web.Response:
        sd = get_service_discovery()
        seen: dict[str, dict] = {}
        for ep in sd.get_endpoint_info():
            for name in ep.model_names:
                info = ep.model_info.get(name) if ep.model_info else None
                seen.setdefault(
                    name,
                    info
                    or {
                        "id": name,
                        "object": "model",
                        "created": int(ep.added_timestamp),
                        "owned_by": "production-stack-tpu",
                    },
                )
        if self.model_aliases:
            for alias, target in self.model_aliases.items():
                if target in seen and alias not in seen:
                    aliased = dict(seen[target])
                    aliased["id"] = alias
                    seen[alias] = aliased
        return web.json_response({"object": "list", "data": list(seen.values())})

    async def health(self, request: web.Request) -> web.Response:
        if self.draining:
            return web.json_response({"status": "draining"}, status=503)
        sd = get_service_discovery()
        scraper = get_engine_stats_scraper()
        if not sd.get_health():
            return web.json_response({"status": "unhealthy: service discovery"}, status=503)
        if not scraper.get_health():
            return web.json_response({"status": "unhealthy: stats scraper"}, status=503)
        watcher = DynamicConfigWatcher.get()
        payload = {"status": "healthy"}
        if watcher and watcher.current:
            payload["dynamic_config"] = json.loads(watcher.current.to_json_str())
        return web.json_response(payload)

    async def engines(self, request: web.Request) -> web.Response:
        from production_stack_tpu_torch.router.resilience import get_breaker_registry

        sd = get_service_discovery()
        out = []
        stats = get_engine_stats_scraper().get_engine_stats()
        rstats = get_request_stats_monitor().get_request_stats()
        breakers = get_breaker_registry().states()
        for ep in sd.get_endpoint_info():
            d = {
                "url": ep.url,
                "models": ep.model_names,
                "model_label": ep.model_label,
                "sleep": ep.sleep,
                "added": ep.added_timestamp,
            }
            b = breakers.get(ep.url)
            if b is not None:
                d["breaker"] = b.state_name
            es = stats.get(ep.url)
            if es:
                d["engine_stats"] = es.__dict__
            rs = rstats.get(ep.url)
            if rs:
                d["request_stats"] = rs.__dict__
            out.append(d)
        # active-check failures + open breakers: the pulled-from-rotation set
        # (the breaker integration in service_discovery surfaces here)
        return web.json_response(
            {"engines": out, "unhealthy": sd.get_unhealthy_endpoint_urls()}
        )

    async def version(self, request: web.Request) -> web.Response:
        return web.json_response({"version": __version__})

    async def metrics(self, request: web.Request) -> web.Response:
        """Router Prometheus metrics (parity routers/metrics_router.py:57-123)."""
        lines = []

        def gauge(name, value, labels=""):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{labels} {value}")

        proc = psutil.Process()
        gauge("vllm_router:cpu_usage_perc", psutil.cpu_percent() / 100.0)
        gauge("vllm_router:memory_usage_bytes", proc.memory_info().rss)
        disk = psutil.disk_usage("/")
        gauge("vllm_router:disk_usage_perc", disk.percent / 100.0)
        rstats = get_request_stats_monitor().get_request_stats()
        for url, rs in rstats.items():
            lab = f'{{server="{url}"}}'
            gauge("vllm_router:current_qps", rs.qps, lab)
            gauge("vllm_router:avg_ttft", rs.ttft, lab)
            gauge("vllm_router:in_prefill_requests", rs.in_prefill_requests, lab)
            gauge("vllm_router:in_decoding_requests", rs.in_decoding_requests, lab)
            gauge("vllm_router:finished_requests", rs.finished_requests, lab)
            gauge("vllm_router:avg_latency", rs.avg_latency, lab)
            gauge("vllm_router:avg_itl", rs.avg_itl, lab)
            gauge("vllm_router:num_swapped_requests", rs.num_swapped_requests, lab)
        estats = get_engine_stats_scraper().get_engine_stats()
        for url, es in estats.items():
            lab = f'{{server="{url}"}}'
            gauge("vllm_router:engine_running_requests", es.num_running_requests, lab)
            gauge("vllm_router:engine_waiting_requests", es.num_queuing_requests, lab)
            gauge("vllm_router:gpu_cache_usage_perc", es.gpu_cache_usage_perc, lab)
            gauge("vllm_router:gpu_prefix_cache_hit_rate", es.gpu_prefix_cache_hit_rate, lab)
        # failure-domain layer: vllm_router:retries_total,
        # vllm_router:failovers_total, vllm_router:deadline_aborts_total,
        # per-backend vllm_router:circuit_state (0=closed 1=half-open 2=open)
        # and vllm_router:circuit_open_events_total
        lines.extend(render_resilience_metrics())
        # KV-aware v2 route-class mix (docs/kv-directory.md):
        # vllm_router:kvaware_v2_{resident,restorable,cold}_routes_total
        # plus the disagg decode picks scored by fabric transfer cost
        # (docs/kv-fabric.md): vllm_router:disagg_fabric_routes_total
        from production_stack_tpu_torch.router.routing_logic import (
            render_kvaware_metrics,
        )

        lines.extend(render_kvaware_metrics())
        # SLO accounting (router/slo.py): vllm_router:slo_attained_total /
        # vllm_router:slo_violated_total per (objective, model, server),
        # vllm_router:slo_request_outcomes_total, vllm_router:slo_records_total,
        # and the vllm_router:fleet_saturation autoscaling gauge (computed
        # fresh per scrape from the live engine stats + shed windows)
        from production_stack_tpu_torch.router.resilience import get_saturation_registry
        from production_stack_tpu_torch.router.slo import get_slo_monitor

        slo = get_slo_monitor()
        sat = get_saturation_registry()
        shedding = [url for url in estats if sat.is_saturated(url)]
        lines.extend(
            slo.render(
                fleet_saturation=slo.fleet_saturation(estats, shedding)
            )
        )
        # per-hop TTFT breakdown (receive->route->backend-headers->first
        # chunk): attributes tail latency to a stage instead of "the stack".
        # One TYPE line per metric name (duplicates fail the whole scrape).
        from production_stack_tpu_torch.router.request_service import get_hop_quantiles

        for hop, qs in get_hop_quantiles().items():
            name = f"vllm_router:ttft_hop_{hop}_ms"
            lines.append(f"# TYPE {name} gauge")
            for q, v in qs.items():
                lines.append(f'{name}{{quantile="{q}"}} {round(v, 3)}')
        # TTFT / e2e-latency distribution histograms (dashboard heatmaps)
        from production_stack_tpu_torch.router.request_service import (
            latency_hist,
            ttft_hist,
        )

        lines.extend(ttft_hist.render('source="router"'))
        lines.extend(latency_hist.render('source="router"'))
        # per-phase histograms (tracing subsystem): the engine observes
        # these; a router-only process exposes them zero-count so either
        # scrape job satisfies the dashboard. In a co-hosted process
        # (bench.py) both endpoints render the same process-global counts
        # under different labels, so the dashboard's phase panels filter on
        # model_name!="" to count the engine's series exactly once
        from production_stack_tpu_torch.tracing import (
            render_collector_metrics,
            render_phase_histograms,
        )

        lines.extend(render_phase_histograms('source="router"'))
        # span-loss visibility for THIS process's collector: ring-wrap
        # overwrites and head-sampling rejections are silent by design — the counters make the loss measurable before
        # someone debugs a tail with an incomplete trace
        lines.extend(render_collector_metrics('source="router"'))
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    async def traces(self, request: web.Request) -> web.Response:
        """Span ring-buffer export (read-only debug surface; docs/tracing.md).
        ?trace_id= filters to one trace, ?limit= caps the trace count."""
        from production_stack_tpu_torch.tracing import export_for_query

        payload, status = export_for_query(request.query)
        return web.json_response(payload, status=status)

    async def metrics_reset(self, request: web.Request) -> web.Response:
        """Clear the TTFT hop sample window (debug/bench endpoint) so a
        benchmark phase's hop quantiles describe only that phase."""
        from production_stack_tpu_torch.router.request_service import reset_hop_samples
        from production_stack_tpu_torch.router.resilience import reset_counters
        from production_stack_tpu_torch.tracing import get_collector

        reset_hop_samples()
        reset_counters()
        # per-phase bench windows: traces too, so a phase's attribution table
        # describes only that phase's requests
        get_collector().reset()
        return web.json_response({"status": "ok"})

    # -- files & batches (parity files_router.py, batches_router.py) --------

    async def upload_file(self, request: web.Request) -> web.Response:
        reader = await request.multipart()
        purpose, filename, content = "batch", "upload", b""
        async for part in reader:
            if part.name == "purpose":
                purpose = (await part.text()).strip()
            elif part.name == "file":
                filename = part.filename or "upload"
                content = await part.read()
        f = await files_service.get_storage().save_file(content, filename, purpose)
        return web.json_response(f.metadata())

    async def list_files(self, request: web.Request) -> web.Response:
        files = await files_service.get_storage().list_files()
        return web.json_response(
            {"object": "list", "data": [f.metadata() for f in files]}
        )

    async def get_file(self, request: web.Request) -> web.Response:
        try:
            f = await files_service.get_storage().get_file(request.match_info["file_id"])
        except KeyError:
            return web.json_response({"error": "file not found"}, status=404)
        return web.json_response(f.metadata())

    async def get_file_content(self, request: web.Request) -> web.Response:
        try:
            content = await files_service.get_storage().get_file_content(
                request.match_info["file_id"]
            )
        except (KeyError, FileNotFoundError):
            return web.json_response({"error": "file not found"}, status=404)
        return web.Response(body=content, content_type="application/octet-stream")

    async def create_batch(self, request: web.Request) -> web.Response:
        if not self.args.enable_batch_api:
            return web.json_response({"error": "batch API disabled"}, status=400)
        body = await request.json()
        info = await batch_service.get_batch_processor().create_batch(
            input_file_id=body["input_file_id"],
            endpoint=body.get("endpoint", "/v1/chat/completions"),
            completion_window=body.get("completion_window", "24h"),
            metadata=body.get("metadata"),
        )
        return web.json_response(info.to_dict())

    async def get_batch(self, request: web.Request) -> web.Response:
        try:
            info = await batch_service.get_batch_processor().retrieve_batch(
                request.match_info["batch_id"]
            )
        except KeyError:
            return web.json_response({"error": "batch not found"}, status=404)
        return web.json_response(info.to_dict())

    async def list_batches(self, request: web.Request) -> web.Response:
        infos = await batch_service.get_batch_processor().list_batches()
        return web.json_response(
            {"object": "list", "data": [i.to_dict() for i in infos]}
        )

    async def cancel_batch(self, request: web.Request) -> web.Response:
        try:
            info = await batch_service.get_batch_processor().cancel_batch(
                request.match_info["batch_id"]
            )
        except KeyError:
            return web.json_response({"error": "batch not found"}, status=404)
        return web.json_response(info.to_dict())

    async def sleep(self, request):
        return await route_sleep_wakeup_request(request, "/sleep")

    async def wake_up(self, request):
        return await route_sleep_wakeup_request(request, "/wake_up")

    async def is_sleeping(self, request):
        return await route_sleep_wakeup_request(request, "/is_sleeping")

    # -- app ----------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application()
        r = app.router
        for ep in (
            "/v1/chat/completions", "/v1/completions", "/v1/embeddings",
            "/v1/rerank", "/v1/score", "/tokenize", "/detokenize",
        ):
            r.add_post(ep, self._proxy)
        r.add_get("/v1/models", self.models)
        r.add_get("/health", self.health)
        r.add_get("/metrics", self.metrics)
        if getattr(self.args, "enable_debug_endpoints", False):
            # unauthenticated debug surfaces — benchmark/debug runs only
            # (/v1/traces is read-only but exposes request ids, backends,
            # and per-request timings; /metrics/reset is state-mutating)
            r.add_get("/v1/traces", self.traces)
            r.add_post("/metrics/reset", self.metrics_reset)
        r.add_get("/engines", self.engines)
        r.add_get("/version", self.version)
        r.add_post("/v1/files", self.upload_file)
        r.add_get("/v1/files", self.list_files)
        r.add_get("/v1/files/{file_id}", self.get_file)
        r.add_get("/v1/files/{file_id}/content", self.get_file_content)
        r.add_post("/v1/batches", self.create_batch)
        r.add_get("/v1/batches", self.list_batches)
        r.add_get("/v1/batches/{batch_id}", self.get_batch)
        r.add_post("/v1/batches/{batch_id}/cancel", self.cancel_batch)
        r.add_post("/sleep", self.sleep)
        r.add_post("/wake_up", self.wake_up)
        r.add_get("/is_sleeping", self.is_sleeping)
        app.on_cleanup.append(self._cleanup)
        return app

    async def _cleanup(self, app) -> None:
        from production_stack_tpu_torch.router.utils import cancel_task

        for t in self._bg:
            await cancel_task(t)
        # close every service that may have started a background task, so the
        # loop never shuts down with pending tasks ("Task was destroyed" noise)
        from production_stack_tpu_torch.router import batch_service
        from production_stack_tpu_torch.router.service_discovery import get_service_discovery

        for closable in (
            lambda: get_service_discovery(),
            lambda: get_engine_stats_scraper(),
            lambda: DynamicConfigWatcher.get(),
            lambda: batch_service.get_batch_processor(),
        ):
            try:
                svc = closable()
                if svc is not None:
                    await svc.close()
            except Exception:  # noqa: BLE001 - service may never have started
                pass
        await close_client_session()


async def serve(args):
    router = RouterApp(args)
    await router.initialize_all()
    app = router.build_app()
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, args.host, args.port)
    await site.start()
    logger.info("router listening on %s:%d (routing=%s, discovery=%s)",
                args.host, args.port, args.routing_logic, args.service_discovery)
    return router, runner


def main():
    import os

    from production_stack_tpu_torch.utils.signals import wait_for_termination

    args = parse_args()
    set_ulimit()

    async def _run():
        router, runner = await serve(args)
        await wait_for_termination()
        # SIGTERM: flip /health to 503 so the LB/readiness pulls this pod,
        # give the fleet a beat to notice, then let AppRunner.cleanup drain
        # in-flight streaming proxies (its shutdown waits on live handlers).
        # PSTPU_DRAIN_TIMEOUT should sit inside the pod's
        # terminationGracePeriodSeconds (helm routerSpec).
        router.draining = True
        await asyncio.sleep(float(os.environ.get("PSTPU_DRAIN_NOTICE", "2")))
        try:
            await asyncio.wait_for(
                runner.cleanup(),
                float(os.environ.get("PSTPU_DRAIN_TIMEOUT", "60")),
            )
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
        logger.info("router shut down cleanly")

    asyncio.run(_run())


if __name__ == "__main__":
    main()
