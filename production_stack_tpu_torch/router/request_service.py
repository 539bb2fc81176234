"""Request proxying: the router's data plane.

The port's copy of ``production_stack_tpu/router/request_service.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/services/request_service/request.py of the upstream vLLM production stack —
process_request (streaming proxy + stats hooks) :54-138, route_general_request
(discovery, alias/sleep filtering, routing, response headers) :141-304,
disaggregated prefill two-phase flow :307-439, sleep/wake proxying :442-514.

The "Routing request <id> ... to <url> at <t>" log line format is load-bearing:
the reference's e2e tests assert on it (tests/e2e/test-routing.py) and ours do
too (SURVEY.md §4.3).
"""

from __future__ import annotations

import asyncio
import collections
import json
import time
import uuid
from typing import Awaitable, Callable, Optional

import aiohttp
from aiohttp import web

from production_stack_tpu_torch.router.resilience import (
    count_batch_deprioritized,
    count_deadline_abort,
    count_failover,
    count_request_class,
    count_retry,
    count_shed,
    get_breaker_registry,
    get_retry_policy,
    get_saturation_registry,
)
from production_stack_tpu_torch.router.routing_logic import (
    DisaggregatedPrefillRouter,
    SessionRouter,
    get_routing_logic,
)
from production_stack_tpu_torch.router.engine_stats import get_engine_stats_scraper
from production_stack_tpu_torch.router.request_stats import get_request_stats_monitor
from production_stack_tpu_torch.router.service_discovery import EndpointInfo, get_service_discovery
from production_stack_tpu_torch.tracing import TRACEPARENT_HEADER, get_collector
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

_client_session: Optional[aiohttp.ClientSession] = None

# Per-request TTFT hop samples, (recv->route, route->backend-headers,
# backend-headers->first-chunk) in ms. /metrics exposes p50/p99 per hop so
# tail latency is attributable to a stage, not just "the stack".
_hop_samples: collections.deque = collections.deque(maxlen=2048)

# Router-observed TTFT / e2e latency distributions (reference dashboard's
# heatmap panels; vLLM-compatible names + buckets — utils/metrics.py)
from production_stack_tpu_torch.utils.metrics import (  # noqa: E402
    LATENCY_BUCKETS,
    TTFT_BUCKETS,
    Histogram,
)

ttft_hist = Histogram(
    # vllm_router: namespace, NOT vllm: — a Prometheus scraping both router
    # and engine would otherwise double-count every request in the
    # dashboard's distribution heatmaps (each request is observed once by
    # each server under the same series name)
    "vllm_router:time_to_first_token_seconds", TTFT_BUCKETS,
    "Time to first token distribution (router-observed)",
)
latency_hist = Histogram(
    "vllm_router:e2e_request_latency_seconds", LATENCY_BUCKETS,
    "End-to-end request latency distribution (router-observed)",
)


def record_hop_sample(recv_to_route: float, route_to_connect: float,
                      connect_to_first: float,
                      ttft_s: Optional[float] = None) -> list:
    """Append a TTFT hop sample and return it. The 4th slot is the request's
    final outcome, tagged at proxy completion — a sample is recorded when the
    first chunk arrives, but the stream may die later, and trace attribution
    must distinguish completed from truncated streams.

    ``ttft_s`` is the CLIENT-experienced TTFT for the histogram when it
    differs from the hop sum: a failed-over request's hops describe the
    successful attempt's stages, but its TTFT must still include the failed
    attempts and backoff the client actually waited through."""
    sample = [recv_to_route, route_to_connect, connect_to_first, "in_flight"]
    _hop_samples.append(sample)
    if ttft_s is None:
        ttft_s = (recv_to_route + route_to_connect + connect_to_first) / 1000
    ttft_hist.observe(ttft_s)
    return sample


def reset_hop_samples() -> None:
    """Clear the hop sample window (POST /metrics/reset): a benchmark phase
    scrapes then resets, so each phase's quantiles describe THAT phase's
    requests instead of pooling across differently-loaded phases."""
    _hop_samples.clear()
    ttft_hist.reset()
    latency_hist.reset()


def get_hop_quantiles() -> dict:
    """{hop: {p50, p99}} in ms over the sample window (the trailing outcome
    tag is not a timing column)."""
    if not _hop_samples:
        return {}
    cols = list(zip(*_hop_samples))[:3]
    names = ("recv_to_route", "route_to_connect", "connect_to_first_chunk")
    out = {}
    for name, vals in zip(names, cols):
        s = sorted(vals)
        out[name] = {
            "p50": s[len(s) // 2],
            "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
        }
    return out


async def get_client_session() -> aiohttp.ClientSession:
    """Shared connection-pooled client (parity: httpx_client.py)."""
    global _client_session
    if _client_session is None or _client_session.closed:
        _client_session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=10),
            connector=aiohttp.TCPConnector(limit=0),
        )
    return _client_session


async def close_client_session() -> None:
    global _client_session
    # in-flight fire-and-forget aborts would otherwise resurrect the session
    # after close (abort_on_engine re-enters get_client_session)
    for task in list(_abort_tasks):
        task.cancel()
    if _client_session and not _client_session.closed:
        await _client_session.close()
    _client_session = None


def _filter_headers(headers) -> dict:
    hop = {"host", "content-length", "transfer-encoding", "connection"}
    return {k: v for k, v in headers.items() if k.lower() not in hop}


class _RetryableProxyError(Exception):
    """Connect-stage or pre-first-byte failure: no response bytes have
    reached the client, so the request can safely fail over to another
    backend. Mid-stream failures are NOT retryable — tokens already left.

    ``status == 429`` marks a load SHED (engine admission control): the
    backend is healthy but out of capacity, so failover is immediate (no
    backoff), the circuit breaker is never fed, and ``retry_after`` carries
    the backend's Retry-After hint for the terminal client response."""

    def __init__(self, reason: str, status: int = 502,
                 retry_after: Optional[float] = None):
        super().__init__(reason)
        self.reason = reason
        self.status = status
        self.retry_after = retry_after

    @property
    def is_shed(self) -> bool:
        return self.status == 429


# longest a single 429 may exclude a backend from routing: a malformed or
# hostile Retry-After ('inf', '1e18') must never quarantine a healthy
# backend until router restart
# class-aware placement threshold (--batch-avoid-attainment; app.py sets it
# at startup, 0 disables): batch requests avoid backends whose interactive
# TTFT attainment fell below this ratio
_batch_avoid_attainment = 0.9


def set_batch_avoid_attainment(value: float) -> None:
    global _batch_avoid_attainment
    _batch_avoid_attainment = max(0.0, float(value))


def request_priority(headers, body_json: Optional[dict]) -> str:
    """Resolve a request's SLO class: ``X-Priority`` header wins, then a
    ``priority`` body field; anything outside the closed {interactive,
    batch} set (and the unlabeled default) degrades to interactive — the
    protective class — so a typo never silently deprioritizes a tenant."""
    raw = None
    if headers is not None:
        raw = headers.get("X-Priority")
    if not raw and body_json:
        raw = body_json.get("priority")
    pri = str(raw or "interactive").strip().lower()
    return pri if pri in ("interactive", "batch") else "interactive"


MAX_RETRY_AFTER_S = 60.0


def _parse_retry_after(raw: Optional[str]) -> float:
    """Retry-After header seconds (delta form only; HTTP-date is overkill
    for an intra-cluster contract). Malformed/absent -> 1 s; clamped to
    [0, MAX_RETRY_AFTER_S]."""
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return 1.0
    if v != v:  # NaN
        return 1.0
    return min(MAX_RETRY_AFTER_S, max(0.0, v))


def _overloaded_response(message: str, retry_after: Optional[float]) -> web.Response:
    """Terminal 429 + Retry-After for a fleet-wide shed (mirrors the
    engine's shed contract, api_server._shed_response): the honest answer
    under saturation, and the signal well-behaved clients back off on."""
    retry = max(1, int(-(-(retry_after or 1.0) // 1)))  # ceil, floor 1 s
    return web.json_response(
        {"error": {"message": message, "type": "overloaded_error",
                   "code": 429}},
        status=429,
        headers={"Retry-After": str(retry)},
    )


async def abort_on_engine(backend_url: str, request_id: str) -> None:
    """Best-effort engine-side abort (POST /abort): closing the proxy's TCP
    connection only reaches a backend that is actively writing — a HUNG
    engine would keep the scheduler slot and KV pages pinned forever. The
    call is fire-and-forget: a plain-vLLM pod without /abort, or a dead pod,
    must not add latency to the abort path."""
    try:
        session = await get_client_session()
        async with session.post(
            f"{backend_url}/abort",
            json={"request_id": request_id},
            timeout=aiohttp.ClientTimeout(total=2),
        ):
            pass
    except Exception:  # noqa: BLE001 - abort is advisory
        pass


# strong refs for fire-and-forget abort tasks (a bare create_task could be
# garbage-collected mid-flight); drained on close_client_session
_abort_tasks: set = set()  # owned-by: event-loop


def spawn_abort(backend_url: str, request_id: str) -> "asyncio.Task":
    """Fire-and-forget engine-side abort: the reclaim must not serialize into
    the request path (a partitioned pod would add the abort call's full 2s
    budget to every failover and delay the client's SSE error event). The
    returned task is tracked so close_client_session can cancel stragglers
    instead of letting them resurrect the shared session after close."""
    task = asyncio.get_running_loop().create_task(
        abort_on_engine(backend_url, request_id)
    )
    _abort_tasks.add(task)
    task.add_done_callback(_abort_tasks.discard)
    return task


# live-migration stream handoff (docs/migration.md): a migrating source
# engine ends its SSE leg with ONE control event instead of [DONE]; the
# proxy suppresses the event, attaches to the target's /migrate_attach, and
# splices the continuation into the client's still-open response — the
# client sees one uninterrupted stream.
MIGRATION_MARKER = b'data: {"pstpu_migration"'


async def _read_migration_event(chunk: bytes, chunks):
    """Split ``chunk`` at the migration control event.

    Returns ``(forward_bytes, event_dict | None)``. The event is the
    stream's final event, but TCP may fragment it across reads — keep
    pulling until its ``\\n\\n`` terminator. A torn or unparseable event is
    treated as absent and forwarded verbatim (the client then sees the raw
    event, which is still better than eating its bytes)."""
    idx = chunk.rfind(MIGRATION_MARKER)
    if idx < 0:
        return chunk, None
    prefix, rest = chunk[:idx], chunk[idx:]
    while b"\n\n" not in rest:
        try:
            rest += await asyncio.wait_for(chunks.__anext__(), 5.0)
        except (StopAsyncIteration, asyncio.TimeoutError, aiohttp.ClientError,
                ConnectionResetError):
            return prefix + rest, None
    payload = rest[len(b"data: "): rest.find(b"\n\n")]
    try:
        event = json.loads(payload)["pstpu_migration"]
    except (ValueError, KeyError, TypeError):
        return prefix + rest, None
    if not isinstance(event, dict):
        return prefix + rest, None
    return prefix, event


def _marker_tail_overlap(chunk: bytes) -> int:
    """Length of the longest suffix of ``chunk`` that is a proper prefix of
    the migration marker. TCP may split the source's final write ANYWHERE —
    including inside the marker itself — and a marker split across two reads
    would otherwise leak the raw control event to the client and skip the
    splice. The proxy withholds such a tail (<= 23 bytes) until the next
    read resolves it."""
    for k in range(min(len(MIGRATION_MARKER) - 1, len(chunk)), 0, -1):
        if chunk.endswith(MIGRATION_MARKER[:k]):
            return k
    return 0


def _maybe_pin_session(request, target: str) -> None:
    """SessionRouter re-pin: the hash ring is deterministic, so without an
    explicit pin the session's NEXT request would route straight back to the
    backend the controller just migrated it off."""
    from production_stack_tpu_torch.router.resilience import get_session_pins

    try:
        router = get_routing_logic()
    except AssertionError:  # embedded/unit use without initialized routing
        return
    if not isinstance(router, SessionRouter):
        return
    headers = getattr(request, "headers", None)
    sid = headers.get(router.session_key) if headers is not None else None
    if sid:
        get_session_pins().pin(str(sid), target)


async def _splice_migrated_stream(
    resp: web.StreamResponse,
    event: dict,
    *,
    request: web.Request,
    session: aiohttp.ClientSession,
    stall_timeout: Optional[float],
    breakers,
    captured: Optional[list] = None,
) -> bool:
    """Attach to the migration target and splice the continuation into the
    client's open response. Loops: a continuation may itself migrate again
    (chained handoff — e.g. its new home drains too), ending its leg with
    another control event. Returns True when [DONE] reached the client;
    on failure the client gets the terminal SSE error event (the streaming error contract)
    — tokens already streamed, so failover is no longer possible."""
    from production_stack_tpu_torch.router.resilience import (
        count_migration_splice_failure,
        count_session_repin,
    )

    hops = 0
    while event is not None:
        if hops >= 8:  # chained-handoff loop bound
            # the cap firing means a pathological migration loop — the
            # stream must end with the explicit error contract, never a
            # silent truncation recorded as success
            count_migration_splice_failure()
            logger.error(
                "migration splice exceeded %d chained hops for %s; aborting",
                hops, event.get("request_id"),
            )
            await resp.write(_sse_error_event(
                f"migration handoff chain exceeded {hops} hops", 502
            ))
            return False
        hops += 1
        target = str(event.get("target") or "").rstrip("/")
        mig_id = event.get("request_id")
        next_event = None
        try:
            if not target or not mig_id:
                raise ValueError(f"malformed migration event: {event}")
            async with session.post(
                f"{target}/migrate_attach", json={"request_id": mig_id},
                timeout=aiohttp.ClientTimeout(total=None, sock_connect=10),
            ) as tr:
                if tr.status != 200:
                    detail = (await tr.read())[:200]
                    raise ValueError(
                        f"attach returned {tr.status}: "
                        f"{detail.decode(errors='replace')}"
                    )
                # the splice IS the session re-pin: count it and pin the
                # session key (when a SessionRouter is active) to the target
                count_session_repin()
                _maybe_pin_session(request, target)
                chunks = tr.content.iter_any()
                while True:
                    try:
                        if stall_timeout:
                            chunk = await asyncio.wait_for(
                                chunks.__anext__(), stall_timeout
                            )
                        else:
                            chunk = await chunks.__anext__()
                    except StopAsyncIteration:
                        break
                    chunk, next_event = await _read_migration_event(
                        chunk, chunks
                    )
                    if chunk:
                        if captured is not None:
                            captured.append(chunk)
                        await resp.write(chunk)
                    if next_event is not None:
                        break
        except (aiohttp.ClientError, ConnectionResetError,
                asyncio.TimeoutError, OSError, ValueError) as e:
            if target:
                breakers.record_failure(target)
            count_migration_splice_failure()
            logger.error(
                "migration splice to %s failed for %s: %s", target, mig_id, e
            )
            await resp.write(_sse_error_event(
                f"migration handoff to {target or '?'} failed: {e}", 502
            ))
            return False
        event = next_event
    return True


def _sse_error_event(message: str, code: int = 502) -> bytes:
    """Terminal SSE error event (docs/failure-handling.md contract): a
    mid-stream backend death must surface as an explicit `error` payload, not
    a silently truncated 200. No [DONE] follows — its absence is how clients
    distinguish an errored stream from a clean EOF. The leading blank line
    forces an event boundary: the connection may have died MID-chunk, and
    gluing this onto a partial `data:` line would make both unparseable."""
    payload = {"error": {"message": message, "type": "upstream_error", "code": code}}
    return f"\n\ndata: {json.dumps(payload)}\n\n".encode()


async def process_request(
    request: web.Request,
    body: bytes,
    backend_url: str,
    endpoint: str,
    request_id: str,
    *,
    is_streaming: bool,
    capture_body: Optional[object] = None,
    ts_recv: Optional[float] = None,
    trace_ctx=None,
    pick_next: Optional[Callable[[set], Awaitable[Optional[str]]]] = None,
    attempts_anchor: Optional[float] = None,
) -> web.StreamResponse:
    """Proxy `body` to backend and stream the response back, firing request
    stats callbacks (parity request.py:54-138), with the failure-domain layer
    wrapped around the attempt: connect-stage and pre-first-byte failures
    retry with capped backoff against ``pick_next``'s next-choice endpoint
    (excluding already-failed URLs), bounded by the attempt budget and the
    per-request deadline; every outcome feeds the backend's circuit breaker.

    `capture_body(status, bytes)` — optional async callback fired with the full
    response once the proxy completes (semantic-cache store, post_request
    callbacks). ``ts_recv`` is the perf_counter when the router first saw the
    request, for the per-hop TTFT breakdown. ``trace_ctx`` is the router's
    request-level span context; each attempt records a child span and
    propagates a grandchild over ``traceparent`` so engine spans nest under
    the attempt that actually served them."""
    policy = get_retry_policy()
    breakers = get_breaker_registry()
    collector = get_collector()
    # ``attempts_anchor`` lets a two-phase caller (disaggregated prefill)
    # charge its phase-1 time against the same --deadline-request budget
    # instead of granting the decode phase a fresh clock
    t_attempts0 = attempts_anchor if attempts_anchor is not None else time.monotonic()
    t_wall0 = time.time()
    t_perf0 = time.perf_counter()
    attempt = 0
    tried: set[str] = set()
    last_err: Optional[_RetryableProxyError] = None
    try:
        while True:
            attempt += 1
            tried.add(backend_url)
            # retries forward an attempt-suffixed id: attempt 1's sequence may
            # still be live on the engine (the abort is best-effort), and two
            # live sequences with one seq_id would cross-wire their output
            # queues. The client-visible X-Request-Id stays the original.
            wire_id = request_id if attempt == 1 else f"{request_id}#r{attempt}"
            try:
                return await _proxy_attempt(
                    request, body, backend_url, endpoint, request_id,
                    wire_id=wire_id,
                    attempt=attempt, capture_body=capture_body,
                    ts_recv=ts_recv, trace_ctx=trace_ctx,
                    policy=policy, breakers=breakers, t_attempts0=t_attempts0,
                )
            except _RetryableProxyError as e:
                last_err = e
                if e.is_shed:
                    # engine load shed (429 + Retry-After): the backend is
                    # healthy, just out of capacity — NEVER feeds the
                    # breaker (acceptance: shed failover must not trip it)
                    logger.warning(
                        "backend %s shed request %s (attempt %d/%d, "
                        "retry-after %.1fs); failing over",
                        backend_url, request_id, attempt, policy.max_attempts,
                        e.retry_after or 1.0,
                    )
                else:
                    breakers.record_failure(backend_url)
                    logger.error(
                        "backend %s failed for request %s (attempt %d/%d): %s",
                        backend_url, request_id, attempt, policy.max_attempts,
                        e.reason,
                    )
                    # replay dedupe: the failed attempt may still be EXECUTING
                    # on its engine (a snapped TCP connection with no bytes in
                    # flight goes unnoticed by a non-streaming generation, and
                    # the engine would run it to completion while the replay
                    # runs elsewhere — double execution fleet-wide). Abort it
                    # by the attempt's echoed X-Request-Id (wire_id) before
                    # failing over; unknown/finished ids are engine-side
                    # no-ops, and the deadline paths' own aborts make this
                    # idempotent. Sheds skip it: a shed was never admitted.
                    spawn_abort(backend_url, wire_id)
            remaining = policy.remaining(t_attempts0)
            if remaining is not None and remaining <= 0:
                count_deadline_abort("request")
                return web.json_response(
                    {"error": f"request deadline exceeded after {attempt} "
                              f"attempt(s): {last_err.reason}"},
                    status=504,
                )
            if attempt >= policy.max_attempts:
                break
            nxt = None
            if pick_next is not None:
                try:
                    nxt = await pick_next(tried)
                except Exception:
                    logger.exception("failover routing failed")
            if nxt is None:
                if last_err.is_shed:
                    # every alternative is saturated too: surface the 429 +
                    # Retry-After now — re-queueing on a known-saturated
                    # backend only adds latency to an honest answer
                    break
                # no alternative endpoint: re-try the same backend only if
                # its breaker still admits traffic, else give up now
                if not breakers.allows(backend_url):
                    break
                nxt = backend_url
            # shed failover is IMMEDIATE: the engine told us exactly why it
            # refused, and other engines have capacity — backoff only delays
            # the client while the shedding engine's queue drains
            delay = 0.0 if last_err.is_shed else policy.backoff(attempt)
            if remaining is not None:
                delay = min(delay, max(0.0, remaining))
            count_retry()
            if nxt != backend_url:
                count_failover()
                logger.warning(
                    "failing request %s over: %s -> %s (attempt %d, backoff %.0f ms)",
                    request_id, backend_url, nxt, attempt + 1, delay * 1000,
                )
            await asyncio.sleep(delay)
            backend_url = nxt
        if last_err.is_shed:
            # all candidates saturated: forward the shed verbatim
            return _overloaded_response(
                f"all backends saturated after {attempt} attempt(s): "
                f"{last_err.reason}",
                last_err.retry_after,
            )
        return web.json_response(
            {"error": f"backend error after {attempt} attempt(s): {last_err.reason}"},
            status=last_err.status if last_err.status >= 500 else 502,
        )
    finally:
        # fires on success, backend error, AND client disconnect
        # (CancelledError): the router.request root span must record exactly
        # once per request regardless of how many proxy attempts ran
        if trace_ctx is not None:
            start = t_wall0 - ((t_perf0 - ts_recv) if ts_recv else 0.0)
            collector.record(
                "router.request", trace_ctx, start,
                time.perf_counter() - (ts_recv or t_perf0),
                endpoint=endpoint, request_id=request_id, attempts=attempt,
            )


async def _proxy_attempt(
    request: web.Request,
    body: bytes,
    backend_url: str,
    endpoint: str,
    request_id: str,
    *,
    wire_id: Optional[str] = None,
    attempt: int,
    capture_body,
    ts_recv,
    trace_ctx,
    policy,
    breakers,
    t_attempts0: float,
) -> web.StreamResponse:
    """One proxy attempt. Raises _RetryableProxyError while failover is still
    possible (nothing sent to the client); after the response is committed,
    failures terminate the stream with the SSE error-event contract."""
    monitor = get_request_stats_monitor()
    session = await get_client_session()
    collector = get_collector()
    wire_id = wire_id or request_id
    proxy_ctx = trace_ctx.child() if trace_ctx is not None else None
    # Always forward X-Request-Id (router-generated when the client sent
    # none): the engine honors it (api_server req_id), so router and engine
    # logs — and trace spans — correlate on one id. Without this the engine
    # minted its own `req-...` id and the two logs never joined. Strip any
    # client-cased duplicates first — aiohttp would send both spellings.
    out_headers = {
        k: v
        for k, v in _filter_headers(request.headers).items()
        if k.lower() not in ("x-request-id", TRACEPARENT_HEADER)
    }
    out_headers["X-Request-Id"] = wire_id
    if proxy_ctx is not None:
        out_headers[TRACEPARENT_HEADER] = proxy_ctx.to_traceparent()
    t_wall = time.time()
    t_route = time.perf_counter()
    proxy_attrs = {"backend": backend_url, "request_id": request_id,
                   "attempt": attempt}
    if wire_id != request_id:
        proxy_attrs["wire_id"] = wire_id  # engine-side id for this attempt
    outcome = "error"
    hop_sample: Optional[list] = None
    backend_resp: Optional[aiohttp.ClientResponse] = None
    resp: Optional[web.StreamResponse] = None
    monitor.on_new_request(backend_url, request_id)

    # pre-first-byte budget: TTFT deadline, clamped by what's left of the
    # per-request (attempt-phase) deadline
    ttft_deadline_at: Optional[float] = None
    if policy.deadline_ttft > 0:
        ttft_deadline_at = time.monotonic() + policy.deadline_ttft
    remaining = policy.remaining(t_attempts0)
    if remaining is not None:
        at = time.monotonic() + max(0.0, remaining)
        ttft_deadline_at = min(ttft_deadline_at, at) if ttft_deadline_at else at

    async def _bounded(awaitable, *, kind: str):
        """Await within the pre-first-byte deadline; deadline expiry aborts
        the engine-side request and converts to a retryable failure."""
        if ttft_deadline_at is None:
            return await awaitable
        budget = ttft_deadline_at - time.monotonic()
        try:
            return await asyncio.wait_for(awaitable, max(budget, 0.001))
        except asyncio.TimeoutError:
            count_deadline_abort(kind)
            spawn_abort(backend_url, wire_id)
            raise _RetryableProxyError(
                f"no first byte from {backend_url} within deadline "
                f"({kind})", 504,
            ) from None

    try:
        # ---- retryable stage: connect + headers + first chunk -------------
        try:
            backend_resp = await _bounded(
                session.post(f"{backend_url}{endpoint}", data=body,
                             headers=out_headers),
                kind="ttft",
            )
        except (aiohttp.ClientError, ConnectionResetError, OSError) as e:
            raise _RetryableProxyError(f"connect failed: {e}") from e
        t_conn = time.perf_counter()
        if backend_resp.status >= 500:
            # a 5xx body is small and already formed; drain it (bounded — a
            # backend that hangs after its error headers must not pin us)
            try:
                detail = (await asyncio.wait_for(backend_resp.read(), 2.0))[:200]
            except Exception:  # noqa: BLE001 - body is best-effort detail
                detail = b""
            raise _RetryableProxyError(
                f"backend returned {backend_resp.status}: "
                f"{detail.decode(errors='replace')}",
                backend_resp.status,
            )
        if backend_resp.status == 429:
            # engine load shed (admission control): remember the Retry-After
            # window so routing stops offering this backend new traffic, and
            # convert to an immediate breaker-neutral failover
            retry_after = _parse_retry_after(
                backend_resp.headers.get("Retry-After")
            )
            try:
                detail = (await asyncio.wait_for(backend_resp.read(), 2.0))[:200]
            except Exception:  # noqa: BLE001 - body is best-effort detail
                detail = b""
            get_saturation_registry().mark(backend_url, retry_after)
            count_shed()
            raise _RetryableProxyError(
                f"backend shed the request (429, retry-after {retry_after:g}s): "
                f"{detail.decode(errors='replace')}",
                429, retry_after=retry_after,
            )
        chunks = backend_resp.content.iter_any()
        first_chunk: Optional[bytes] = None
        try:
            first_chunk = await _bounded(chunks.__anext__(), kind="ttft")
        except StopAsyncIteration:
            pass  # empty body (204s, HEAD-ish replies): still a success
        except (aiohttp.ClientError, ConnectionResetError) as e:
            raise _RetryableProxyError(f"died before first byte: {e}") from e

        # ---- committed stage: headers are sent, no more failover ----------
        resp = web.StreamResponse(
            status=backend_resp.status,
            headers={
                **_filter_headers(backend_resp.headers),
                "X-Request-Id": request_id,
            },
        )
        await resp.prepare(request)
        is_sse = "text/event-stream" in (
            backend_resp.headers.get("Content-Type") or ""
        )
        stall_timeout = policy.deadline_inter_chunk or None
        captured: list[bytes] = []
        first = True
        chunk = first_chunk
        mig_carry = b""  # withheld possible-marker-prefix tail (SSE only)
        while chunk is not None:
            mig_event = None
            if is_sse:
                if mig_carry:
                    chunk = mig_carry + chunk
                    mig_carry = b""
                if MIGRATION_MARKER in chunk:
                    # live-migration handoff: split out the control event
                    # (it must never reach the client) before forwarding
                    chunk, mig_event = await _read_migration_event(
                        chunk, chunks
                    )
                elif chunk:
                    # a chunk tail that could be the START of a split
                    # marker is withheld until the next read resolves it
                    k = _marker_tail_overlap(chunk)
                    if k:
                        mig_carry = chunk[-k:]
                        chunk = chunk[:-k]
            if chunk or mig_event is None:
                if first:
                    monitor.on_request_response(backend_url, request_id)
                    first = False
                    t_first = time.perf_counter()
                    # hop columns are attempt-relative (stage costs stay honest:
                    # retry/backoff time of earlier attempts must not pollute the
                    # recv_to_route quantiles); the TTFT histogram still gets the
                    # full client-experienced window including failed attempts
                    hop_sample = record_hop_sample(
                        (t_route - (ts_recv or t_route)) * 1000 if attempt == 1 else 0.0,
                        (t_conn - t_route) * 1000,
                        (t_first - t_conn) * 1000,
                        ttft_s=t_first - (ts_recv or t_route),
                    )
                else:
                    monitor.on_token(backend_url, request_id)
            if chunk:
                if capture_body is not None:
                    captured.append(chunk)
                await resp.write(chunk)
            if mig_event is not None:
                # the source leg ended cleanly by handing the stream over:
                # splice the continuation from the target into the client's
                # open response (docs/migration.md)
                spliced_ok = await _splice_migrated_stream(
                    resp, mig_event, request=request, session=session,
                    stall_timeout=stall_timeout, breakers=breakers,
                    captured=captured if capture_body is not None else None,
                )
                proxy_attrs["migrated_to"] = mig_event.get("target")
                outcome = "migrated" if spliced_ok else "migration_splice_failed"
                breakers.record_success(backend_url)
                latency_hist.observe(time.perf_counter() - (ts_recv or t_route))
                if spliced_ok and capture_body is not None:
                    await capture_body(backend_resp.status, b"".join(captured))
                try:
                    await resp.write_eof()
                except Exception:  # noqa: BLE001 - client may be gone
                    pass
                return resp
            try:
                # per-chunk wait_for costs a Task per chunk, but only when
                # the stall deadline is enabled. ClientTimeout(sock_read=…)
                # would be cheaper but ALSO bounds the pre-first-byte gap,
                # which must stay governed by the (longer) TTFT deadline —
                # a slow prefill is not a stalled stream.
                if stall_timeout:
                    chunk = await asyncio.wait_for(
                        chunks.__anext__(), stall_timeout
                    )
                else:
                    chunk = await chunks.__anext__()
            except StopAsyncIteration:
                chunk = None
            except asyncio.TimeoutError:
                # mid-stream stall: reclaim the engine slot and tell the
                # client explicitly — never leave a silently-frozen 200
                count_deadline_abort("inter_chunk")
                spawn_abort(backend_url, wire_id)
                backend_resp.close()
                breakers.record_failure(backend_url)
                outcome = "deadline_inter_chunk"
                proxy_attrs["error"] = (
                    f"stream stalled > {stall_timeout}s between chunks"
                )
                logger.error(
                    "request %s stalled on %s (> %.1fs between chunks); aborted",
                    request_id, backend_url, stall_timeout,
                )
                if is_sse:
                    await resp.write(_sse_error_event(
                        f"upstream stream stalled after {stall_timeout}s; aborted",
                        504,
                    ))
                await resp.write_eof()
                return resp
            except (aiohttp.ClientError, ConnectionResetError) as e:
                breakers.record_failure(backend_url)
                outcome = "truncated"
                proxy_attrs["error"] = str(e)
                logger.error(
                    "backend %s died mid-stream for request %s: %s",
                    backend_url, request_id, e,
                )
                if is_sse:
                    await resp.write(_sse_error_event(
                        f"upstream connection lost mid-stream: {e}", 502,
                    ))
                try:
                    await resp.write_eof()
                except Exception:  # noqa: BLE001 - client may be gone too
                    pass
                return resp
        if mig_carry:
            # clean EOF with a withheld tail: it was ordinary content that
            # merely LOOKED like a marker prefix — deliver it
            if capture_body is not None:
                captured.append(mig_carry)
            await resp.write(mig_carry)
        await resp.write_eof()
        latency_hist.observe(time.perf_counter() - (ts_recv or t_route))
        if hop_sample is None:
            # no body chunk ever arrived (204s / empty non-streaming
            # replies): the request still completed, and the engine-side
            # histograms count it — record a TTFT-equals-latency sample so
            # the router and engine /metrics distributions keep covering
            # the SAME request population (a request must never appear in
            # the router's latency histogram but not its TTFT one)
            t_done = time.perf_counter()
            hop_sample = record_hop_sample(
                (t_route - (ts_recv or t_route)) * 1000 if attempt == 1 else 0.0,
                (t_conn - t_route) * 1000,
                (t_done - t_conn) * 1000,
                ttft_s=t_done - (ts_recv or t_route),
            )
        proxy_attrs["status"] = backend_resp.status
        outcome = "ok"
        breakers.record_success(backend_url)
        if capture_body is not None:
            await capture_body(backend_resp.status, b"".join(captured))
        return resp
    except _RetryableProxyError as e:
        outcome = "shed" if e.is_shed else "retryable_error"
        if backend_resp is not None:
            backend_resp.close()
        raise
    except ConnectionResetError:
        # CLIENT went away mid-write (headers already sent): backend-side
        # resets are converted to _RetryableProxyError / truncated above, so
        # a reset here is ours. Release the backend leg and reclaim the
        # engine slot; there is nobody left to stream to.
        outcome = "client_disconnect"
        if backend_resp is not None:
            backend_resp.close()
        spawn_abort(backend_url, wire_id)
        return resp
    except asyncio.CancelledError:
        # client disconnect: close the backend leg so an actively-writing
        # engine notices; a hung one is covered by the abort call
        outcome = "client_disconnect"
        if backend_resp is not None:
            backend_resp.close()
        # shielded await over a TRACKED task: this handler is being torn
        # down, so the abort must survive our cancellation — but it must
        # also stay cancellable by close_client_session at shutdown, or it
        # could resurrect the shared session after close
        await asyncio.shield(spawn_abort(backend_url, wire_id))
        raise
    finally:
        # fires on every exit path so a disconnect cannot record the
        # router.request root while dropping this attempt's router.proxy
        # span — that would orphan the engine subtree (parented under
        # proxy_ctx) out of the attribution and misattribute engine time
        # to the router
        monitor.on_request_complete(backend_url, request_id)
        proxy_attrs["outcome"] = outcome
        if hop_sample is not None:
            hop_sample[3] = outcome
        collector.record(
            "router.proxy", proxy_ctx, t_wall,
            time.perf_counter() - t_route, **proxy_attrs,
        )


async def route_general_request(
    request: web.Request,
    endpoint: str,
    *,
    model_aliases: Optional[dict] = None,
    capture_body: Optional[object] = None,
    body_override: Optional[bytes] = None,
) -> web.StreamResponse:
    """Parse, filter endpoints by model + sleep state, route, proxy.
    Parity request.py:141-304."""
    in_router_time = time.time()
    ts_recv = time.perf_counter()
    body = body_override if body_override is not None else await request.read()
    request_id = request.headers.get("X-Request-Id") or str(uuid.uuid4())
    # request-level trace: adopt the client's traceparent (its sampled flag
    # wins — head-based sampling) or root a new trace here; every downstream
    # span (routing decision, proxy, engine phases) nests under this context.
    # child() so the router.request span has its OWN id — recording under the
    # client's span id verbatim would collide retries that reuse a header
    # into one phantom span at merge time
    trace_ctx = get_collector().root_from_headers(request.headers).child()
    try:
        request_json = json.loads(body) if body else {}
    except json.JSONDecodeError:
        return web.json_response({"error": "invalid JSON body"}, status=400)

    router = get_routing_logic()
    if isinstance(router, DisaggregatedPrefillRouter):
        return await route_disaggregated_prefill_request(
            request, endpoint, request_json, request_id,
            trace_ctx=trace_ctx, ts_recv=ts_recv,
        )

    requested_model = request_json.get("model")
    if model_aliases and requested_model in model_aliases:
        requested_model = model_aliases[requested_model]
        request_json["model"] = requested_model
        body = json.dumps(request_json).encode()

    endpoints = get_service_discovery().get_endpoint_info()
    endpoints = [ep for ep in endpoints if not ep.sleep]
    if requested_model:
        matching = [ep for ep in endpoints if requested_model in ep.model_names]
        if endpoints and not matching:
            return web.json_response(
                {"error": f"model {requested_model!r} not found"}, status=400
            )
        endpoints = matching
    if not endpoints:
        return web.json_response(
            {"error": f"no healthy endpoints for model {requested_model!r}"}, status=503
        )

    # passive circuit breaking: open-breaker backends drop out of the
    # candidate set (fail-static: an all-open set passes through unchanged,
    # so a fully-tripped fleet degrades to "try anyway", never a hard 503)
    candidates = endpoints
    endpoints = get_breaker_registry().filter_endpoints(endpoints)

    engine_stats = get_engine_stats_scraper().get_engine_stats()
    # shed-aware placement: saturated backends (inside a 429 Retry-After
    # window, or reporting vllm:engine_saturated on scrape) receive no new
    # NON-STICKY traffic. Sticky means THIS request actually resolves a
    # session key — that request keeps its backend (losing affinity costs a
    # full-prefix recompute; the engine's own 429 plus failover covers the
    # truly-saturated case). Keyless requests under a SessionRouter fall
    # back to QPS routing and are as re-homeable as any other traffic, so
    # they route around saturation too. Fail-static when the whole fleet is
    # saturated.
    sticky = False
    if isinstance(router, SessionRouter):
        headers = getattr(request, "headers", None)
        sticky = bool(
            (headers.get(router.session_key) if headers is not None else None)
            or (request_json or {}).get(router.session_key)
        )
    # SLO-class tagging (docs/failure-handling.md priority classes): resolve
    # the class once here; _filter_headers forwards X-Priority to the engine
    # untouched, so the engine's class-aware admission sees the same label.
    priority = request_priority(getattr(request, "headers", None), request_json)
    count_request_class(priority)
    if not sticky:
        endpoints = router.saturation_filtered(endpoints, engine_stats)
        # batch avoids engines failing their interactive tenants (fail-static
        # inside class_filtered — a fully-degraded fleet passes through and
        # the engine's batch-first shed answers with the honest 429)
        filtered = router.class_filtered(
            endpoints, priority, _batch_avoid_attainment
        )
        if len(filtered) < len(endpoints):
            count_batch_deprioritized()
        endpoints = filtered

    request_stats = get_request_stats_monitor().get_request_stats()
    t_route0 = time.perf_counter()
    try:
        server_url = await router.route_request(
            endpoints, engine_stats, request_stats, request, request_json
        )
    except Exception as e:
        logger.exception("routing failed")
        return web.json_response({"error": f"routing failure: {e}"}, status=500)

    async def pick_next(excluded: set) -> Optional[str]:
        """Failover target: re-run the routing logic over the surviving
        candidates (already-failed URLs excluded, open breakers and
        saturated backends excluded WITHOUT the fail-static fallback — if
        every alternative is tripped or shedding, surfacing the original
        error/429 beats queueing on a known-bad or known-full pod)."""
        sat = get_saturation_registry()
        pool = [
            ep for ep in candidates
            if ep.url not in excluded and not sat.is_saturated(ep.url)
        ]
        pool = get_breaker_registry().filter_endpoints(pool, fail_static=False)
        if not pool:
            return None
        return await router.route_request(
            pool,
            get_engine_stats_scraper().get_engine_stats(),
            get_request_stats_monitor().get_request_stats(),
            request, request_json,
        )

    curr_time = time.time()
    get_collector().record(
        "router.routing", trace_ctx.child(),
        curr_time - (time.perf_counter() - t_route0),
        time.perf_counter() - t_route0,
        backend=server_url, logic=type(router).__name__,
        request_id=request_id,
    )
    logger.info(
        "Routing request %s for model %s to %s at %f, process time = %.4f",
        request_id, requested_model, server_url, curr_time, curr_time - in_router_time,
    )
    is_streaming = bool(request_json.get("stream", False))
    return await process_request(
        request, body, server_url, endpoint, request_id,
        is_streaming=is_streaming, capture_body=capture_body, ts_recv=ts_recv,
        trace_ctx=trace_ctx, pick_next=pick_next,
    )


async def send_request_to_prefiller(
    session: aiohttp.ClientSession, url: str, endpoint: str, payload: dict,
    request_id: str, trace_ctx=None, timeout: Optional[float] = None,
) -> "tuple[int, dict]":
    """Phase 1: run prefill with max_tokens=1 (parity request.py:307-325).
    ``timeout`` bounds the whole phase — a hung prefiller must convert to a
    failover, not pin the request (and its KV pages) forever.

    Returns ``(status, body)`` for non-5xx responses; raises
    _RetryableProxyError for 5xx so only genuine backend failures enter the
    retry/breaker path — a 400 (client's fault) must pass through verbatim,
    not trip every healthy prefiller's breaker."""
    headers = {"X-Request-Id": request_id}
    if trace_ctx is not None:
        headers[TRACEPARENT_HEADER] = trace_ctx.to_traceparent()
    async with session.post(
        f"{url}{endpoint}",
        json=payload,
        headers=headers,
        timeout=aiohttp.ClientTimeout(total=timeout or None),
    ) as resp:
        if resp.status >= 500:
            detail = (await resp.read())[:200]
            raise _RetryableProxyError(
                f"prefiller returned {resp.status}: "
                f"{detail.decode(errors='replace')}",
                resp.status,
            )
        if resp.status == 429:
            # prefiller shed (admission control): breaker-neutral immediate
            # failover to another prefiller, same as the general proxy path
            retry_after = _parse_retry_after(resp.headers.get("Retry-After"))
            get_saturation_registry().mark(url, retry_after)
            count_shed()
            raise _RetryableProxyError(
                f"prefiller shed the request (429, retry-after "
                f"{retry_after:g}s)", 429, retry_after=retry_after,
            )
        try:
            body = await resp.json()
        except Exception:  # noqa: BLE001 - non-JSON 4xx body
            body = {"error": (await resp.text())[:500]}
        return resp.status, body


async def route_disaggregated_prefill_request(
    request: web.Request, endpoint: str, request_json: dict, request_id: str,
    trace_ctx=None, ts_recv: Optional[float] = None,
) -> web.StreamResponse:
    """Two-phase P/D flow (parity request.py:347-439): prefill pool computes
    KV (max_tokens=1), KV ships prefill->decode out-of-band (ICI/DCN via the
    engine's kv-transfer role), then the decode pool streams tokens."""
    router = get_routing_logic()
    assert isinstance(router, DisaggregatedPrefillRouter)
    endpoints = [ep for ep in get_service_discovery().get_endpoint_info() if not ep.sleep]
    if not endpoints:
        return web.json_response({"error": "no endpoints"}, status=503)
    policy = get_retry_policy()
    breakers = get_breaker_registry()
    # no set-wide pre-filter here: route_prefill/route_decode breaker-filter
    # per ROLE internally, so a tripped prefiller degrades fail-static within
    # the prefill pool instead of re-homing prefill onto decode pods
    prefill_url = router.route_prefill(endpoints)
    decode_url = router.route_decode(endpoints)
    monitor = get_request_stats_monitor()
    session = await get_client_session()

    orig_max_tokens = request_json.get("max_tokens", 256)
    prefill_json = dict(request_json)
    prefill_json["max_tokens"] = 1
    prefill_json["stream"] = False
    prefill_json.setdefault("kv_transfer_params", {})["request_id"] = request_id

    t_start = time.time()
    t_attempts0 = time.monotonic()  # --deadline-request anchor, both phases
    logger.info(
        "Routing request %s for model %s to prefill=%s decode=%s at %f",
        request_id, request_json.get("model"), prefill_url, decode_url, t_start,
    )

    def _phase_timeout() -> Optional[float]:
        """Per-attempt prefill timeout: the TTFT deadline clamped by what is
        left of the per-request (attempt-phase) deadline."""
        t = policy.deadline_ttft if policy.deadline_ttft > 0 else None
        rem = policy.remaining(t_attempts0)
        if rem is not None:
            t = min(t, max(rem, 0.001)) if t else max(rem, 0.001)
        return t

    # phase-1 failover: a failed/hung prefiller retries against another
    # prefiller (already-failed URLs excluded), same budget/backoff/deadline
    # as the general proxy path
    attempt = 0
    tried: set = set()
    while True:
        attempt += 1
        tried.add(prefill_url)
        t0 = time.time()
        monitor.on_new_request(prefill_url, request_id)
        prefill_ctx = trace_ctx.child() if trace_ctx is not None else None
        try:
            status, prefill_body = await send_request_to_prefiller(
                session, prefill_url, endpoint, prefill_json, request_id,
                trace_ctx=prefill_ctx,
                timeout=_phase_timeout(),
            )
            if status >= 400:
                # 4xx: the CLIENT's fault and the prefiller is alive —
                # forward verbatim; retrying it against other prefillers
                # would trip every healthy breaker on bad client traffic
                monitor.on_request_complete(prefill_url, request_id)
                breakers.record_success(prefill_url)
                return web.json_response(prefill_body, status=status)
            monitor.on_request_response(prefill_url, request_id)
            monitor.on_request_complete(prefill_url, request_id)
            breakers.record_success(prefill_url)
            logger.info("Prefill of %s done in %.3fs (TTFT)", request_id, time.time() - t0)
            get_collector().record(
                "router.disagg_prefill", prefill_ctx, t0, time.time() - t0,
                backend=prefill_url, request_id=request_id, attempt=attempt,
            )
            break
        except (_RetryableProxyError, aiohttp.ClientError, asyncio.TimeoutError,
                ConnectionResetError) as e:
            monitor.on_request_complete(prefill_url, request_id)
            shed = isinstance(e, _RetryableProxyError) and e.is_shed
            if not shed:  # sheds are capacity, not failure: breaker-neutral
                breakers.record_failure(prefill_url)
            if isinstance(e, asyncio.TimeoutError):
                count_deadline_abort("ttft")
                spawn_abort(prefill_url, request_id)
            get_collector().record(
                "router.disagg_prefill", prefill_ctx, t0, time.time() - t0,
                backend=prefill_url, request_id=request_id, attempt=attempt,
                error=str(e), outcome="retryable_error",
            )
            logger.error(
                "prefill on %s failed for request %s (attempt %d/%d): %s",
                prefill_url, request_id, attempt, policy.max_attempts, e,
            )
            remaining = policy.remaining(t_attempts0)
            if remaining is not None and remaining <= 0:
                count_deadline_abort("request")
                return web.json_response(
                    {"error": f"request deadline exceeded after {attempt} "
                              f"prefill attempt(s): {e}"},
                    status=504,
                )
            # untried endpoints only, and ROLE-correct: when the deployment
            # has prefill-labeled pods, failover must stay within them —
            # _pick's label fallback would otherwise silently run prefill on
            # a decode pod, breaking the disaggregation invariant. With no
            # labeled pods anywhere (label-less test rigs) any pod is fair.
            sat = get_saturation_registry()
            pool = [ep for ep in endpoints
                    if ep.url not in tried and not sat.is_saturated(ep.url)]
            if any(ep.model_label in router.prefill_labels for ep in endpoints):
                pool = [ep for ep in pool
                        if ep.model_label in router.prefill_labels]
            if attempt >= policy.max_attempts or not pool:
                if shed:
                    return _overloaded_response(
                        f"all prefillers saturated after {attempt} attempt(s)",
                        e.retry_after,
                    )
                return web.json_response(
                    {"error": f"prefill failed after {attempt} attempt(s): {e}"},
                    status=502,
                )
            count_retry()
            count_failover()
            delay = 0.0 if shed else policy.backoff(attempt)
            if remaining is not None:
                delay = min(delay, max(0.0, remaining))
            await asyncio.sleep(delay)
            prefill_url = router.route_prefill(pool)

    async def pick_next_decode(excluded: set) -> Optional[str]:
        pool = [ep for ep in endpoints if ep.url not in excluded]
        pool = breakers.filter_endpoints(pool, fail_static=False)
        return router.route_decode(pool) if pool else None

    decode_json = dict(request_json)
    decode_json["max_tokens"] = orig_max_tokens
    decode_json.setdefault("kv_transfer_params", {})["request_id"] = request_id
    body = json.dumps(decode_json).encode()
    # ts_recv rides through so the router.request root span covers the WHOLE
    # P/D request (prefill phase included) — without it the root would start
    # at the decode proxy and the disagg_prefill child would fall outside
    # its parent's window, corrupting the attribution table
    return await process_request(
        request, body, decode_url, endpoint, request_id,
        is_streaming=bool(request_json.get("stream", False)),
        trace_ctx=trace_ctx, ts_recv=ts_recv, pick_next=pick_next_decode,
        attempts_anchor=t_attempts0,
    )


async def route_sleep_wakeup_request(
    request: web.Request, path: str
) -> web.Response:
    """Proxy /sleep, /wake_up, /is_sleeping to a specific engine chosen by
    ?url=... or model, and update discovery sleep flags
    (parity request.py:442-514)."""
    target = request.query.get("url")
    sd = get_service_discovery()
    candidates = [ep for ep in sd.get_endpoint_info() if target is None or ep.url == target]
    # sleeping endpoints are filtered from get_endpoint_info (k8s mode) but
    # must still be reachable for wake_up
    if hasattr(sd, "endpoints"):
        known = {c.url for c in candidates}
        for ep in getattr(sd, "endpoints").values():
            if ep.url not in known and (target is None or ep.url == target):
                candidates.append(ep)
    elif target is not None and not candidates and target in getattr(sd, "urls", []):
        candidates = [EndpointInfo(url=target, model_names=[], added_timestamp=0)]
    if not candidates:
        return web.json_response({"error": "no matching engine"}, status=404)
    ep = candidates[0]
    session = await get_client_session()
    try:
        if path == "/is_sleeping":
            async with session.get(f"{ep.url}{path}") as resp:
                return web.json_response(await resp.json(), status=resp.status)
        async with session.post(
            f"{ep.url}{path}", params={k: v for k, v in request.query.items() if k != "url"}
        ) as resp:
            status = resp.status
        if status == 200:
            await sd.set_sleep_label(ep.url, path == "/sleep")
        return web.Response(status=status)
    except aiohttp.ClientError as e:
        return web.json_response({"error": str(e)}, status=502)
