"""Failure-domain layer for the router data plane.

The port's copy of ``production_stack_tpu/router/resilience.py``;
it imports neither the JAX package nor torch.

Three cooperating mechanisms (docs/failure-handling.md):

- **RetryPolicy** — connect-stage and pre-first-byte proxy failures are
  retried with capped exponential backoff + full jitter against the routing
  logic's next-choice endpoint, bounded by an attempt budget and a
  per-request deadline. Mid-stream failures are never retried (tokens have
  already reached the client); they surface as a terminal SSE error event.
- **Deadlines** — a TTFT deadline bounds connect→first-byte, an inter-chunk
  stall timeout bounds each gap between streamed chunks. Both abort the
  backend request AND fire a best-effort ``POST /abort`` on the engine so
  scheduler slots and KV pages are reclaimed instead of leaking behind a
  dead TCP connection.
- **CircuitBreaker** — every proxy outcome feeds a per-backend breaker
  (closed → open after N consecutive failures → half-open probe after a
  cooldown → closed again on success). Routing consults the breakers in
  addition to the optional active health-check loop, so static-discovery
  deployments react to failures without probe traffic. Breaker filtering is
  fail-static: when EVERY candidate's breaker is open the original list is
  returned unchanged — a fully-tripped fleet must degrade to "try anyway",
  never to a synthesized 503.
- **SaturationRegistry** — backend 429 + Retry-After responses (engine load
  shedding, docs/failure-handling.md overload section) mark the backend
  saturated for the advertised window. Shed-aware failover moves the request
  to the next engine immediately WITHOUT feeding the breaker (an overloaded
  engine is healthy), and routing stops offering saturated backends new
  non-sticky traffic until the window elapses.

All state is mutated from the router's single event loop; plain ints are
safe counters here. Rendered into /metrics by ``render_resilience_metrics``
(vllm_router:retries_total, vllm_router:failovers_total,
vllm_router:deadline_aborts_total, vllm_router:circuit_state,
vllm_router:circuit_open_events_total).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

# breaker states, also the circuit_state gauge encoding
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}


@dataclasses.dataclass
class RetryPolicy:
    """Retry/deadline knobs (parser --retry-* / --deadline-* flags).

    ``deadline_request`` bounds the ATTEMPT phase (connect + retries up to
    the first streamed byte), not the stream itself — a 10-minute legitimate
    decode must not be killed by a retry budget. 0 disables a deadline.
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    deadline_request: float = 0.0
    deadline_ttft: float = 0.0
    deadline_inter_chunk: float = 0.0

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff with full jitter (attempt is 1-based:
        the delay before attempt N+1 after attempt N failed)."""
        cap = min(self.backoff_max, self.backoff_base * (2 ** max(0, attempt - 1)))
        return random.uniform(0, cap)

    def remaining(self, t_start: float, now: Optional[float] = None) -> Optional[float]:
        """Seconds left in the attempt-phase deadline, or None if unbounded."""
        if self.deadline_request <= 0:
            return None
        return self.deadline_request - ((now or time.monotonic()) - t_start)


class CircuitBreaker:
    """Passive per-backend breaker.

    closed: traffic flows; ``failure_threshold`` consecutive failures open it.
    open: traffic is filtered out until ``cooldown`` elapses.
    half-open: admits traffic; the first recorded outcome decides — success
    closes, failure re-opens (and restarts the cooldown). No active probes:
    the next real request IS the probe, which is what makes this work for
    static-discovery deployments with no health loop.
    """

    def __init__(self, failure_threshold: int = 5, cooldown: float = 30.0):
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.open_events = 0

    def allow(self, now: Optional[float] = None) -> bool:
        if self.failure_threshold <= 0:  # breaker disabled
            return True
        if self.state == OPEN:
            if now is None:
                now = time.monotonic()
            if now - self.opened_at >= self.cooldown:
                self.state = HALF_OPEN
                return True
            return False
        return True

    def record_success(self) -> None:
        if self.state != CLOSED:
            logger.info("circuit breaker closing (probe succeeded)")
        self.state = CLOSED
        self.consecutive_failures = 0

    def record_probe_success(self) -> None:
        """Out-of-band evidence (active health loop): an OPEN breaker skips
        the rest of its cooldown and goes half-open, but probe traffic never
        ERASES data-plane failure evidence — a backend can pass a 1-token
        dummy probe while 500ing or stalling real requests, and only a real
        request outcome may close the breaker."""
        if self.state == OPEN:
            self.state = HALF_OPEN

    def record_failure(self, now: Optional[float] = None) -> None:
        if self.failure_threshold <= 0:
            return
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
            self.state == CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self.state = OPEN
            self.opened_at = time.monotonic() if now is None else now
            self.open_events += 1

    def peek_state(self, now: Optional[float] = None) -> int:
        """The state the NEXT allow() would see, WITHOUT mutating: a metrics
        scrape must not flip open→half-open itself — that would let scrape
        frequency influence when a straggler failure restarts the cooldown."""
        if self.state == OPEN:
            if now is None:
                now = time.monotonic()
            if now - self.opened_at >= self.cooldown:
                return HALF_OPEN
        return self.state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]


class BreakerRegistry:
    """URL-keyed breakers + the fail-static endpoint filter."""

    def __init__(self, failure_threshold: int = 5, cooldown: float = 30.0):
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self._breakers: dict[str, CircuitBreaker] = {}

    def breaker(self, url: str) -> CircuitBreaker:
        b = self._breakers.get(url)
        if b is None:
            b = self._breakers[url] = CircuitBreaker(
                self.failure_threshold, self.cooldown
            )
        return b

    def record_success(self, url: str) -> None:
        self.breaker(url).record_success()

    def record_probe_success(self, url: str) -> None:
        self.breaker(url).record_probe_success()

    def record_failure(self, url: str) -> None:
        b = self.breaker(url)
        was = b.state
        b.record_failure()
        if b.state == OPEN and was != OPEN:
            logger.warning(
                "circuit breaker OPEN for %s after %d consecutive failures",
                url, b.consecutive_failures,
            )

    def allows(self, url: str) -> bool:
        return self.breaker(url).allow()

    def filter_endpoints(self, endpoints: list, *, fail_static: bool = True) -> list:
        """Drop endpoints whose breaker is open. With ``fail_static`` (the
        routing path), an all-open candidate set is returned unchanged so the
        router degrades to trying a tripped backend rather than 503ing; the
        failover path passes False because it has a better option — giving
        up the retry and surfacing the original error."""
        allowed = [ep for ep in endpoints if self.allows(ep.url)]
        if not allowed and fail_static:
            return list(endpoints)
        return allowed

    def open_urls(self) -> list[str]:
        return sorted(
            url for url, b in self._breakers.items() if b.state == OPEN
        )

    def forget(self, url: str) -> None:
        """Drop a backend's breaker (pod deleted): a replacement pod reusing
        the address must start closed, not inherit the corpse's open state."""
        self._breakers.pop(url, None)

    def states(self) -> dict[str, CircuitBreaker]:
        return dict(self._breakers)


class SessionPinRegistry:
    """Session re-pins after a live migration (docs/migration.md).

    A SessionRouter maps a session key to its backend through a consistent
    hash ring — deterministic, so a stream migrated off its hashed home
    would bounce straight back on the session's next request and thrash.
    A pin is an explicit override: "this session now lives on <url>",
    written by the router's stream-splice path when it hands a migrated
    stream over, consulted by SessionRouter before the ring, expired by TTL
    (a session that goes quiet long enough re-homes via the ring, which is
    also how pins converge back after a scale event)."""

    TTL_S = 1800.0

    def __init__(self):
        self._pins: dict[str, tuple[str, float]] = {}  # sid -> (url, expiry)

    def pin(self, session_id: str, url: str, ttl: Optional[float] = None) -> None:
        self._pins[session_id] = (
            url, time.monotonic() + (ttl if ttl is not None else self.TTL_S)
        )

    def lookup(self, session_id: str, now: Optional[float] = None) -> Optional[str]:
        ent = self._pins.get(session_id)
        if ent is None:
            return None
        url, expiry = ent
        if (now or time.monotonic()) >= expiry:
            del self._pins[session_id]
            return None
        return url

    def forget_backend(self, url: str) -> None:
        """Backend gone (pod deleted / drained away): its pins must not keep
        steering sessions at a corpse."""
        for sid in [s for s, (u, _) in self._pins.items() if u == url]:
            del self._pins[sid]

    def clear(self) -> None:
        self._pins.clear()

    def __len__(self) -> int:
        return len(self._pins)


class SaturationRegistry:
    """Per-backend load-shed state (overload survival).

    A backend answering 429 + Retry-After is SHEDDING, not failing: it is
    healthy, it just has no capacity right now. The registry remembers the
    advertised Retry-After window so routing stops offering the backend new
    non-sticky traffic until the window elapses — a scrape-interval-fast
    signal (the engine-stats gauge lags by up to a scrape period). Distinct
    from the circuit breaker by design: sheds never feed the breaker, so an
    overloaded-but-alive fleet can't trip itself into fail-static mode.
    """

    def __init__(self):
        self._until: dict[str, float] = {}  # url -> monotonic expiry
        # every backend that EVER shed, for 1->0 gauge transitions: a series
        # that vanishes instead of flipping to 0 leaves Prometheus showing a
        # stale 1 until the staleness interval, and `== 0` alerts never fire
        self._seen: set[str] = set()

    # shed-window clamp (defense in depth with request_service's Retry-After
    # parser): one 429 must never exclude a backend for longer than this
    MAX_WINDOW_S = 60.0

    def mark(self, url: str, retry_after_s: float) -> None:
        window = min(self.MAX_WINDOW_S, max(0.5, retry_after_s))
        self._until[url] = time.monotonic() + window
        self._seen.add(url)

    def is_saturated(self, url: str, now: Optional[float] = None) -> bool:
        until = self._until.get(url)
        if until is None:
            return False
        if (now or time.monotonic()) >= until:
            del self._until[url]  # window elapsed: eligible again
            return False
        return True

    def saturated_urls(self) -> list[str]:
        now = time.monotonic()
        return sorted(u for u in list(self._until) if self.is_saturated(u, now))

    def seen_urls(self) -> list[str]:
        return sorted(self._seen)

    def forget(self, url: str) -> None:
        """Backend gone (pod deleted): drop its window AND its gauge row."""
        self._until.pop(url, None)
        self._seen.discard(url)

    def clear(self) -> None:
        self._until.clear()
        self._seen.clear()


# -- counters (event-loop-only mutation; rendered by app.py /metrics) --------

retries_total = 0
failovers_total = 0
sheds_total = 0  # backend 429s observed (shed-aware failover, not failures)
deadline_aborts_total: dict[str, int] = {"ttft": 0, "inter_chunk": 0, "request": 0}
# live-migration stream handoffs the proxy spliced (each is a session re-pin
# of the in-flight stream; SessionRouter pins are registered alongside)
session_repins_total = 0
# handoffs that failed after the source committed (the client got the SSE
# error-event contract instead of a silent truncation)
migration_splice_failures_total = 0
# per-SLO-class request tagging (docs/failure-handling.md priority classes):
# closed label set, zero rows always rendered so dashboards see the split
# from the first scrape
requests_by_class_total: dict[str, int] = {"interactive": 0, "batch": 0}
# batch requests steered away from at least one backend whose interactive
# SLO attainment was degraded (RoutingInterface.class_filtered shrank the
# candidate set) — a flat line under overload means the avoidance filter
# never engaged
batch_deprioritized_routes_total = 0


def count_retry() -> None:
    global retries_total
    retries_total += 1


def count_failover() -> None:
    global failovers_total
    failovers_total += 1


def count_shed() -> None:
    global sheds_total
    sheds_total += 1


def count_deadline_abort(kind: str) -> None:
    deadline_aborts_total[kind] = deadline_aborts_total.get(kind, 0) + 1


def count_request_class(priority: str) -> None:
    key = priority if priority in requests_by_class_total else "interactive"
    requests_by_class_total[key] += 1


def count_batch_deprioritized() -> None:
    global batch_deprioritized_routes_total
    batch_deprioritized_routes_total += 1


def count_session_repin() -> None:
    global session_repins_total
    session_repins_total += 1


def count_migration_splice_failure() -> None:
    global migration_splice_failures_total
    migration_splice_failures_total += 1


def reset_counters() -> None:
    """Test/bench support (mirrors reset_hop_samples): live Prometheus
    counters never reset outside a process restart."""
    global retries_total, failovers_total, sheds_total
    global session_repins_total, migration_splice_failures_total
    global batch_deprioritized_routes_total
    retries_total = 0
    failovers_total = 0
    sheds_total = 0
    session_repins_total = 0
    migration_splice_failures_total = 0
    batch_deprioritized_routes_total = 0
    for k in list(deadline_aborts_total):
        deadline_aborts_total[k] = 0
    for k in list(requests_by_class_total):
        requests_by_class_total[k] = 0


def render_resilience_metrics() -> list[str]:
    """Prometheus exposition lines for the failure-domain layer."""
    lines = [
        "# TYPE vllm_router:retries_total counter",
        f"vllm_router:retries_total {retries_total}",
        "# TYPE vllm_router:failovers_total counter",
        f"vllm_router:failovers_total {failovers_total}",
        "# TYPE vllm_router:sheds_total counter",
        f"vllm_router:sheds_total {sheds_total}",
        "# TYPE vllm_router:session_repins_total counter",
        f"vllm_router:session_repins_total {session_repins_total}",
        "# TYPE vllm_router:migration_splice_failures_total counter",
        f"vllm_router:migration_splice_failures_total "
        f"{migration_splice_failures_total}",
        "# TYPE vllm_router:batch_deprioritized_routes_total counter",
        f"vllm_router:batch_deprioritized_routes_total "
        f"{batch_deprioritized_routes_total}",
        "# TYPE vllm_router:deadline_aborts_total counter",
    ]
    for kind, n in sorted(deadline_aborts_total.items()):
        lines.append(f'vllm_router:deadline_aborts_total{{kind="{kind}"}} {n}')
    lines.append("# TYPE vllm_router:requests_by_class_total counter")
    for pri, n in sorted(requests_by_class_total.items()):
        lines.append(
            f'vllm_router:requests_by_class_total{{priority="{pri}"}} {n}'
        )
    reg = get_breaker_registry()
    states = reg.states()
    if states:
        lines.append("# TYPE vllm_router:circuit_state gauge")
        for url, b in sorted(states.items()):
            # read-only view of what the NEXT routing decision would see
            # (an elapsed cooldown shows half-open without mutating state)
            lines.append(
                f'vllm_router:circuit_state{{backend="{url}"}} {b.peek_state()}'
            )
        lines.append("# TYPE vllm_router:circuit_open_events_total counter")
        for url, b in sorted(states.items()):
            lines.append(
                f'vllm_router:circuit_open_events_total{{backend="{url}"}} {b.open_events}'
            )
    sat_reg = get_saturation_registry()
    seen = sat_reg.seen_urls()
    if seen:
        active = set(sat_reg.saturated_urls())
        lines.append("# TYPE vllm_router:backend_saturated gauge")
        for url in seen:  # 0 rows included: the gauge flips, never vanishes
            lines.append(
                f'vllm_router:backend_saturated{{backend="{url}"}} '
                f"{int(url in active)}"
            )
    return lines


# -- singletons --------------------------------------------------------------

_policy: Optional[RetryPolicy] = None
_registry: Optional[BreakerRegistry] = None
_saturation: Optional[SaturationRegistry] = None
_session_pins: Optional[SessionPinRegistry] = None


def get_saturation_registry() -> SaturationRegistry:
    global _saturation
    if _saturation is None:
        _saturation = SaturationRegistry()
    return _saturation


def get_session_pins() -> SessionPinRegistry:
    global _session_pins
    if _session_pins is None:
        _session_pins = SessionPinRegistry()
    return _session_pins


def initialize_resilience(
    *,
    retry_max_attempts: int = 3,
    retry_backoff_base: float = 0.05,
    retry_backoff_max: float = 2.0,
    deadline_request: float = 0.0,
    deadline_ttft: float = 0.0,
    deadline_inter_chunk: float = 0.0,
    breaker_failure_threshold: int = 5,
    breaker_cooldown: float = 30.0,
) -> None:
    global _policy, _registry
    get_saturation_registry().clear()  # reconfigure: no stale shed windows
    get_session_pins().clear()  # ...and no stale migration pins
    _policy = RetryPolicy(
        max_attempts=retry_max_attempts,
        backoff_base=retry_backoff_base,
        backoff_max=retry_backoff_max,
        deadline_request=deadline_request,
        deadline_ttft=deadline_ttft,
        deadline_inter_chunk=deadline_inter_chunk,
    )
    _registry = BreakerRegistry(breaker_failure_threshold, breaker_cooldown)
    logger.info(
        "resilience layer: attempts=%d backoff=%.3fs..%.1fs deadlines "
        "request=%.1fs ttft=%.1fs inter_chunk=%.1fs breaker threshold=%d "
        "cooldown=%.1fs",
        retry_max_attempts, retry_backoff_base, retry_backoff_max,
        deadline_request, deadline_ttft, deadline_inter_chunk,
        breaker_failure_threshold, breaker_cooldown,
    )


def get_retry_policy() -> RetryPolicy:
    global _policy
    if _policy is None:  # unit tests / embedded use: defaults apply
        _policy = RetryPolicy()
    return _policy


def get_breaker_registry() -> BreakerRegistry:
    global _registry
    if _registry is None:
        _registry = BreakerRegistry()
    return _registry
