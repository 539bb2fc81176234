"""Saturation-driven fleet controller.

The port's copy of ``production_stack_tpu/migration/controller.py``;
it imports neither the JAX package nor torch.

The stack's first closed control loop over its own telemetry: the reference
stack scales replicas with prometheus-adapter but must kill or
drain-to-completion any pod it removes; with live sequence migration
(migration/manager.py) the controller instead *moves* work, so scale-down,
drain, and hot-spot rebalancing are zero-loss.

Structure mirrors the stack's other control surfaces:

- :class:`FleetDecider` — the PURE decision core (no I/O): given per-backend
  views and the fleet saturation signal it returns actions, applying
  **hysteresis** (rebalancing engages above the high watermark and stays
  engaged until pressure falls below the low watermark — no flapping at the
  threshold), a **cooldown** between actions, and a **cap on concurrent
  migrations** (each migration costs the source a device fetch and the
  target a restore; an unbounded storm would be self-inflicted overload).
  Unit-tested in isolation (tests/test_migration.py).
- :class:`FleetController` — the asyncio loop around it: scrapes each
  engine's ``/metrics`` (the same ``vllm:`` names the router scrapes, so it
  works against real and fake engines alike) and optionally the router's
  ``vllm_router:fleet_saturation`` gauge, executes decisions by POSTing
  ``/migrate_out`` to sources, and exposes its own Prometheus surface.
  ``scripts/fleet_controller.py`` is the CLI entrypoint; chaos
  ``--scenario scale-cycle`` drives it as a library.

Decisions by kind:

- ``rebalance`` — migrate the K hottest (longest-output) migratable streams
  from the most pressured engine to the least pressured one.
- ``drain`` — evacuate EVERY migratable sequence from a victim before it is
  SIGTERM'd (zero-loss scale-down); exposed as :meth:`FleetController.evacuate`.
- ``warm_up`` — a newly appeared engine is noted (it prefetches the fleet's
  top warm prefixes itself via ``--warm-prefetch-on-boot`` before /ready;
  the decision records that scale-up completed so operators can alert on a
  scale-up that never warmed).
- ``latency_protect`` — an engine whose *interactive* TTFT/ITL p99 (the
  ``vllm:interactive_{ttft,itl}_p99_ms`` gauges) breached its watermark
  sheds BATCH-class streams to the coolest peer before any interactive
  stream is touched (docs/failure-handling.md priority classes). Per-URL
  hysteresis: engages on breach, releases only when the p99 falls below
  ``latency_release_ratio`` x watermark.
"""

from __future__ import annotations

import asyncio
import re
import time
from dataclasses import dataclass, field
from typing import Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

_METRIC_LINE = re.compile(
    r"^(vllm:[a-z0-9_]+|vllm_router:[a-z0-9_]+)(?:\{[^}]*\})? ([0-9.eE+-]+)$"
)


@dataclass
class BackendView:
    """One engine's scraped state for a controller tick."""

    url: str
    healthy: bool = True
    saturated: bool = False
    waiting: int = 0
    running: int = 0
    # probed KV-fabric bandwidth summed over the engine's peer links
    # (vllm:kv_fabric_peer_bandwidth_bytes_per_sec; 0 = fabric off). A
    # migration target with a live fabric link receives the page chain
    # device-to-device instead of through the shared tier, so equal-pressure
    # target picks prefer the higher-bandwidth backend (docs/kv-fabric.md)
    fabric_bandwidth: float = 0.0
    # rolling interactive-class latency p99s the engine exports
    # (vllm:interactive_ttft_p99_ms / vllm:interactive_itl_p99_ms); 0 until
    # the first interactive request finishes — the latency_protect policy
    # treats 0 as "no signal", never as "fast"
    interactive_ttft_p99: float = 0.0
    interactive_itl_p99: float = 0.0
    # [{"request_id": ..., "output_tokens": ..., "priority": ...}, ...] —
    # migratable streams (priority defaults interactive when absent)
    migratable: list = field(default_factory=list)

    def batch_migratable(self) -> list:
        """Migratable streams in the batch SLO class — the only legal
        victims for latency_protect preemption."""
        return [
            r for r in self.migratable
            if r.get("priority", "interactive") == "batch"
        ]

    def rank_key(self, queue_ref: int) -> tuple:
        """Target-selection sort key: pressure first, probed fabric
        bandwidth as the tiebreak (higher bandwidth sorts earlier among
        equal-pressure backends — cheaper to ship a page chain to)."""
        return (self.pressure(queue_ref), -self.fabric_bandwidth)

    def pressure(self, queue_ref: int) -> float:
        """[0, 1] pressure score, mirroring the router's fleet-saturation
        per-backend term: saturation pins 1.0, else queue depth normalized
        by ``queue_ref`` with a small running-load term so two empty-queue
        backends still order by load."""
        if not self.healthy:
            return 0.0
        if self.saturated:
            return 1.0
        q = max(1, queue_ref)
        return min(1.0, self.waiting / q + 0.1 * min(1.0, self.running / q))


@dataclass
class Action:
    kind: str   # "rebalance" | "drain" | "warm_up" | "latency_protect"
    source: Optional[str] = None
    target: Optional[str] = None
    request_ids: list = field(default_factory=list)


@dataclass
class ControllerPolicy:
    """Policy knobs (docs/migration.md has the tuning table)."""

    # rebalance engages when (hottest - coolest) pressure exceeds this...
    rebalance_high_delta: float = 0.5
    # ...and stays engaged until the delta falls below this (hysteresis)
    rebalance_low_delta: float = 0.2
    # seconds between controller-initiated actions of the same kind
    cooldown_s: float = 10.0
    # migrations in flight fleet-wide; further rebalance decisions wait
    max_concurrent_migrations: int = 2
    # streams moved per rebalance decision (hottest/longest first)
    rebalance_k: int = 1
    # queue-depth normalizer for the pressure score (the router's
    # --saturation-queue-ref twin)
    saturation_queue_ref: int = 8
    # latency protection (0 disables): when an engine's interactive-class
    # TTFT or ITL p99 exceeds its watermark, batch streams migrate off it
    interactive_ttft_watermark_ms: float = 0.0
    interactive_itl_watermark_ms: float = 0.0
    # per-URL hysteresis release: disengage only when the breached p99
    # falls below watermark * this ratio (not at the watermark itself)
    latency_release_ratio: float = 0.7
    # batch streams moved per latency_protect decision
    latency_protect_k: int = 1


class FleetDecider:
    """Pure decision core — feed it views, read back actions. All state is
    explicit so the hysteresis/cooldown units test without a clock or I/O
    (``now`` is injected)."""

    def __init__(self, policy: ControllerPolicy):
        self.policy = policy
        self._engaged = False            # rebalance hysteresis latch
        self._latency_engaged: set = set()  # per-URL latency_protect latch
        self._last_action: dict = {}     # kind -> monotonic ts
        self._known_urls: set = set()    # for warm_up (new engine) detection
        self.decisions_total: dict = {
            "rebalance": 0, "drain": 0, "warm_up": 0, "latency_protect": 0,
        }

    def _cooled(self, kind: str, now: float) -> bool:
        last = self._last_action.get(kind)
        return last is None or now - last >= self.policy.cooldown_s

    def _note(self, kind: str, now: float) -> None:
        self._last_action[kind] = now
        self.decisions_total[kind] += 1

    def decide(
        self,
        views: list,
        inflight_migrations: int = 0,
        now: Optional[float] = None,
    ) -> list:
        """One tick. ``views`` are BackendView; returns Actions."""
        now = time.monotonic() if now is None else now
        p = self.policy
        actions: list = []
        healthy = [v for v in views if v.healthy]
        # warm_up: an engine url seen for the first time (scale-up landed)
        for v in healthy:
            if v.url not in self._known_urls and self._known_urls:
                actions.append(Action("warm_up", target=v.url))
                self._note("warm_up", now)
        self._known_urls.update(v.url for v in healthy)
        if len(healthy) < 2:
            self._engaged = False
            return actions
        scored = sorted(
            healthy, key=lambda v: v.rank_key(p.saturation_queue_ref)
        )
        cold, hot = scored[0], scored[-1]
        # latency protection (docs/failure-handling.md priority classes):
        # an engine failing its INTERACTIVE latency watermark sheds batch
        # streams to the coolest peer — batch is always preempted before
        # any interactive stream is considered, and an engine with no
        # interactive signal yet (p99 == 0) never engages
        for v in healthy:
            breach = (
                p.interactive_ttft_watermark_ms > 0
                and v.interactive_ttft_p99 > p.interactive_ttft_watermark_ms
            ) or (
                p.interactive_itl_watermark_ms > 0
                and v.interactive_itl_p99 > p.interactive_itl_watermark_ms
            )
            released = (
                p.interactive_ttft_watermark_ms <= 0
                or v.interactive_ttft_p99
                < p.interactive_ttft_watermark_ms * p.latency_release_ratio
            ) and (
                p.interactive_itl_watermark_ms <= 0
                or v.interactive_itl_p99
                < p.interactive_itl_watermark_ms * p.latency_release_ratio
            )
            if v.url not in self._latency_engaged and breach:
                self._latency_engaged.add(v.url)
            elif v.url in self._latency_engaged and released:
                self._latency_engaged.discard(v.url)
            if not (
                v.url in self._latency_engaged
                and inflight_migrations < p.max_concurrent_migrations
                and self._cooled("latency_protect", now)
            ):
                continue
            budget = min(
                p.latency_protect_k,
                p.max_concurrent_migrations - inflight_migrations,
            )
            victims = sorted(
                v.batch_migratable(),
                key=lambda r: -int(r.get("output_tokens", 0)),
            )[:budget]
            targets = [t for t in scored if t.url != v.url]
            if victims and targets:
                actions.append(Action(
                    "latency_protect", source=v.url, target=targets[0].url,
                    request_ids=[r["request_id"] for r in victims],
                ))
                self._note("latency_protect", now)
        delta = hot.pressure(p.saturation_queue_ref) - cold.pressure(
            p.saturation_queue_ref
        )
        # hysteresis: engage above the high watermark, stay engaged until
        # the delta falls below the low one — a delta hovering at the
        # threshold must not flap the controller on and off every tick
        if not self._engaged and delta >= p.rebalance_high_delta:
            self._engaged = True
        elif self._engaged and delta < p.rebalance_low_delta:
            self._engaged = False
        if (
            self._engaged
            and hot.migratable
            and inflight_migrations < p.max_concurrent_migrations
            and self._cooled("rebalance", now)
        ):
            budget = min(
                p.rebalance_k,
                p.max_concurrent_migrations - inflight_migrations,
            )
            victims = sorted(
                hot.migratable,
                key=lambda r: -int(r.get("output_tokens", 0)),
            )[:budget]
            if victims:
                actions.append(Action(
                    "rebalance", source=hot.url, target=cold.url,
                    request_ids=[r["request_id"] for r in victims],
                ))
                self._note("rebalance", now)
        return actions

    def plan_drain(self, views: list, victim_url: str) -> list:
        """Evacuation plan: every migratable stream on the victim, spread
        over the surviving backends coolest-first (round-robin so one target
        does not absorb the whole working set)."""
        victim = next((v for v in views if v.url == victim_url), None)
        survivors = sorted(
            (v for v in views if v.url != victim_url and v.healthy),
            key=lambda v: v.rank_key(self.policy.saturation_queue_ref),
        )
        if victim is None or not survivors or not victim.migratable:
            return []
        actions = []
        for i, r in enumerate(sorted(
            victim.migratable, key=lambda r: -int(r.get("output_tokens", 0))
        )):
            actions.append(Action(
                "drain", source=victim_url,
                target=survivors[i % len(survivors)].url,
                request_ids=[r["request_id"]],
            ))
        if actions:
            self._note("drain", time.monotonic())
        return actions


class FleetController:
    """Asyncio loop: scrape -> decide -> execute. HTTP only (aiohttp); the
    controller is a pure client of the engines' and router's surfaces, so it
    runs anywhere — a sidecar, a CLI, or in-process in the chaos harness."""

    def __init__(
        self,
        engine_urls: list,
        router_url: Optional[str] = None,
        policy: Optional[ControllerPolicy] = None,
        tick_interval_s: float = 5.0,
        migrate_timeout_s: float = 30.0,
    ):
        self.engine_urls = list(engine_urls)
        self.router_url = router_url
        self.policy = policy or ControllerPolicy()
        self.decider = FleetDecider(self.policy)
        self.tick_interval_s = tick_interval_s
        self.migrate_timeout_s = migrate_timeout_s
        self._session = None
        # request_id -> started monotonic; entries retire on completion or
        # timeout so a wedged migration cannot pin the concurrency cap
        self._inflight: dict = {}
        self.migrations_started = 0
        self.migrations_failed = 0
        self.last_fleet_saturation = 0.0

    async def _client(self):
        import aiohttp

        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=10)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # -- scraping ------------------------------------------------------------

    @staticmethod
    def parse_metrics(text: str) -> dict:
        """Summed values per metric name (label sets collapse, like the
        router's EngineStats parser)."""
        out: dict = {}
        for line in text.splitlines():
            line = line.strip()
            m = _METRIC_LINE.match(line)
            if m:
                # label-collapsed sum; names used here are single-series
                out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
        return out

    async def _fetch_text(self, url: str) -> Optional[str]:
        try:
            session = await self._client()
            async with session.get(url) as resp:
                if resp.status != 200:
                    return None
                return await resp.text()
        except Exception:  # noqa: BLE001 - a dead backend is a view, not a crash
            return None

    async def _fetch_json(self, url: str) -> Optional[dict]:
        try:
            session = await self._client()
            async with session.get(url) as resp:
                if resp.status != 200:
                    return None
                return await resp.json()
        except Exception:  # noqa: BLE001
            return None

    async def view_of(self, url: str) -> BackendView:
        text = await self._fetch_text(f"{url}/metrics")
        if text is None:
            return BackendView(url=url, healthy=False)
        vals = self.parse_metrics(text)
        view = BackendView(
            url=url,
            healthy=True,
            saturated=bool(vals.get("vllm:engine_saturated", 0)),
            waiting=int(vals.get("vllm:num_requests_waiting", 0)),
            running=int(vals.get("vllm:num_requests_running", 0)),
            fabric_bandwidth=float(
                vals.get("vllm:kv_fabric_peer_bandwidth_bytes_per_sec", 0.0)
            ),
            interactive_ttft_p99=float(
                vals.get("vllm:interactive_ttft_p99_ms", 0.0)
            ),
            interactive_itl_p99=float(
                vals.get("vllm:interactive_itl_p99_ms", 0.0)
            ),
        )
        listing = await self._fetch_json(f"{url}/migratable")
        if listing:
            view.migratable = [
                r for r in listing.get("requests", [])
                if r.get("migratable", True)
            ]
        return view

    async def gather_views(self) -> list:
        return list(await asyncio.gather(
            *(self.view_of(u) for u in self.engine_urls)
        ))

    async def fleet_saturation(self) -> float:
        """The router's autoscaling gauge when a router is configured, else
        the mean of the per-backend pressure scores."""
        if self.router_url:
            text = await self._fetch_text(f"{self.router_url}/metrics")
            if text is not None:
                vals = self.parse_metrics(text)
                if "vllm_router:fleet_saturation" in vals:
                    return float(vals["vllm_router:fleet_saturation"])
        views = await self.gather_views()
        if not views:
            return 0.0
        return sum(
            v.pressure(self.policy.saturation_queue_ref) for v in views
        ) / len(views)

    # -- execution -----------------------------------------------------------

    def _sweep_inflight(self) -> None:
        cutoff = time.monotonic() - self.migrate_timeout_s
        for rid in [r for r, t in self._inflight.items() if t < cutoff]:
            del self._inflight[rid]

    async def migrate(self, source: str, request_id: str, target: str) -> bool:
        """POST /migrate_out on the source; True when the stream moved."""
        self._inflight[request_id] = time.monotonic()
        self.migrations_started += 1
        try:
            session = await self._client()
            async with session.post(
                f"{source}/migrate_out",
                json={"request_id": request_id, "target_url": target},
            ) as resp:
                body = await resp.json()
                ok = resp.status == 200 and bool(body.get("migrated"))
        except Exception as e:  # noqa: BLE001 - failure = pick another victim
            logger.warning(
                "migrate_out %s %s -> %s failed: %s",
                request_id, source, target, e,
            )
            ok = False
        finally:
            self._inflight.pop(request_id, None)
        if not ok:
            self.migrations_failed += 1
        return ok

    async def execute(self, action: Action) -> int:
        """Run one action; returns migrations that succeeded."""
        if action.kind == "warm_up":
            logger.info(
                "fleet controller: engine %s scaled up (boot prefetch is "
                "engine-side: --warm-prefetch-on-boot)", action.target,
            )
            return 0
        n = 0
        for rid in action.request_ids:
            if await self.migrate(action.source, rid, action.target):
                n += 1
        return n

    async def tick(self) -> list:
        """One control iteration: scrape, decide, execute. Returns the
        actions taken (chaos/tests introspect them)."""
        self._sweep_inflight()
        views = await self.gather_views()
        self.last_fleet_saturation = await self.fleet_saturation()
        actions = self.decider.decide(views, len(self._inflight))
        for a in actions:
            await self.execute(a)
        return actions

    async def run(self, stop: Optional[asyncio.Event] = None) -> None:
        stop = stop or asyncio.Event()
        while not stop.is_set():
            try:
                await self.tick()
            except Exception:  # noqa: BLE001 - the loop must outlive one bad tick
                logger.exception("fleet controller tick failed")
            try:
                await asyncio.wait_for(stop.wait(), self.tick_interval_s)
            except asyncio.TimeoutError:
                pass

    async def evacuate(
        self, victim_url: str, deadline_s: float = 60.0
    ) -> dict:
        """Zero-loss drain: migrate EVERY migratable sequence off the victim
        before the operator SIGTERMs it. Loops (new streams may land on the
        victim while it evacuates — callers should pull it from routing
        first) until the victim reports no running work or the deadline
        passes. Returns a report dict the chaos scenario asserts on."""
        t0 = time.monotonic()
        moved = failed = rounds = 0
        while time.monotonic() - t0 < deadline_s:
            rounds += 1
            views = await self.gather_views()
            victim = next((v for v in views if v.url == victim_url), None)
            if victim is None or not victim.healthy:
                break
            if not victim.migratable and victim.running == 0:
                break
            plan = self.decider.plan_drain(views, victim_url)
            if not plan:
                # running work that is not (yet) migratable: give it a beat
                # to emit its first token or finish
                await asyncio.sleep(0.2)
                continue
            for a in plan:
                n = await self.execute(a)
                moved += n
                failed += len(a.request_ids) - n
            await asyncio.sleep(0.1)
        views = await self.gather_views()
        victim = next((v for v in views if v.url == victim_url), None)
        return {
            "victim": victim_url,
            "moved": moved,
            "failed": failed,
            "rounds": rounds,
            "evacuation_s": round(time.monotonic() - t0, 3),
            "residual_running": victim.running if victim else 0,
            "residual_migratable": len(victim.migratable) if victim else 0,
        }

    # -- observability -------------------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus exposition for --metrics-port:
        vllm:fleet_controller_decisions_total{kind=...},
        vllm:fleet_controller_migrations_started_total,
        vllm:fleet_controller_migrations_failed_total,
        vllm:fleet_controller_migrations_inflight,
        vllm:fleet_controller_fleet_saturation."""
        lines = ["# TYPE vllm:fleet_controller_decisions_total counter"]
        for kind, n in sorted(self.decider.decisions_total.items()):
            lines.append(
                "vllm:fleet_controller_decisions_total"
                f'{{kind="{kind}"}} {n}'
            )
        lines += [
            "# TYPE vllm:fleet_controller_migrations_started_total counter",
            f"vllm:fleet_controller_migrations_started_total "
            f"{self.migrations_started}",
            "# TYPE vllm:fleet_controller_migrations_failed_total counter",
            f"vllm:fleet_controller_migrations_failed_total "
            f"{self.migrations_failed}",
            "# TYPE vllm:fleet_controller_migrations_inflight gauge",
            f"vllm:fleet_controller_migrations_inflight {len(self._inflight)}",
            "# TYPE vllm:fleet_controller_fleet_saturation gauge",
            f"vllm:fleet_controller_fleet_saturation "
            f"{round(self.last_fleet_saturation, 4)}",
        ]
        return "\n".join(lines) + "\n"


__all__ = [
    "Action",
    "BackendView",
    "ControllerPolicy",
    "FleetController",
    "FleetDecider",
]
