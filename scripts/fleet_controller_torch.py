#!/usr/bin/env python3
"""Saturation-driven fleet controller CLI (docs/migration.md), on the port: the
CLI of scripts/fleet_controller.py. It imports neither the JAX package nor
torch.

Runs the closed control loop in production_stack_tpu_torch/migration/controller.py
as a standalone process — a prometheus-adapter-style sidecar that consumes
the stack's own telemetry (per-engine ``vllm:engine_saturated`` / queue
depth via ``/metrics``, ``vllm_router:fleet_saturation`` when a router URL
is given) and, instead of only *reporting* pressure, acts on it with live
sequence migration:

- steady-state loop: **rebalance** the hottest long streams off the most
  pressured engine onto the coolest one (hysteresis + cooldown +
  max-concurrent-migrations cap);
- ``--drain URL``: **evacuate** every migratable sequence off one engine and
  exit — run this before SIGTERM'ing the pod and scale-down drops zero
  streams (the chaos ``--scenario scale-cycle`` asserts exactly this);
- ``--once``: one decision tick (cron-style operation), print the actions.

Examples:

    python scripts/fleet_controller_torch.py \
        --engines http://e0:8100,http://e1:8100 --router-url http://r:8000
    python scripts/fleet_controller_torch.py --engines ... --drain http://e1:8100
    python scripts/fleet_controller_torch.py --engines ... --once

``--metrics-port`` serves the controller's own Prometheus surface
(``vllm:fleet_controller_*``, see docs/migration.md).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

sys.path.insert(0, ".")

from production_stack_tpu_torch.migration.controller import (  # noqa: E402
    ControllerPolicy,
    FleetController,
)
from production_stack_tpu_torch.utils.logging import init_logger  # noqa: E402

logger = init_logger("fleet-controller")


def build_controller(args) -> FleetController:
    policy = ControllerPolicy(
        rebalance_high_delta=args.rebalance_high_delta,
        rebalance_low_delta=args.rebalance_low_delta,
        cooldown_s=args.cooldown,
        max_concurrent_migrations=args.max_concurrent_migrations,
        rebalance_k=args.rebalance_k,
        saturation_queue_ref=args.saturation_queue_ref,
        interactive_ttft_watermark_ms=args.interactive_ttft_watermark_ms,
        interactive_itl_watermark_ms=args.interactive_itl_watermark_ms,
        latency_release_ratio=args.latency_release_ratio,
        latency_protect_k=args.latency_protect_k,
    )
    return FleetController(
        engine_urls=[u for u in args.engines.split(",") if u],
        router_url=args.router_url,
        policy=policy,
        tick_interval_s=args.tick_interval,
    )


async def _serve_metrics(ctrl: FleetController, host: str, port: int):
    from aiohttp import web

    async def metrics(request):
        return web.Response(
            text=ctrl.metrics_text(), content_type="text/plain"
        )

    app = web.Application()
    app.router.add_get("/metrics", metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    logger.info("fleet controller metrics on %s:%d", host, port)
    return runner


async def _run(args) -> int:
    ctrl = build_controller(args)
    try:
        if args.metrics_port:
            await _serve_metrics(ctrl, args.metrics_host, args.metrics_port)
        if args.drain:
            report = await ctrl.evacuate(
                args.drain.rstrip("/"), deadline_s=args.drain_deadline
            )
            print(json.dumps(report, indent=2))
            ok = (
                report["residual_running"] == 0
                and report["residual_migratable"] == 0
            )
            print("DRAIN " + ("COMPLETE" if ok else "INCOMPLETE"))
            return 0 if ok else 1
        if args.once:
            actions = await ctrl.tick()
            print(json.dumps(
                [a.__dict__ for a in actions], indent=2
            ))
            return 0
        from production_stack_tpu_torch.utils.signals import wait_for_termination

        stop = asyncio.Event()
        loop_task = asyncio.create_task(ctrl.run(stop))
        await wait_for_termination()
        stop.set()
        await loop_task
        return 0
    finally:
        await ctrl.close()


def main() -> int:
    p = argparse.ArgumentParser("fleet-controller")
    p.add_argument("--engines", required=True,
                   help="comma-separated engine base URLs the controller "
                        "scrapes and migrates between")
    p.add_argument("--router-url", default=None,
                   help="router base URL; its vllm_router:fleet_saturation "
                        "gauge becomes the fleet pressure signal (default: "
                        "mean per-engine pressure)")
    p.add_argument("--tick-interval", type=float, default=5.0,
                   help="seconds between control-loop ticks")
    p.add_argument("--rebalance-high-delta", type=float, default=0.5,
                   help="hottest-minus-coolest pressure delta that ENGAGES "
                        "rebalancing (hysteresis high watermark)")
    p.add_argument("--rebalance-low-delta", type=float, default=0.2,
                   help="pressure delta below which rebalancing disengages "
                        "(hysteresis low watermark)")
    p.add_argument("--cooldown", type=float, default=10.0,
                   help="seconds between controller actions of one kind")
    p.add_argument("--max-concurrent-migrations", type=int, default=2,
                   help="fleet-wide cap on migrations in flight")
    p.add_argument("--rebalance-k", type=int, default=1,
                   help="streams moved per rebalance decision (longest "
                        "output first)")
    p.add_argument("--saturation-queue-ref", type=int, default=8,
                   help="queue depth that scores a backend's pressure as "
                        "1.0 (the router's --saturation-queue-ref twin)")
    p.add_argument("--interactive-ttft-watermark-ms", type=float, default=0.0,
                   help="interactive-class TTFT p99 (vllm:interactive_"
                        "ttft_p99_ms) above which batch streams migrate "
                        "off the engine (latency_protect); 0 disables")
    p.add_argument("--interactive-itl-watermark-ms", type=float, default=0.0,
                   help="interactive-class inter-token p99 watermark for "
                        "latency_protect; 0 disables")
    p.add_argument("--latency-release-ratio", type=float, default=0.7,
                   help="latency_protect disengages when the breached p99 "
                        "falls below watermark * this ratio (hysteresis)")
    p.add_argument("--latency-protect-k", type=int, default=1,
                   help="batch streams moved per latency_protect decision")
    p.add_argument("--drain", default=None,
                   help="evacuate every migratable sequence off this engine "
                        "URL (zero-loss scale-down), print a report, exit")
    p.add_argument("--drain-deadline", type=float, default=60.0,
                   help="seconds --drain may spend evacuating")
    p.add_argument("--once", action="store_true",
                   help="run one decision tick and exit")
    p.add_argument("--metrics-host", default="0.0.0.0")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve GET /metrics (vllm:fleet_controller_*) on "
                        "this port; 0 disables")
    args = p.parse_args()
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
