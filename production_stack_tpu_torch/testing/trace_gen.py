"""Deterministic trace-driven workload generator (docs/failure-handling.md
priority classes; bench.py --qa trace phase, chaos mixed-class-overload).

The port's copy of ``production_stack_tpu/testing/trace_gen.py`` (pure
Python): the same arguments and seed give the same trace as the original.

Synthesizes the arrival process the multi-tenant SLO work is judged under:

- **bursty + diurnal arrivals** — a non-homogeneous Poisson process whose
  rate is ``base_qps`` modulated by a slow sinusoid (the diurnal swell) with
  periodic multiplicative bursts on top (the thundering herd). Sampled by
  thinning, so the arrival pattern is exact for the composed rate function.
- **mixed context lengths** — log-uniform over [min_context, max_context]
  (default 1k..32k): most requests are short, the tail is genuinely long,
  matching production context distributions better than uniform draws.
- **mixed SLO classes** — each request is ``batch`` with probability
  ``batch_fraction`` else ``interactive``; batch requests draw longer
  outputs (they are the migration/preemption victims under overload).

Everything is driven by one ``random.Random(seed)``: the same arguments
always produce the identical trace (tests/test_slo_classes.py pins this),
which is what makes overload benchmarks comparable across runs — the
variance-bounded QA headline replays the same trace, not a fresh sample.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass


@dataclass
class TraceRequest:
    """One synthetic arrival."""

    t: float             # arrival offset in seconds from trace start
    prompt_tokens: int   # context length
    output_tokens: int   # decode length
    priority: str        # "interactive" | "batch"


def generate_trace(
    *,
    seed: int,
    duration_s: float,
    base_qps: float,
    burst_factor: float = 3.0,
    burst_period_s: float = 30.0,
    burst_duration_s: float = 5.0,
    diurnal_period_s: float = 120.0,
    diurnal_amplitude: float = 0.5,
    batch_fraction: float = 0.3,
    min_context: int = 1024,
    max_context: int = 32768,
    interactive_output: tuple = (16, 128),
    batch_output: tuple = (64, 512),
) -> list:
    """Build the full trace up front (bounded: duration * peak rate).

    Returns ``TraceRequest`` rows sorted by arrival time. Deterministic in
    every argument; no global RNG state is touched.
    """
    if duration_s <= 0 or base_qps <= 0:
        return []
    rng = random.Random(seed)
    amp = max(0.0, min(1.0, diurnal_amplitude))
    burst = max(1.0, burst_factor)

    def rate(t: float) -> float:
        r = base_qps * (
            1.0 + amp * math.sin(2.0 * math.pi * t / diurnal_period_s)
        )
        if burst_period_s > 0 and (t % burst_period_s) < burst_duration_s:
            r *= burst
        return r

    peak = base_qps * (1.0 + amp) * burst
    out: list = []
    t = 0.0
    ln_min, ln_max = math.log(max(1, min_context)), math.log(max_context)
    while True:
        # thinning: propose at the peak rate, accept at rate(t)/peak
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() > rate(t) / peak:
            continue
        if rng.random() < batch_fraction:
            priority, (lo, hi) = "batch", batch_output
        else:
            priority, (lo, hi) = "interactive", interactive_output
        out.append(TraceRequest(
            t=round(t, 6),
            prompt_tokens=int(math.exp(rng.uniform(ln_min, ln_max))),
            output_tokens=rng.randint(lo, hi),
            priority=priority,
        ))
    return out


def trace_summary(trace: list) -> dict:
    """Shape digest for logs and assertions (bench embeds it in results)."""
    if not trace:
        return {"n": 0}
    by_class = {"interactive": 0, "batch": 0}
    for r in trace:
        by_class[r.priority] += 1
    ctx = sorted(r.prompt_tokens for r in trace)
    return {
        "n": len(trace),
        "duration_s": round(trace[-1].t, 3),
        "by_class": by_class,
        "context_p50": ctx[len(ctx) // 2],
        "context_max": ctx[-1],
        "mean_qps": round(len(trace) / max(1e-9, trace[-1].t), 3),
    }


__all__ = ["TraceRequest", "generate_trace", "trace_summary"]
