"""Device telemetry for the port engine's ``/metrics``: a rewrite for CUDA
of the JAX package's engine/devicemon.py, under the same series names.

Sampled lazily on scrape (no background thread, nothing between scrapes):

- ``vllm:tpu_hbm_bytes_in_use{device="cuda:0"}`` / ``vllm:tpu_hbm_bytes_limit``
  -- per device: the bytes PyTorch's caching allocator holds on the card
  (``torch.cuda.memory_reserved``: live tensors plus the blocks it keeps for
  reuse, which no other process can have) against the card's total memory
  (``torch.cuda.mem_get_info``). An engine on the CPU reports one
  ``device="host"`` row instead (process RSS against host RAM), as the JAX
  monitor does on a backend without device memory stats.
- ``vllm:hbm_headroom_bytes`` -- sum(limit) - sum(in_use).
- ``vllm:kv_pool_device_bytes`` / ``vllm:kv_pool_used_bytes`` -- the bytes of
  the runner's page pools and their int8 scales (``nbytes`` of the tensors
  themselves, 0 while sleep has dropped them; under tp the leader's times
  tp, every rank holding the same shapes: the one logical pool, as the JAX
  monitor's num_pages x page bytes, with no dp replica counted again), and
  that times the pool's occupancy.
- ``vllm:kv_pool_shard_bytes{device=...}`` -- one row per rank, all pp x
  dp x sp x ep x tp of them: the bytes of that rank's KV-head shard of
  every page (runner.kv_pool_shard_layout, from the pools' shapes, so
  1/tp of the pool each, 1/(pp x tp) under pp; every dp group, and every
  sp and ep rank, holds a whole replica). Ranks on one card keep a row
  each: a rank's label is its device and its rank (``cuda:0/tp1``, with
  dp > 1 ``cuda:0/dp1tp0``, with sp > 1 ``cuda:0/sp1tp0``); a single
  rank's is its device (``cuda:0``).
- ``vllm:compile_seconds_total`` / ``vllm:compile_events_total`` -- the nvcc
  builds of the CUDA kernels this process ran (ops/kernels/_build.py, at a
  kernel's first use or an explicit build). The JAX monitor counts XLA
  backend compiles here; building the hand-written kernels is the port's
  nearest counterpart, and the port compiles nothing else.
- ``vllm:compile_cache_entries`` / ``vllm:compile_cache_bytes`` -- the built
  kernel libraries under ``build/torch_kernels/``.
- ``vllm:engine_step_duty_cycle`` -- the share of wall time the engine loop
  spent in device dispatches since the previous scrape (delta of
  ``loop_seconds["step"]`` over delta wall).

Why a GPU reports under ``tpu_`` names: the stack's dashboard
(observability/tpu-stack-dashboard.json) and the prometheus-adapter rules
that feed the autoscaler read these exact series, so a port engine keeps
them rather than forking every consumer. The memory rows are the leader
process's device only: a follower rank's allocator lives in its own
process.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from production_stack_tpu_torch.ops.kernels import _build


def pool_bytes(runner) -> int:
    """Bytes of the runner's page pools and scales on its device (0 for a
    pool that sleep dropped)."""
    return sum(
        t.nbytes for t in (runner.k_pages, runner.v_pages, runner.k_scales, runner.v_scales)
        if t is not None
    )


class DeviceMonitor:
    """Lazy on-scrape sampler over one engine (its runner's device, pools and
    loop accounting). Memory samples are cached for SAMPLE_MAX_AGE_S so a
    burst of scrapes cannot turn telemetry into load."""

    SAMPLE_MAX_AGE_S = 1.0

    def __init__(self, engine):
        self.engine = engine
        self._mem_sample: tuple[float, list] = (0.0, [])
        self._duty_prev: Optional[tuple[float, float]] = None

    def device_memory(self) -> list[dict]:
        """[{device, bytes_in_use, bytes_limit}]: the runner's CUDA device,
        else one host row."""
        now = time.monotonic()
        ts, cached = self._mem_sample
        if cached and now - ts < self.SAMPLE_MAX_AGE_S:
            return cached
        dev = self.engine.runner.device
        if dev.type == "cuda":
            _, total = torch.cuda.mem_get_info(dev)
            rows = [{
                "device": f"cuda:{dev.index or 0}",
                "bytes_in_use": int(torch.cuda.memory_reserved(dev)),
                "bytes_limit": int(total),
            }]
        else:
            rows = [self._host_memory_row()]
        self._mem_sample = (now, rows)
        return rows

    @staticmethod
    def _host_memory_row() -> dict:
        """The engine on the CPU: the process's RSS against total host RAM
        (a zero row without psutil)."""
        try:
            import psutil
        except ImportError:
            return {"device": "host", "bytes_in_use": 0, "bytes_limit": 0}
        return {
            "device": "host",
            "bytes_in_use": int(psutil.Process().memory_info().rss),
            "bytes_limit": int(psutil.virtual_memory().total),
        }

    def _duty_cycle(self) -> float:
        """d(step seconds)/d(wall) since the previous scrape; 0.0 on the
        first."""
        now = time.monotonic()
        step = float(self.engine.loop_seconds["step"])
        prev = self._duty_prev
        self._duty_prev = (now, step)
        if prev is None or now - prev[0] <= 0:
            return 0.0
        return min(1.0, max(0.0, (step - prev[1]) / (now - prev[0])))

    def metrics_lines(self, model: str) -> list[str]:
        labels = f'model_name="{model}"'
        lines = [
            "# TYPE vllm:tpu_hbm_bytes_in_use gauge",
            "# TYPE vllm:tpu_hbm_bytes_limit gauge",
        ]
        total_use = total_limit = 0
        for row in self.device_memory():
            dl = f'{labels},device="{row["device"]}"'
            lines.append(f"vllm:tpu_hbm_bytes_in_use{{{dl}}} {row['bytes_in_use']}")
            lines.append(f"vllm:tpu_hbm_bytes_limit{{{dl}}} {row['bytes_limit']}")
            total_use += row["bytes_in_use"]
            total_limit += row["bytes_limit"]
        pool = pool_bytes(self.engine.runner) * getattr(self.engine, "tensor_parallel", 1)
        secs, events = _build.compile_totals()
        entries, cache_bytes = _build.cache_size()
        lines += [
            "# TYPE vllm:hbm_headroom_bytes gauge",
            f"vllm:hbm_headroom_bytes{{{labels}}} {max(0, total_limit - total_use)}",
            "# TYPE vllm:kv_pool_device_bytes gauge",
            f"vllm:kv_pool_device_bytes{{{labels}}} {pool}",
            "# TYPE vllm:kv_pool_used_bytes gauge",
            f"vllm:kv_pool_used_bytes{{{labels}}} {int(pool * self.engine.kv.usage())}",
            "# TYPE vllm:kv_pool_shard_bytes gauge",
        ]
        lines += [
            f'vllm:kv_pool_shard_bytes{{{labels},device="{dev}"}} {nbytes}'
            for dev, nbytes in self.engine.runner.kv_pool_shard_layout()
        ]
        lines += [
            "# TYPE vllm:compile_seconds_total counter",
            f"vllm:compile_seconds_total{{{labels}}} {round(secs, 4)}",
            "# TYPE vllm:compile_events_total counter",
            f"vllm:compile_events_total{{{labels}}} {events}",
            "# TYPE vllm:compile_cache_entries gauge",
            f"vllm:compile_cache_entries{{{labels}}} {entries}",
            "# TYPE vllm:compile_cache_bytes gauge",
            f"vllm:compile_cache_bytes{{{labels}}} {cache_bytes}",
            "# TYPE vllm:engine_step_duty_cycle gauge",
            f"vllm:engine_step_duty_cycle{{{labels}}} {round(self._duty_cycle(), 4)}",
        ]
        return lines
