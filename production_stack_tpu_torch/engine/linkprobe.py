"""Startup host<->device link-bandwidth probe: the port's counterpart of
production_stack_tpu/engine/linkprobe.py.

``kv_offload_max_io_pages``, the per-operation page budget of KV offload
spills and restores, is a function of the host<->device link bandwidth:
unbounded on PCIe-class links (restoring beats recomputing), a few pages on
slow ones. With the default -1 and an offload tier configured, the engine
measures the link once at startup and derives the cap; both are exported
on /metrics. An explicit ``--kv-offload-max-io-pages >= 0`` skips the probe.

The probe times pinned-host -> device -> pinned-host copies of one buffer
with CUDA events: the copies a spill or restore batch pays.
"""

from __future__ import annotations

from typing import Optional

import torch

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

# links at or above this are "PCIe-class": restore always beats recompute,
# so the I/O budget stays unbounded
FAST_LINK_BYTES_PER_S = 1.0e9
# worst-case engine-loop stall one capped offload operation may cost
STALL_BUDGET_S = 0.25


def probe_link_bandwidth(device, nbytes: int = 8 << 20, trials: int = 3) -> Optional[float]:
    """Best-of-``trials`` round-trip bandwidth in bytes/second between pinned
    host memory and the CUDA ``device``, or None when the probe fails (or the
    device is not a CUDA device)."""
    try:
        device = torch.device(device)
        if device.type != "cuda":
            return None
        host = torch.zeros(nbytes, dtype=torch.uint8).pin_memory()
        dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        best = 0.0
        with torch.cuda.device(device):
            for i in range(trials + 1):  # the first round absorbs set-up
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                dev.copy_(host, non_blocking=True)
                host.copy_(dev, non_blocking=True)
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1)
                if i and ms > 0:
                    best = max(best, 2 * nbytes / (ms / 1e3))
        return best or None
    except Exception as e:  # noqa: BLE001 - the probe must never kill startup
        logger.warning("link-bandwidth probe failed (%s); cap stays unbounded", e)
        return None


def derive_max_io_pages(
    bandwidth_bytes_per_s: Optional[float],
    page_bytes: int,
    *,
    stall_budget_s: float = STALL_BUDGET_S,
    fast_link_bytes_per_s: float = FAST_LINK_BYTES_PER_S,
) -> int:
    """Offload I/O page cap for a measured link bandwidth: 0 (unbounded) for
    an unknown bandwidth or a PCIe-class link; else the pages one
    ``stall_budget_s`` stall can move, at least 1 so chain heads stay
    restorable."""
    if not bandwidth_bytes_per_s or bandwidth_bytes_per_s >= fast_link_bytes_per_s:
        return 0
    return max(1, int(bandwidth_bytes_per_s * stall_budget_s / max(page_bytes, 1)))
