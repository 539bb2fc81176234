"""Per-peer link probing and transfer-cost scoring for the KV fabric; the
port's copy of production_stack_tpu/kvfabric/peers.py.

`engine/linkprobe.py` measures the host<->device link once at startup; the
fabric extends the same idea engine-to-engine: each peer's usable bandwidth
and RTT are MEASURED (a small ping for RTT, a timed ~1 MB echo for
bandwidth — the linkprobe pilot/bulk staging, scaled to a network hop),
cached with a TTL, and re-probed after a transfer failure instead of on a
timer. NetKV is the design source: peer selection driven by probed link
bandwidth and queue depth beats round-robin exactly when links are
asymmetric — the normal state between engines on one host (loopback, NVLink)
and engines on different hosts (the data-center network).

The score every chooser uses (disagg router picking a decode target, the
fleet controller picking a migration target, the engine picking a pull
source) is :func:`transfer_cost_score` — bytes/second the peer can actually
absorb right now, i.e. probed bandwidth discounted by the peer's fabric
queue depth.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

# small echo for RTT; big enough echo that bandwidth dominates RTT on any
# link worth distinguishing (1 MB ~ a KV page at common configs)
PROBE_PILOT_BYTES = 4 << 10
PROBE_BULK_BYTES = 1 << 20
# a cached probe stays trusted this long unless a transfer failure
# invalidates it first
PROBE_TTL_S = 300.0


@dataclass
class PeerLink:
    """One probed peer link. ``bandwidth`` is bytes/second measured over the
    fabric echo; ``rtt`` is seconds for a pilot round trip."""

    addr: str
    bandwidth: float = 0.0
    rtt: float = 0.0
    probed_at: float = field(default_factory=time.monotonic)
    failures: int = 0


def probe_peer_link(
    addr: str, request_fn: Callable[[dict, bytes], "tuple[dict, bytes]"]
) -> "tuple[float, float]":
    """Measure (bandwidth_bytes_per_s, rtt_s) against one fabric peer.

    ``request_fn(header, payload) -> (header, payload)`` is a fabric
    round-trip (the client's ``fabric_probe`` op: the server echoes the
    payload back). RTT comes from the pilot; bandwidth from the bulk echo
    (both directions counted, matching linkprobe's round-trip convention).
    Raises on any transport error — the caller records the failure and
    falls back to unscored selection for this peer."""
    pilot = bytes(PROBE_PILOT_BYTES)
    t0 = time.perf_counter()
    hdr, _ = request_fn({"op": "fabric_probe", "echo": len(pilot)}, pilot)
    rtt = time.perf_counter() - t0
    if not hdr.get("ok"):
        raise ConnectionError(f"fabric probe refused by {addr}: {hdr}")
    bulk = bytes(PROBE_BULK_BYTES)
    t0 = time.perf_counter()
    hdr, echoed = request_fn({"op": "fabric_probe", "echo": len(bulk)}, bulk)
    dt = time.perf_counter() - t0
    if not hdr.get("ok") or len(echoed) != len(bulk):
        raise ConnectionError(f"fabric bulk probe failed against {addr}")
    # subtract the pilot-measured RTT so tiny payloads on high-latency links
    # don't read as slow bandwidth; floor keeps the division sane
    xfer = max(dt - rtt, 1e-6)
    return (2 * len(bulk)) / xfer, rtt


class PeerProbeCache:
    """TTL cache of :class:`PeerLink` measurements, one per peer address.

    ``get`` returns the cached link, probing (via the injected probe
    callable) when missing or expired; ``invalidate`` drops a peer after a
    transfer failure so the next touch re-probes — a peer that restarted on
    a different machine class must not keep its old score. Probe failures
    are recorded (the link keeps bandwidth 0.0 → sorts last) rather than
    raised: scoring is advisory, transfers carry their own retry/breaker."""

    def __init__(
        self,
        probe_fn: Callable[[str], "tuple[float, float]"],
        ttl_s: float = PROBE_TTL_S,
    ):
        self._probe_fn = probe_fn
        self.ttl_s = ttl_s
        self._links: "dict[str, PeerLink]" = {}
        self._lock = threading.Lock()
        self.probes = 0
        self.probe_failures = 0

    def get(self, addr: str) -> PeerLink:
        now = time.monotonic()
        with self._lock:
            link = self._links.get(addr)
            if link is not None and now - link.probed_at < self.ttl_s:
                return link
        self.probes += 1
        try:
            bw, rtt = self._probe_fn(addr)
            link = PeerLink(addr, bandwidth=bw, rtt=rtt, probed_at=now)
        except Exception as e:  # noqa: BLE001 - scoring must not break transfer
            self.probe_failures += 1
            logger.warning("fabric peer probe failed for %s: %s", addr, e)
            prev = self._links.get(addr)
            link = PeerLink(
                addr, probed_at=now,
                failures=(prev.failures + 1 if prev else 1),
            )
        with self._lock:
            self._links[addr] = link
        return link

    def invalidate(self, addr: str) -> None:
        with self._lock:
            link = self._links.pop(addr, None)
        if link is not None:
            logger.info("fabric peer %s invalidated after failure", addr)

    def snapshot(self) -> "dict[str, PeerLink]":
        with self._lock:
            return dict(self._links)


def transfer_cost_score(
    bandwidth: float, queue_depth: "float | int", rtt: float = 0.0
) -> float:
    """Higher = better target. Probed bandwidth discounted by the peer's
    in-flight fabric ops (NetKV's cost model: a fast link behind a deep
    queue is a slow link), with RTT as a mild tiebreak between idle peers."""
    depth = max(0.0, float(queue_depth))
    score = float(bandwidth) / (1.0 + depth)
    if rtt > 0:
        score /= 1.0 + min(rtt, 1.0)
    return score


def pick_best_peer(
    candidates: "list[tuple[str, float, float]]",
) -> Optional[str]:
    """``candidates`` = [(url, bandwidth, queue_depth)]; returns the url with
    the best transfer-cost score, or None for an empty list. All-zero
    bandwidths (nothing probed yet) return None so callers keep their
    round-robin default rather than a degenerate argmax."""
    if not candidates:
        return None
    if all(bw <= 0 for _, bw, _ in candidates):
        return None
    best = max(candidates, key=lambda c: transfer_cost_score(c[1], c[2]))
    return best[0]
