"""KV fabric client: the pushing/pulling side every mover shares; the port's
copy of production_stack_tpu/kvfabric/client.py.

One ``KVFabricClient`` per engine serves every mover — streamed disagg
prefill pushes, the fleet directory's resident-page pulls
(kvdirectory.DirectoryPuller) and live migration's page-chain ships
(``LLMEngine.fabric_ship_pairs``). It owns:

- one lazily-connected :class:`BlockingClient` per peer address (guarded by
  a per-peer lock: callers run on the device thread, the puller executor,
  and the migration executor concurrently);
- a per-peer circuit breaker: ``BREAKER_THRESHOLD`` consecutive failures
  open the breaker for ``BREAKER_COOLDOWN_S`` — during the cooldown every
  fabric call against that peer fails instantly and the caller takes its
  tier fallback, so a dead peer costs one timeout, not one per page;
- bounded retries (``retries`` config) below the breaker;
- the :class:`PeerProbeCache` (peers.py) so choosers can score peers, with
  failures invalidating the cached probe;
- the fabric counters and latency histograms the engine exports on
  /metrics (``vllm:kv_fabric_*``).

Every public method degrades to a documented failure value (False/None)
instead of raising: the fabric is an OPTIMIZATION over the tier path, and
the contract is that a fabric outage converts to tier traffic + counted
fallbacks, never to request errors.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from production_stack_tpu_torch.kvfabric import peers as fabric_peers
from production_stack_tpu_torch.kvfabric.wire import (
    FabricWireError,
    decode_frame,
    verify_frame,
)
from production_stack_tpu_torch.kvoffload.protocol import BlockingClient, parse_hostport
from production_stack_tpu_torch.utils.logging import init_logger
from production_stack_tpu_torch.utils.metrics import Histogram

logger = init_logger(__name__)

BREAKER_THRESHOLD = 3
BREAKER_COOLDOWN_S = 30.0

# fabric transfers are sub-second on healthy links; buckets stretch to the
# breaker cooldown so a timing-out peer is still visible in the histogram
FABRIC_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class KVFabricClient:
    def __init__(self, retries: int = 2, timeout: float = 30.0):
        self.retries = max(0, int(retries))
        self.timeout = timeout
        self._clients: "dict[str, BlockingClient]" = {}
        self._locks: "dict[str, threading.Lock]" = {}
        self._breaker: "dict[str, tuple[int, float]]" = {}  # addr -> (fails, open_until)
        self._meta_lock = threading.Lock()
        self.probe_cache = fabric_peers.PeerProbeCache(self._probe_addr)
        self.pushed_pages = 0
        self.pulled_pages = 0
        self.fallbacks = 0
        self.corrupt_frames = 0
        self.breaker_opens = 0
        self.push_hist = Histogram(
            "vllm:kv_fabric_stream_latency_seconds",
            FABRIC_LATENCY_BUCKETS,
            "Latency of one fabric push (streamed prefill / migration ship)",
        )
        self.pull_hist = Histogram(
            "vllm:kv_fabric_pull_latency_seconds",
            FABRIC_LATENCY_BUCKETS,
            "Latency of one fabric resident-page pull",
        )

    # -- connection + breaker plumbing ----------------------------------------

    def _lock_for(self, addr: str) -> threading.Lock:
        with self._meta_lock:
            lock = self._locks.get(addr)
            if lock is None:
                lock = self._locks[addr] = threading.Lock()
            return lock

    def _client_for(self, addr: str) -> BlockingClient:
        with self._meta_lock:
            cli = self._clients.get(addr)
            if cli is None:
                host, port = parse_hostport(addr)
                cli = self._clients[addr] = BlockingClient(
                    host, port, timeout=self.timeout
                )
            return cli

    def breaker_open(self, addr: str) -> bool:
        with self._meta_lock:
            _, until = self._breaker.get(addr, (0, 0.0))
            return until > time.monotonic()

    def _record_success(self, addr: str) -> None:
        with self._meta_lock:
            self._breaker.pop(addr, None)

    def _record_failure(self, addr: str) -> None:
        with self._meta_lock:
            fails, _ = self._breaker.get(addr, (0, 0.0))
            fails += 1
            until = 0.0
            if fails >= BREAKER_THRESHOLD:
                until = time.monotonic() + BREAKER_COOLDOWN_S
                self.breaker_opens += 1
            self._breaker[addr] = (fails, until)
        if fails >= BREAKER_THRESHOLD:
            logger.warning(
                "fabric breaker OPEN for %s after %d failures (%.0fs cooldown)",
                addr, fails, BREAKER_COOLDOWN_S,
            )
        # a failed transfer invalidates the cached probe: the peer may be
        # gone, rebooted elsewhere, or congested — re-measure on recovery
        self.probe_cache.invalidate(addr)

    def _request(self, addr: str, header: dict, payload: bytes = b"") -> "tuple[dict, bytes]":
        """One fabric round trip with bounded retries under the breaker.
        Raises ConnectionError when the breaker is open or every attempt
        failed — callers convert that to their tier fallback."""
        if self.breaker_open(addr):
            raise ConnectionError(f"fabric breaker open for {addr}")
        last: Optional[Exception] = None
        for _ in range(1 + self.retries):
            try:
                with self._lock_for(addr):
                    hdr, body = self._client_for(addr).request(header, payload)
                self._record_success(addr)
                return hdr, body
            except Exception as e:  # noqa: BLE001 - retried, then surfaced
                last = e
                self._record_failure(addr)
                if self.breaker_open(addr):
                    break
        raise ConnectionError(f"fabric request to {addr} failed: {last}")

    def _probe_addr(self, addr: str) -> "tuple[float, float]":
        return fabric_peers.probe_peer_link(
            addr, lambda hdr, payload: self._request(addr, hdr, payload)
        )

    # -- public ops ------------------------------------------------------------

    def hello(self, addr: str) -> Optional[dict]:
        """Peer handshake; returns the peer's {generation, quant, page_size,
        nlayers} or None when unreachable."""
        try:
            hdr, _ = self._request(addr, {"op": "fabric_hello"})
            return hdr if hdr.get("ok") else None
        except Exception:  # noqa: BLE001
            return None

    def probe(self, addr: str) -> fabric_peers.PeerLink:
        """Cached per-peer bandwidth/RTT (re-probed on TTL or failure)."""
        return self.probe_cache.get(addr)

    def push(self, addr: str, frame: bytes) -> bool:
        """Ship one wire frame (already encoded) to a peer's sink. Returns
        False on any failure — the caller counts a fallback and takes the
        tier path for those pages."""
        t0 = time.perf_counter()
        try:
            # pre-flight the frame locally: a frame corrupted before send
            # (encoder bug, memory fault) must not spend a network round
            # trip to be quarantined by the peer
            n_pages = len(verify_frame(frame)["keys"])
        except FabricWireError as e:
            self.corrupt_frames += 1
            logger.warning("refusing to push corrupt fabric frame: %s", e)
            return False
        try:
            hdr, _ = self._request(addr, {"op": "fabric_push"}, frame)
            if not hdr.get("ok"):
                if hdr.get("error") == "integrity":
                    self.corrupt_frames += 1
                return False
            self.pushed_pages += n_pages
            self.push_hist.observe(time.perf_counter() - t0)
            return True
        except Exception as e:  # noqa: BLE001
            logger.debug("fabric push to %s failed: %s", addr, e)
            return False

    def pull(
        self,
        addr: str,
        keys: "list[str]",
        expect_generation: Optional[int] = None,
    ) -> Optional[dict]:
        """Fetch resident pages from a peer. Returns the decoded frame dict
        (wire.decode_frame shape, ``found`` keys only) or None on miss /
        stale generation / transport failure / corrupt reply — every None is
        the caller's cue to fall back to the tier path."""
        t0 = time.perf_counter()
        req = {"op": "fabric_pull", "keys": list(keys)}
        if expect_generation is not None:
            req["expect_generation"] = int(expect_generation)
        try:
            hdr, body = self._request(addr, req)
        except Exception as e:  # noqa: BLE001
            logger.debug("fabric pull from %s failed: %s", addr, e)
            return None
        if not hdr.get("ok") or not hdr.get("found") or not body:
            return None
        try:
            frame = decode_frame(body)
        except FabricWireError as e:
            # corrupt reply: quarantine (count + drop), invalidate the probe
            # (the link may be flaky), let the tier path cover these keys
            self.corrupt_frames += 1
            self.probe_cache.invalidate(addr)
            logger.warning("quarantining corrupt fabric pull from %s: %s", addr, e)
            return None
        self.pulled_pages += len(frame["keys"])
        self.pull_hist.observe(time.perf_counter() - t0)
        return frame

    def count_fallback(self, n: int = 1) -> None:
        self.fallbacks += n

    def close(self) -> None:
        with self._meta_lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for cli in clients:
            try:
                cli.close()
            except Exception:  # noqa: BLE001
                pass

    def stats(self) -> dict:
        return {
            "pushed_pages": self.pushed_pages,
            "pulled_pages": self.pulled_pages,
            "fallbacks": self.fallbacks,
            "corrupt_frames": self.corrupt_frames,
            "breaker_opens": self.breaker_opens,
            "probes": self.probe_cache.probes,
            "probe_failures": self.probe_cache.probe_failures,
        }
