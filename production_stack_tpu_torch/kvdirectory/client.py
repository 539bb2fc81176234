"""Directory clients, the port's copy of production_stack_tpu/kvdirectory/
client.py: async (router / report tooling), publisher (engine background
thread), and puller (engine event-loop prefetch).

All three speak the kvoffload frame protocol against the cache server's
``dir_*`` ops (kvoffload/cache_server.py), so one shared server hosts both
the blob tier and the directory that indexes it.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
from typing import Optional, Sequence

from production_stack_tpu_torch.kvoffload.protocol import (
    BlockingClient,
    parse_hostport,
    read_frame,
    write_frame,
)
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class DirectoryClient:
    """Asyncio request/response client (router lookup path, report script)."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.host, self.port = parse_hostport(url, default_port=8200)
        self.timeout = timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def _request(self, header: dict) -> dict:
        async with self._lock:
            try:
                if self._writer is None:
                    self._reader, self._writer = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port), self.timeout
                    )
                await write_frame(self._writer, header)
                hdr, _ = await asyncio.wait_for(read_frame(self._reader), self.timeout)
                return hdr
            except Exception:
                await self.close()
                raise

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
        self._reader = self._writer = None

    async def lookup(self, tokens: list[int], salt_hex: str = "") -> dict:
        return await self._request(
            {"op": "dir_lookup", "tokens": tokens, "salt": salt_hex}
        )

    async def lookup_hashes(self, hashes: list[str]) -> dict:
        return await self._request({"op": "dir_lookup_hashes", "hashes": hashes})

    async def top_prefixes(self, limit: int, page_size: int = 0) -> dict:
        return await self._request({
            "op": "dir_top_prefixes", "limit": limit, "page_size": page_size,
        })

    async def stats(self) -> dict:
        return await self._request({"op": "dir_stats"})

    async def dump(self) -> dict:
        return await self._request({"op": "dir_dump"})


class DirectoryPublisher:
    """Engine-side dirty-batched publisher.

    The kv_manager hooks (register_filled / evict / proactive_spill) and the
    warm-start spill enqueue claim changes here; a background thread
    coalesces them and flushes one frame batch per ``flush_interval_s`` (the
    engine-stats cadence), so directory upkeep never blocks a serving step
    and a publish storm costs one wire round trip per interval, not one per
    page. Ordering within a flush is preserved (a withdraw enqueued after a
    publish wins)."""

    MAX_PENDING = 16384  # ops; beyond this the oldest are dropped (hint store)

    def __init__(
        self,
        directory_url: str,
        engine_url: str,
        page_size: int,
        generation: int = 1,
        flush_interval_s: float = 5.0,
        shared_enabled: bool = True,
    ):
        self.engine_url = engine_url
        self.page_size = page_size
        self.generation = generation
        self.flush_interval_s = max(0.05, flush_interval_s)
        # shared-tier claims only make sense when the engine writes blobs
        # through to the shared cache server (a disk-only tier is private)
        self.shared_enabled = shared_enabled
        self.publishes = 0
        self.withdrawals = 0
        self.flush_errors = 0
        host, port = parse_hostport(directory_url, default_port=8200)
        self._client = BlockingClient(host, port)
        self._q: queue.Queue = queue.Queue()
        # ENTRY count queued (one batch item can carry a whole working set,
        # so bounding by batch count would leave memory unbounded during a
        # directory outage); guarded by its own lock against the drop-oldest
        # path racing the consumer
        self._queued_entries = 0
        self._entries_lock = threading.Lock()
        self._stop = threading.Event()
        self._registered = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="kv-directory"
        )
        self._thread.start()

    # -- producer side (engine device thread / warm-start) --------------------

    def _put(self, item) -> None:
        with self._entries_lock:
            self._queued_entries += len(item[1])
            while self._queued_entries > self.MAX_PENDING:
                try:  # drop-oldest: the directory is a hint, not a ledger
                    old = self._q.get_nowait()
                except queue.Empty:
                    break
                if old is None:  # never swallow the stop sentinel
                    self._q.put(None)
                    break
                self._queued_entries -= len(old[1])
        self._q.put(item)

    def _take(self, item) -> None:
        """Consumer-side entry accounting for a dequeued batch."""
        with self._entries_lock:
            self._queued_entries -= len(item[1])

    def publish_resident(self, entries: Sequence) -> None:
        """``entries``: (hash bytes, depth, score) of pages now in HBM."""
        if entries:
            self._put(("hbm", [(h.hex(), d, s) for h, d, s in entries]))

    def publish_shared(self, entries: Sequence) -> None:
        """``entries``: (hash bytes, depth, score) whose blobs are CONFIRMED
        in the shared tier (spill / warm-start save confirmations only)."""
        if entries and self.shared_enabled:
            self._put(("shared", [(h.hex(), d, s) for h, d, s in entries]))

    def withdraw(self, hashes: Sequence[bytes], scope: str = "resident") -> None:
        """Evicted from HBM. scope="all" when no restorable blob remains
        (evict-without-spill / dropped beyond the I/O cap)."""
        if hashes:
            self._put(("withdraw-" + scope, [h.hex() for h in hashes]))

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)
        self._client.close()

    # -- flush thread ----------------------------------------------------------

    def _register(self, force: bool = False) -> None:
        if force or not self._registered:
            self._client.request({
                "op": "dir_register", "url": self.engine_url,
                "page_size": self.page_size,
                "generation": self.generation,
            })
            self._registered = True

    def _run(self) -> None:
        pending: list = []
        last_flush = time.monotonic()
        try:
            # eager best-effort register: a COLD engine publishes nothing,
            # but the fleet (directory dumps, liveness TTL) should still see
            # it; failures fall back to register-on-first-flush
            self._register()
        except Exception as e:  # noqa: BLE001 - directory may not be up yet
            logger.warning("kv directory register failed (will retry): %s", e)
        while True:
            wait = max(0.05, self.flush_interval_s - (time.monotonic() - last_flush))
            try:
                item = self._q.get(timeout=wait)
            except queue.Empty:
                item = False  # timeout tick
            if item is None:
                self._flush(pending)  # final drain on stop
                return
            if item:
                self._take(item)
                pending.append(item)
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(pending)
                    return
                self._take(nxt)
                pending.append(nxt)
            if time.monotonic() - last_flush >= self.flush_interval_s:
                if pending:
                    if self._flush(pending):
                        pending = []
                    else:
                        # outage retention is ENTRY-bounded too: keep the
                        # newest batches whose summed entries fit the cap
                        pending = self._trim_entries(pending, self.MAX_PENDING)
                else:
                    # idle heartbeat: re-register so the directory's liveness
                    # TTL never expires a healthy-but-quiet engine's claims
                    try:
                        self._register(force=True)
                    except Exception:  # noqa: BLE001 - retried next tick
                        self._registered = False
                last_flush = time.monotonic()

    @staticmethod
    def _trim_entries(batches: list, cap: int) -> list:
        """Newest suffix of ``batches`` whose summed entry count fits ``cap``."""
        total = 0
        for i in range(len(batches) - 1, -1, -1):
            total += len(batches[i][1])
            if total > cap:
                return batches[i + 1:]
        return batches

    def _merge(self, pending: list) -> list:
        """Coalesce adjacent same-kind batches (order across kinds kept)."""
        merged: list = []
        for kind, items in pending:
            if merged and merged[-1][0] == kind:
                merged[-1][1].extend(items)
            else:
                merged.append((kind, list(items)))
        return merged

    def _flush(self, pending: list) -> bool:
        if not pending:
            return True
        try:
            self._register()
            for kind, items in self._merge(pending):
                if kind in ("hbm", "shared"):
                    self._client.request({
                        "op": "dir_publish", "url": self.engine_url,
                        "generation": self.generation, "tier": kind,
                        "page_size": self.page_size, "entries": items,
                    })
                    self.publishes += len(items)
                else:
                    self._client.request({
                        "op": "dir_withdraw", "url": self.engine_url,
                        "hashes": items,
                        "scope": kind.split("-", 1)[1],
                    })
                    self.withdrawals += len(items)
            return True
        except Exception as e:  # noqa: BLE001 - directory down: retry next tick
            self.flush_errors += 1
            self._registered = False  # re-register on reconnect
            logger.warning("kv directory flush failed: %s", e)
            return False

    def stats(self) -> dict:
        return {
            "kv_directory_publishes_total": self.publishes,
            "kv_directory_withdrawals_total": self.withdrawals,
            "kv_directory_flush_errors_total": self.flush_errors,
        }


class DirectoryPuller:
    """Engine event-loop side of the cross-engine pull.

    On request admission (engine.generate, BEFORE the sequence reaches the
    scheduler) it asks the directory how much of the prompt's chain beyond
    the local prefix match is restorable from the shared tier, and prefetches
    those blobs into the LOCAL host tiers off the event loop. The later
    device-thread restore (kv_manager._extend_from_offload) then finds them
    with a local read instead of paying a per-chunk remote round trip inside
    scheduling. Misses and corrupt blobs degrade to recompute — the store
    CRC-verifies and quarantines on get."""

    def __init__(
        self,
        directory_url: str,
        kv,
        store,
        page_size: int,
        max_pages: int = 256,
        timeout: float = 2.0,
        backoff_s: float = 30.0,
    ):
        self.url = directory_url
        self.kv = kv
        self.store = store
        self.page_size = page_size
        self.max_pages = max_pages
        self.timeout = timeout
        self.backoff_s = backoff_s
        self.lookups = 0
        self.lookup_hits = 0
        self.pulled_pages = 0
        self.fabric_pulled_pages = 0
        self.errors = 0
        self._client: Optional[DirectoryClient] = None
        self._skip_until = 0.0
        # fabric resident-pull path (docs/kv-fabric.md): fetch RESIDENT-only
        # pages straight from the owning engine — zero shared-tier I/O — with
        # the tier walk as fallback. Armed by the engine via enable_fabric.
        self._fabric = None
        self._serde = None
        self.self_url: Optional[str] = None
        self._fabric_addrs: "dict[str, tuple[Optional[str], float]]" = {}

    FABRIC_ADDR_TTL_S = 60.0

    def enable_fabric(self, fabric_client, self_url: str, serde=None) -> None:
        """Arm the fabric pull path: ``fabric_client`` is the engine's
        KVFabricClient (its counters and breaker are shared with the other
        movers); ``self_url`` keeps this engine from "pulling" from itself;
        ``serde`` converts pulled frames into this engine's tier blobs
        (defaults to the engine serde the store was built with)."""
        self._fabric = fabric_client
        self.self_url = self_url
        if serde is None:
            from production_stack_tpu_torch.kvoffload.serde import get_serde

            serde = get_serde("naive")
        self._serde = serde

    async def maybe_prefetch(self, tokens: Sequence[int], salt: bytes = b"") -> int:
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes

        if time.monotonic() < self._skip_until:
            return 0
        hashes = prefix_hashes(tokens, self.page_size, salt)
        if not hashes:
            return 0
        # local-prefix hint: dict probes only (the device thread owns the
        # manager; a racy read here can only cost an unnecessary prefetch)
        local = 0
        for h in hashes:
            if h in self.kv.hash_to_page:
                local += 1
            else:
                break
        missing = hashes[local:]
        if not missing:
            return 0
        self.lookups += 1
        try:
            if self._client is None:
                self._client = DirectoryClient(self.url, timeout=self.timeout)
            res = await self._client.lookup_hashes([h.hex() for h in missing])
        except Exception as e:  # noqa: BLE001 - directory down: back off
            self.errors += 1
            self._client = None
            self._skip_until = time.monotonic() + self.backoff_s
            logger.warning("kv directory lookup failed (backing off): %s", e)
            return 0
        flags = res.get("shared") or []
        n = 0
        for f in flags:
            if not f or n >= self.max_pages:
                break
            n += 1
        if self._fabric is not None:
            # fabric resident pull: fetch straight from the engine that
            # holds the deepest contiguous RESIDENT prefix (a resident hit
            # used to be routing-only — these pages may not exist in the
            # shared tier at all). Generation-fenced: the pull carries the
            # claim's generation and a reborn owner rejects it. Any miss
            # falls through to the shared-tier walk below.
            resident = res.get("resident") or {}
            gens = res.get("generations") or {}
            owner, depth = None, 0
            for url, d in resident.items():
                if url != self.self_url and int(d) > depth:
                    owner, depth = url, int(d)
            depth = min(depth, self.max_pages, len(missing))
            if owner is not None and depth > 0:
                keys = [h.hex() for h in missing[:depth]]
                loop = asyncio.get_running_loop()
                got = await loop.run_in_executor(
                    None, self._fabric_fetch, owner, gens.get(owner), keys
                )
                if got:
                    self.lookup_hits += 1
                    self.fabric_pulled_pages += got
                    self.pulled_pages += got
                    return got
        if n == 0:
            return 0
        self.lookup_hits += 1
        keys = [h.hex() for h in missing[:n]]
        loop = asyncio.get_running_loop()
        got = await loop.run_in_executor(None, self._fetch, keys)
        self.pulled_pages += got
        return got

    def _owner_fabric_addr(self, owner_url: str) -> Optional[str]:
        """Resolve (and cache) an owner's fabric listener via its
        GET /kv_fabric. Negative results are cached too — an owner without
        the fabric enabled must not cost an HTTP round trip per admission."""
        addr, until = self._fabric_addrs.get(owner_url, (None, 0.0))
        if until > time.monotonic():
            return addr
        resolved = None
        try:
            import json as json_mod
            import urllib.request

            with urllib.request.urlopen(
                owner_url.rstrip("/") + "/kv_fabric", timeout=self.timeout
            ) as r:
                info = json_mod.loads(r.read())
            if info.get("enabled", True):
                resolved = info.get("addr")
        except Exception as e:  # noqa: BLE001 - fabric optional per owner
            logger.debug("fabric addr resolve failed for %s: %s", owner_url, e)
        self._fabric_addrs[owner_url] = (
            resolved, time.monotonic() + self.FABRIC_ADDR_TTL_S
        )
        return resolved

    def _fabric_fetch(
        self, owner_url: str, generation: Optional[int], keys: "list[str]"
    ) -> int:
        """Pull resident pages from the owning engine over the fabric
        (executor thread) and land them as LOCAL tier blobs. Returns pages
        landed; 0 sends the caller to the shared-tier fallback (counted as a
        fabric fallback)."""
        addr = self._owner_fabric_addr(owner_url)
        if addr is None:
            return 0
        frame = self._fabric.pull(
            addr, keys,
            expect_generation=int(generation) if generation is not None else None,
        )
        if frame is None:
            # miss/stale/outage: drop the cached addr (the owner may have
            # restarted on a new port) and count the tier fallback
            self._fabric_addrs.pop(owner_url, None)
            self._fabric.count_fallback(len(keys))
            return 0
        from production_stack_tpu_torch.kvfabric.wire import frame_to_blobs

        n = 0
        try:
            for key, blob in frame_to_blobs(frame, self._serde):
                self.store.put_local(key, blob)
                n += 1
        except Exception:  # noqa: BLE001 - partial landing is still progress
            logger.exception("fabric pull landing failed after %d pages", n)
        return n

    def _fetch(self, keys: list[str]) -> int:
        """Pull blobs into the local tiers (executor thread). ``store.get``
        walks local->remote, CRC-verifies, and promotes remote hits into the
        CPU tier; a key already local is free."""
        n = 0
        for k in keys:
            try:
                if self.store.contains_local(k):
                    n += 1
                elif self.store.get(k) is not None:
                    n += 1
                else:
                    break  # chain broken: later chunks are unrestorable anyway
            except Exception:  # noqa: BLE001 - tier error: recompute covers it
                logger.exception("kv directory prefetch failed for %s", k)
                break
        return n

    def stats(self) -> dict:
        return {
            "kv_directory_lookups_total": self.lookups,
            "kv_directory_lookup_hits_total": self.lookup_hits,
            "kv_directory_pulled_pages_total": self.pulled_pages,
        }
