"""Tiered KV blob store: host DRAM -> local disk -> remote cache server; the
port's copy of production_stack_tpu/kvoffload/tiers.py. Keys are chunk-hash
hex strings (the rolling hashes of engine/kv_manager.py); values are serde
blobs.

Policy: ``put`` writes to DRAM (and through to the remote tier, the cache
server of kvoffload/cache_server.py, so other engines and a restarted one
can share); DRAM eviction spills to disk; disk eviction drops the blob
locally. ``get`` walks DRAM -> disk -> remote and promotes hits to DRAM.
Evictions that remove the *last local* copy surface through
``on_local_drop`` so the engine can tell the KV-index controller. A remote
error is a miss (the engine recomputes), never an error of the request.

Integrity: every ``get`` verifies the blob's checksum and version first: a
corrupt blob is quarantined (deleted from the tier that served it, counted
in ``corrupt_pages``) and the walk goes on, so a bit-flip on disk falls back
to the remote copy and, failing that, to recompute. A bad page is never
served. Mutable keys (warm-start heads) are read with ``get_authoritative``,
shared sources first.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional

from production_stack_tpu_torch.kvoffload.protocol import BlockingClient, parse_hostport
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError, verify_blob
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class CPUTier:
    """Byte-capped LRU in host DRAM."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self.used_bytes = 0

    def get(self, key: str) -> Optional[bytes]:
        blob = self._data.get(key)
        if blob is not None:
            self._data.move_to_end(key)
        return blob

    def put(self, key: str, blob: bytes) -> list[tuple[str, bytes]]:
        """Insert; returns evicted (key, blob) pairs for spill-down."""
        if len(blob) > self.max_bytes:
            return [(key, blob)]
        if key in self._data:
            self.used_bytes -= len(self._data[key])
            del self._data[key]
        self._data[key] = blob
        self.used_bytes += len(blob)
        evicted = []
        while self.used_bytes > self.max_bytes:
            k, b = self._data.popitem(last=False)
            self.used_bytes -= len(b)
            evicted.append((k, b))
        return evicted

    def delete(self, key: str) -> None:
        blob = self._data.pop(key, None)
        if blob is not None:
            self.used_bytes -= len(blob)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)


class DiskTier:
    """Byte-capped LRU of blob files in a directory."""

    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self.max_bytes = max_bytes
        os.makedirs(path, exist_ok=True)
        self._index: OrderedDict[str, int] = OrderedDict()  # key -> size
        self.used_bytes = 0
        for name in sorted(os.listdir(path)):  # recover after restart
            if name.endswith(".kv"):
                size = os.path.getsize(os.path.join(path, name))
                self._index[name[:-3]] = size
                self.used_bytes += size

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.kv")

    def get(self, key: str) -> Optional[bytes]:
        if key not in self._index:
            return None
        try:
            with open(self._file(key), "rb") as f:
                blob = f.read()
        except OSError:
            self.delete(key)
            return None
        self._index.move_to_end(key)
        return blob

    def get_fresh(self, key: str) -> Optional[bytes]:
        """Read the file directly, bypassing this process's in-memory index:
        a concurrent incarnation sharing the directory (rolling upgrade on
        one host) may have written the key after our index was built. Does
        not touch index/LRU state — mutable-key reads must stay side-effect
        free."""
        try:
            with open(self._file(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def put(self, key: str, blob: bytes) -> list[str]:
        """Write; returns keys evicted (dropped entirely)."""
        if len(blob) > self.max_bytes:
            return [key]
        self.delete(key)
        tmp = self._file(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._file(key))
        self._index[key] = len(blob)
        self.used_bytes += len(blob)
        dropped = []
        while self.used_bytes > self.max_bytes:
            k, size = self._index.popitem(last=False)
            self.used_bytes -= size
            try:
                os.unlink(self._file(k))
            except OSError:
                pass
            dropped.append(k)
        return dropped

    def delete(self, key: str) -> None:
        size = self._index.pop(key, None)
        if size is not None:
            self.used_bytes -= size
            try:
                os.unlink(self._file(key))
            except OSError:
                pass

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)


class RemoteTier:
    """Client view of the shared cache server (kvoffload/cache_server.py)."""

    def __init__(self, url: str, timeout: float = 10.0):
        host, port = parse_hostport(url, default_port=8200)
        self._client = BlockingClient(host, port, timeout=timeout)
        self._lock = threading.Lock()
        self.errors = 0

    def _request(self, header: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        with self._lock:
            return self._client.request(header, payload)

    def get(self, key: str) -> Optional[bytes]:
        try:
            hdr, body = self._request({"op": "get", "key": key})
            return body if hdr.get("ok") and hdr.get("found") else None
        except Exception as e:
            self.errors += 1
            logger.warning("remote kv get failed: %s", e)
            return None

    def put(self, key: str, blob: bytes) -> bool:
        """Store ``blob``; True once the server acknowledged it."""
        try:
            hdr, _ = self._request({"op": "put", "key": key}, blob)
            return bool(hdr.get("ok"))
        except Exception as e:
            self.errors += 1
            logger.warning("remote kv put failed: %s", e)
            return False

    def __contains__(self, key: str) -> bool:
        try:
            hdr, _ = self._request({"op": "exists", "key": key})
            return bool(hdr.get("found"))
        except Exception:
            self.errors += 1
            return False

    def delete(self, key: str) -> None:
        """Quarantine support: drop a corrupt entry server-side so other
        engines sharing the cache server stop fetching it too."""
        try:
            self._request({"op": "delete", "key": key})
        except Exception as e:
            self.errors += 1
            logger.warning("remote kv delete failed: %s", e)

    def close(self) -> None:
        self._client.close()


class TieredKVStore:
    """The per-engine offload hierarchy. Thread-safe for the engine loop +
    background reporters."""

    def __init__(
        self,
        *,
        cpu_bytes: int = 0,
        disk_path: Optional[str] = None,
        disk_bytes: int = 0,
        remote_url: Optional[str] = None,
        on_local_drop: Optional[Callable[[str], None]] = None,
    ):
        self.cpu = CPUTier(cpu_bytes) if cpu_bytes > 0 else None
        self.disk = (
            DiskTier(disk_path, disk_bytes) if disk_path and disk_bytes > 0 else None
        )
        self.remote = RemoteTier(remote_url) if remote_url else None
        self.on_local_drop = on_local_drop
        self._lock = threading.RLock()
        # bumped from every thread that reads the store — shared `+=` on a
        # dict slot loses increments without the lock
        self.hits = {"cpu": 0, "disk": 0, "remote": 0}  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        # blobs evicted out the BOTTOM of the local hierarchy (disk-tier
        # eviction, or CPU-tier eviction with no disk tier). Without a remote
        # tier this is permanent KV loss — it used to happen silently;
        # exported as kv_offload_dropped_evictions_total on /metrics
        self.dropped_evictions = 0
        # blobs that failed their checksum/version check on read and were
        # quarantined (vllm:kv_corrupt_pages_total); nonzero means a tier is
        # flipping bits or a rolling upgrade crossed an incompatible format
        self.corrupt_pages = 0
        # local blobs the remote tier has not acknowledged: landed with
        # put_local (a peer's frame), or a put whose write-through failed;
        # write_through uploads them, and a drop from the local tiers forgets
        # them
        self._unshared: set[str] = set()  # guarded-by: _lock

    def enabled(self) -> bool:
        # NB: explicit None checks — the tiers define __len__, so an *empty*
        # tier is falsy and `bool(self.cpu)` would wrongly disable the store.
        return (
            self.cpu is not None or self.disk is not None or self.remote is not None
        )

    def durable(self) -> bool:
        """True if some tier survives process death (disk or remote) — the
        prerequisite for warm-start state to mean anything across restarts."""
        return self.disk is not None or self.remote is not None

    def _spill(self, evicted: list[tuple[str, bytes]]) -> None:
        for k, b in evicted:
            if self.disk is not None:
                for dropped in self.disk.put(k, b):
                    self._dropped_locally(dropped)
            else:
                self._dropped_locally(k)

    def _dropped_locally(self, key: str) -> None:
        # every caller already holds the RLock (_spill under put_local, get
        # and persist); taking it again costs a re-entry and keeps
        # `_unshared` under its lock wherever this is called from
        with self._lock:
            self.dropped_evictions += 1
            if not self.contains_local(key):
                self._unshared.discard(key)
                if self.on_local_drop is not None:
                    self.on_local_drop(key)

    def put_local(self, key: str, blob: bytes) -> None:
        """Insert into the local tiers only (no remote write-through) — used
        for chunks *received* from a peer. The remote tier may lack them:
        ``write_through`` gives it one when a caller needs it shared."""
        with self._lock:
            self._put_local(key, blob)
            if self.remote is not None and self.contains_local(key):
                self._unshared.add(key)

    def _put_local(self, key: str, blob: bytes) -> None:
        if self.cpu is not None:
            self._spill(self.cpu.put(key, blob))
        elif self.disk is not None:
            for dropped in self.disk.put(key, blob):
                self._dropped_locally(dropped)

    def put(self, key: str, blob: bytes) -> None:
        with self._lock:
            self._put_local(key, blob)
        if self.remote is None:
            return
        shared = self.remote.put(key, blob)
        with self._lock:
            if shared:
                self._unshared.discard(key)
            elif self.contains_local(key):
                self._unshared.add(key)

    def _verified(self, key: str, blob: bytes, tier_name: str, tier) -> bool:
        """True if ``blob`` passes its integrity check; on failure the entry
        is quarantined (deleted from the tier that served it) and counted so
        the get-walk falls through to the next tier / recompute."""
        try:
            verify_blob(blob)
            return True
        except KVIntegrityError as e:
            self.corrupt_pages += 1
            logger.warning(
                "quarantining corrupt kv blob %s from %s tier: %s",
                key, tier_name, e,
            )
            try:
                tier.delete(key)
            except Exception:  # noqa: BLE001 - quarantine is best-effort
                pass
            return False

    def get_authoritative(self, key: str) -> Optional[bytes]:
        """Read a MUTABLE key (warm-start head pointer), preferring SHARED
        sources over this process's private caches: remote first, then the
        disk FILE (bypassing this process's in-memory index — another
        incarnation sharing the directory may have written it after our
        index was built), DRAM last. The ordinary ``get`` walk is designed
        for immutable content-addressed blobs, where a local copy is as good
        as any; for a mutable key it would return our own stale copy and,
        e.g., blind an old engine incarnation to the newer generation that
        fenced it."""
        if self.remote is not None:
            blob = self.remote.get(key)
            if blob is not None and self._verified(key, blob, "remote", self.remote):
                return blob
        with self._lock:
            if self.disk is not None:
                blob = self.disk.get_fresh(key)
                if blob is not None and self._verified(key, blob, "disk", self.disk):
                    return blob
            if self.cpu is not None:
                blob = self.cpu.get(key)
                if blob is not None and self._verified(key, blob, "cpu", self.cpu):
                    return blob
        return None

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            if self.cpu is not None:
                blob = self.cpu.get(key)
                if blob is not None and self._verified(key, blob, "cpu", self.cpu):
                    self.hits["cpu"] += 1
                    return blob
            if self.disk is not None:
                blob = self.disk.get(key)
                if blob is not None and self._verified(key, blob, "disk", self.disk):
                    self.hits["disk"] += 1
                    if self.cpu is not None:  # promote
                        self._spill(self.cpu.put(key, blob))
                    return blob
        if self.remote is not None:
            blob = self.remote.get(key)
            if blob is not None and self._verified(key, blob, "remote", self.remote):
                with self._lock:
                    # counter bump inside the promote's lock window: an
                    # unlocked `+=` races the cpu/disk paths' locked bumps
                    self.hits["remote"] += 1
                    if self.cpu is not None:
                        self._spill(self.cpu.put(key, blob))
                return blob
        self.misses += 1
        return None

    def persist(self, key: str, force: bool = False) -> bool:
        """Ensure a DRAM-tier blob also has a process-death-durable local
        copy: copy it to the disk tier if one exists (remote copies are
        already written through by ``put``). Warm-start state must outlive
        the process — a cpu+disk hierarchy otherwise holds the newest (last
        to evict) blobs only in DRAM. ``force`` re-copies even when the key
        is already on disk: content-addressed page blobs are immutable (skip
        is safe and cheap), but MUTABLE keys (the warm-start head pointer)
        would otherwise keep a stale durable copy forever. Returns True if a
        durable local copy exists afterwards."""
        with self._lock:
            if self.disk is None:
                return False
            if not force and key in self.disk:
                return True
            blob = self.cpu.get(key) if self.cpu is not None else None
            if blob is None:
                return key in self.disk
            for dropped in self.disk.put(key, blob):
                self._dropped_locally(dropped)
            return key in self.disk

    def write_through(self, key: str) -> bool:
        """Give the remote tier a local blob it has not acknowledged (one
        that landed with ``put_local``, or whose ``put`` failed to reach
        it). True if the remote tier holds ``key`` afterwards; False without
        a remote tier or the server's acknowledgement. A blob ``put`` wrote
        through costs no request; only a key held neither locally nor as
        unshared asks the server."""
        if self.remote is None:
            return False
        with self._lock:
            if key not in self._unshared:
                if self.contains_local(key):
                    return True
                blob = None
            else:
                blob = self.cpu.get(key) if self.cpu is not None else None
                if blob is None and self.disk is not None:
                    blob = self.disk.get(key)
        if blob is None:
            return key in self.remote
        if not self.remote.put(key, blob):
            return False
        with self._lock:
            self._unshared.discard(key)
        return True

    def contains_local(self, key: str) -> bool:
        with self._lock:
            return bool(
                (self.cpu is not None and key in self.cpu)
                or (self.disk is not None and key in self.disk)
            )

    def contains(self, key: str) -> bool:
        if self.contains_local(key):
            return True
        return self.remote is not None and key in self.remote

    def stats(self) -> dict:
        with self._lock:
            return {
                "cpu_entries": len(self.cpu) if self.cpu else 0,
                "cpu_bytes": self.cpu.used_bytes if self.cpu else 0,
                "disk_entries": len(self.disk) if self.disk else 0,
                "disk_bytes": self.disk.used_bytes if self.disk else 0,
                "hits": dict(self.hits),
                "misses": self.misses,
                "dropped_evictions": self.dropped_evictions,
                "corrupt_pages": self.corrupt_pages,
                "remote_errors": self.remote.errors if self.remote else 0,
            }
