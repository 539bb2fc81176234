"""Tiered KV blob store: host DRAM -> local disk -> remote cache server; the
port's copy of production_stack_tpu/kvoffload/tiers.py. Keys are chunk-hash
hex strings (the rolling hashes of engine/kv_manager.py); values are serde
blobs.

Policy: ``put`` writes to DRAM (and through to the remote tier); DRAM
eviction spills to disk; disk eviction drops the blob locally. ``get`` walks
DRAM -> disk -> remote and promotes hits to DRAM. Every ``get`` verifies the
blob's checksum and version first: a corrupt blob is quarantined (deleted
from the tier that served it, counted in ``corrupt_pages``) and the walk
goes on, so a bad page is never served. The engine configures the local
tiers only; the remote tier stays unreachable until the cache server is
ported (``kv_remote_url`` is refused).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

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

    def put(self, key: str, blob: bytes) -> None:
        try:
            self._request({"op": "put", "key": key}, blob)
        except Exception as e:
            self.errors += 1
            logger.warning("remote kv put failed: %s", e)

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
    """The per-engine offload hierarchy. Thread-safe."""

    def __init__(
        self,
        *,
        cpu_bytes: int = 0,
        disk_path: Optional[str] = None,
        disk_bytes: int = 0,
        remote_url: Optional[str] = None,
    ):
        self.cpu = CPUTier(cpu_bytes) if cpu_bytes > 0 else None
        self.disk = (
            DiskTier(disk_path, disk_bytes) if disk_path and disk_bytes > 0 else None
        )
        self.remote = RemoteTier(remote_url) if remote_url else None
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

    def enabled(self) -> bool:
        # NB: explicit None checks — the tiers define __len__, so an *empty*
        # tier is falsy and `bool(self.cpu)` would wrongly disable the store.
        return (
            self.cpu is not None or self.disk is not None or self.remote is not None
        )

    def _spill(self, evicted: list[tuple[str, bytes]]) -> None:
        for k, b in evicted:
            if self.disk is not None:
                self.dropped_evictions += len(self.disk.put(k, b))
            else:
                self.dropped_evictions += 1

    def put(self, key: str, blob: bytes) -> None:
        """Write to the local tiers (host RAM first, spilling to disk) and
        through to the remote tier."""
        with self._lock:
            if self.cpu is not None:
                self._spill(self.cpu.put(key, blob))
            elif self.disk is not None:
                self.dropped_evictions += len(self.disk.put(key, blob))
        if self.remote is not None:
            self.remote.put(key, blob)

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
