"""The fleet-wide KV directory index (the port's copy of
production_stack_tpu/kvdirectory/directory.py).

Maps chunk hash -> per-engine claims: *resident* (the engine holds the page
in HBM) and *shared* (the blob is in the shared cache-server tier, pullable
by ANY engine). Chunk hashes are the same rolling blake2b chain the engine
prefix cache, the warm-start manifests, and the KV-index controller already
use (engine/kv_manager.prefix_hashes), so identity is consistent
router <-> engine <-> tier.

Consistency model (docs/kv-directory.md): the directory is a HINT.

- **Generation fencing**: every engine publishes under a monotonically
  increasing generation (the warm-start generation when --warm-start is on,
  a boot epoch otherwise). A (re)publish with a higher generation expires the
  engine's older-generation entries; a lookup that touches an entry from an
  older generation counts it stale (``stale_hits_total``) and skips it — a
  restarted engine's leftover claims can therefore never win a lookup.
- **Liveness TTL**: an engine silent past ``engine_timeout`` loses its
  *resident* claims (its HBM is presumed gone). *Shared* claims outlive the
  engine — the blob lives in the cache server, not the engine — and are
  verified against the co-hosted blob store (``blob_check``) at lookup time,
  so a capacity-evicted blob stops being advertised immediately.
- Engines always verify: every pulled blob is CRC-checked by the tier store
  and a miss/corruption falls back to recompute (kv_manager contract).

Single-writer by construction: the cache server mutates this from one asyncio
loop. Unit tests drive it synchronously; no locking is needed or provided.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

SNAPSHOT_FORMAT = 1


@dataclass
class DirEntry:
    """One engine's claim on one chunk."""

    resident: bool = False
    shared: bool = False
    generation: int = 0
    depth: int = 0
    score: float = 0.0
    ts: float = 0.0  # wall clock of the last publish touching this entry


@dataclass
class EngineRecord:
    url: str
    page_size: int
    generation: int = 0
    last_seen: float = field(default_factory=time.monotonic)
    chunks: set = field(default_factory=set)  # hash hexes this engine claims


class KVDirectory:
    """In-memory prefix->holders index with generation fencing + TTL."""

    def __init__(
        self,
        engine_timeout: float = 60.0,
        blob_check: Optional[Callable[[str], bool]] = None,
    ):
        self.engine_timeout = engine_timeout
        # co-hosted cache server passes `key in store`: restorable answers
        # then reflect the blobs that actually exist, not stale claims
        self.blob_check = blob_check
        self.engines: dict[str, EngineRecord] = {}  # owned-by: event-loop
        self.chunks: dict[str, dict[str, DirEntry]] = {}  # owned-by: event-loop
        # exported as vllm:kv_directory_* on the cache server metrics surface
        self.publishes_total = 0
        self.withdrawals_total = 0
        self.stale_hits_total = 0
        self.expired_entries_total = 0
        self.lookups_total = 0
        self._stale_publishes = 0

    # -- registration / fencing ----------------------------------------------

    def register(self, url: str, page_size: int, generation: int) -> None:
        rec = self.engines.get(url)
        if rec is None:
            rec = self.engines[url] = EngineRecord(url, page_size, generation)
            logger.info(
                "kv directory: engine %s registered (page_size=%d gen=%d)",
                url, page_size, generation,
            )
            return
        rec.last_seen = time.monotonic()
        rec.page_size = page_size
        if generation > rec.generation:
            self._fence(rec, generation)

    def _fence(self, rec: EngineRecord, generation: int) -> None:
        """A newer incarnation claimed this engine url: expire every entry
        the older generations published (resident claims are definitely gone
        with the old process; shared claims are re-validated by blob_check at
        lookup, but attributing them to a dead generation would misreport
        residency, so they expire too and the new incarnation republishes)."""
        expired = 0
        for h in list(rec.chunks):
            holders = self.chunks.get(h)
            if holders is None:
                rec.chunks.discard(h)
                continue
            e = holders.get(rec.url)
            if e is not None and e.generation < generation:
                del holders[rec.url]
                rec.chunks.discard(h)
                expired += 1
                if not holders:
                    del self.chunks[h]
        if expired:
            logger.info(
                "kv directory: engine %s generation %d -> %d fenced %d "
                "stale entries", rec.url, rec.generation, generation, expired,
            )
        self.expired_entries_total += expired
        rec.generation = generation

    def _alive(self, rec: EngineRecord) -> bool:
        return time.monotonic() - rec.last_seen <= self.engine_timeout

    def expire_dead_engines(self) -> int:
        """Drop RESIDENT claims of engines silent past the TTL (their HBM is
        presumed gone). Shared claims survive — the blob lives in the cache
        server. Called lazily from lookups and the persist loop."""
        expired = 0
        for rec in self.engines.values():
            if self._alive(rec) or not rec.chunks:
                continue
            for h in list(rec.chunks):
                holders = self.chunks.get(h)
                e = holders.get(rec.url) if holders else None
                if e is None:
                    rec.chunks.discard(h)
                    continue
                if e.resident:
                    e.resident = False
                    expired += 1
                if not e.shared:
                    del holders[rec.url]
                    rec.chunks.discard(h)
                    if not holders:
                        del self.chunks[h]
        self.expired_entries_total += expired
        return expired

    # -- publish / withdraw ---------------------------------------------------

    def publish(
        self,
        url: str,
        generation: int,
        entries: Iterable,
        tier: str,
        page_size: int = 0,
    ) -> int:
        """Record claims. ``entries`` is ``[(hash_hex, depth, score), ...]``;
        ``tier`` is "hbm" (resident) or "shared" (blob in the shared store).
        A publish under an OLDER generation than the engine's current one is
        a fenced incarnation's late flush — dropped."""
        rec = self.engines.get(url)
        if rec is None:
            self.register(url, page_size or 0, generation)
            rec = self.engines[url]
        rec.last_seen = time.monotonic()
        if page_size:
            rec.page_size = page_size
        if generation > rec.generation:
            self._fence(rec, generation)
        elif generation < rec.generation:
            self._stale_publishes += 1
            return 0
        resident = tier == "hbm"
        now = time.time()
        n = 0
        for h, depth, score in entries:
            holders = self.chunks.setdefault(h, {})
            e = holders.get(url)
            if e is None:
                e = holders[url] = DirEntry()
                rec.chunks.add(h)
            if resident:
                e.resident = True
            else:
                e.shared = True
            e.generation = generation
            e.depth = int(depth)
            e.score = float(score)
            e.ts = now
            n += 1
        self.publishes_total += n
        return n

    def withdraw(self, url: str, hashes: Iterable[str], scope: str = "resident") -> int:
        """Remove claims. ``scope`` "resident" drops only the HBM claim (the
        blob may still be in the shared tier); "all" removes the engine's
        entry entirely (evict-without-spill: nothing restorable remains)."""
        rec = self.engines.get(url)
        if rec is None:
            return 0
        rec.last_seen = time.monotonic()
        n = 0
        for h in hashes:
            holders = self.chunks.get(h)
            e = holders.get(url) if holders else None
            if e is None:
                continue
            e.resident = False
            if scope == "all":
                e.shared = False
            if not e.resident and not e.shared:
                del holders[url]
                rec.chunks.discard(h)
                if not holders:
                    del self.chunks[h]
            n += 1
        self.withdrawals_total += n
        return n

    def blob_evicted(self, key: str) -> None:
        """The co-hosted cache server evicted (or quarantined) a blob: its
        shared claims are no longer restorable anywhere."""
        holders = self.chunks.get(key)
        if not holders:
            return
        for url in list(holders):
            e = holders[url]
            e.shared = False
            if not e.resident:
                del holders[url]
                rec = self.engines.get(url)
                if rec is not None:
                    rec.chunks.discard(key)
        if not holders:
            del self.chunks[key]

    # -- lookups --------------------------------------------------------------

    def _entry_live(self, url: str, e: DirEntry) -> bool:
        """Generation-fence check at lookup time; stale entries are counted
        and lazily dropped so a restarted engine's claims cannot win."""
        rec = self.engines.get(url)
        if rec is None:
            return False
        if e.generation < rec.generation:
            self.stale_hits_total += 1
            e.resident = e.shared = False
            return False
        return True

    def _shared_available(self, h: str) -> bool:
        holders = self.chunks.get(h)
        if not holders:
            return False
        claimed = any(
            e.shared and self._entry_live(url, e) for url, e in list(holders.items())
        )
        if not claimed:
            return False
        if self.blob_check is not None and not self.blob_check(h):
            # the blob vanished under the claim (capacity eviction raced a
            # publish, or a quarantine): stop advertising it
            self.blob_evicted(h)
            return False
        return True

    def lookup_hashes(self, hashes: list[str]) -> dict:
        """Engine-side pull lookup: per-hash shared-tier availability plus
        contiguous per-engine resident depths (both from chain position 0).
        ``generations`` carries each resident owner's claim generation so a
        fabric pull can be FENCED: the owner rejects a pull tagged with a
        generation older than its own (a reborn owner must not serve pages
        the claim's publisher never wrote)."""
        self.lookups_total += 1
        self.expire_dead_engines()
        shared_flags = [self._shared_available(h) for h in hashes]
        resident: dict[str, int] = {}
        generations: dict[str, int] = {}
        for url, rec in self.engines.items():
            if not self._alive(rec):
                continue
            n = 0
            for h in hashes:
                e = self.chunks.get(h, {}).get(url)
                if e is None or not e.resident or not self._entry_live(url, e):
                    break
                n += 1
            if n:
                resident[url] = n
                generations[url] = rec.generation
        return {
            "shared": shared_flags,
            "resident": resident,
            "generations": generations,
        }

    def lookup_tokens(self, tokens: list[int], salt_hex: str = "") -> dict:
        """Router-side lookup: recompute the chunk-hash chain per registered
        page size (the same scheme as the KV-index controller) and report,
        per engine, the longest contiguous RESIDENT prefix in tokens, plus
        the longest contiguous SHARED (restorable-by-anyone) prefix per page
        size."""
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes

        self.lookups_total += 1
        self.expire_dead_engines()
        salt = bytes.fromhex(salt_hex) if salt_hex else b""
        by_ps: dict[int, list[str]] = {}
        for rec in self.engines.values():
            ps = rec.page_size
            if ps > 0 and ps not in by_ps:
                by_ps[ps] = [h.hex() for h in prefix_hashes(tokens, ps, salt)]
        engines_out: dict[str, dict] = {}
        for url, rec in self.engines.items():
            if not self._alive(rec) or rec.page_size not in by_ps:
                continue
            chain = by_ps[rec.page_size]
            n = 0
            for h in chain:
                e = self.chunks.get(h, {}).get(url)
                if e is None or not e.resident or not self._entry_live(url, e):
                    break
                n += 1
            if n:
                engines_out[url] = {
                    "resident_tokens": n * rec.page_size,
                    "resident_chunks": n,
                    "page_size": rec.page_size,
                    "generation": rec.generation,
                }
        restorable: dict[str, int] = {}
        for ps, chain in by_ps.items():
            n = 0
            for h in chain:
                if not self._shared_available(h):
                    break
                n += 1
            if n:
                restorable[str(ps)] = n * ps
        return {
            "engines": engines_out,
            "restorable": restorable,
            # every live engine's page size: the router's restorable ranking
            # must not credit a backend with blobs hashed at a page size it
            # cannot consume (chunk identity is page-size-dependent)
            "page_sizes": {
                url: rec.page_size
                for url, rec in self.engines.items()
                if self._alive(rec) and rec.page_size > 0
            },
            "total_tokens": len(tokens),
        }

    def top_prefixes(self, limit: int, page_size: int = 0) -> list:
        """The fleet's warmest RESTORABLE chunks, heads-first (scale-up
        prefetch, docs/migration.md): shared-claimed, blob-backed chunk
        hashes ranked by chain depth ASC then reuse score DESC — a chain can
        only restore from its head, so under a budget the heads are what a
        new engine must pull first. ``page_size`` filters to chunks a
        consumer at that page size can actually use (chunk identity is
        page-size-dependent); 0 keeps all."""
        self.expire_dead_engines()
        scored: list = []
        for h, holders in list(self.chunks.items()):
            best = None
            for url, e in list(holders.items()):
                if not e.shared or not self._entry_live(url, e):
                    continue
                rec = self.engines.get(url)
                if page_size and (rec is None or rec.page_size != page_size):
                    continue
                key = (e.depth, -e.score)
                if best is None or key < best:
                    best = key
            if best is None:
                continue
            if self.blob_check is not None and not self.blob_check(h):
                self.blob_evicted(h)  # vanished under the claim
                continue
            scored.append((best[0], best[1], h))
        scored.sort()
        return [h for _, _, h in scored[: max(0, int(limit))]]

    # -- persistence -----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable state for offload-tier-backed persistence. The
        loaded copy stays generation-fenced: a reborn engine republishing
        under generation+1 expires its snapshot-restored claims."""
        return {
            "format": SNAPSHOT_FORMAT,
            "ts": time.time(),
            "engines": {
                url: {"page_size": r.page_size, "generation": r.generation}
                for url, r in self.engines.items()
            },
            "chunks": {
                h: {
                    url: [
                        int(e.resident), int(e.shared), e.generation,
                        e.depth, round(e.score, 4),
                    ]
                    for url, e in holders.items()
                }
                for h, holders in self.chunks.items()
            },
        }

    def load_snapshot(self, doc: dict) -> int:
        """Restore a snapshot (cache-server boot). Engines get a fresh TTL
        window to re-appear; resident claims from the snapshot are kept but
        expire via the normal TTL if their engine never returns."""
        if int(doc.get("format", 0)) != SNAPSHOT_FORMAT:
            logger.warning("kv directory: unsupported snapshot format; ignoring")
            return 0
        now = time.monotonic()
        for url, meta in doc.get("engines", {}).items():
            rec = self.engines.setdefault(
                url, EngineRecord(url, int(meta.get("page_size", 0)))
            )
            rec.page_size = int(meta.get("page_size", rec.page_size))
            rec.generation = max(rec.generation, int(meta.get("generation", 0)))
            rec.last_seen = now
        n = 0
        for h, holders in doc.get("chunks", {}).items():
            for url, packed in holders.items():
                rec = self.engines.get(url)
                if rec is None:
                    continue
                resident, shared, gen, depth, score = packed
                if int(gen) < rec.generation:
                    continue  # already fenced when the snapshot was taken
                e = self.chunks.setdefault(h, {}).setdefault(url, DirEntry())
                e.resident = bool(resident)
                e.shared = bool(shared)
                e.generation = int(gen)
                e.depth = int(depth)
                e.score = float(score)
                rec.chunks.add(h)
                n += 1
        logger.info("kv directory: restored %d entries from snapshot", n)
        return n

    def snapshot_json(self) -> bytes:
        return json.dumps(self.snapshot()).encode()

    # -- observability ---------------------------------------------------------

    def stats(self) -> dict:
        entries = sum(len(h) for h in self.chunks.values())
        return {
            "kv_directory_entries": entries,
            "kv_directory_chunks": len(self.chunks),
            "kv_directory_engines": len(self.engines),
            "kv_directory_publishes_total": self.publishes_total,
            "kv_directory_withdrawals_total": self.withdrawals_total,
            "kv_directory_stale_hits_total": self.stale_hits_total,
            "kv_directory_expired_entries_total": self.expired_entries_total,
            "kv_directory_lookups_total": self.lookups_total,
        }

    def dump(self) -> dict:
        """Debug/report surface (scripts/kv_directory_report.py): per-engine
        residency, chain-depth histogram, stale/expired accounting — computed
        server-side so the wire payload stays bounded by fleet size, not
        chunk count."""
        self.expire_dead_engines()
        depth_hist: dict[int, int] = {}
        per_engine: dict[str, dict] = {}
        for url, rec in self.engines.items():
            per_engine[url] = {
                "page_size": rec.page_size,
                "generation": rec.generation,
                "alive": self._alive(rec),
                "resident_chunks": 0,
                "shared_chunks": 0,
            }
        for h, holders in self.chunks.items():
            for url, e in holders.items():
                pe = per_engine.get(url)
                if pe is None:
                    continue
                if e.resident:
                    pe["resident_chunks"] += 1
                    depth_hist[e.depth] = depth_hist.get(e.depth, 0) + 1
                if e.shared:
                    pe["shared_chunks"] += 1
        return {
            "engines": per_engine,
            "depth_histogram": {str(k): v for k, v in sorted(depth_hist.items())},
            **self.stats(),
        }
