"""Host-side KV page accounting: allocator + chunk-hash prefix cache.

The device holds the page *pools* (engine/runner.py); this module decides which
physical pages each sequence owns. Prefix caching is page-granular and keyed by
a rolling blake2b chain over full pages of token ids — the same chunk-hash
scheme the router's prefix trie and the KV-index controller use, so routing,
engine cache, and offload tiers agree on identity (SURVEY.md §7 hard part #3:
"chunk hashing consistent between router trie, engine prefix cache, and
KV-index controller").

Reference parity: vLLM's `--enable-prefix-caching` + LMCache chunk reuse, as
the upstream production stack's helm deployment template enables them.
"""

from __future__ import annotations

import hashlib
import heapq
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from production_stack_tpu_torch.tracing import get_flightrecorder


def chunk_hash(prev_hash: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(prev_hash, digest_size=16)
    h.update(b"".join(int(t).to_bytes(4, "little", signed=True) for t in tokens))
    return h.digest()


def prefix_hashes(
    tokens: Sequence[int], page_size: int, salt: bytes = b""
) -> list[bytes]:
    """Hash chain over full pages of `tokens` (len // page_size entries).

    ``salt`` seeds the chain; LoRA requests salt with the adapter name because
    adapters change wk/wv and hence the KV contents — pages must never be
    shared across adapters (or with the base model)."""
    out, h = [], salt
    for i in range(len(tokens) // page_size):
        h = chunk_hash(h, tokens[i * page_size : (i + 1) * page_size])
        out.append(h)
    return out


@dataclass
class PageInfo:
    ref_count: int = 0
    hash: Optional[bytes] = None  # set once the page is full + hashable
    hits: int = 0                 # times served from the prefix cache
    depth: int = 0                # page index in its prefix chain (0 = head)
    last_used: float = 0.0        # monotonic, refreshed on every cache hit
    offloaded: bool = False       # blob already saved to the offload tier


class KVPageManager:
    """Reference-counted page allocator with a hot-prefix-protecting cache.

    - ``allocate(n)`` / ``free(pages)``: plain paged allocation.
    - ``match_prefix(tokens)``: longest cached page-aligned prefix -> shared
      (ref-counted) pages. Cached pages with ref_count 0 live in an evictable
      pool and are reclaimed only when a fresh allocation needs them.

    Eviction is NOT pure LRU. Free order puts a finished sequence's chain
    HEAD pages into the pool before its tail, so LRU evicted the most
    shareable pages first, and past full page-pool occupancy the prefix hit
    rate collapsed with most of every prompt recomputed. Instead
    every evictable page carries a reuse score (hit count decayed by recency,
    plus a shared-prefix head bonus) and eviction takes the COLDEST page
    first: one-shot tails churn while hot shared prefixes stay resident, so
    >100% occupancy degrades smoothly. ``proactive_spill`` additionally
    copies the coldest evictable pages to the offload tier once usage
    crosses ``spill_watermark`` — the eventual eviction then frees the slot
    without a blocking device fetch, heading off the allocation-stall
    preemption storms of a spill done at the last possible moment.
    """

    # hotness half-life: a page's accumulated hits decay with time since its
    # last use, so a prefix that stops being requested eventually loses its
    # protection instead of pinning pool space forever
    HIT_DECAY_S = 600.0

    def __init__(
        self, num_pages: int, page_size: int, offload=None,
        max_io_pages: int = 0, spill_watermark: float = 0.9,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        # per-operation offload I/O budget (pages); 0 = unbounded. See
        # EngineConfig.kv_offload_max_io_pages: on slow host<->device links
        # recompute beats restore past a few pages, and an uncapped spill
        # batch stalls the engine loop for the whole fetch.
        self.max_io_pages = max_io_pages
        # usage fraction past which proactive spill engages (0 or >=1 disable)
        self.spill_watermark = spill_watermark
        self.pages = [PageInfo() for _ in range(num_pages)]
        self.free_list: list[int] = list(  # owned-by: device-thread
            range(num_pages - 1, -1, -1)
        )
        self.hash_to_page: dict[bytes, int] = {}
        # pages with ref_count==0 but still holding reusable KV. Victim
        # selection goes through a lazy min-heap keyed by reuse score; the
        # token map invalidates stale heap entries (a page re-referenced and
        # re-freed gets a fresh entry, the old one is skipped on pop).
        self.evictable: dict[int, None] = {}
        self._evict_heap: list[tuple[float, int, int]] = []  # (score, token, pid)
        self._heap_token: dict[int, int] = {}
        self._token_counter = 0
        self._heap_refreshed_at = time.monotonic()
        # unspilled-work flag gating proactive_spill's candidate scan
        self._spill_dirty = False
        self.prefix_queries = 0
        self.prefix_hits = 0  # counted in pages
        self.offload_hits = 0  # pages restored from the offload tiers
        self.evicted_pages_total = 0
        # pages evicted DESPITE a nonzero hit count — hot-prefix casualties;
        # a rising rate means the pool is too small for the hot set
        self.evicted_hot_pages_total = 0
        self.proactive_spilled_pages_total = 0
        # KVOffloadConnector (kvoffload/connector.py): spill evicted pages to
        # host DRAM/disk/remote and restore them on later prefix matches
        self.offload = offload
        # fleet-wide KV directory publisher (kvdirectory.DirectoryPublisher,
        # wired by LLMEngine when --kv-directory-url is set): prefix-cache
        # inserts publish resident claims, confirmed spills publish shared
        # claims, evictions withdraw — all dirty-batched off-thread
        self.directory = None

    # -- eviction policy ----------------------------------------------------

    def _evict_score(self, info: PageInfo) -> float:
        """Reuse score; eviction takes the LOWEST first. Hits (decayed by
        time since last use) dominate, so any recently-hit page outlives
        every cold one; among cold pages the head bonus (1/(1+depth)) makes
        chain TAILS go first — a chain can only restore/re-share from its
        head, so a surviving head keeps value a surviving tail does not."""
        age = max(0.0, time.monotonic() - info.last_used)
        return info.hits * 0.5 ** (age / self.HIT_DECAY_S) + 1.0 / (1.0 + info.depth)

    def _make_evictable(self, pid: int) -> None:
        info = self.pages[pid]
        self._token_counter += 1
        self._heap_token[pid] = self._token_counter
        heapq.heappush(
            self._evict_heap, (self._evict_score(info), self._token_counter, pid)
        )
        self.evictable[pid] = None
        # stale entries (page re-referenced then re-freed) are normally
        # purged on pop — but a pool running BELOW capacity never pops, and
        # a hot prefix cycling through the pool would leak one tuple per
        # hit forever. Compact when stale entries dominate (amortized O(1);
        # AFTER registering pid so the rebuild includes it).
        if len(self._evict_heap) > 2 * len(self.evictable) + 64:
            self._refresh_heap(time.monotonic())
        if info.hash is not None and not info.offloaded:
            self._spill_dirty = True

    def _remove_evictable(self, pid: int) -> None:
        del self.evictable[pid]
        self._heap_token.pop(pid, None)  # stale heap entries skip on pop

    def _refresh_heap(self, now: float) -> None:
        """Rebuild the heap with CURRENT scores. Entries carry the score
        computed when the page entered the pool; recency decay since then is
        invisible to the heap ordering, so an abandoned hot prefix would
        otherwise keep its stale high score (and its protection) forever.
        One O(E) rebuild per HIT_DECAY_S bounds the staleness to a single
        half-life — exactly the granularity the decay is meant to act at."""
        self._evict_heap = []
        self._heap_token.clear()
        for pid in self.evictable:
            self._token_counter += 1
            self._heap_token[pid] = self._token_counter
            self._evict_heap.append(
                (self._evict_score(self.pages[pid]), self._token_counter, pid)
            )
        heapq.heapify(self._evict_heap)
        self._heap_refreshed_at = now

    def _pop_coldest(self) -> int:
        """Pop the lowest-score evictable page (lazy heap: entries whose page
        left the pool since push are skipped; scores older than one decay
        half-life are refreshed wholesale first)."""
        now = time.monotonic()
        if now - self._heap_refreshed_at > self.HIT_DECAY_S:
            self._refresh_heap(now)
        while self._evict_heap:
            _, token, pid = heapq.heappop(self._evict_heap)
            if self._heap_token.get(pid) == token:
                del self._heap_token[pid]
                del self.evictable[pid]
                return pid
        raise AssertionError("evictable pool and heap out of sync")

    # -- allocation ---------------------------------------------------------

    def num_free(self) -> int:
        return len(self.free_list) + len(self.evictable)

    def usage(self) -> float:
        return 1.0 - self.num_free() / self.num_pages

    def allocate(self, n: int) -> Optional[list[int]]:
        if self.num_free() < n:
            return None
        out, spill = [], []
        # flight-recorder accounting for this allocation's evictions (one
        # event per evicting allocate call, not per page — the batch IS the
        # engine-level action); scores only gathered when the recorder is on
        fr = get_flightrecorder()
        n_evicted = n_hot = 0
        evict_scores: list = []
        # directory withdrawal accounting: evicted-with-restorable-blob
        # hashes lose only their RESIDENT claim (the shared-tier claim stays
        # truthful); evicted-without-blob hashes withdraw entirely
        w_resident: list = []
        w_all: list = []
        for _ in range(n):
            if self.free_list:
                pid = self.free_list.pop()
            else:  # evict the coldest reusable page (reuse-score policy)
                pid = self._pop_coldest()
                info = self.pages[pid]
                self.evicted_pages_total += 1
                n_evicted += 1
                if fr.enabled and len(evict_scores) < 8:
                    evict_scores.append(round(self._evict_score(info), 4))
                if info.hits > 0:
                    self.evicted_hot_pages_total += 1
                    n_hot += 1
                if info.hash is not None:
                    # already-offloaded pages (proactive spill / earlier
                    # restore) skip the spill batch — their blob is in the
                    # tier, so the slot frees with zero device I/O
                    if info.offloaded:
                        w_resident.append(info.hash)
                    elif self.offload is not None:
                        spill.append((pid, info.hash, info.depth))
                    else:
                        w_all.append(info.hash)
                    self.hash_to_page.pop(info.hash, None)
                    info.hash = None
                info.hits = 0
                info.depth = 0
                info.offloaded = False
            self.pages[pid].ref_count = 1
            out.append(pid)
        if spill:
            # batched: one device fetch for the whole eviction set, not one
            # ~100 ms host<->device round trip per page (connector.save_pages).
            # Over budget, chain HEADS spill (lowest depth first) — a prefix
            # chain can only restore from its head (the tail past the cap
            # recomputes, or re-shares if still in HBM). The rest are
            # dropped + reported evicted so the global KV index stays
            # truthful.
            spill.sort(key=lambda t: t[2])
            depths = {h: d for _, h, d in spill}
            spill = [(pid, h) for pid, h, _ in spill]
            cap = self.max_io_pages
            if cap and len(spill) > cap:
                dropped = spill[cap:]
                spill = spill[:cap]
                self.offload.report_evict([h for _, h in dropped])
                w_all.extend(h for _, h in dropped)
            import time as time_mod

            from production_stack_tpu_torch import tracing

            t_wall, t0 = time_mod.time(), time_mod.perf_counter()
            saved = self.offload.save_pages(spill)
            # directory truthfulness mirrors the offloaded-flag contract:
            # only CONFIRMED saves advertise a restorable shared claim; a
            # mid-batch tier failure withdraws the rest outright
            shared_pub: list = []
            for _, h in spill:
                if saved is None or h in saved:
                    w_resident.append(h)
                    shared_pub.append((h, depths.get(h, 0), 0.0))
                else:
                    w_all.append(h)
            if self.directory is not None and shared_pub:
                self.directory.publish_shared(shared_pub)
            # spill span under whichever request's admission forced the
            # eviction (scheduler publishes it); decode-growth evictions
            # carry no ambient context and record nothing
            ctx = tracing.current_context()
            if ctx is not None:
                tracing.get_collector().record(
                    "engine.kv_spill", ctx.child(), t_wall,
                    time_mod.perf_counter() - t0, pages=len(spill),
                )
        if n_evicted and fr.enabled:
            from production_stack_tpu_torch import tracing as _tr

            ctx = _tr.current_context()
            fr.record(
                "kv", op="evict", pages=n_evicted, hot=n_hot,
                spilled=len(spill), victim_scores=evict_scores,
                usage=round(self.usage(), 4),
                trace_id=ctx.trace_id if ctx is not None else None,
            )
        if self.directory is not None:
            if w_resident:
                self.directory.withdraw(w_resident, "resident")
            if w_all:
                self.directory.withdraw(w_all, "all")
        return out

    def free(self, page_ids: Sequence[int]) -> None:
        for pid in page_ids:
            info = self.pages[pid]
            info.ref_count -= 1
            assert info.ref_count >= 0, f"double free of page {pid}"
            if info.ref_count == 0:
                if info.hash is not None:
                    self._make_evictable(pid)  # keep KV for reuse
                else:
                    self.free_list.append(pid)

    def proactive_spill(self) -> int:
        """Copy the coldest evictable pages' KV to the offload tier while
        they are still cache-resident, once usage crosses the high
        watermark. The pages stay matchable in HBM; their eventual eviction
        then frees the slot with no blocking device fetch (allocate skips
        ``offloaded`` pages), so an allocation storm at >100% occupancy no
        longer stalls the engine loop into a preemption storm. Bounded per
        call by ``max_io_pages`` (64 when unbounded); cheap no-op until the
        watermark is crossed AND unspilled evictable work exists. The
        watermark is measured against the TRULY-free list (``usage()`` counts
        evictable pages as free, and a pool full of cached-but-evictable KV
        is exactly the state to pre-spill): free slots below
        (1 - watermark) of the pool means the next allocation burst must
        evict."""
        if (
            self.offload is None
            or not self._spill_dirty
            or not 0.0 < self.spill_watermark < 1.0
            or len(self.free_list) > (1.0 - self.spill_watermark) * self.num_pages
        ):
            return 0
        cap = self.max_io_pages or 64
        # O(E log cap) selection, not a full sort: this runs on the scheduler
        # step path whenever the watermark holds and unspilled work exists
        unspilled = [
            pid for pid in self.evictable
            if self.pages[pid].hash is not None and not self.pages[pid].offloaded
        ]
        cands = heapq.nsmallest(
            cap, ((self._evict_score(self.pages[pid]), pid) for pid in unspilled)
        )
        batch = [(pid, self.pages[pid].hash) for _, pid in cands]
        self._spill_dirty = len(unspilled) > len(batch)
        if not batch:
            return 0
        # flip to the zero-I/O eviction path only for CONFIRMED saves — a
        # mid-batch tier failure marking unsaved pages would silently lose
        # their KV at eviction time (the blob the skip relies on never made
        # it into the tier)
        saved = self.offload.save_pages(batch)
        n = 0
        shared_pub = []
        for pid, h in batch:
            if saved is None or h in saved:  # None: legacy offload stubs
                self.pages[pid].offloaded = True
                n += 1
                info = self.pages[pid]
                shared_pub.append((h, info.depth, info.hits))
        if self.directory is not None and shared_pub:
            # proactively-spilled pages stay HBM-resident AND restorable:
            # advertise the shared claim (the resident one already exists)
            self.directory.publish_shared(shared_pub)
        if n < len(batch):
            # unconfirmed saves stay on the dirty list: the flag was computed
            # from the PLANNED batch, and leaving it False would park those
            # pages until some unrelated free() — re-arming retries them next
            # call (the tier may have recovered)
            self._spill_dirty = True
        self.proactive_spilled_pages_total += n
        if n:
            get_flightrecorder().record(
                "kv", op="spill", pages=n, planned=len(batch),
                usage=round(self.usage(), 4),
            )
        return n

    # -- prefix cache -------------------------------------------------------

    def match_prefix(
        self, tokens: Sequence[int], salt: bytes = b""
    ) -> tuple[list[int], int]:
        """Longest cached prefix of `tokens` (page-aligned).

        Returns (shared_page_ids, num_cached_tokens). Increments ref counts of
        the returned pages (caller owns them until `free`).
        """
        hashes = prefix_hashes(tokens, self.page_size, salt)
        self.prefix_queries += max(len(hashes), 1)
        now = time.monotonic()
        shared: list[int] = []
        for h in hashes:
            pid = self.hash_to_page.get(h)
            if pid is None:
                break
            info = self.pages[pid]
            if info.ref_count == 0 and pid in self.evictable:
                self._remove_evictable(pid)
            info.ref_count += 1
            info.hits += 1
            info.last_used = now
            shared.append(pid)
        if self.offload is not None:
            shared = self._extend_from_offload(hashes, shared)
        self.prefix_hits += len(shared)
        return shared, len(shared) * self.page_size

    def _extend_from_offload(
        self, hashes: list[bytes], shared: list[int]
    ) -> list[int]:
        """Extend an HBM prefix match from the offload tiers — BATCHED.

        Plans the whole chain extension first (HBM re-shares interleaved with
        tier restores), then restores every needed page through ONE
        host->device upload + scatter per <=64 pages
        (connector.load_pages). The per-page restore this replaces paid a
        full host<->device round trip (~100 ms network-attached) per page —
        an 8k-token history (128 pages) would have taken >10 s to restore.
        """
        # plan the longest contiguous extension: share pages already (back)
        # in HBM, restore tier-resident ones; stop at the first miss
        plan: list[tuple[bytes, Optional[int]]] = []  # (hash, pid | None)
        n_restores = 0
        now = time.monotonic()
        for h in hashes[len(shared):]:
            pid = self.hash_to_page.get(h)
            if pid is not None:
                # chunk re-appeared in HBM further along the chain (e.g.
                # registered by a later request) — share it, don't restore.
                # Ref it NOW so planning's own allocations can't evict it.
                info = self.pages[pid]
                if info.ref_count == 0 and pid in self.evictable:
                    self._remove_evictable(pid)
                info.ref_count += 1
                info.hits += 1
                info.last_used = now
                plan.append((h, pid))
            elif self.offload.has(h):
                if self.max_io_pages and n_restores >= self.max_io_pages:
                    # restore budget exhausted: truncate the chain here — on
                    # a slow link the remaining prefix RECOMPUTES faster
                    # than it restores (EngineConfig.kv_offload_max_io_pages).
                    # Checked only when a restore is actually NEEDED: pages
                    # still HBM-resident keep sharing for free above.
                    break
                plan.append((h, None))
                n_restores += 1
            else:
                break
        # allocate slots for every restore; shrink the plan from the tail
        # until the allocation fits (dropping a share un-refs it)
        restore_pids: list[int] = []
        while plan:
            n_restore = sum(1 for _, p in plan if p is None)
            if n_restore == 0:
                break
            got = self.allocate(n_restore)
            if got is not None:
                restore_pids = got
                break
            h, pid = plan.pop()
            if pid is not None:
                self.free([pid])
        n_restore = len(restore_pids)
        restored = 0
        if n_restore:
            import time as time_mod

            from production_stack_tpu_torch import tracing

            t_wall, t0 = time_mod.time(), time_mod.perf_counter()
            restored = self.offload.load_pages(
                list(zip(restore_pids, (h for h, p in plan if p is None)))
            )
            dt = time_mod.perf_counter() - t0
            # restore latency is a first-class phase: histogram always
            # (dashboard phase panels), span when the admission is traced
            tracing.offload_restore_hist.observe(dt)
            ctx = tracing.current_context()
            if ctx is not None:
                tracing.get_collector().record(
                    "engine.kv_restore", ctx.child(), t_wall, dt,
                    pages_planned=n_restore, pages_restored=restored,
                )
            tracing.get_flightrecorder().record(
                "kv", op="restore", pages_planned=n_restore,
                pages_restored=restored, seconds=round(dt, 4),
                trace_id=ctx.trace_id if ctx is not None else None,
            )
        # stitch the final chain: a failed restore truncates it there;
        # shares past the truncation un-ref, unused restore slots free
        ri = 0
        broke = False
        resident_pub = []
        for h, pid in plan:
            if broke:
                if pid is not None:
                    self.free([pid])
            elif pid is not None:
                shared.append(pid)
            elif ri < restored:
                rp = restore_pids[ri]
                ri += 1
                info = self.pages[rp]
                info.hash = h
                info.depth = len(shared)  # position in the restored chain
                info.hits = 1
                info.last_used = now
                info.offloaded = True  # blob still lives in the tier
                self.hash_to_page[h] = rp
                shared.append(rp)
                self.offload_hits += 1
                resident_pub.append((h, info.depth, 1.0))
            else:
                broke = True
        if ri < n_restore:
            self.free(restore_pids[ri:])  # unhashed -> back to the free list
        if self.directory is not None and resident_pub:
            # tier-restored chunks are back in THIS engine's HBM — the
            # fleet directory should route matching prefixes here now
            self.directory.publish_resident(resident_pub)
        return shared

    # -- warm start (kvoffload/warmstart.py) --------------------------------

    def warm_candidates(
        self, max_pages: int
    ) -> "list[tuple[int, bytes, int, float]]":
        """The pages a warm-start manifest should cover: every hashed page
        (cached-evictable AND still-referenced — a full page's contents are
        immutable once hashed), ordered by reuse score DESC then chain depth
        ASC and capped at ``max_pages``. The depth tiebreak mirrors the
        capped-spill rule: a chain can only restore from its head, so under
        a cap the heads are what must survive. Returns
        ``(pid, hash, depth, hits)`` tuples — ``hits`` is the recency-DECAYED
        hit count WITHOUT the head bonus, because warm_restore feeds it back
        into ``PageInfo.hits`` and ``_evict_score`` re-adds the depth bonus;
        storing the full score would double-count it and skew post-restart
        eviction toward fresher, genuinely-hot pages."""
        now = time.monotonic()

        def decayed_hits(info: PageInfo) -> float:
            age = max(0.0, now - info.last_used)
            return info.hits * 0.5 ** (age / self.HIT_DECAY_S)

        # top-k selection, not a full sort: this runs on the engine device
        # thread every warm_start_interval_s (same reasoning as
        # proactive_spill's nsmallest) — O(H log cap) over hashed pages
        cands = heapq.nsmallest(
            max(0, max_pages),
            (
                (-self._evict_score(self.pages[pid]), self.pages[pid].depth, pid, h)
                for h, pid in self.hash_to_page.items()
            ),
        )
        return [
            (pid, h, d, decayed_hits(self.pages[pid])) for _, d, pid, h in cands
        ]

    def warm_restore(self, entries, loader) -> int:
        """Rebuild prefix-cache state from a warm-start manifest: allocate
        slots, pull the blobs through ``loader`` (connector.load_pages_sparse
        — per-entry best-effort, batched device upload), and register each
        restored page under its chunk hash with its manifest depth and reuse
        score. Restored pages enter the pool EVICTABLE (nothing references
        them yet), so a cold boot under immediate load degrades exactly like
        a warm cache would. Returns the number of pages restored."""
        todo = [
            (h, d, s) for h, d, s in entries if h not in self.hash_to_page
        ]
        # at boot the pool is empty; cap defensively anyway so a manifest
        # larger than the pool cannot force evictions of fresher state
        todo = todo[: self.num_free()]
        if not todo:
            return 0
        pids = self.allocate(len(todo))
        if pids is None:  # cannot happen given the cap; stay safe
            return 0
        ok = loader([(pid, h) for pid, (h, _, _) in zip(pids, todo)])
        now = time.monotonic()
        restored = 0
        for pid, (h, depth, score), good in zip(pids, todo, ok):
            if not good:
                continue  # free() below returns the unhashed slot to the pool
            info = self.pages[pid]
            info.hash = h
            info.depth = depth
            # the manifest's decayed hit count seeds hits so restored
            # prefixes keep their relative eviction protection (the depth
            # bonus is re-added by _evict_score, not stored)
            info.hits = score
            info.last_used = now
            info.offloaded = True  # the blob is (still) in the tier
            self.hash_to_page[h] = pid
            restored += 1
        # hashed pages land in the evictable pool; failed ones free outright
        self.free(pids)
        if self.directory is not None and restored:
            self.directory.publish_resident([
                (h, d, s) for (h, d, s), good in zip(todo, ok) if good
            ])
        if restored:
            get_flightrecorder().record(
                "kv", op="warm_restore", pages=restored, planned=len(todo)
            )
        return restored

    def register_filled(
        self, tokens: Sequence[int], page_ids: Sequence[int], salt: bytes = b""
    ) -> None:
        """Record hashes for fully-written pages of a sequence so later
        requests can share them. Called after prefill completes."""
        hashes = prefix_hashes(tokens, self.page_size, salt)
        now = time.monotonic()
        new: list[bytes] = []
        new_pub: list = []
        for depth, (h, pid) in enumerate(zip(hashes, page_ids)):
            info = self.pages[pid]
            if info.hash is None and h not in self.hash_to_page:
                info.hash = h
                info.depth = depth
                info.hits = 0
                info.last_used = now
                info.offloaded = False
                self.hash_to_page[h] = pid
                new.append(h)
                new_pub.append((h, depth, 0.0))
        if self.offload is not None and new:
            self.offload.report_admit(new)  # global KV index (kvaware routing)
        if self.directory is not None and new_pub:
            # prefix-cache insert -> fleet-directory resident claim
            self.directory.publish_resident(new_pub)

    def hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_queries if self.prefix_queries else 0.0
