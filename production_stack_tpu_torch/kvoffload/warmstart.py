"""Warm-start manifests: engine restarts that keep their hot KV working set
(the port's copy of production_stack_tpu/kvoffload/warmstart.py). The
engine's own offload tier doubles as the durable store:

- **Spill** (server drain, and periodically, so a hard crash loses only the
  delta since the last interval): the highest-reuse-score chain-head pages'
  blobs are saved through the ordinary offload path, and a small MANIFEST
  (chunk hash, chain depth, reuse score per page: what re-admitting them
  needs) is written to the tier under a per-engine namespace.
- **Restore** (engine construction, before the server reports ready): the
  manifest is read back, its blobs restored into the page pool through the
  batched ``set_pages`` path, and the prefix-cache entries rebuilt, so the
  first post-restart requests hit warm prefixes instead of recomputing them.

**Generation fencing.** The namespace head records a monotonically
increasing generation. A new incarnation restores from whatever the head
points at, then claims generation+1; an old incarnation still flushing (the
rolling-upgrade overlap) re-reads the head before every spill and, on seeing
a higher generation, fences itself: its stale manifests become inert.
Staleness is never a correctness risk (pages are content-addressed by chunk
hash and every blob is checksummed, kvoffload/serde.py), only a freshness
one, which the fence bounds.

Everything here runs on the engine's device thread (restore during engine
construction, spills serialized with steps), so no extra locking against the
scheduler is needed.
"""

from __future__ import annotations

import json
import re
import time
from typing import Optional

from production_stack_tpu_torch.kvoffload.serde import (
    KVIntegrityError,
    seal_bytes,
    unseal_bytes,
)
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

MANIFEST_FORMAT = 1


def _safe(ns: str) -> str:
    """Namespace -> tier-key-safe token (disk tiers use keys as filenames)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", ns) or "default"


class WarmStartManager:
    """Spill/restore choreography between one engine's KVPageManager and its
    offload tier. ``kv`` is the page manager, ``connector`` the
    KVOffloadConnector (blob store + batched device I/O)."""

    def __init__(
        self,
        kv,
        connector,
        *,
        namespace: str,
        interval_s: float = 60.0,
        max_pages: int = 256,
        model: str = "",
    ):
        self.kv = kv
        self.connector = connector
        self.namespace = _safe(namespace)
        self.interval_s = interval_s
        self.max_pages = max_pages
        self.model = model
        # claimed at restore(): head generation + 1 (1 on a cold tier)
        self.generation = 1
        # a higher generation appeared in the head: a newer incarnation owns
        # the namespace now; this instance must stop writing manifests
        self.fenced = False
        self.restored_pages = 0
        # age of the manifest the restore consumed (how stale the warm state
        # was), and of the newest manifest THIS incarnation wrote (how much a
        # hard crash right now would lose) — both exported on /metrics
        self.restored_manifest_age_s: Optional[float] = None
        self.last_manifest_ts: Optional[float] = None
        self.spilled_pages_total = 0
        self.stale_manifests_skipped = 0
        self._last_spill_mono = 0.0
        self._boot_mono = time.monotonic()
        # generation + write-time of the head that fenced us, for the
        # dead-fencer takeover check (see maybe_spill), plus the number of
        # consecutive head-read misses while fenced (blip tolerance)
        self._fencer_ts: Optional[float] = None
        self._fence_miss_streak = 0
        if not connector.store.durable():
            # a CPU-only tier dies with the process: spills still run (the
            # restore path is exercisable in tests) but restarts stay cold
            logger.warning(
                "warm-start: offload tier has no disk or remote level — "
                "manifests will NOT survive process death; configure "
                "--kv-offload-dir or --kv-remote-url"
            )

    # -- tier keys -----------------------------------------------------------

    @property
    def head_key(self) -> str:
        return f"ws-{self.namespace}-head"

    def manifest_key(self, generation: int) -> str:
        return f"ws-{self.namespace}-gen{generation:08d}"

    # -- envelope ------------------------------------------------------------

    def _read_json(self, key: str, attempts: int = 1) -> Optional[dict]:
        """``attempts`` > 1 retries transient misses — a remote-tier blip
        during the HEAD read must not masquerade as a cold namespace (the
        resulting generation-1 claim would invert the fence against a
        still-live older incarnation). Reads are AUTHORITATIVE (shared
        sources before this process's private caches): warm-start docs are
        mutable, and the ordinary content-addressed get-walk would hand an
        old incarnation its own stale head back — blinding it to the newer
        generation that fenced it."""
        for i in range(max(1, attempts)):
            blob = self.connector.store.get_authoritative(key)
            if blob is not None:
                try:
                    _, body = unseal_bytes(blob)
                    doc = json.loads(body)
                    return doc if isinstance(doc, dict) else None
                except (KVIntegrityError, ValueError) as e:
                    logger.warning("unreadable warm-start doc %s: %s", key, e)
                    return None
            if i + 1 < attempts:
                time.sleep(0.2)
        return None

    def _write_json(self, key: str, doc: dict) -> None:
        store = self.connector.store
        store.put(
            key, seal_bytes(json.dumps(doc).encode(), kind="warmstart")
        )
        # warm-start state must outlive the process: `put` lands in the DRAM
        # tier (disk only sees DRAM *evictions*), so force a durable local
        # copy now; the remote tier already got its write-through copy.
        # force=True: the head key is MUTABLE (generation/manifest pointer
        # updates) and a skip-if-present copy would leave the stale value
        # as the durable one
        store.persist(key, force=True)

    # -- restore (engine startup, before ready) ------------------------------

    def restore(self) -> int:
        """Pull the namespace head, restore the manifest it points at into
        the page pool, rebuild prefix-cache entries, and claim the next
        generation. Returns the number of pages restored. Never raises — a
        corrupt/absent manifest is a cold start, not a boot failure."""
        head = self._read_json(
            self.head_key,
            # remote-backed tiers can blip; a misread head means claiming
            # generation 1 under a live older incarnation — worth 3 tries
            attempts=3 if self.connector.store.remote is not None else 1,
        )
        if head is None:
            logger.info(
                "warm-start: no manifest for namespace %r (cold start, "
                "claiming generation 1)", self.namespace,
            )
            self._write_head(manifest=None)
            return 0
        prev_gen = int(head.get("generation", 0))
        self.generation = prev_gen + 1
        manifest = (
            self._read_json(head["manifest"]) if head.get("manifest") else None
        )
        restored = 0
        if manifest and int(manifest.get("format", 0)) == MANIFEST_FORMAT:
            if int(manifest.get("page_size", -1)) != self.kv.page_size:
                # page size changed across the upgrade: the chunk hashes no
                # longer line up with this engine's pages — skip wholesale
                logger.warning(
                    "warm-start: manifest page_size %s != engine %d; skipping",
                    manifest.get("page_size"), self.kv.page_size,
                )
                self.stale_manifests_skipped += 1
            else:
                entries = [
                    (bytes.fromhex(h), int(d), float(s))
                    for h, d, s in manifest.get("entries", [])
                ]
                restored = self.kv.warm_restore(
                    entries, self.connector.load_pages_sparse
                )
                self.restored_manifest_age_s = max(
                    0.0, time.time() - float(manifest.get("ts", time.time()))
                )
                logger.info(
                    "warm-start: restored %d/%d pages from generation %d "
                    "manifest (age %.1fs); serving warm",
                    restored, len(entries), prev_gen,
                    self.restored_manifest_age_s,
                )
        elif manifest is not None:
            self.stale_manifests_skipped += 1
            logger.warning("warm-start: unsupported manifest format; skipping")
        self.restored_pages = restored
        # claim the namespace NOW: a dying previous incarnation re-reads the
        # head before each spill and fences itself on our higher generation.
        # The head keeps pointing at the old manifest until our first spill,
        # so a crash before then still warm-starts from it.
        self._write_head(manifest=head.get("manifest"))
        return restored

    def _write_head(self, manifest: Optional[str]) -> None:
        try:
            self._write_json(
                self.head_key,
                {
                    "generation": self.generation,
                    "manifest": manifest,
                    "model": self.model,
                    "ts": time.time(),
                },
            )
        except Exception:  # noqa: BLE001 - tier down: warm start degrades
            logger.exception("warm-start: head write failed")

    # -- spill (periodic + SIGTERM drain) ------------------------------------

    # consecutive failed head reads before a fenced process concludes the
    # head is genuinely GONE (not a blip) and may resume; with the interval
    # gate in maybe_spill this is ~5 spill intervals of patience
    FENCE_MISS_STREAK = 5

    def _check_fence(self) -> bool:
        """True if this incarnation still owns the namespace. A missed head
        read (None) never changes the fence verdict by itself — a transient
        remote blip lifting the fence would let a stale incarnation clobber
        the live owner's head (the exact race restore()'s read-retry also
        guards); only repeated misses (see _try_takeover) conclude the head
        is really gone."""
        head = self._read_json(self.head_key)
        if head is None:
            return not self.fenced
        self._fence_miss_streak = 0
        if int(head.get("generation", 0)) > self.generation:
            if not self.fenced:
                logger.warning(
                    "warm-start: generation %d fenced by newer incarnation "
                    "(generation %d); suspending manifests from this process",
                    self.generation, head["generation"],
                )
            self.fenced = True
            self._fencer_ts = float(head.get("ts", 0.0)) or None
            return False
        if self.fenced:
            # the higher-generation head regressed: whoever fenced us is no
            # longer asserting ownership — resume
            logger.info("warm-start: fence lifted for generation %d",
                        self.generation)
            self.fenced = False
            self._fencer_ts = None
        return True

    def _try_takeover(self) -> bool:
        """Dead-fencer recovery. A LIVE newer incarnation refreshes its head
        every spill interval; a head that has not moved for several intervals
        belongs to a process that died (or a head-read blip at OUR boot made
        us claim a too-low generation — the inverted-fence case). Adopt the
        head's generation + 1 and resume, so the namespace cannot end up
        permanently writer-less. Returns True when ownership was retaken."""
        head = self._read_json(self.head_key)
        if head is None:
            # missing ≠ gone: tolerate FENCE_MISS_STREAK consecutive misses
            # (remote blips) before concluding the head vanished with its
            # writer (e.g. a DRAM-only cache server restarted)
            self._fence_miss_streak += 1
            if self._fence_miss_streak < self.FENCE_MISS_STREAK:
                return False
            logger.warning(
                "warm-start: fencing head unreadable %d times; assuming its "
                "writer is gone and resuming as generation %d",
                self._fence_miss_streak, self.generation,
            )
            self.fenced = False
            self._fencer_ts = None
            self._fence_miss_streak = 0
            return True
        self._fence_miss_streak = 0
        if int(head.get("generation", 0)) <= self.generation:
            self.fenced = False
            self._fencer_ts = None
            return True
        ts = float(head.get("ts", 0.0))
        stale_after = max(5 * max(self.interval_s, 1.0), 300.0)
        if ts and time.time() - ts > stale_after:
            self.generation = int(head["generation"]) + 1
            self.fenced = False
            self._fencer_ts = None
            logger.warning(
                "warm-start: fencing head is stale (%.0fs); taking over as "
                "generation %d", time.time() - ts, self.generation,
            )
            self._write_head(manifest=head.get("manifest"))
            return True
        self._fencer_ts = ts or self._fencer_ts
        return False

    def spill(self, reason: str = "interval") -> int:
        """Save the hottest restorable pages' blobs + a fresh manifest.
        Runs on the engine device thread. Returns pages covered by the
        manifest (0 when fenced or nothing is cached)."""
        self._last_spill_mono = time.monotonic()
        if not self._check_fence():
            return 0
        cands = self.kv.warm_candidates(self.max_pages)
        if not cands:
            return 0
        # make every manifest entry restorable: blobs not yet in the tier are
        # saved through the ordinary batched offload path. Pages are hashed
        # only once FULL, so their contents are immutable — but a page flips
        # to ``offloaded`` (the zero-I/O eviction path) ONLY when the save is
        # CONFIRMED: a mid-batch tier failure marking unsaved pages would
        # turn their later eviction into silent KV loss.
        todo = [
            (pid, h) for pid, h, _, _ in cands
            if not self.kv.pages[pid].offloaded
        ]
        saved: set = set()
        if todo:
            saved = self.connector.save_pages(todo)
            for pid, h in todo:
                if h in saved:
                    self.kv.pages[pid].offloaded = True
        # the manifest lists only restorable pages (blob known to the tier)
        entries = [
            c for c in cands
            if self.kv.pages[c[0]].offloaded or c[1] in saved
        ]
        store = self.connector.store
        if store.cpu is not None and store.disk is not None:
            # cpu+disk hierarchy: puts land in DRAM and disk only sees DRAM
            # evictions, so the manifest's blobs (hot = last to evict) would
            # die with the process — force durable copies now. No-op for
            # blobs already on disk; remote tiers got their write-through.
            for _, h, _, _ in entries:
                store.persist(h.hex())
        now = time.time()
        key = self.manifest_key(self.generation)
        try:
            self._write_json(
                key,
                {
                    "format": MANIFEST_FORMAT,
                    "generation": self.generation,
                    "model": self.model,
                    "page_size": self.kv.page_size,
                    "ts": now,
                    "entries": [
                        [h.hex(), depth, round(hits, 4)]
                        for _, h, depth, hits in entries
                    ],
                },
            )
            self._write_head(manifest=key)
        except Exception:  # noqa: BLE001 - tier down: retried next interval
            logger.exception("warm-start: manifest write failed")
            return 0
        self.last_manifest_ts = now
        self.spilled_pages_total += len(saved)
        d = getattr(self.kv, "directory", None)
        if d is not None:
            if d.generation != self.generation:
                # a generation taken over mid-life (_try_takeover): its first
                # publish fences everything this engine advertised, and the
                # publisher sends deltas only, so the live working set is
                # advertised again under the new generation
                d.generation = self.generation
                d.publish_resident([
                    (h, self.kv.pages[pid].depth, self.kv.pages[pid].hits)
                    for h, pid in self.kv.hash_to_page.items()
                ])
            # every manifest entry's blob is confirmed in the tier (written
            # through to the cache server when there is one): the fleet
            # directory's shared claims, so another engine can pull them
            d.publish_shared([(h, dep, hits) for _, h, dep, hits in entries])
        logger.info(
            "warm-start: generation %d manifest written (%s): %d pages "
            "(%d blobs newly saved)", self.generation, reason, len(entries),
            len(saved),
        )
        return len(entries)

    def maybe_spill(self, busy: bool = False) -> int:
        """Interval-gated spill for the engine loop. A busy engine defers up
        to one extra interval so the blob save (a device fetch) doesn't land
        in the middle of a traffic burst; past 2x the interval it spills
        anyway — crash-loss must stay bounded even under sustained load.
        While fenced, each interval instead re-checks the fencing head and
        takes the namespace back once its writer is provably dead."""
        if self.interval_s <= 0:
            return 0
        age = time.monotonic() - self._last_spill_mono
        if age < self.interval_s or (busy and age < 2 * self.interval_s):
            return 0
        if self.fenced:
            self._last_spill_mono = time.monotonic()  # one head read/interval
            if not self._try_takeover():
                return 0
        return self.spill("interval")

    # -- observability -------------------------------------------------------

    def manifest_age_seconds(self) -> float:
        """Seconds since the newest manifest covering this engine's state —
        i.e. how much warm state a hard crash right now would lose. Before
        this incarnation's first spill (drain-only configs, or a failing
        tier) the restored manifest keeps AGING with uptime; reporting its
        boot-time age frozen would keep the dashboard's climbing-line alert
        from ever firing in exactly the situation it documents."""
        if self.last_manifest_ts is not None:
            return max(0.0, time.time() - self.last_manifest_ts)
        if self.restored_manifest_age_s is not None:
            return self.restored_manifest_age_s + (
                time.monotonic() - self._boot_mono
            )
        return -1.0  # no manifest has ever existed for this namespace

    def stats(self) -> dict:
        return {
            "warm_start_restored_pages": self.restored_pages,
            "warm_start_manifest_age_seconds": round(
                self.manifest_age_seconds(), 3
            ),
            "warm_start_spilled_pages_total": self.spilled_pages_total,
            "warm_start_generation": self.generation,
            "warm_start_fenced": int(self.fenced),
            "warm_start_stale_manifests_skipped_total": (
                self.stale_manifests_skipped
            ),
        }
