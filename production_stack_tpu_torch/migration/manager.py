"""Engine-side migration choreography: freeze -> ship -> commit | rollback
(the port's copy of production_stack_tpu/migration/manager.py).

State machine (source engine, one sequence):

    RUNNING --freeze--> FROZEN --commit--> MIGRATED (finish_reason
       ^                   |                "migrated"; stream ends with the
       |                   |                control event the router splices on)
       +----- rollback ----+  (target refused / unreachable: the sequence
                               re-enters the running set and decoding resumes
                               locally — nothing was client-visible)

Target engine: /migrate_in parks a continuation (api_server), which the
router attaches to with /migrate_attach. Everything here that touches
scheduler or device state runs ON the engine device thread via
``engine._run_on_device_thread`` — the same serialization discipline as
LoRA updates and sleep/wake — so no extra locking against the step loop is
needed; ``_frozen`` is device-thread-owned by construction.

KV movement rides the existing offload path: full pages are saved
content-addressed (confirmed-save contract, connector.save_pages), persisted
past DRAM for cpu+disk hierarchies (the warm-start lesson — puts land in
DRAM and disk only sees evictions), CRC-verified by every reader, and
advertised to the fleet KV directory when one is configured.
"""

from __future__ import annotations

import time

from production_stack_tpu_torch.migration.state import (
    SequenceSnapshot,
    params_to_doc,
    unmigratable_reason,
)
from production_stack_tpu_torch.utils.logging import init_logger
from production_stack_tpu_torch.utils.metrics import LATENCY_BUCKETS, Histogram

logger = init_logger(__name__)


class MigrationError(RuntimeError):
    """A sequence cannot be (or is no longer) migratable; the caller maps
    this to a 409 and the controller picks another victim."""


class MigrationManager:
    """Owned by LLMEngine (``engine.migration``); api_server drives it from
    executor threads so the event loop never blocks on a device command."""

    def __init__(self, engine):
        self.engine = engine
        # counters are single-writer enough for unlocked ints: out/pages/
        # failures mutate on the device thread (freeze/commit) or the event
        # loop (ship failures), and stats() readers tolerate a torn read the
        # same way every other engine counter does
        self.migrations_out = 0
        self.migrations_in = 0
        self.pages_moved = 0
        self.fabric_pages = 0
        self.failures = 0
        # freeze -> commit wall time on the source (the stream-stall window
        # a client could observe between the last source chunk and the
        # router's attach)
        self.duration_hist = Histogram(
            "vllm:migration_duration_seconds", LATENCY_BUCKETS,
            "Source-side migration duration (freeze to commit)",
        )
        # seq_id -> monotonic freeze time
        self._freeze_started: dict[str, float] = {}  # owned-by: device-thread

    # -- source side ---------------------------------------------------------

    def freeze_and_snapshot(
        self, seq_id: str, meta: dict, fabric_addr=None
    ) -> SequenceSnapshot:
        """Freeze a running sequence (it stops decoding but keeps its pages)
        and build its snapshot: full-page KV shipped to the target over the
        KV fabric when ``fabric_addr`` names its listener (device-to-device
        handoff, zero shared-tier I/O), else saved through the offload tiers
        (confirmed prefix only); plus token history, params, presentation
        meta. Runs on the device thread; raises MigrationError when the
        sequence is gone or semantically unmigratable."""
        return self.engine._run_on_device_thread(
            lambda: self._freeze(seq_id, meta, fabric_addr),
            what=f"migrate freeze {seq_id}",
        )

    def _freeze(
        self, seq_id: str, meta: dict, fabric_addr=None
    ) -> SequenceSnapshot:
        engine = self.engine
        sched = engine.scheduler
        seq = next(
            (s for s in sched.running if s.seq_id == seq_id and not s.finished),
            None,
        )
        if seq is None:
            raise MigrationError(f"sequence {seq_id!r} is not running")
        reason = unmigratable_reason(seq)
        if reason is not None:
            raise MigrationError(reason)
        from production_stack_tpu_torch.engine.kv_manager import prefix_hashes

        tokens = seq.prompt_ids + seq.output_ids
        # only FULLY-WRITTEN pages ship: the newest emitted token's KV is not
        # written until it is fed back as the next step's input, so the page
        # holding position len(tokens)-1 is incomplete and must recompute
        n_full = (len(tokens) - 1) // engine.kv.page_size
        hashes = prefix_hashes(tokens, engine.kv.page_size, seq.cache_salt)[:n_full]
        confirmed = 0
        offload = engine._offload
        if (
            fabric_addr
            and hashes
            and getattr(engine, "_fabric_client", None) is not None
        ):
            # fabric handoff (docs/kv-fabric.md): the page chain moves
            # engine-to-engine as (pages, scales) frames and lands straight
            # in the TARGET's local tiers — the shared tier never sees the
            # bytes. The tier save below remains the fallback when the
            # fabric could not cover the chain (counted on
            # kv_fabric_fallbacks_total by the client).
            pairs = [(p, h.hex()) for p, h in zip(seq.pages, hashes)]
            shipped = set(engine.fabric_ship_pairs(fabric_addr, pairs))
            while confirmed < len(hashes) and hashes[confirmed].hex() in shipped:
                confirmed += 1
            self.fabric_pages += confirmed
        if confirmed == 0 and offload is not None and hashes:
            pairs = list(zip(seq.pages, hashes))
            saved = offload.save_pages(pairs)
            # the restorable chain must be CONTIGUOUS from the head — the
            # target's prefix match truncates at the first miss anyway
            while confirmed < len(hashes) and hashes[confirmed] in saved:
                confirmed += 1
            store = offload.store
            if store.cpu is not None and store.disk is not None:
                # cpu+disk hierarchy: puts land in DRAM and disk only sees
                # DRAM evictions — force durable copies so a target sharing
                # the disk tier (or a source crash before the pull) still
                # restores (same contract as warm-start manifests)
                for h in hashes[:confirmed]:
                    store.persist(h.hex())
            shared = confirmed
            if store.remote is not None:
                # save_pages counts a page already local as saved, and a
                # page a peer's fabric frame landed is local only (put_local):
                # write such blobs through before any shared claim, so a
                # target that shares only the remote tier finds them (a blob
                # put wrote through costs no request). The claims stop at
                # the first blob the remote tier lacks
                shared = 0
                while shared < confirmed and store.write_through(hashes[shared].hex()):
                    shared += 1
            if engine.kv.directory is not None and shared:
                # truthful fleet hint: these blobs are confirmed in the
                # shared tier (when one exists; publish_shared gates itself)
                engine.kv.directory.publish_shared([
                    (h, i, 1.0) for i, h in enumerate(hashes[:shared])
                ])
        # freeze: out of the running set, pages kept, no more decode steps
        sched.running.remove(seq)
        engine._frozen[seq_id] = seq
        self._freeze_started[seq_id] = time.monotonic()
        logger.info(
            "migration: froze %s (%d tokens, %d/%d pages restorable)",
            seq_id, len(tokens), confirmed, n_full,
        )
        return SequenceSnapshot(
            request_id=meta.get("request_id", seq_id),
            model=engine.cfg.name,
            page_size=engine.kv.page_size,
            tokens=list(tokens),
            prompt_len=len(seq.prompt_ids),
            output_len=len(seq.output_ids),
            params=params_to_doc(seq.params),
            page_hashes=[h.hex() for h in hashes[:confirmed]],
            meta=dict(meta),
        )

    def commit(self, seq_id: str, pages_moved: int) -> None:
        """The target accepted: finish the frozen sequence with reason
        "migrated" (registers its pages in the local prefix cache and frees
        them) and emit the terminal output the API layer converts into the
        stream-handoff control event. Device thread."""

        def run():
            seq = self.engine._frozen.pop(seq_id, None)
            if seq is None or seq.finished:
                return
            self.engine.scheduler._finish(seq, "migrated")
            self.engine._emit(seq, "")
            self.migrations_out += 1
            self.pages_moved += pages_moved
            t0 = self._freeze_started.pop(seq_id, None)
            if t0 is not None:
                self.duration_hist.observe(time.monotonic() - t0)

        self.engine._run_on_device_thread(run, what=f"migrate commit {seq_id}")

    def rollback(self, seq_id: str) -> None:
        """The target refused or the ship failed: the sequence re-enters the
        running set and decoding resumes locally — the client stream never
        noticed. Device thread."""

        def run():
            seq = self.engine._frozen.pop(seq_id, None)
            self._freeze_started.pop(seq_id, None)
            self.failures += 1
            if seq is not None and not seq.finished:
                self.engine.scheduler.running.append(seq)
                logger.warning(
                    "migration: rolled back %s (resuming locally)", seq_id
                )

        self.engine._run_on_device_thread(run, what=f"migrate rollback {seq_id}")

    # -- target side ---------------------------------------------------------

    def prefetch_pages(self, hashes_hex: list) -> int:
        """Pull the snapshot's blobs into the LOCAL host tiers (executor
        thread, before the continuation is admitted) so the device-thread
        restore at admission reads locally. ``store.get`` walks
        local -> remote, CRC-verifies, and promotes; a miss or corruption
        truncates the chain there — the tail recomputes, which is always
        correct (the warm-restart contract)."""
        offload = self.engine._offload
        if offload is None or not hashes_hex:
            return 0
        from production_stack_tpu_torch.kvoffload.serde import (
            KVIntegrityError,
            verify_blob,
        )

        store = offload.store
        n = 0
        for key in hashes_hex:
            try:
                if store.contains_local(key) or store.get(key) is not None:
                    n += 1
                    continue
                # co-located engines sharing a disk directory: the source
                # wrote the blob AFTER this process built its disk index, so
                # the indexed get-walk misses it — read the FILE directly
                # (the warm-start get_fresh path), verify, and index it
                blob = (
                    store.disk.get_fresh(key)
                    if store.disk is not None else None
                )
                if blob is None:
                    break  # chain broken: later chunks cannot extend anyway
                verify_blob(blob)
                store.put_local(key, blob)
                n += 1
            except KVIntegrityError:
                logger.warning("migration prefetch: corrupt blob %s", key)
                break
            except Exception:  # noqa: BLE001 - recompute covers any tier error
                logger.exception("migration prefetch failed for %s", key)
                break
        return n

    def note_migrate_in(self) -> None:
        self.migrations_in += 1

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Rendered by api_server /metrics under the vllm: namespace:
        vllm:migrations_out_total, vllm:migrations_in_total,
        vllm:migration_pages_moved_total, vllm:migration_failures_total
        (plus the vllm:migration_duration_seconds histogram)."""
        return {
            "migrations_out_total": self.migrations_out,
            "migrations_in_total": self.migrations_in,
            "migration_pages_moved_total": self.pages_moved,
            "migration_fabric_pages_total": self.fabric_pages,
            "migration_failures_total": self.failures,
        }
