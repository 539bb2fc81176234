"""Engine-side KV offload connector: the device page pools (engine/runner.py)
to the tiered blob store (kvoffload/tiers.py: host RAM, disk and the remote
cache server) and to the KV-index controller (kvoffload/controller.py). The
port's copy of production_stack_tpu/kvoffload/connector.py, with the device
staging of disaggregated prefill (``device_staging``: pages a consumer
pulled device to device, written into the pool by ``load_page``).

Runs on the engine's device thread (KVPageManager calls it from inside the
scheduler, warm start from its restore and spills), so it never raises into
the loop:
- ``save_pages``: one device-to-host copy per <= 64 pages, serialize, put;
- ``load_pages``: get, deserialize, one host-to-device copy per <= 64 pages;
- ``load_page``: one page, a staged device page first;
- ``load_pages_sparse``: the same as ``load_pages``, skipping a missing page instead of
  ending the chain there (warm-start manifests);
- ``report_admit``/``report_evict``: queued to the controller reporter's
  thread, so an index update never blocks a step.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.kvoffload import serde as serde_mod
from production_stack_tpu_torch.kvoffload.serde import BF16, get_serde
from production_stack_tpu_torch.kvoffload.tiers import TieredKVStore
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class ControllerReporter:
    """Batches admit/evict chunk-hash reports to the KV-index controller."""

    def __init__(self, controller_url: str, instance_id: str, engine_url: str,
                 page_size: int):
        from production_stack_tpu_torch.kvoffload.controller import WorkerClient

        self.client = WorkerClient(controller_url, instance_id)
        self.engine_url = engine_url
        self.page_size = page_size
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="kv-reporter")
        self._thread.start()

    def admit(self, hashes: list[str]) -> None:
        if hashes:
            self._q.put(("admit", hashes))

    def evict(self, hashes: list[str]) -> None:
        if hashes:
            self._q.put(("evict", hashes))

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)
        try:
            self.client.deregister()
        except Exception:
            pass
        self.client.close()

    def _run(self) -> None:
        registered = False
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                return
            # coalesce whatever queued up behind it
            batch: dict[str, list[str]] = {"admit": [], "evict": []}
            batch[item[0]].extend(item[1])
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    return
                batch[nxt[0]].extend(nxt[1])
            try:
                if not registered:
                    self.client.register(self.engine_url, self.page_size)
                    registered = True
                if batch["admit"]:
                    self.client.admit(batch["admit"])
                if batch["evict"]:
                    self.client.evict(batch["evict"])
            except Exception as e:
                logger.warning("kv controller report failed: %s", e)
                registered = False  # re-register on reconnect


# the numpy dtype a blob's header names for the model's fp dtype
_NP_DTYPES = {torch.float32: np.dtype(np.float32), torch.bfloat16: BF16, torch.float16: np.dtype(np.float16)}


class KVOffloadConnector:
    """Wired into KVPageManager (``kv.offload``); owned by LLMEngine."""

    def __init__(
        self,
        runner,
        *,
        cpu_bytes: int = 0,
        disk_path: Optional[str] = None,
        disk_bytes: int = 0,
        remote_url: Optional[str] = None,
        serde: str = "naive",
        controller_url: Optional[str] = None,
        instance_id: Optional[str] = None,
        engine_url: str = "",
    ):
        self.runner = runner
        # int8 pools (runner.kv_quant, ops/quant.py) ship their OWN int8
        # bytes and scales (format v3): a spill and restore is bit-exact, and
        # every tier moves half the bytes. The configured serde would either
        # double them (naive dequant) or requantize lossily (int8 transport),
        # so int8page overrides it.
        self.quant = bool(getattr(runner, "kv_quant", False))
        self.serde = get_serde("int8page" if self.quant else serde)
        self.reporter: Optional[ControllerReporter] = None
        if controller_url and instance_id:
            self.reporter = ControllerReporter(controller_url, instance_id, engine_url, runner.page_size)
        self.store = TieredKVStore(
            cpu_bytes=cpu_bytes, disk_path=disk_path, disk_bytes=disk_bytes,
            remote_url=remote_url, on_local_drop=self._on_local_drop,
        )
        self.saved_pages = 0
        self.loaded_pages = 0
        # device-pulled pages awaiting admission (disaggregated prefill's
        # device path), consulted before the host-blob tiers so admission
        # never pays a serde round trip for them
        self.device_staging = None
        self.device_loaded_pages = 0

    def _on_local_drop(self, key: str) -> None:
        # last local copy gone; remote copies (shared server) still count as
        # "this cluster has it" but not as this instance holding it
        if self.reporter is not None:
            self.reporter.evict([key])

    # -- KVPageManager hooks (engine device thread) ---------------------------

    def _serialize_pages(self, pids: "list[int]") -> "list[bytes]":
        """Blobs for a batch of pool pages, from ONE device fetch."""
        if self.quant:
            ks, vs, sks, svs = self.runner.get_pages_quant(pids)
            # the fp dtype a non-quantized reader dequantizes into
            dt = _NP_DTYPES.get(self.runner.cfg.dtype)
            return [
                self.serde.serialize_quant(k, sk, v, sv, orig_dtype=dt)
                for k, v, sk, sv in zip(ks, vs, sks, svs)
            ]
        ks, vs = self.runner.get_pages(pids)
        return [self.serde.serialize(np.asarray(k), np.asarray(v)) for k, v in zip(ks, vs)]

    def save_pages(self, pairs: "list[tuple[int, bytes]]") -> "set[bytes]":
        """Offload a batch of pages before their slots are reused. Returns the
        hashes whose blobs are KNOWN to be in the store afterwards (already
        local, or stored by this call): a caller that marks pages offloaded
        must do so only for these. Never raises."""
        ok: "set[bytes]" = set()
        todo = pairs
        stored = 0  # prefix of `todo` safely in the store
        try:
            if not self.store.enabled():
                # index-only mode: eviction from the pool = chunk gone here
                self.report_evict([h for _, h in pairs])
                return ok
            # pages already offloaded (contains_local) stay OUT of the evict
            # set on failure: their blobs still exist
            todo = []
            for pid, h in pairs:
                if self.store.contains_local(h.hex()):
                    ok.add(h)
                else:
                    todo.append((pid, h))
            for i in range(0, len(todo), 64):
                chunk = todo[i : i + 64]
                blobs = self._serialize_pages([pid for pid, _ in chunk])
                for (pid, h), blob in zip(chunk, blobs):
                    self.store.put(h.hex(), blob)
                    self.saved_pages += 1
                    stored += 1
                    ok.add(h)
        except Exception:
            # evict ONLY what was neither already local nor stored before the
            # failure; reporting stored pages evicted would poison the index
            # for chunks this instance holds
            logger.exception("kv offload save_pages failed; dropping %d pages", len(todo) - stored)
            self.report_evict([h for _, h in todo[stored:]])
        return ok

    def _deserialize_for_pool(self, blob: bytes):
        """Blob -> what the runner's restore takes: (k, v) for fp pools,
        (qk, sk, qv, sv) for int8 ones. Cross-dtype blobs convert here (an
        fp blob quantizes on the host; a v3 blob dequantizes)."""
        if self.quant:
            return serde_mod.get_serde("int8page").deserialize_quant(blob)
        return serde_mod.deserialize(blob, verify=False)

    def _set_pool_pages(self, ids: "list[int]", payloads: "list") -> None:
        if self.quant:
            self.runner.set_pages_quant(
                ids,
                [p[0] for p in payloads], [p[2] for p in payloads],
                [p[1] for p in payloads], [p[3] for p in payloads],
            )
        else:
            self.runner.set_pages(ids, [p[0] for p in payloads], [p[1] for p in payloads])

    def load_pages(self, pairs: "list[tuple[int, bytes]]") -> int:
        """Restore a batch of pages into the pools, one upload per <= 64
        pages. Returns the length of the restored PREFIX of ``pairs``: a
        missing or unreadable blob truncates the chain there, as the prefix
        cache requires. Never raises."""
        done = 0
        batch_ids: list[int] = []
        batch_p: list = []

        def flush() -> bool:
            nonlocal done
            if not batch_ids:
                return True
            try:
                self._set_pool_pages(batch_ids, batch_p)
            except Exception:
                logger.exception("kv offload batched restore failed")
                return False
            done += len(batch_ids)
            self.loaded_pages += len(batch_ids)
            batch_ids.clear()
            batch_p.clear()
            return True

        for pid, h in pairs:
            try:
                if self.device_staging is not None and self.device_staging.contains(h.hex()):
                    # a staged device page: flush the host batch first so
                    # the restored prefix stays in chain order, then write
                    # it device to device
                    if not flush() or not self.load_page(pid, h):
                        return done
                    done += 1
                    continue
                blob = self.store.get(h.hex())  # verifies and quarantines
                if blob is None:
                    break
                batch_ids.append(pid)
                batch_p.append(self._deserialize_for_pool(blob))
                if len(batch_ids) >= 64 and not flush():
                    return done
            except Exception:
                logger.exception("kv offload load_pages failed for %s", h.hex())
                break
        flush()
        return done

    def load_pages_sparse(self, pairs: "list[tuple[int, bytes]]") -> "list[bool]":
        """Best-effort batched restore: like :meth:`load_pages`, but a
        missing or corrupt blob skips THAT page instead of truncating the
        rest. Warm-start restore uses it: a manifest's entries are
        independent hash -> page mappings, not one prefix chain. Returns
        per-page success flags aligned with ``pairs``. Never raises."""
        ok = [False] * len(pairs)
        batch_idx: list[int] = []
        batch_ids: list[int] = []
        batch_p: list = []

        def flush() -> None:
            if not batch_ids:
                return
            try:
                self._set_pool_pages(batch_ids, batch_p)
            except Exception:
                logger.exception("kv warm restore batch failed")
            else:
                for i in batch_idx:
                    ok[i] = True
                self.loaded_pages += len(batch_ids)
            batch_idx.clear()
            batch_ids.clear()
            batch_p.clear()

        for i, (pid, h) in enumerate(pairs):
            try:
                blob = self.store.get(h.hex())  # verifies and quarantines
                if blob is None:
                    continue
                batch_idx.append(i)
                batch_ids.append(pid)
                batch_p.append(self._deserialize_for_pool(blob))
                if len(batch_ids) >= 64:
                    flush()
            except Exception:
                logger.exception("kv warm restore failed for %s", h.hex())
        flush()
        return ok

    def has(self, h: bytes) -> bool:
        try:
            if self.device_staging is not None and self.device_staging.contains(h.hex()):
                return True
            return self.store.contains(h.hex())
        except Exception:
            return False

    def load_page(self, pid: int, h: bytes) -> bool:
        """Restore one page into the pool; False if it is neither staged nor
        in a tier (or unreadable). Never raises."""
        try:
            if self.device_staging is not None and self.device_staging.pop(h.hex()):
                self.runner.kv_restore_page(h.hex(), pid)  # device to device
                self.device_loaded_pages += 1
                self.loaded_pages += 1
                return True
            blob = self.store.get(h.hex())
            if blob is None:
                return False
            self._set_pool_pages([pid], [self._deserialize_for_pool(blob)])
            self.loaded_pages += 1
            return True
        except Exception:
            logger.exception("kv offload load_page failed for %s", h.hex())
            return False

    # -- controller index reporting ------------------------------------------

    def report_admit(self, hashes: "list[bytes]") -> None:
        if self.reporter is not None:
            self.reporter.admit([h.hex() for h in hashes])

    def report_evict(self, hashes: "list[bytes]") -> None:
        if self.reporter is not None:
            self.reporter.evict([h.hex() for h in hashes])

    def stop(self) -> None:
        if self.reporter is not None:
            self.reporter.stop()
        if self.store.remote is not None:
            self.store.remote.close()

    def stats(self) -> dict:
        return {"saved_pages": self.saved_pages, "loaded_pages": self.loaded_pages, **self.store.stats()}
