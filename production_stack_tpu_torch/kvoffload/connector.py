"""Engine-side KV offload connector: the device page pools (engine/runner.py)
to the tiered blob store (kvoffload/tiers.py). The port's copy of
production_stack_tpu/kvoffload/connector.py for the local tiers; the
KV-index controller reporter and device KV staging are not ported, so
``report_admit``/``report_evict`` record nothing.

Runs on the engine's device thread (KVPageManager calls it from inside the
scheduler), so it never raises into the loop:
- ``save_pages``: one device-to-host copy per <= 64 pages, serialize, put;
- ``load_pages``: get, deserialize, one host-to-device copy per <= 64 pages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from production_stack_tpu_torch.kvoffload import serde as serde_mod
from production_stack_tpu_torch.kvoffload.serde import BF16, get_serde
from production_stack_tpu_torch.kvoffload.tiers import TieredKVStore
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

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
        serde: str = "naive",
    ):
        self.runner = runner
        # int8 pools (runner.kv_quant, ops/quant.py) ship their OWN int8
        # bytes and scales (format v3): a spill and restore is bit-exact, and
        # every tier moves half the bytes. The configured serde would either
        # double them (naive dequant) or requantize lossily (int8 transport),
        # so int8page overrides it.
        self.quant = bool(getattr(runner, "kv_quant", False))
        self.serde = get_serde("int8page" if self.quant else serde)
        self.store = TieredKVStore(cpu_bytes=cpu_bytes, disk_path=disk_path, disk_bytes=disk_bytes)
        self.saved_pages = 0
        self.loaded_pages = 0

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
                return ok
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
            logger.exception("kv offload save_pages failed; dropping %d pages", len(todo) - stored)
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

    def has(self, h: bytes) -> bool:
        try:
            return self.store.contains(h.hex())
        except Exception:
            return False

    # -- KV-index controller reporting (not ported: nothing to report to) -----

    def report_admit(self, hashes: "list[bytes]") -> None:
        pass

    def report_evict(self, hashes: "list[bytes]") -> None:
        pass

    def stats(self) -> dict:
        return {"saved_pages": self.saved_pages, "loaded_pages": self.loaded_pages, **self.store.stats()}
