"""Fleet-wide KV directory, the port's copy of production_stack_tpu/kvdirectory/:
a content-addressed index of which engine (and which tier) holds which
prefix chunks, hosted by the cache server (kvoffload/cache_server.py).

Engines publish directory entries as their prefix caches change; the router
consults the directory to rank backends *resident > restorable > cold*; a
cold engine pulls a fleet-warm prefix through the cache-server blob path (or
straight from the owning engine over the KV fabric) before prefill.

The directory is a HINT, never a source of truth: every pulled blob is
CRC-verified by the tier store (kvoffload/serde.py) and a miss or corruption
falls back to recompute exactly like the warm-restart path. Entries are
fenced by the warm-start generation scheme, so a restarted engine's stale
claims expire instead of poisoning lookups.
"""

from production_stack_tpu_torch.kvdirectory.client import (
    DirectoryClient,
    DirectoryPublisher,
    DirectoryPuller,
)
from production_stack_tpu_torch.kvdirectory.directory import KVDirectory

__all__ = [
    "KVDirectory",
    "DirectoryClient",
    "DirectoryPublisher",
    "DirectoryPuller",
]
