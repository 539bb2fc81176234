"""Standalone remote KV cache server: a DRAM tier shared by engine pods (the
port's copy of production_stack_tpu/kvoffload/cache_server.py).

Engines reach it through ``--kv-remote-url`` (kvoffload/tiers.RemoteTier):
every offloaded page is written through to it, and a miss in an engine's
local tiers reads it back, so engines share spilled prefixes and a restarted
engine finds its warm-start manifests here. Speaks the frame protocol of
kvoffload/protocol.py; blobs are opaque serde bytes, so one server serves
engines of any serde and KV dtype. The store is an LRU bounded by
``--max-bytes``; a blob that fails its integrity check on read is
quarantined (dropped and counted) and answered as a miss.

The JAX server also hosts the fleet-wide KV directory (its ``dir_*`` ops,
``--directory*`` flags, and the ``vllm:kv_directory_*`` series of its
``--metrics-port``, its only series). The port has no directory yet:
``--directory`` is refused by name, a ``dir_*`` op gets the answer the JAX
server gives when its directory is off, and there is no metrics port, whose
page would be empty, as the JAX server's is with its directory off.

Run: ``python -m production_stack_tpu_torch.kvoffload.cache_server --port 8200``.
"""

from __future__ import annotations

import argparse
import asyncio
from collections import OrderedDict
from typing import Optional

from production_stack_tpu_torch.kvoffload.protocol import read_frame, write_frame
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError, verify_blob
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class CacheServer:
    def __init__(self, max_bytes: int = 4 << 30):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, bytes] = OrderedDict()  # owned-by: event-loop
        self.used_bytes = 0
        self.gets = 0
        self.hits = 0
        self.puts = 0
        # entries that failed their integrity check on read and were dropped
        # (a shared server must never fan corruption out to the whole fleet)
        self.corrupt = 0

    # -- storage --------------------------------------------------------------

    def put(self, key: str, blob: bytes) -> None:
        self.puts += 1
        old = self._data.pop(key, None)
        if old is not None:
            self.used_bytes -= len(old)
        self._data[key] = blob
        self.used_bytes += len(blob)
        while self.used_bytes > self.max_bytes and self._data:
            _, b = self._data.popitem(last=False)
            self.used_bytes -= len(b)

    def get(self, key: str) -> Optional[bytes]:
        self.gets += 1
        blob = self._data.get(key)
        if blob is None:
            return None
        try:
            verify_blob(blob)
        except KVIntegrityError as e:
            # quarantine: a corrupt entry on a SHARED server would otherwise
            # be re-fetched by every engine in the fleet; drop it and report
            # a miss so the caller falls back to another tier or recompute
            self.corrupt += 1
            self._data.pop(key, None)
            self.used_bytes -= len(blob)
            logger.warning("cache server: quarantined corrupt blob %s: %s", key, e)
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return blob

    def stats(self) -> dict:
        return {
            "entries": len(self._data),
            "used_bytes": self.used_bytes,
            "max_bytes": self.max_bytes,
            "gets": self.gets,
            "hits": self.hits,
            "puts": self.puts,
            "corrupt": self.corrupt,
        }

    # -- protocol -------------------------------------------------------------

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    hdr, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                op = hdr.get("op")
                if op == "put":
                    self.put(hdr["key"], payload)
                    await write_frame(writer, {"ok": True})
                elif op == "get":
                    blob = self.get(hdr["key"])
                    await write_frame(writer, {"ok": True, "found": blob is not None}, blob or b"")
                elif op == "exists":
                    await write_frame(writer, {"ok": True, "found": hdr["key"] in self._data})
                elif op == "delete":
                    blob = self._data.pop(hdr["key"], None)
                    if blob is not None:
                        self.used_bytes -= len(blob)
                    await write_frame(writer, {"ok": True, "found": blob is not None})
                elif op == "stats":
                    await write_frame(writer, {"ok": True, **self.stats()})
                elif op == "ping":
                    await write_frame(writer, {"ok": True})
                elif isinstance(op, str) and op.startswith("dir_"):
                    # the JAX server's answer with its directory off
                    await write_frame(writer, {"ok": False, "error": "directory disabled"})
                else:
                    await write_frame(writer, {"ok": False, "error": f"bad op {op!r}"})
        except Exception as e:  # keep the server alive across bad clients
            logger.warning("cache server: client %s error: %s", peer, e)
        finally:
            try:
                writer.close()
            except Exception:
                pass


async def serve(host: str, port: int, max_bytes: int) -> asyncio.AbstractServer:
    cs = CacheServer(max_bytes)
    server = await asyncio.start_server(cs.handle, host, port)
    logger.info("kv cache server on %s:%d (%.1f GB)", host, port, max_bytes / 1e9)
    return server


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="remote KV cache server (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--max-bytes", type=int, default=4 << 30)
    p.add_argument("--directory", action=argparse.BooleanOptionalAction, default=False,
                   help="host the fleet-wide KV directory: not supported by the PyTorch port yet "
                        "(--no-directory, the port's default, is accepted)")
    args = p.parse_args(argv)
    if args.directory:
        p.error("--directory: the fleet KV directory is not supported by the PyTorch port yet")

    async def run():
        server = await serve(args.host, args.port, args.max_bytes)
        async with server:
            await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
