"""KV-index controller: the global "which engine holds which KV chunks"
service (the port's copy of production_stack_tpu/kvoffload/controller.py).

- Engines register ``(instance_id, url, page_size)`` and stream
  ``admit``/``evict`` batches of chunk-hash hexes
  (kvoffload/connector.py ControllerReporter).
- The router's kvaware routing sends ``lookup`` with token ids; the
  controller recomputes the rolling chunk-hash chain
  (engine/kv_manager.prefix_hashes, the same hash as the engine's prefix
  cache) and returns the instance holding the longest contiguous prefix.

Run: ``python -m production_stack_tpu_torch.kvoffload.controller --port 9000``.
"""

from __future__ import annotations

import argparse
import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional

from production_stack_tpu_torch.engine.kv_manager import prefix_hashes
from production_stack_tpu_torch.kvoffload.protocol import (
    BlockingClient,
    parse_hostport,
    read_frame,
    write_frame,
)
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

DEFAULT_PAGE_SIZE = 16


@dataclass
class InstanceState:
    url: str
    page_size: int
    chunks: set[str] = field(default_factory=set)
    last_seen: float = field(default_factory=time.monotonic)


class KVIndexController:
    """In-memory chunk index. Single asyncio loop — no locking needed."""

    def __init__(self, instance_timeout: float = 120.0):
        self.instances: dict[str, InstanceState] = {}
        self.chunk_holders: dict[str, set[str]] = {}
        self.instance_timeout = instance_timeout
        self.lookups = 0
        self.lookup_hits = 0

    # -- index ops ------------------------------------------------------------

    def register(self, instance_id: str, url: str, page_size: int) -> None:
        prev = self.instances.get(instance_id)
        if prev is not None and prev.url != url:
            self.deregister(instance_id)
            prev = None
        if prev is None:
            self.instances[instance_id] = InstanceState(url, page_size)
            logger.info("registered instance %s at %s", instance_id, url)
        else:
            prev.last_seen = time.monotonic()

    def deregister(self, instance_id: str) -> None:
        st = self.instances.pop(instance_id, None)
        if st is None:
            return
        for h in st.chunks:
            holders = self.chunk_holders.get(h)
            if holders is not None:
                holders.discard(instance_id)
                if not holders:
                    del self.chunk_holders[h]
        logger.info("deregistered instance %s", instance_id)

    def admit(self, instance_id: str, hashes: list[str]) -> None:
        st = self.instances.get(instance_id)
        if st is None:
            return
        st.last_seen = time.monotonic()
        for h in hashes:
            st.chunks.add(h)
            self.chunk_holders.setdefault(h, set()).add(instance_id)

    def evict(self, instance_id: str, hashes: list[str]) -> None:
        st = self.instances.get(instance_id)
        if st is None:
            return
        st.last_seen = time.monotonic()
        for h in hashes:
            st.chunks.discard(h)
            holders = self.chunk_holders.get(h)
            if holders is not None:
                holders.discard(instance_id)
                if not holders:
                    del self.chunk_holders[h]

    def _expire(self) -> None:
        now = time.monotonic()
        for iid in [
            i
            for i, st in self.instances.items()
            if now - st.last_seen > self.instance_timeout
        ]:
            self.deregister(iid)

    def lookup(self, tokens: list[int], page_size: Optional[int] = None) -> dict:
        """Longest contiguous chunk-chain prefix across instances.

        Instances may use different page sizes, so the hash chain is computed
        per distinct page size and each instance is scored against its own
        chain; the comparison metric is *matched tokens*, not chunks."""
        self._expire()
        self.lookups += 1
        by_ps: dict[int, list[str]] = {}
        for st in self.instances.values():
            ps = page_size or st.page_size
            if ps not in by_ps:
                by_ps[ps] = [h.hex() for h in prefix_hashes(tokens, ps)]
        best_inst, best_tokens, best_chunks, best_total = None, 0, 0, 0
        for inst, st in self.instances.items():
            ps = page_size or st.page_size
            hashes = by_ps[ps]
            n = 0
            for h in hashes:
                if inst not in self.chunk_holders.get(h, ()):
                    break
                n += 1
            if n * ps > best_tokens:
                best_inst, best_tokens = inst, n * ps
                best_chunks, best_total = n, len(hashes)
        if best_inst is None:
            return {"instance_id": None, "url": None, "matched_chunks": 0}
        self.lookup_hits += 1
        return {
            "instance_id": best_inst,
            "url": self.instances[best_inst].url,
            "matched_chunks": best_chunks,
            "matched_tokens": best_tokens,
            "total_chunks": best_total,
        }

    def stats(self) -> dict:
        return {
            "instances": {
                i: {"url": st.url, "chunks": len(st.chunks)}
                for i, st in self.instances.items()
            },
            "indexed_chunks": len(self.chunk_holders),
            "lookups": self.lookups,
            "lookup_hits": self.lookup_hits,
        }

    # -- protocol -------------------------------------------------------------

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    hdr, _ = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                op = hdr.get("op")
                if op == "register":
                    self.register(
                        hdr["instance_id"],
                        hdr["url"],
                        hdr.get("page_size", DEFAULT_PAGE_SIZE),
                    )
                    await write_frame(writer, {"ok": True})
                elif op == "deregister":
                    self.deregister(hdr["instance_id"])
                    await write_frame(writer, {"ok": True})
                elif op == "admit":
                    self.admit(hdr["instance_id"], hdr["hashes"])
                    await write_frame(writer, {"ok": True})
                elif op == "evict":
                    self.evict(hdr["instance_id"], hdr["hashes"])
                    await write_frame(writer, {"ok": True})
                elif op == "lookup":
                    res = self.lookup(hdr["tokens"], hdr.get("page_size"))
                    await write_frame(writer, {"ok": True, **res})
                elif op == "query_inst":
                    # upstream parity: QueryInstMsg(ip) -> instance url
                    st = self.instances.get(hdr["instance_id"])
                    await write_frame(
                        writer, {"ok": True, "url": st.url if st else None}
                    )
                elif op == "stats":
                    await write_frame(writer, {"ok": True, **self.stats()})
                elif op == "ping":
                    await write_frame(writer, {"ok": True})
                else:
                    await write_frame(writer, {"ok": False, "error": f"bad op {op!r}"})
        except Exception as e:
            logger.warning("kv controller: client %s error: %s", peer, e)
        finally:
            try:
                writer.close()
            except Exception:
                pass


async def serve(host: str, port: int) -> asyncio.AbstractServer:
    ctl = KVIndexController()
    server = await asyncio.start_server(ctl.handle, host, port)
    logger.info("kv-index controller on %s:%d", host, port)
    return server


# -- clients ------------------------------------------------------------------


class ControllerClient:
    """Asyncio client, as the router's KvawareRouter holds one."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.host, self.port = parse_hostport(url, default_port=9000)
        self.timeout = timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def _request(self, header: dict) -> dict:
        async with self._lock:
            try:
                if self._writer is None:
                    self._reader, self._writer = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port), self.timeout
                    )
                await write_frame(self._writer, header)
                hdr, _ = await asyncio.wait_for(read_frame(self._reader), self.timeout)
                return hdr
            except Exception:
                await self.close()
                raise

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._reader = self._writer = None

    async def lookup(self, tokens: list[int]) -> dict:
        return await self._request({"op": "lookup", "tokens": tokens})

    async def lookup_url(self, tokens: list[int]) -> Optional[str]:
        return (await self.lookup(tokens)).get("url")

    async def stats(self) -> dict:
        return await self._request({"op": "stats"})


class WorkerClient(BlockingClient):
    """Blocking client for the engine-side reporting thread."""

    def __init__(self, url: str, instance_id: str, timeout: float = 10.0):
        host, port = parse_hostport(url, default_port=9000)
        super().__init__(host, port, timeout=timeout)
        self.instance_id = instance_id

    def register(self, engine_url: str, page_size: int) -> None:
        self.request(
            {
                "op": "register",
                "instance_id": self.instance_id,
                "url": engine_url,
                "page_size": page_size,
            }
        )

    def admit(self, hashes: list[str]) -> None:
        self.request({"op": "admit", "instance_id": self.instance_id, "hashes": hashes})

    def evict(self, hashes: list[str]) -> None:
        self.request({"op": "evict", "instance_id": self.instance_id, "hashes": hashes})

    def deregister(self) -> None:
        self.request({"op": "deregister", "instance_id": self.instance_id})


def main() -> None:
    p = argparse.ArgumentParser(description="KV-index controller (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    args = p.parse_args()

    async def run():
        server = await serve(args.host, args.port)
        async with server:
            await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
