"""Standalone remote KV cache server: a DRAM tier shared by engine pods (the
port's copy of production_stack_tpu/kvoffload/cache_server.py).

Engines reach it through ``--kv-remote-url`` (kvoffload/tiers.RemoteTier):
every offloaded page is written through to it, and a miss in an engine's
local tiers reads it back, so engines share spilled prefixes and a restarted
engine finds its warm-start manifests here. Speaks the frame protocol of
kvoffload/protocol.py; values are opaque serialized pages, shareable across
engines of any serde and KV dtype. The store is an LRU bounded by
``--max-bytes``; a blob that fails its integrity check on read is
quarantined (dropped and counted) and answered as a miss.

The server also hosts the fleet-wide KV directory (kvdirectory/, on by
default; ``--no-directory`` turns it off, and a ``dir_*`` op is then
answered "directory disabled"): engines publish which chunk hashes they hold
and which blobs they spilled here (``--kv-directory-url``), the router's
kvaware routing consults it (``--kv-directory-url`` of the router), and cold
engines pull fleet-warm prefixes through the ordinary get path. The
directory rides the same frame connection (``dir_*`` ops), stays consistent
with the blob map (an evicted or quarantined blob stops being advertised as
restorable at once), and persists snapshots to ``--directory-persist-path``,
so a server restart keeps the fleet's claims. ``--metrics-port`` serves the
``vllm:kv_directory_*`` series for Prometheus.

Run: ``python -m production_stack_tpu_torch.kvoffload.cache_server --port 8200``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
from collections import OrderedDict
from typing import Optional

from production_stack_tpu_torch.kvoffload.protocol import read_frame, write_frame
from production_stack_tpu_torch.kvoffload.serde import (
    KVIntegrityError,
    seal_bytes,
    unseal_bytes,
    verify_blob,
)
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class CacheServer:
    def __init__(self, max_bytes: int = 4 << 30, directory=None):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, bytes] = OrderedDict()  # owned-by: event-loop
        self.used_bytes = 0
        self.gets = 0
        self.hits = 0
        self.puts = 0
        # entries that failed their integrity check on read and were dropped
        # (a shared server must never fan corruption out to the whole fleet)
        self.corrupt = 0
        # fleet-wide KV directory (kvdirectory.KVDirectory) — optional so the
        # plain blob-tier deployment shape keeps working unchanged
        self.directory = directory
        if directory is not None and directory.blob_check is None:
            # restorable lookups answer against the ACTUAL blob map, so a
            # capacity-evicted blob stops being advertised instantly
            directory.blob_check = self._contains

    def _contains(self, key: str) -> bool:
        return key in self._data

    # -- storage --------------------------------------------------------------

    def put(self, key: str, blob: bytes) -> None:
        self.puts += 1
        old = self._data.pop(key, None)
        if old is not None:
            self.used_bytes -= len(old)
        self._data[key] = blob
        self.used_bytes += len(blob)
        while self.used_bytes > self.max_bytes and self._data:
            k, b = self._data.popitem(last=False)
            self.used_bytes -= len(b)
            if self.directory is not None:
                self.directory.blob_evicted(k)

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
            if self.directory is not None:
                self.directory.blob_evicted(key)
            logger.warning("cache server: quarantined corrupt blob %s: %s", key, e)
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return blob

    def stats(self) -> dict:
        out = {
            "entries": len(self._data),
            "used_bytes": self.used_bytes,
            "max_bytes": self.max_bytes,
            "gets": self.gets,
            "hits": self.hits,
            "puts": self.puts,
            "corrupt": self.corrupt,
        }
        if self.directory is not None:
            out.update(self.directory.stats())
        return out

    # -- directory persistence -------------------------------------------------

    def directory_snapshot_blob(self) -> Optional[bytes]:
        """Serialize the directory ON the event loop: the index is
        single-writer on this loop (kvdirectory/directory.py), so a worker
        thread would iterate dicts the loop concurrently mutates and die
        with 'dictionary changed size during iteration' on every busy
        interval. Only the file WRITE belongs off-loop."""
        if self.directory is None:
            return None
        return seal_bytes(self.directory.snapshot_json(), kind="kvdirectory")

    @staticmethod
    def write_snapshot(path: str, blob: bytes) -> None:
        """Atomic-replace file write (runs in asyncio.to_thread)."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    def load_directory_snapshot(self, path: str) -> int:
        if self.directory is None or not os.path.exists(path):
            return 0
        import json

        try:
            with open(path, "rb") as f:
                _, body = unseal_bytes(f.read())
            return self.directory.load_snapshot(json.loads(body))
        except (OSError, ValueError, KVIntegrityError) as e:
            # a rotted snapshot is a cold directory, not a boot failure —
            # engines republish on their flush cadence anyway
            logger.warning("cache server: unreadable directory snapshot: %s", e)
            return 0

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
                    await write_frame(
                        writer, {"ok": True, "found": blob is not None}, blob or b""
                    )
                elif op == "exists":
                    await write_frame(
                        writer, {"ok": True, "found": hdr["key"] in self._data}
                    )
                elif op == "delete":
                    blob = self._data.pop(hdr["key"], None)
                    if blob is not None:
                        self.used_bytes -= len(blob)
                        if self.directory is not None:
                            self.directory.blob_evicted(hdr["key"])
                    await write_frame(writer, {"ok": True, "found": blob is not None})
                elif op == "stats":
                    await write_frame(writer, {"ok": True, **self.stats()})
                elif op == "ping":
                    await write_frame(writer, {"ok": True})
                elif isinstance(op, str) and op.startswith("dir_"):
                    await self._handle_dir(writer, op, hdr)
                else:
                    await write_frame(writer, {"ok": False, "error": f"bad op {op!r}"})
        except Exception as e:  # keep the server alive across bad clients
            logger.warning("cache server: client %s error: %s", peer, e)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_dir(self, writer, op: str, hdr: dict) -> None:
        d = self.directory
        if d is None:
            await write_frame(
                writer, {"ok": False, "error": "directory disabled"}
            )
            return
        if op == "dir_register":
            d.register(
                hdr["url"], int(hdr.get("page_size", 0)),
                int(hdr.get("generation", 0)),
            )
            await write_frame(writer, {"ok": True})
        elif op == "dir_publish":
            n = d.publish(
                hdr["url"], int(hdr.get("generation", 0)),
                hdr.get("entries", []), hdr.get("tier", "hbm"),
                page_size=int(hdr.get("page_size", 0)),
            )
            await write_frame(writer, {"ok": True, "published": n})
        elif op == "dir_withdraw":
            n = d.withdraw(
                hdr["url"], hdr.get("hashes", []),
                hdr.get("scope", "resident"),
            )
            await write_frame(writer, {"ok": True, "withdrawn": n})
        elif op == "dir_lookup":
            res = d.lookup_tokens(hdr.get("tokens", []), hdr.get("salt", ""))
            await write_frame(writer, {"ok": True, **res})
        elif op == "dir_lookup_hashes":
            res = d.lookup_hashes(hdr.get("hashes", []))
            await write_frame(writer, {"ok": True, **res})
        elif op == "dir_top_prefixes":
            hashes = d.top_prefixes(
                int(hdr.get("limit", 0)), int(hdr.get("page_size", 0))
            )
            await write_frame(writer, {"ok": True, "hashes": hashes})
        elif op == "dir_stats":
            await write_frame(writer, {"ok": True, **d.stats()})
        elif op == "dir_dump":
            await write_frame(writer, {"ok": True, **d.dump()})
        else:
            await write_frame(writer, {"ok": False, "error": f"bad op {op!r}"})

    def metrics_text(self) -> str:
        """Prometheus exposition for --metrics-port: the kv-directory surface
        (docs/kv-directory.md, check_metrics_coverage.py)."""
        if self.directory is None:
            return ""
        s = self.directory.stats()
        lines = []
        for name, kind in (
            ("vllm:kv_directory_entries", "gauge"),
            ("vllm:kv_directory_engines", "gauge"),
            ("vllm:kv_directory_publishes_total", "counter"),
            ("vllm:kv_directory_withdrawals_total", "counter"),
            ("vllm:kv_directory_stale_hits_total", "counter"),
            ("vllm:kv_directory_expired_entries_total", "counter"),
            ("vllm:kv_directory_lookups_total", "counter"),
        ):
            key = name.split(":", 1)[1]
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f'{name}{{server="cache"}} {s.get(key, 0)}')
        return "\n".join(lines) + "\n"


async def _persist_loop(cs: CacheServer, path: str, interval: float) -> None:
    """Periodic offload-tier-backed persistence of the directory index:
    serialize on the loop (single-writer safety), write off it."""
    while True:
        await asyncio.sleep(interval)
        try:
            blob = cs.directory_snapshot_blob()
            if blob is not None:
                await asyncio.to_thread(cs.write_snapshot, path, blob)
        except Exception:  # noqa: BLE001 - persistence is best-effort
            logger.exception("cache server: directory snapshot failed")


async def _serve_metrics(cs: CacheServer, host: str, port: int):
    """Tiny HTTP /metrics endpoint for Prometheus (aiohttp, like the other
    first-party servers)."""
    from aiohttp import web

    async def metrics(request):
        return web.Response(text=cs.metrics_text(), content_type="text/plain")

    app = web.Application()
    app.router.add_get("/metrics", metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    logger.info("cache server metrics on %s:%d", host, port)
    return runner


async def serve(
    host: str,
    port: int,
    max_bytes: int,
    *,
    directory: bool = True,
    directory_persist_path: Optional[str] = None,
    directory_persist_interval: float = 30.0,
    directory_engine_timeout: float = 60.0,
    metrics_port: int = 0,
) -> asyncio.AbstractServer:
    d = None
    if directory:
        from production_stack_tpu_torch.kvdirectory import KVDirectory

        d = KVDirectory(engine_timeout=directory_engine_timeout)
    cs = CacheServer(max_bytes, directory=d)
    if d is not None and directory_persist_path:
        cs.load_directory_snapshot(directory_persist_path)
        # keep a strong reference on the server object: the event loop holds
        # only a weak ref to tasks, and a GC'd persist loop would silently
        # stop snapshots on a long-lived, mostly-idle server
        cs._persist_task = asyncio.get_running_loop().create_task(
            _persist_loop(cs, directory_persist_path, directory_persist_interval)
        )
    if metrics_port:
        await _serve_metrics(cs, host, metrics_port)
    server = await asyncio.start_server(cs.handle, host, port)
    logger.info(
        "kv cache server on %s:%d (%.1f GB, directory=%s)",
        host, port, max_bytes / 1e9, "on" if d is not None else "off",
    )
    return server


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="remote KV cache server (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--max-bytes", type=int, default=4 << 30)
    p.add_argument("--directory", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="host the fleet-wide KV directory (dir_* ops; "
                        "docs/kv-directory.md); --no-directory disables")
    p.add_argument("--directory-persist-path", type=str, default=None,
                   help="file the directory index snapshots to (sealed JSON, "
                        "atomic replace) and reloads from at boot; unset = "
                        "in-memory only")
    p.add_argument("--directory-persist-interval", type=float, default=30.0,
                   help="seconds between directory snapshots")
    p.add_argument("--directory-engine-timeout", type=float, default=60.0,
                   help="seconds of engine silence before its resident "
                        "claims expire from the directory")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve GET /metrics (vllm:kv_directory_*) on this "
                        "port; 0 disables")
    args = p.parse_args(argv)

    async def run():
        server = await serve(
            args.host, args.port, args.max_bytes,
            directory=args.directory,
            directory_persist_path=args.directory_persist_path,
            directory_persist_interval=args.directory_persist_interval,
            directory_engine_timeout=args.directory_engine_timeout,
            metrics_port=args.metrics_port,
        )
        async with server:
            await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
