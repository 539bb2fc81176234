"""KV fabric listener: one engine's serving side of the peer-to-peer plane;
the port's copy of production_stack_tpu/kvfabric/server.py.

Every engine with ``--kv-fabric`` runs one ``KVFabricServer``. Peers speak
the kvoffload frame protocol (``protocol.py`` — the same envelope the cache
server and KV transfer use) with four ops:

    fabric_hello   -> {"ok", "generation", "quant", "page_size", "nlayers"}
                      peer handshake: who am I talking to, what dtype family
                      do its frames carry, which directory generation fences
                      its pages
    fabric_probe   -> echoes the payload (peers.probe_peer_link times this
                      to measure per-peer bandwidth/RTT)
    fabric_pull    -> header {keys, expect_generation?}; reply payload is
                      ONE wire frame (wire.encode_frame) holding every
                      requested page still resident here, header lists which
                      keys were found. A stale ``expect_generation`` (the
                      directory claim predates this engine's rebirth) is
                      REJECTED — generation fencing, the reborn owner must
                      not serve pages the claim's issuer never wrote
    fabric_push    -> payload is one wire frame; verified + decoded, pages
                      land through the injected sink (streamed disagg
                      prefill and migration ship through this). Corrupt
                      frames are QUARANTINED (counted, dropped, error reply)
                      — the sender's caller falls back to the tier path

The server is transport only: page bytes come from / go to injected
callables (``pages_fn``/``sink_fn``), which the engine routes through its
device thread — the listener thread never touches the pools or the card
(the same split as ``KVTransferReceiver``). ``queue_depth`` counts
in-flight ops and is exported on /metrics; the router and fleet controller
fold it into transfer-cost scores (peers.transfer_cost_score).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Callable, Optional

from production_stack_tpu_torch.kvfabric.wire import FabricWireError, decode_frame
from production_stack_tpu_torch.kvoffload.protocol import read_frame, write_frame
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class KVFabricServer:
    """Asyncio TCP listener in its own thread (KVTransferReceiver pattern:
    the engine loop and device thread stay untouched)."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        *,
        generation: int = 0,
        quant: bool = False,
        page_size: int = 0,
        nlayers: int = 0,
        pages_fn: Optional[Callable[["list[str]"], "tuple[list[str], bytes]"]] = None,
        sink_fn: Optional[Callable[[dict], int]] = None,
        advertise_host: Optional[str] = None,
    ):
        self.host, self.port = host, port
        self.generation = int(generation)
        self.quant = bool(quant)
        self.page_size = int(page_size)
        self.nlayers = int(nlayers)
        # pages_fn(keys) -> (found_keys, frame_bytes): gather resident pages
        # and encode one wire frame (engine: device-thread get_pages[_quant]
        # + wire.encode_frame). sink_fn(decoded_frame) -> pages_stored.
        self.pages_fn = pages_fn
        self.sink_fn = sink_fn
        self._advertise_host = advertise_host
        self.queue_depth = 0
        self.served_pages = 0
        self.received_pages = 0
        self.corrupt_frames = 0
        self.stale_generation_pulls = 0
        self.errors = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.bound_port: Optional[int] = None

    @property
    def address(self) -> str:
        host = self._advertise_host or (
            "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        )
        return f"{host}:{self.bound_port or self.port}"

    async def _handle_op(self, hdr: dict, payload: bytes) -> "tuple[dict, bytes]":
        op = hdr.get("op")
        if op == "fabric_hello":
            return {
                "ok": True,
                "generation": self.generation,
                "quant": self.quant,
                "page_size": self.page_size,
                "nlayers": self.nlayers,
            }, b""
        if op == "fabric_probe":
            return {"ok": True, "echo": len(payload)}, payload
        if op == "fabric_pull":
            expect = hdr.get("expect_generation")
            if expect is not None and int(expect) != self.generation:
                # generation fence: the claim was issued by a previous
                # incarnation of this owner; its pages are gone or reused
                self.stale_generation_pulls += 1
                return {
                    "ok": False,
                    "error": "stale_generation",
                    "generation": self.generation,
                }, b""
            keys = hdr.get("keys") or []
            if self.pages_fn is None or not keys:
                return {"ok": True, "found": []}, b""
            try:
                found, frame = await asyncio.to_thread(self.pages_fn, keys)
            except Exception as e:  # noqa: BLE001 - a pull must not kill the listener
                self.errors += 1
                logger.warning("fabric pull of %d keys failed: %s", len(keys), e)
                return {"ok": False, "error": "pull_failed"}, b""
            self.served_pages += len(found)
            return {"ok": True, "found": list(found)}, frame or b""
        if op == "fabric_push":
            if self.sink_fn is None:
                return {"ok": False, "error": "no_sink"}, b""
            try:
                frame = decode_frame(payload)
            except FabricWireError as e:
                # quarantine: a corrupt frame admitted here would scatter
                # wrong KV downstream; drop it and tell the sender, whose
                # caller falls back to the tier path
                self.corrupt_frames += 1
                logger.warning("quarantining corrupt fabric frame: %s", e)
                return {"ok": False, "error": "integrity"}, b""
            try:
                stored = int(await asyncio.to_thread(self.sink_fn, frame) or 0)
            except Exception as e:  # noqa: BLE001
                self.errors += 1
                logger.warning("fabric push sink failed: %s", e)
                return {"ok": False, "error": "sink_failed"}, b""
            self.received_pages += stored
            return {"ok": True, "stored": stored}, b""
        return {"ok": False, "error": f"bad op {op!r}"}, b""

    async def _handle(self, reader, writer):
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    hdr, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                self.queue_depth += 1
                try:
                    rhdr, rpayload = await self._handle_op(hdr, payload)
                finally:
                    self.queue_depth -= 1
                await write_frame(writer, rhdr, rpayload)
        except Exception as e:  # noqa: BLE001
            logger.warning("fabric server: client %s error: %s", peer, e)
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    def start(self) -> None:
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def serve():
                server = await asyncio.start_server(self._handle, self.host, self.port)
                self.bound_port = server.sockets[0].getsockname()[1]
                self._started.set()
                async with server:
                    await server.serve_forever()

            try:
                self._loop.run_until_complete(serve())
            except asyncio.CancelledError:
                pass

        self._thread = threading.Thread(target=run, daemon=True, name="kv-fabric")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("KV fabric server failed to start")
        logger.info("kv fabric listening on %s", self.address)

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: [t.cancel() for t in asyncio.all_tasks(self._loop)]
            )
        if self._thread is not None:
            self._thread.join(timeout=5)

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "served_pages": self.served_pages,
            "received_pages": self.received_pages,
            "corrupt_frames": self.corrupt_frames,
            "stale_generation_pulls": self.stale_generation_pulls,
            "errors": self.errors,
        }
