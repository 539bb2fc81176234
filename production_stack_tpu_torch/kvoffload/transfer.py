"""Disaggregated-prefill KV transfer: prefill (producer) -> decode (consumer);
the port's copy of production_stack_tpu/kvoffload/transfer.py, with its
device-to-device half rewritten on CUDA IPC.

The reference stack pairs a NIXL sender and receiver (an LMCache role per
engine, receiver port 55555). Here KV pages ship as serde blobs over TCP,
keyed by the same rolling chunk hashes the prefix cache uses, so the decode
engine's ordinary offload-restore path injects them into its pools.

Flow (two engines behind the router's ``disaggregated_prefill`` mode):
1. The router sends the prompt to the prefill engine with max_tokens=1.
2. The producer engine, at the sequence's finish and *before* it answers the
   prefill HTTP request, pushes each full page's blob to the consumer's
   receiver, so the KV is there when the router's decode request lands.
3. The consumer's receiver drops the blobs into its offload store; decode
   admission restores them through KVPageManager.match_prefix (the offload
   extension path).

The device path (``--kv-transfer-device``, both roles): the producer copies
a page into fresh device tensors and offers them through
:class:`DeviceKVEndpoint`; the consumer opens the CUDA IPC handles, copies
the page into its own staging tensors (:class:`DeviceStaging` keeps the
budget) and admission writes it into the pool device to device, with no host
serde. Two engine processes on one host and one card or several; the
per-page fallback is the TCP blob.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import threading
import time
from typing import Optional

from production_stack_tpu_torch.kvoffload.protocol import (
    BlockingClient,
    parse_hostport,
    read_frame,
    write_frame,
)
from production_stack_tpu_torch.kvoffload.serde import KVIntegrityError, verify_blob
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class _FrameListener:
    """An asyncio frame server (kvoffload/protocol.py) on a thread of its own,
    so the engine loop and its device thread stay untouched. Subclasses
    answer ops in ``_op``."""

    _name = "kv-listener"

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.bound_port: Optional[int] = None

    async def _op(self, hdr: dict, payload: bytes, peer) -> dict:
        raise NotImplementedError

    async def _handle(self, reader, writer):
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    hdr, payload = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                await write_frame(writer, await self._op(hdr, payload, peer))
        except Exception as e:
            logger.warning("%s: client %s error: %s", self._name, peer, e)
        finally:
            try:
                writer.close()
            except Exception:
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

        self._thread = threading.Thread(target=run, daemon=True, name=self._name)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError(f"{self._name} failed to start")
        logger.info("%s on %s:%s", self._name, self.host, self.bound_port)

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: [t.cancel() for t in asyncio.all_tasks(self._loop)]
            )
        if self._thread is not None:
            self._thread.join(timeout=5)


class KVTransferReceiver(_FrameListener):
    """TCP server inside the decode (consumer) engine process; pushes land in
    the engine's tiered store where prefix-match admission finds them."""

    _name = "kv-receiver"

    def __init__(self, store, host: str = "0.0.0.0", port: int = 55555, staging=None):
        super().__init__(host, port)
        self.store = store
        # device path (DeviceKVEndpoint + DeviceStaging): producers announce
        # pages via "page_ready"; pull_fn(addr, uuid, shape, dtype, key) ->
        # staged bytes (runner.kv_pull_page) copies them device to device,
        # unstage_fn(key) drops a partial pull (runner.kv_unstage_page)
        self.staging = staging
        self.pull_fn = None
        self.unstage_fn = None
        self.received_chunks = 0
        self.received_bytes = 0
        self.device_pages = 0
        # pushes rejected by the integrity check (bit-flipped in flight or a
        # producer on an incompatible serde format) — never enter the store
        self.corrupt_chunks = 0

    # a device pull that outlasts this fails to the producer's blob fallback
    PULL_TIMEOUT_S = 15.0

    async def _op(self, hdr: dict, payload: bytes, peer) -> dict:
        op = hdr.get("op")
        if op == "push":
            try:
                verify_blob(payload)
            except KVIntegrityError as e:
                # refuse the page: a corrupt blob admitted here would later
                # scatter wrong KV into the decode pools. The producer keeps
                # its copy; admission falls back to recompute
                self.corrupt_chunks += 1
                logger.warning("rejecting corrupt kv push %s from %s: %s", hdr.get("key"), peer, e)
                return {"ok": False, "error": "integrity"}
            self.store.put_local(hdr["key"], payload)
            self.received_chunks += 1
            self.received_bytes += len(payload)
            return {"ok": True}
        if op == "page_query":
            # device path phase 1: atomically reserve staging budget so the
            # producer offers the page only once a pull is sure to be tried
            if self.pull_fn is None or self.staging is None:
                return {"ok": False}
            verdict = self.staging.reserve(hdr["key"], int(hdr["nbytes"]))
            return {"ok": verdict == "reserved", "have": verdict == "have"}
        if op == "page_ready" and "uuid" in hdr:
            # device path phase 2: the offer's (addr, uuid); the pull runs in
            # a timed worker thread, so a producer that died mid-handshake
            # fails here, before staging publishes the page
            key = hdr["key"]
            if self.pull_fn is None or self.staging is None:
                return {"ok": False}
            nbytes = 0
            try:
                nbytes = int(await asyncio.wait_for(
                    asyncio.to_thread(self.pull_fn, hdr["addr"], hdr["uuid"], hdr["shape"], hdr["dtype"], key),
                    timeout=self.PULL_TIMEOUT_S,
                ) or 0)
            except (Exception, asyncio.TimeoutError) as e:  # noqa: BLE001
                logger.warning("device kv pull failed: %s", e)
            if nbytes > 0:
                self.staging.promote(key, nbytes)
                self.device_pages += 1
                return {"ok": True}
            self.staging.unreserve(key)
            if self.unstage_fn is not None:
                await asyncio.to_thread(self.unstage_fn, key)
            return {"ok": False}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"bad op {op!r}"}


class KVTransferSender:
    """Producer-side pusher. Called on the engine device thread at sequence
    finish — synchronous by design: the prefill HTTP response must not return
    before the decode peer holds the KV (the reference gets the same ordering
    from the NIXL blocking handshake)."""

    def __init__(self, peer_url: str, timeout: float = 30.0):
        host, port = parse_hostport(peer_url, default_port=55555)
        self._client = BlockingClient(host, port, timeout=timeout)
        self._lock = threading.Lock()
        # device path (engine-armed): this process's endpoint address, the
        # offer (runner.kv_offer_page) and its retirement
        self._dev_addr: Optional[str] = None
        self._dev_offer = None
        self._dev_retire = None
        self._dev_uuid = 0
        self.sent_chunks = 0
        self.sent_bytes = 0
        self.device_pages = 0
        self.skipped_pages = 0
        self.errors = 0

    def enable_device(self, addr: str, offer_fn, retire_fn) -> None:
        """Arm the device path: ``addr`` is the producer endpoint's address,
        ``offer_fn(pid, uuid) -> (shape, dtype)`` offers a copy of page
        ``pid`` under ``uuid`` and ``retire_fn(uuid)`` drops it."""
        self._dev_addr, self._dev_offer, self._dev_retire = addr, offer_fn, retire_fn

    @property
    def device_armed(self) -> bool:
        return self._dev_addr is not None

    def push_device(self, key: str, nbytes: int, pid: int) -> bool:
        """One page moves device to device with no host serde. Phase 1
        reserves consumer staging; phase 2 offers a copy of the page and
        announces its (addr, uuid), and the consumer answers once it has
        copied the page and closed the handle, so the offer retires with the
        answer, whatever it is. Returns False for the per-page TCP-blob
        fallback."""
        if not self.device_armed:
            return False
        try:
            with self._lock:
                hdr, _ = self._client.request({"op": "page_query", "key": key, "nbytes": nbytes})
                if hdr.get("have"):
                    self.skipped_pages += 1
                    return True
                if not hdr.get("ok"):
                    return False
                self._dev_uuid += 1
                uuid = self._dev_uuid
                shape, dtype = self._dev_offer(pid, uuid)
                try:
                    hdr, _ = self._client.request({
                        "op": "page_ready", "key": key, "addr": self._dev_addr, "uuid": uuid,
                        "shape": shape, "dtype": dtype,
                    })
                finally:
                    self._dev_retire(uuid)
            if bool(hdr.get("ok")):
                self.device_pages += 1
                return True
            return False
        except Exception as e:  # noqa: BLE001
            self.errors += 1
            logger.warning("device kv offer failed: %s", e)
            return False

    def push(self, key: str, blob: bytes) -> bool:
        with self._lock:
            try:
                hdr, _ = self._client.request({"op": "push", "key": key}, blob)
                if hdr.get("ok"):
                    self.sent_chunks += 1
                    self.sent_bytes += len(blob)
                    return True
                return False
            except Exception as e:
                self.errors += 1
                logger.warning("kv transfer push failed: %s", e)
                return False

    def close(self) -> None:
        self._client.close()


# -- device-to-device path (CUDA IPC between engine processes on one host) -----


def _ipc_encode(x):
    """One element of torch's CUDA tensor reduction as JSON: handles as
    base64, dtypes and the tensor and storage classes by name."""
    import torch

    if isinstance(x, (bytes, bytearray)):
        return {"b64": base64.b64encode(bytes(x)).decode()}
    if isinstance(x, torch.dtype):
        return {"dtype": str(x).removeprefix("torch.")}
    if isinstance(x, type):
        return {"cls": f"{x.__module__}.{x.__qualname__}"}
    if isinstance(x, torch.Size):
        return {"size": list(x)}
    if isinstance(x, tuple):
        return {"tuple": [_ipc_encode(y) for y in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot encode {type(x).__name__} of a CUDA IPC handle")


def _ipc_decode(x):
    import torch

    if not isinstance(x, dict):
        return x
    if "b64" in x:
        return base64.b64decode(x["b64"])
    if "dtype" in x:
        dt = getattr(torch, x["dtype"])
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"not a dtype: {x['dtype']!r}")
        return dt
    if "cls" in x:
        # only the classes torch's reduction names: never import by name
        known = {f"{c.__module__}.{c.__qualname__}": c
                 for c in (torch.Tensor, torch.nn.Parameter, torch.TypedStorage, torch.UntypedStorage)}
        if x["cls"] not in known:
            raise ValueError(f"unexpected class {x['cls']!r} in a CUDA IPC handle")
        return known[x["cls"]]
    if "size" in x:
        return torch.Size(x["size"])
    if "tuple" in x:
        return tuple(_ipc_decode(y) for y in x["tuple"])
    raise ValueError(f"cannot decode {x!r}")


class DeviceKVEndpoint:
    """One engine's side of the device-to-device KV path, on CUDA IPC.

    The producer offers a page as one ``[2, L, page, KH, D]`` tensor, K
    then V (a fresh copy, never a view of the pool: a page is reused once
    its sequence is freed), under a uuid the sender assigns
    (``offer_fixed``): it exports its IPC handle with torch's own CUDA
    tensor reduction, which carries the allocation's handle, the storage's
    offset in that caching-allocator block, a cross-process ref counter and
    an event recorded after the copy. A small listener at ``address`` hands
    a uuid's handle to the consumer. The consumer (``pull``) asks the
    producer for it over a connection it keeps per producer (a dead
    producer fails the request fast), opens it (its stream waits on the
    producer's event), copies the page into a tensor of its own,
    synchronizes and only then drops the opened tensor, which closes the
    handle: the staged copy is then independent of the producer. An IPC
    handle cannot be opened in the process that exported it, so the roles
    are two processes.

    The consumer answers ``page_ready`` only after its copy synchronized and
    the handle closed, so the sender retires an offer (``retire``) with the
    answer, ok or not: offers pin device memory only while their pull runs
    (a pull still copying past the receiver's timeout keeps the memory:
    torch frees an exported block only once every opener closed it). An
    offer that outlives ``OFFER_TTL`` was never retired (the sending
    thread died mid-handshake); the sweep drops it and counts it leaked.
    """

    OFFER_TTL = 120.0
    DEAD_ADDR_TTL = 60.0
    # connecting to a producer's listener: a dead one fails within this
    PROBE_TIMEOUT_S = 3.0

    def __init__(self, device, host: str = "127.0.0.1"):
        import torch

        self.device = torch.device(device)
        self._offered: dict[int, tuple] = {}  # uuid -> (kv, deadline, handle)
        self._conns: dict[str, tuple] = {}  # producer addr -> (BlockingClient, lock)
        self._lock = threading.Lock()
        self._stream = None  # the consumer's copy stream, made at the first pull
        self.offered_pages = 0
        self.pulled_pages = 0
        # offers the sweep dropped by age: never retired by their sender
        self.leaked_offers = 0
        self._dead_addrs: dict[str, float] = {}  # addr -> retry-after
        self._listener = _HandleListener(self, host)
        self._listener.start()
        self.address = f"{host}:{self._listener.bound_port}"

    # -- the export and open of one tensor (the CUDA-specific part) -------------

    def _export(self, t) -> dict:
        """The IPC handle of tensor ``t``, as JSON: torch's reduction of a
        CUDA tensor, which records the event the consumer waits on."""
        from torch.multiprocessing.reductions import reduce_tensor

        _, args = reduce_tensor(t)
        return {"args": [_ipc_encode(a) for a in args]}

    def _open(self, handle: dict):
        """A tensor over the producer's memory (on the current stream, which
        waits on the producer's event)."""
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        return rebuild_cuda_tensor(*[_ipc_decode(a) for a in handle["args"]])

    # -- producer -------------------------------------------------------------

    @staticmethod
    def _offer_bytes(entry: tuple) -> int:
        return int(entry[0].numel() * entry[0].element_size())

    def pinned_offer_bytes(self) -> int:
        """Device bytes held by live offers."""
        with self._lock:
            return sum(self._offer_bytes(e) for e in self._offered.values())

    def sweep(self) -> None:
        """Drop the offers past ``OFFER_TTL``: their senders never retired
        them."""
        now = time.monotonic()
        with self._lock:
            stale = [u for u, e in self._offered.items() if e[1] < now]
            for u in stale:
                self._offered.pop(u)
            self.leaked_offers += len(stale)
        if stale:
            self._collect()

    def retire(self, uuid: int) -> None:
        """Drop an offer once its ``page_ready`` was answered."""
        with self._lock:
            entry = self._offered.pop(uuid, None)
        if entry is not None:
            self._collect()

    def _collect(self) -> None:
        """Free the dropped offers whose consumers closed their handles
        (torch keeps an exported block until every opener released it)."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.ipc_collect()

    def offer_fixed(self, uuid: int, kv) -> None:
        """Offer a page (``kv``: K and V stacked, [2, L, page, KH, D]) under a
        caller-chosen uuid. ``kv`` must be the endpoint's own: the caller
        made it for the offer."""
        self.sweep()
        handle = self._export(kv)
        with self._lock:
            self._offered[uuid] = (kv, time.monotonic() + self.OFFER_TTL, handle)
        self.offered_pages += 1

    def handle(self, uuid: int) -> Optional[dict]:
        with self._lock:
            entry = self._offered.get(uuid)
        return entry[2] if entry is not None else None

    # -- consumer -------------------------------------------------------------

    def mark_dead(self, addr: str) -> None:
        """Negative-cache a producer address after a failed pull, so later
        pages fail fast to the TCP blob path instead of each paying a
        timeout."""
        with self._lock:
            self._dead_addrs[addr] = time.monotonic() + self.DEAD_ADDR_TTL
            conn = self._conns.pop(addr, None)
        if conn is not None:
            conn[0].close()

    def _fetch_handle(self, addr: str, uuid: int) -> dict:
        """Ask the producer's listener for an offer's handle, over the
        connection kept to it; an unreachable or dead producer raises
        ConnectionError within PROBE_TIMEOUT_S."""
        with self._lock:
            conn = self._conns.get(addr)
            if conn is None:
                host, port = parse_hostport(addr)
                conn = self._conns[addr] = (
                    BlockingClient(host or "127.0.0.1", port, timeout=self.PROBE_TIMEOUT_S), threading.Lock())
        cli, lock = conn
        try:
            with lock:
                hdr, _ = cli.request({"op": "ipc_handle", "uuid": int(uuid)})
        except (OSError, ValueError) as e:
            raise ConnectionError(f"kv producer {addr} unreachable: {e}") from e
        if not hdr.get("ok"):
            raise LookupError(f"kv producer {addr} holds no offer {uuid}: {hdr.get('error')}")
        return hdr["handle"]

    def pull(self, addr: str, uuid: int, shape, dtype):
        """Copy a page's (k, v) from the producer at ``addr`` into fresh
        tensors on this endpoint's device, synchronized before returning, so
        a producer that dies mid-pull is caught here, before staging
        publishes the page. Raises on any failure (the caller marks the
        address dead and the producer falls back to a blob). The tensors are
        allocated on this endpoint's copy stream: a caller that reads them
        on another stream calls ``record_stream`` before dropping them, or
        the next pull may reuse their memory while that read is pending."""
        import torch

        with self._lock:
            dead_until = self._dead_addrs.get(addr, 0.0)
            if dead_until > time.monotonic():
                raise ConnectionError(f"kv producer {addr} marked dead until {dead_until:.0f}")
            self._dead_addrs.pop(addr, None)
        handle = self._fetch_handle(addr, uuid)
        want_dt = getattr(torch, str(dtype).removeprefix("torch."))
        on_card = self.device.type == "cuda"
        if on_card and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with (torch.cuda.stream(self._stream) if on_card else contextlib.nullcontext()):
            src = self._open(handle)
            try:
                if list(src.shape) != [2, *shape] or src.dtype != want_dt:
                    raise ValueError(f"offer {uuid} holds {tuple(src.shape)}/{src.dtype}, "
                                     f"announced 2 x {tuple(shape)}/{dtype}")
                dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dst.copy_(src)
                if on_card:
                    self._stream.synchronize()  # the copy is done before the handle closes
            finally:
                del src  # the last reference: the handle closes
        self.pulled_pages += 1
        return dst[0], dst[1]

    def close(self) -> None:
        """Stop the listener, drop every offer (a consumer that opens one
        later fails and the page goes as a blob) and the kept connections."""
        self._listener.stop()
        with self._lock:
            self._offered.clear()
            conns, self._conns = list(self._conns.values()), {}
        for cli, _ in conns:
            cli.close()
        self._collect()

    def stats(self) -> dict:
        return {
            "kv_transfer_pinned_offer_bytes": self.pinned_offer_bytes(),
            "kv_transfer_leaked_offers_total": self.leaked_offers,
            # the JAX server's series: its offers outlive their pulls and
            # are capped; here one retires with its answer, none is evicted
            "kv_transfer_cap_evicted_offers_total": 0,
        }


class _HandleListener(_FrameListener):
    """The producer endpoint's listener: ``ipc_handle {uuid}`` answers an
    offer's handle; a failed request is the consumer's sign of a dead
    producer."""

    _name = "kv-ipc-endpoint"

    def __init__(self, endpoint: DeviceKVEndpoint, host: str):
        super().__init__(host, 0)
        self.endpoint = endpoint

    async def _op(self, hdr: dict, payload: bytes, peer) -> dict:
        op = hdr.get("op")
        if op == "ipc_handle":
            handle = self.endpoint.handle(int(hdr.get("uuid", -1)))
            if handle is None:
                return {"ok": False, "error": "unknown offer"}
            return {"ok": True, "handle": handle}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"bad op {op!r}"}


class DeviceStaging:
    """Consumer-side staging for device-pulled pages awaiting admission.

    Pulled pages live on the device (runner.kv_staged) until the decode
    request's prefix match writes them into the pool (runner.kv_restore_page,
    a device-to-device copy); this object keeps the budget and admission's
    view of them. Bounded and self-cleaning: budget is reserved atomically
    BEFORE the pull (so concurrent producers cannot overcommit), and both
    reservations and staged pages expire after ``ttl`` seconds — a decode
    request that never arrives (client abort after prefill) must not pin
    consumer memory or wedge the budget into permanent TCP fallback."""

    def __init__(self, max_bytes: int = 1 << 30, ttl: float = 120.0, on_expire=None):
        self._time = time.monotonic
        self.max_bytes = max_bytes
        self.ttl = ttl
        # on_expire(key): fired (outside the lock) when a staged page expires,
        # so the runner drops its staged copy with the accounting entry
        self.on_expire = on_expire
        self._pages: dict[str, tuple] = {}     # key -> (nbytes, deadline)
        self._reserved: dict[str, tuple] = {}  # key -> (nbytes, deadline)
        self._bytes = 0
        self._lock = threading.Lock()
        self._expire_q = None  # lazy single-worker on_expire queue
        self.expired_pages = 0

    def _sweep_locked(self) -> list:
        """Drop expired entries; returns the expired staged keys so the caller
        can fire ``on_expire`` after releasing the lock."""
        now = self._time()
        expired_meta = []
        for key in [k for k, (_, d) in self._pages.items() if d < now]:
            nbytes, _ = self._pages.pop(key)
            self._bytes -= nbytes
            self.expired_pages += 1
            expired_meta.append(key)
        for key in [k for k, (_, d) in self._reserved.items() if d < now]:
            nbytes, _ = self._reserved.pop(key)
            self._bytes -= nbytes
        return expired_meta

    def _fire_expired(self, keys: list) -> None:
        """Queue on_expire for a single background worker: reserve() and
        contains() run on the KV receiver's event loop, which must not block
        behind an expiry. The worker re-checks each key under the lock right
        before firing: a page staged again while the callback sat queued
        must not lose its fresh copy."""
        if self.on_expire is None or not keys:
            return
        with self._lock:
            if self._expire_q is None:
                import queue as queue_mod

                self._expire_q = queue_mod.Queue()
                threading.Thread(target=self._expire_worker, daemon=True, name="kv-staging-expire").start()
        for k in keys:
            self._expire_q.put(k)

    def _expire_worker(self) -> None:
        while True:
            k = self._expire_q.get()
            with self._lock:
                if k in self._pages or k in self._reserved:
                    continue  # staged again while the callback was queued
            try:
                self.on_expire(k)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                logger.exception("staging on_expire(%s) failed", k)

    def reserve(self, key: str, nbytes: int) -> str:
        """Atomically check-and-reserve budget for an incoming page.
        Returns "reserved", "have" (already STAGED — the producer can skip
        the page entirely), or "full" (over budget, or an in-flight
        reservation that may never complete — the producer must keep its
        TCP fallback)."""
        with self._lock:
            expired = self._sweep_locked()
            if key in self._pages:
                verdict = "have"
            elif key in self._reserved:
                verdict = "full"
            elif self._bytes + nbytes > self.max_bytes:
                verdict = "full"
            else:
                self._reserved[key] = (nbytes, self._time() + self.ttl)
                self._bytes += nbytes
                verdict = "reserved"
        self._fire_expired(expired)
        return verdict

    def promote(self, key: str, nbytes: int = 0) -> None:
        """Convert a reservation into a staged entry: the page's tensors live
        in runner.kv_staged; this object keeps the budget accounting and
        admission's view. ``nbytes`` is the pulled page's real size, charged
        when the reservation timed out during a slow pull, so staged memory
        never escapes the budget."""
        with self._lock:
            res = self._reserved.pop(key, None)
            if res is not None:
                size = res[0]
            else:
                size = nbytes
                self._bytes += size
            if key not in self._pages:
                self._pages[key] = (size, self._time() + self.ttl)
            else:
                self._bytes -= size  # already staged; drop the double count

    def unreserve(self, key: str) -> None:
        with self._lock:
            res = self._reserved.pop(key, None)
            if res is not None:
                self._bytes -= res[0]

    def contains(self, key: str) -> bool:
        with self._lock:
            expired = self._sweep_locked()
            found = key in self._pages
        self._fire_expired(expired)
        return found

    def pop(self, key: str) -> bool:
        """True when ``key`` was staged (its tensors are in runner.kv_staged;
        the entry leaves the budget)."""
        with self._lock:
            entry = self._pages.pop(key, None)
            if entry is None:
                return False
            self._bytes -= entry[0]
            return True

    def clear(self) -> None:
        with self._lock:
            self._pages.clear()
            self._reserved.clear()
            self._bytes = 0
