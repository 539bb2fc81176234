"""The engine's ranks: the leader's step stream and the followers'
replay, on one host or across host processes.

The port's own copy of production_stack_tpu/engine/distributed.py (its
codec, frames, handshake, ``StepBroadcaster``, ``BroadcastingRunner`` and
``follower_loop``) and of the JAX api_server's multi-host entry
(``resolve_process_id``), for the pp x dp x sp x ep x tp rank processes of
one engine, on one host or split over ``distributed_num_processes`` host
processes:

- Global rank 0 (the leader) runs the real engine: HTTP API, scheduler,
  tokenizer, prefix cache. Every runner call that must run on every rank
  (``REPLICATED``) is first sent -- method name plus numpy arguments in a
  non-executable tagged binary format -- to every follower, then run
  locally.
- Every other rank (a follower) runs ``follower_loop``: it reads each call
  and makes the same one on its own ``ModelRunner``. The collectives inside
  a call then meet (parallel/tp.py, parallel/ep.py, parallel/dp.py,
  parallel/ring_attention.py, parallel/pipeline.py): they go over the
  process groups, never over this stream. Every rank gets the whole call (a
  step's every row and token): each takes its dp group's rows and its
  sequence rank's tokens itself, and every pipeline stage runs the whole
  step's microbatches through its own layers.
- Each host process starts its own block of ranks (``RankBlock``: host h
  of n runs global ranks [h * L, (h + 1) * L), L = ranks / n, itself the
  first and the rest as children of a fork server, ``rank_context``).
  Host 0 is the leader's; every other host runs ``follower_host_main``
  (api_server.serve's branch for a process id other than 0), which builds
  no engine, only its ranks' runners. All ranks rendezvous at ``distributed_coordinator`` (a c10d TCP
  store that global rank 0 hosts); the leader's stream listens on every
  interface at ``worker_sync_port`` and each remote rank dials
  ``<coordinator host>:worker_sync_port``. On one host the rendezvous and
  the stream take free localhost ports.

Security model, as in the JAX copy: every connection starts with a
random-nonce HMAC handshake and every frame carries an HMAC over (sequence
number, payload), so a reachable sync port cannot be used to join as a fake
follower, inject calls or replay old ones. The secret is the caller's, else
``PSTPU_STEP_SYNC_SECRET``, else (across hosts) the one the leader draws
and publishes in the rendezvous' c10d store, where every other rank reads
it (the JAX copy uses its coordination service's key-value store). On one
host the leader draws one and hands it to the processes it starts.
Serialization is a tagged tree of numpy buffers and plain scalars (no
pickle).

Failure model: the ranks cannot survive losing one. Any error of a
replicated call on the leader (a lost follower included) exits the leader
(``os._exit(13)``, as the JAX engine does in multi-host mode), and a
follower dies on any replay error: its sockets close, so the leader's next
collective or send fails and the leader exits too. The leader's watchdog
also ends it (exit 13) as soon as one of its own rank processes exits or
any follower's stream socket closes (a remote host's loss, seen at once
rather than after gloo's timeout); a follower host's watchdog ends that
host (exit 13) when one of its rank processes exits. A follower host that
cannot reach the rendezvous or the stream within the timeout exits
non-zero.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import os
import secrets as secrets_mod
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)

_LEN = struct.Struct("!Q")
_SEQ = struct.Struct("!Q")
_MAC_LEN = hashlib.sha256().digest_size
# Frames are one step's numpy args (batch x chunk scale, or a set of KV
# pages). Cap the announced length so an unauthenticated peer cannot make
# the receiver buffer an arbitrary allocation before the MAC check.
_MAX_FRAME = 1 << 30
_HELLO_NONCE_LEN = 32

# runner methods every rank must run, in the leader's order: each changes
# device state or runs a collective (engine/runner.py). The page moves
# gather or scatter the KV-head shards at the serde boundary (and keep the
# dp replicas equal); sleep level 2 moves each rank's own weight shards;
# ``rank_stats``, ``replica_digest``, ``params_digest`` and ``gathered_params`` read every rank's counters,
# pools and weights;
# ``replay_routes`` gives every rank's MoE routers the same experts; the
# LoRA slot writes take the whole adapter (numpy arrays and a float) and
# each rank keeps its part, ``gathered_lora`` and ``lora_digest`` read the
# slots back.
REPLICATED = (
    "step",
    "step_multi",
    "step_multi_pipelined",
    "step_spec",
    "encode",
    "get_pages",
    "set_pages",
    "get_pages_quant",
    "set_pages_quant",
    "reset_kv",
    "drop_kv_pools",
    "offload_params",
    "restore_params",
    "rank_stats",
    "replica_digest",
    "params_digest",
    "gathered_params",
    "replay_routes",
    "set_lora_slot",
    "clear_lora_slot",
    "gathered_lora",
    "lora_digest",
)


# the rendezvous store's key of the leader's step-stream secret
_SECRET_KEY = "pstpu/step_sync_secret"


def resolve_sync_secret(secret: Optional[bytes] = None, store=None, leader: bool = False) -> bytes:
    """The step stream's shared secret: the caller's, else
    ``PSTPU_STEP_SYNC_SECRET``, else through ``store`` (the rendezvous' c10d
    store): the ``leader`` draws one and publishes it, every other rank
    blocks until it is there (up to the store's timeout)."""
    if secret is not None:
        return secret
    env = os.environ.get("PSTPU_STEP_SYNC_SECRET")
    if env:
        return env.encode()
    if store is None:
        raise RuntimeError("no step-sync secret: pass one, set PSTPU_STEP_SYNC_SECRET or join the rendezvous first")
    if leader:
        s = secrets_mod.token_hex(32)
        store.set(_SECRET_KEY, s)
        return bytes.fromhex(s)
    return bytes.fromhex(store.get(_SECRET_KEY).decode())


def resolve_process_id(cfg) -> int:
    """Process id for multi-host serving: the explicit flag, else
    JAX_PROCESS_ID (the JAX engine's variable, so a deployment written for
    it runs the port unchanged), else the StatefulSet hostname ordinal
    (``engine-llama3-2`` -> 2)."""
    if cfg.distributed_process_id is not None:
        return int(cfg.distributed_process_id)
    if os.environ.get("JAX_PROCESS_ID"):
        return int(os.environ["JAX_PROCESS_ID"])
    host = socket.gethostname()
    tail = host.rsplit("-", 1)[-1]
    if not tail.isdigit():
        raise ValueError(
            f"cannot derive process id from hostname {host!r}; set "
            "--distributed-process-id or JAX_PROCESS_ID"
        )
    return int(tail)


# -- non-executable serialization --------------------------------------------
# A tagged tree: scalars stay in a JSON header, array/bytes payloads append
# as raw buffers. No pickle anywhere: a malicious frame can only produce
# numpy arrays and plain Python values, never code execution.


def _pack_call(method: Optional[str], args: tuple, kwargs: dict) -> bytes:
    bufs: list[bytes] = []

    def enc(o: Any):
        if o is None or isinstance(o, (bool, int, float, str)):
            return ["v", o]
        if isinstance(o, bytes):
            bufs.append(o)
            return ["b", len(bufs) - 1]
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            bufs.append(a.tobytes())
            # dtype by NAME, not .str: extended dtypes (ml_dtypes bfloat16,
            # every bf16 KV page crossing the stream) stringify as opaque
            # void ('|V2') under .str and would decode as raw bytes
            return ["nd", len(bufs) - 1, a.dtype.name, list(a.shape)]
        if isinstance(o, np.generic):
            return ["ns", o.dtype.name, o.item()]
        if isinstance(o, list):
            return ["l", [enc(x) for x in o]]
        if isinstance(o, tuple):
            return ["t", [enc(x) for x in o]]
        if isinstance(o, dict):
            return ["d", [[enc(k), enc(v)] for k, v in o.items()]]
        # StepInput (imported lazily to avoid a cycle)
        from production_stack_tpu_torch.engine.runner import StepInput

        if isinstance(o, StepInput):
            return ["si", [enc(getattr(o, f.name)) for f in dataclasses.fields(StepInput)]]
        raise TypeError(f"cannot serialize {type(o).__name__} on the step stream")

    tree = enc([method, list(args), kwargs])
    head = json.dumps(tree, separators=(",", ":")).encode()
    parts = [_LEN.pack(len(head)), head]
    for b in bufs:
        parts.append(_LEN.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


def _unpack_call(payload: bytes) -> tuple[Optional[str], tuple, dict]:
    off = _LEN.size
    (hlen,) = _LEN.unpack_from(payload, 0)
    tree = json.loads(payload[off:off + hlen])
    off += hlen
    bufs: list[bytes] = []
    while off < len(payload):
        (blen,) = _LEN.unpack_from(payload, off)
        off += _LEN.size
        bufs.append(payload[off:off + blen])
        off += blen

    def _dtype(name: str) -> np.dtype:
        try:
            return np.dtype(name)
        except TypeError:
            import ml_dtypes  # bfloat16 & friends live here, not in numpy

            return np.dtype(getattr(ml_dtypes, name))

    def dec(n: Any) -> Any:
        tag = n[0]
        if tag == "v":
            return n[1]
        if tag == "b":
            return bufs[n[1]]
        if tag == "nd":
            _, i, dtype, shape = n
            return np.frombuffer(bufs[i], dtype=_dtype(dtype)).reshape(shape).copy()
        if tag == "ns":
            return _dtype(n[1]).type(n[2])
        if tag == "l":
            return [dec(x) for x in n[1]]
        if tag == "t":
            return tuple(dec(x) for x in n[1])
        if tag == "d":
            return {dec(k): dec(v) for k, v in n[1]}
        if tag == "si":
            from production_stack_tpu_torch.engine.runner import StepInput

            return StepInput(*[dec(x) for x in n[1]])
        raise ValueError(f"unknown tag {tag!r} on the step stream")

    method, args, kwargs = dec(tree)
    return method, tuple(args), kwargs


# -- authenticated framing ----------------------------------------------------


def _conn_key(secret: bytes, nonce_l: bytes, nonce_f: bytes) -> bytes:
    """Per-connection frame key bound to BOTH sides' handshake nonces, so
    frames recorded from an old session (same secret) never verify against
    a new connection."""
    return hmac.new(secret, b"pstpu-frame-key-v1" + nonce_l + nonce_f, hashlib.sha256).digest()


def _mac(key: bytes, seq: int, payload: bytes, digest: Optional[bytes] = None) -> bytes:
    # hash the (possibly multi-MB) payload once; the MAC covers its digest,
    # so fanning a frame out to N followers costs N cheap 32-byte HMACs
    if digest is None:
        digest = hashlib.sha256(payload).digest()
    return hmac.new(key, _SEQ.pack(seq) + digest, hashlib.sha256).digest()


def _send_msg(sock: socket.socket, payload: bytes, key: bytes, seq: int, digest: Optional[bytes] = None) -> None:
    frame = _mac(key, seq, payload, digest) + payload
    sock.sendall(_LEN.pack(len(frame)) + frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket, key: bytes, seq: int) -> Optional[bytes]:
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n < _MAC_LEN or n > _MAX_FRAME:
        raise RuntimeError(f"step stream: invalid frame length {n}")
    frame = _recv_exact(sock, n)
    if frame is None:
        return None
    mac, payload = frame[:_MAC_LEN], frame[_MAC_LEN:]
    if not hmac.compare_digest(mac, _mac(key, seq, payload)):
        raise RuntimeError("step stream: frame authentication failed (wrong secret, replay, or tampering)")
    return payload


class StepBroadcaster:
    """Leader side: accepts follower connections (nonce handshake), fans out
    authenticated call descriptors.

    The constructor blocks until all ``num_followers`` have connected, or
    ``timeout`` passes (a ``TimeoutError`` naming how many did not).
    ``alive``, when given, is called about once a second
    while it waits and raises if a follower has died, so a follower that
    fails to start ends the wait at once. A connection that fails the
    handshake is dropped and its slot re-listened. ``listener`` is a
    socket ``listen_socket`` bound before the followers were started
    (their connections wait in its backlog): localhost for one host's
    ranks, every interface (``0.0.0.0``) across hosts. It takes the socket
    over and closes it.

    ``method_frames`` and ``method_bytes`` count what it has sent since
    the last ``reset_stats``, by the runner method each frame carries
    (every follower's copy of every frame, headers and MACs included).
    """

    def __init__(
        self,
        listener: socket.socket,
        num_followers: int,
        *,
        timeout: float = 300.0,
        secret: Optional[bytes] = None,
        alive: Optional[Callable[[], None]] = None,
    ):
        self._secret = resolve_sync_secret(secret)
        self._lock = threading.Lock()
        self._socks: list[tuple[socket.socket, bytes]] = []  # (conn, frame key)
        self._seq = 0
        self.method_frames: dict = {}
        self.method_bytes: dict = {}
        srv = listener
        srv.settimeout(1.0)
        deadline = time.monotonic() + timeout
        logger.info("leader waiting for %d follower(s) on %s:%d", num_followers, *srv.getsockname()[:2])
        try:
            while len(self._socks) < num_followers:
                try:
                    conn, addr = srv.accept()
                except socket.timeout:
                    if alive is not None:
                        alive()
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{num_followers - len(self._socks)} follower(s) did not connect in {timeout:.0f} s"
                        ) from None
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                key = self._handshake(conn)
                if key is None:
                    logger.warning("rejecting unauthenticated peer %s", addr)
                    conn.close()
                    continue
                self._socks.append((conn, key))
                logger.info("follower connected from %s", addr)
        except BaseException:
            for s, _ in self._socks:
                s.close()
            raise
        finally:
            srv.close()

    def _handshake(self, conn: socket.socket) -> Optional[bytes]:
        """Mutual-nonce challenge-response. We send nonce_L; the follower
        replies nonce_F + HMAC(secret, nonce_L + nonce_F). Both sides derive
        the per-connection frame key from (secret, nonce_L, nonce_F).
        Returns the frame key, or None on failure."""
        nonce_l = secrets_mod.token_bytes(_HELLO_NONCE_LEN)
        try:
            conn.settimeout(30.0)
            conn.sendall(nonce_l)
            reply = _recv_exact(conn, _HELLO_NONCE_LEN + _MAC_LEN)
            conn.settimeout(None)
            if reply is None:
                return None
            nonce_f, proof = reply[:_HELLO_NONCE_LEN], reply[_HELLO_NONCE_LEN:]
            want = hmac.new(self._secret, nonce_l + nonce_f, hashlib.sha256).digest()
            if not hmac.compare_digest(want, proof):
                return None
            return _conn_key(self._secret, nonce_l, nonce_f)
        except OSError:
            return None

    def broadcast(self, method: Optional[str], args: tuple, kwargs: dict) -> None:
        payload = _pack_call(method, args, kwargs)
        digest = hashlib.sha256(payload).digest()  # hash the payload ONCE
        with self._lock:
            seq = self._seq
            self._seq += 1
            for s, key in self._socks:
                try:
                    _send_msg(s, payload, key, seq, digest)
                except OSError as e:
                    # a lost follower is fatal for the whole set
                    # (BroadcastingRunner exits the leader)
                    raise RuntimeError(f"step broadcast to a follower failed: {e}") from e
            self.method_frames[method] = self.method_frames.get(method, 0) + 1
            self.method_bytes[method] = (self.method_bytes.get(method, 0)
                                         + len(self._socks) * (_LEN.size + _MAC_LEN + len(payload)))

    def reset_stats(self) -> None:
        with self._lock:
            self.method_frames, self.method_bytes = {}, {}

    def lost(self) -> list:
        """The peer addresses of followers whose stream socket has closed.
        A follower sends nothing after its handshake, so a peek that finds
        no data waiting means it is alive, and an end of stream or a reset
        means its process, or its host, is gone. A probe that fails for
        any other reason says nothing of the follower."""
        gone = []
        for s, _ in list(self._socks):
            try:
                data = s.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
            except BlockingIOError:
                continue
            except ConnectionResetError:
                data = b""
            except OSError:
                continue
            if data == b"":
                try:
                    gone.append(s.getpeername())
                except OSError:
                    gone.append("<unknown peer>")
        return gone

    def close(self) -> None:
        with self._lock:
            payload = _pack_call(None, (), {})
            digest = hashlib.sha256(payload).digest()
            for s, key in self._socks:
                try:
                    _send_msg(s, payload, key, self._seq, digest)
                    s.close()
                except OSError:
                    pass
            self._seq += 1
            self._socks.clear()


class BroadcastingRunner:
    """Wraps a ModelRunner: replicated methods broadcast before local
    dispatch; everything else is the wrapped runner's. Return values come
    from the local call (the leader's gathers hold every rank's part)."""

    def __init__(self, runner, broadcaster: StepBroadcaster):
        self._runner = runner
        self._bc = broadcaster

    def __getattr__(self, name):
        attr = getattr(self._runner, name)
        if name not in REPLICATED or not callable(attr):
            return attr

        def call(*args, **kwargs):
            # once a call is broadcast, leader and followers MUST stay in
            # lockstep: a failed broadcast (lost follower) or a failed local
            # call (followers already running what the leader won't) both
            # desync the ranks' collectives. Exit, as the JAX engine does.
            try:
                self._bc.broadcast(name, args, kwargs)
                return attr(*args, **kwargs)
            except Exception:
                logger.exception("replicated call %s failed with follower ranks; exiting", name)
                os._exit(13)

        return call


def follower_loop(
    runner,
    leader_host: str,
    port: int,
    *,
    timeout: float = 300.0,
    secret: Optional[bytes] = None,
) -> None:
    """Follower side: dial the leader, answer the nonce challenge, and replay
    every authenticated call descriptor on the local runner until the leader
    closes the stream.

    Connection attempts retry until ``timeout``: the leader may still be
    loading its weights when a follower is ready to dial (past it the
    last ``OSError`` is raised).

    Any replay error propagates (and ends the follower process): a desynced
    follower must not keep running while the leader serves."""
    key = resolve_sync_secret(secret)
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection((leader_host, port), timeout=timeout)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    nonce_l = _recv_exact(sock, _HELLO_NONCE_LEN)
    if nonce_l is None:
        raise RuntimeError("leader closed during handshake")
    nonce_f = secrets_mod.token_bytes(_HELLO_NONCE_LEN)
    proof = hmac.new(key, nonce_l + nonce_f, hashlib.sha256).digest()
    sock.sendall(nonce_f + proof)
    frame_key = _conn_key(key, nonce_l, nonce_f)
    logger.info("follower connected to leader %s:%d", leader_host, port)
    seq = 0
    try:
        while True:
            payload = _recv_msg(sock, frame_key, seq)
            seq += 1
            if payload is None:
                logger.info("leader stream closed; follower exiting")
                return
            method, args, kwargs = _unpack_call(payload)
            if method is None:
                logger.info("leader shutdown; follower exiting")
                return
            if method not in REPLICATED:
                raise RuntimeError(f"follower received non-replicated method {method!r}")
            if not method.startswith("step") and method != "encode":
                # rare control calls (pool drops, page moves) get a visible
                # marker, so a test can see that replication ran
                logger.info("follower replayed %s", method)
            try:
                getattr(runner, method)(*args, **kwargs)
            except Exception:
                logger.exception("follower replay of %s failed; exiting", method)
                raise
    finally:
        sock.close()


# -- the rank processes of one engine ------------------------------------------


def listen_socket(host: str, port: int, backlog: int) -> socket.socket:
    """The step stream's listening socket on (host, port); port 0 takes a
    free one (``getsockname`` names it)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(backlog)
    except OSError:
        srv.close()
        raise
    return srv


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_follower_main(cfg, rank: int, devices, init_method: str, sync_addr: tuple, secret: Optional[bytes],
                     model_cfg, params, num_pages: int, hosts: int = 1) -> None:
    """A follower rank's process (started by ``RankBlock``): join the
    ranks as global ``rank``, at (p, d, s, e, t) with rank = (((p * dp + d)
    * sp + s) * ep + e) * tp + t (parallel/group.rank_place), on
    ``devices[rank]`` (made current before anything touches CUDA), build
    the rank's runner and replay the leader's calls from ``sync_addr``
    (host, port) until it closes the stream. ``secret`` None: read it from
    the rendezvous (across hosts). Any error ends the process."""
    from production_stack_tpu_torch.engine.engine import build_runner
    from production_stack_tpu_torch.parallel.group import TIMEOUT_S, TPGroup

    group = TPGroup.init(rank, cfg.data_parallel_size, cfg.tensor_parallel_size, cfg.tp_backend, devices,
                         init_method, ep=cfg.expert_parallel_size, pp=cfg.pipeline_parallel_size,
                         sp=cfg.sequence_parallel_size, hosts=hosts)
    try:
        secret = resolve_sync_secret(secret, group.store)
        runner = build_runner(cfg, group.device, model_cfg, params, num_pages, group)
        follower_loop(runner, *sync_addr, secret=secret, timeout=TIMEOUT_S)
    finally:
        group.close()


def rank_context():
    """The multiprocessing context a block's ranks start from: a fork
    server that imported torch and the engine once and holds no CUDA
    context, so each rank forks from it and initialises its own device, as
    a ``spawn``ed process does, without importing torch anew (seconds a rank
    on every engine start). The server starts with a process's first
    rank, with that moment's environment and ``sys.path``, and ends with
    the process."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "production_stack_tpu_torch.engine.engine"])
    return ctx


class RankBlock:
    """One host process's block of an engine's pp x dp x sp x ep x tp ranks:
    host h of ``distributed_num_processes`` n runs global ranks [h * L,
    (h + 1) * L), L = ranks / n (one host: all of them). It starts ranks
    h * L + 1 .. (h + 1) * L - 1 from ``rank_context`` (the process may
    already hold a CUDA context, which ``fork`` would copy into a broken
    child) and joins the ranks as global rank h * L: on one host over a
    free localhost port, across hosts over ``tcp://<distributed_coordinator>``.

    On the leader's host (h = 0), ``wrap`` waits for every other rank's step
    stream (all ranks - 1 of them, its own processes and every remote
    host's) and wraps the leader's runner. From then on a watchdog thread
    ends the leader (exit 13) as soon as one of its processes exits or a
    follower's stream socket closes before ``close``: a rank that died
    mid-serve, here or on another host, is never waited on. On any other
    host, ``follow`` replays the leader's calls on this process's runner
    until the leader closes the stream, while a watchdog ends the host
    (exit 13) if one of its processes exits. ``close`` ends the stream (on
    the leader), reaps the block's processes and leaves the group; no
    process outlives it.

    The kernels are built here, before any of the block's processes
    starts, so ranks that share a card do not race the first build (two
    hosts on one machine may both build: each writes its own temporary
    file and renames it into place, so the library is whole either way)."""

    def __init__(self, cfg, device, model_cfg, params, num_pages: int, host: int = 0):
        from production_stack_tpu_torch.engine.config import check_hosts, resolve_attn_impl
        from production_stack_tpu_torch.ops.kernels import _build
        from production_stack_tpu_torch.parallel.group import (
            TIMEOUT_S,
            TPGroup,
            check_backend,
            host_ranks,
            parse_device_ids,
            rank_devices,
        )

        dp, ep, tp = cfg.data_parallel_size, cfg.expert_parallel_size, cfg.tensor_parallel_size
        pp, sp = cfg.pipeline_parallel_size, cfg.sequence_parallel_size
        world = pp * dp * sp * ep * tp
        hosts = cfg.distributed_num_processes
        local = check_hosts(cfg)
        block = host_ranks(world, hosts, host)
        # every host runs the same layout: rank r on its host's (r % L)-th device
        own = rank_devices(device, local, parse_device_ids(cfg.tp_device_ids, local))
        devices = [own[r % local] for r in range(world)]
        check_backend(cfg.tp_backend, devices)
        if resolve_attn_impl(cfg.attn_impl, devices[0]) == "cuda":
            _build.build()
        self.world, self.timeout = world, TIMEOUT_S
        self.procs: list = []
        self.bc: Optional[StepBroadcaster] = None
        self.group = None
        self._closing = threading.Event()
        self._streaming = False
        # the leader's stream listens from here on, before any rank starts:
        # on one host at a free localhost port, across hosts at
        # worker_sync_port on every interface (taken or not, known at once)
        self._listener = None
        if host == 0:
            self._listener = listen_socket("0.0.0.0" if hosts > 1 else "127.0.0.1",
                                           cfg.worker_sync_port if hosts > 1 else 0, world)
        if hosts > 1:
            coordinator = cfg.distributed_coordinator
            init_method = f"tcp://{coordinator}"
            self._sync_addr = (coordinator.rpartition(":")[0], cfg.worker_sync_port)
            secret = None  # every rank but global rank 0 reads the leader's from the rendezvous
        else:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
            self._sync_addr = ("127.0.0.1", self._listener.getsockname()[1])
            secret = secrets_mod.token_bytes(32)
        many = pp * dp * sp * ep > 1 or hosts > 1
        ctx = rank_context()
        try:
            for r in block[1:]:
                p = ctx.Process(
                    target=tp_follower_main, name=f"rank-{r}" if many else f"tp-rank-{r}", daemon=True,
                    args=(cfg, r, devices, init_method, self._sync_addr, secret, model_cfg, params, num_pages,
                          hosts),
                )
                p.start()
                self.procs.append(p)
            self.group = TPGroup.init(block[0], dp, tp, cfg.tp_backend, devices, init_method, ep=ep, pp=pp, sp=sp,
                                      hosts=hosts)
            self._secret = resolve_sync_secret(secret, self.group.store, leader=host == 0)
        except BaseException:
            self.close()
            raise
        logger.info("host %d of %d: ranks %d..%d of %d (pp %d x dp %d x sp %d x ep %d x tp %d) on %s over %s",
                    host, hosts, block[0], block[-1], world, pp, dp, sp, ep, tp, self.group.labels[block[0]:block[-1] + 1],
                    cfg.tp_backend)

    def _dead(self) -> list:
        """The block's processes that are gone: any exit before the stream
        runs, a non-zero one after. A rank leaves its loop with exit 0 only
        once the leader's stream has ended (the leader closed it, or died),
        and then this host's own loop ends too."""
        return [(p.name, p.exitcode) for p in self.procs
                if p.exitcode is not None and (p.exitcode != 0 or not self._streaming)]

    def _alive(self) -> None:
        dead = self._dead()
        if dead:
            raise RuntimeError(f"follower rank(s) exited before joining the step stream: {dead}")

    def wrap(self, runner) -> BroadcastingRunner:
        """The leader's runner behind the step stream, once every follower
        of every host has connected (one of this host's that dies first
        ends the wait; a host that never connects ends it after the
        stream's timeout with a ``TimeoutError``)."""
        listener, self._listener = self._listener, None
        self.bc = StepBroadcaster(listener, self.world - 1, secret=self._secret, alive=self._alive,
                                  timeout=self.timeout)
        self._streaming = True
        threading.Thread(target=self._watch, name="tp-watchdog", daemon=True).start()
        return BroadcastingRunner(runner, self.bc)

    def follow(self, runner) -> None:
        """A follower host's own rank: replay the leader's calls on
        ``runner`` until the leader closes the stream."""
        self._streaming = True
        threading.Thread(target=self._watch, name="host-watchdog", daemon=True).start()
        follower_loop(runner, *self._sync_addr, secret=self._secret, timeout=self.timeout)

    def _watch(self) -> None:
        while not self._closing.wait(1.0):
            dead = self._dead()
            bc = self.bc
            gone = bc.lost() if bc is not None else []
            if dead or gone:
                if self._closing.is_set():
                    return  # close() ended them (it sets the flag first)
                logger.critical("a rank of the engine exited while serving (%s); exiting",
                                f"processes {dead}" if dead else f"the step stream to {gone} closed")
                os._exit(13)

    def close(self, timeout: float = 30.0) -> None:
        """End the stream (the followers leave their loops), reap every
        process of the block (terminated, then killed, past ``timeout``)
        and leave the group. Idempotent."""
        self._closing.set()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        if self.bc is not None:
            self.bc.close()
            self.bc = None
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self.procs = []
        if self.group is not None:
            self.group.close()
            self.group = None


def follower_host_main(cfg, process_id: int, device="cuda", params=None) -> None:
    """A follower host process (``distributed_process_id`` > 0): start its
    block of ranks, build its own rank's runner (the same model, pool and
    seed as the leader's; ``params`` a whole parameter dict, else the
    preset's seeded weights or the directory's, each host reading its own
    copy) and replay the leader's calls until the leader closes the stream.
    It builds no engine: no HTTP site, scheduler, tiers, controller, remote
    cache or KV role (JAX api_server.serve switches those off on its
    followers). Any error raises; a lost rank of this host exits it (13)."""
    from production_stack_tpu_torch.engine.engine import build_runner, engine_geometry

    if process_id < 1:
        raise ValueError(f"a follower host has a process id >= 1, got {process_id}")
    cfg = dataclasses.replace(cfg, kv_offload_cpu_gb=0.0, kv_offload_dir=None, kv_remote_url=None,
                              kv_controller_url=None, kv_role="none")
    model_cfg, num_pages = engine_geometry(cfg, device)
    block = RankBlock(cfg, device, model_cfg, params, num_pages, host=process_id)
    try:
        runner = build_runner(cfg, block.group.device, model_cfg, params, num_pages, block.group)
        block.follow(runner)
    finally:
        block.close()
