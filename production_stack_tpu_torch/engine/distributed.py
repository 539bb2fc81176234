"""The engine ranks' lockstep: the leader's step stream and the followers'
replay.

The port's own copy of production_stack_tpu/engine/distributed.py (its
codec, frames, handshake, ``StepBroadcaster``, ``BroadcastingRunner`` and
``follower_loop``), for the pp x dp x sp x ep x tp rank processes of one engine
rather than the hosts of a multi-host set:

- Rank 0 (the leader) runs the real engine: HTTP API, scheduler, tokenizer,
  prefix cache. Every runner call that must run on every rank (``REPLICATED``)
  is first sent -- method name plus numpy arguments in a non-executable
  tagged binary format -- to every follower, then run locally.
- Ranks 1..pp*dp*sp*ep*tp-1 (the followers) run ``follower_loop``: they
  read each call and make the same one on their own ``ModelRunner``. The
  collectives inside a call then meet (parallel/tp.py, parallel/ep.py,
  parallel/dp.py, parallel/ring_attention.py, parallel/pipeline.py): they
  go over the process groups, never over this stream. Every rank gets the
  whole call (a step's every row and token): each takes its dp group's
  rows and its sequence rank's tokens itself, and every pipeline stage
  runs the whole step's microbatches through its own layers.

Security model, as in the JAX copy: every connection starts with a
random-nonce HMAC handshake and every frame carries an HMAC over (sequence
number, payload), so a reachable sync port cannot be used to join as a fake
follower, inject calls or replay old ones. The secret is the caller's
(the leader draws one and hands it to the processes it starts), else
``PSTPU_STEP_SYNC_SECRET``. Serialization is a tagged tree of numpy buffers
and plain scalars (no pickle). The leader listens on localhost only: its
followers are its own child processes.

Failure model: the ranks cannot survive losing one. Any error of a
replicated call on the leader (a lost follower included) exits the leader
(``os._exit(13)``, as the JAX engine does in multi-host mode), and a
follower dies on any replay error: its sockets close, so the leader's next
collective or send fails and the leader exits too.
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
# ``rank_stats``, ``replica_digest`` and ``gathered_params`` read every rank's counters, pools and weights;
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
    "gathered_params",
    "replay_routes",
    "set_lora_slot",
    "clear_lora_slot",
    "gathered_lora",
    "lora_digest",
)


def resolve_sync_secret(secret: Optional[bytes] = None) -> bytes:
    """The step stream's shared secret: the caller's, else
    ``PSTPU_STEP_SYNC_SECRET``."""
    if secret is not None:
        return secret
    env = os.environ.get("PSTPU_STEP_SYNC_SECRET")
    if env:
        return env.encode()
    raise RuntimeError("no step-sync secret: pass one or set PSTPU_STEP_SYNC_SECRET")


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
    ``timeout`` passes. ``alive``, when given, is called about once a second
    while it waits and raises if a follower has died, so a follower that
    fails to start ends the wait at once. A connection that fails the
    handshake is dropped and its slot re-listened.
    """

    def __init__(
        self,
        port: int,
        num_followers: int,
        *,
        timeout: float = 300.0,
        secret: Optional[bytes] = None,
        host: str = "127.0.0.1",
        alive: Optional[Callable[[], None]] = None,
    ):
        self._secret = resolve_sync_secret(secret)
        self._lock = threading.Lock()
        self._socks: list[tuple[socket.socket, bytes]] = []  # (conn, frame key)
        self._seq = 0
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(num_followers)
        srv.settimeout(1.0)
        deadline = time.monotonic() + timeout
        logger.info("leader waiting for %d follower(s) on %s:%d", num_followers, host, port)
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
    loading its weights when a follower is ready to dial.

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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_follower_main(cfg, rank: int, devices, init_method: str, sync_port: int, secret: bytes,
                     model_cfg, params, num_pages: int) -> None:
    """A follower rank's process (``spawn``ed by ``TPLeader``): join the
    ranks as global ``rank``, at (p, d, e, t) with rank = ((p * dp + d) * ep
    + e) * tp + t, on ``devices[rank]`` (made current before anything
    touches CUDA), build the rank's runner and replay the leader's calls
    until it closes the stream. Any error ends the process. With sp > 1 the
    rank sits at (s, t), rank = s * tp + t (parallel/group.py gives the
    general order)."""
    from production_stack_tpu_torch.engine.engine import build_runner
    from production_stack_tpu_torch.parallel.group import TPGroup

    group = TPGroup.init(rank, cfg.data_parallel_size, cfg.tensor_parallel_size, cfg.tp_backend, devices,
                         init_method, ep=cfg.expert_parallel_size, pp=cfg.pipeline_parallel_size,
                         sp=cfg.sequence_parallel_size)
    try:
        runner = build_runner(cfg, group.device, model_cfg, params, num_pages, group)
        follower_loop(runner, "127.0.0.1", sync_port, secret=secret)
    finally:
        group.close()


class TPLeader:
    """The leader's side of an engine's pp x dp x sp x ep x tp ranks: starts
    ranks 1..pp*dp*sp*ep*tp-1 as
    ``spawn``ed processes (the leader may already hold a CUDA context, which
    ``fork`` would copy into a broken child), joins the group as rank 0 on a
    free localhost port, then (``wrap``) waits for the followers' step
    streams and wraps its runner. From then on a watchdog thread ends the
    leader (exit 13) as soon as a follower exits before ``close``: a rank
    that died mid-serve is never waited on. ``close`` ends the followers and
    the group; no process outlives it.

    The kernels are built here, before any follower starts, so ranks that
    share a card do not race the first build."""

    def __init__(self, cfg, device, model_cfg, params, num_pages: int):
        import torch.multiprocessing as tmp

        from production_stack_tpu_torch.engine.config import resolve_attn_impl
        from production_stack_tpu_torch.ops.kernels import _build
        from production_stack_tpu_torch.parallel.group import (
            TPGroup,
            check_backend,
            parse_device_ids,
            rank_devices,
        )

        dp, ep, tp = cfg.data_parallel_size, cfg.expert_parallel_size, cfg.tensor_parallel_size
        pp, sp = cfg.pipeline_parallel_size, cfg.sequence_parallel_size
        world = pp * dp * sp * ep * tp
        devices = rank_devices(device, world, parse_device_ids(cfg.tp_device_ids, world))
        check_backend(cfg.tp_backend, devices)
        if resolve_attn_impl(cfg.attn_impl, devices[0]) == "cuda":
            _build.build()
        self.procs: list = []
        self.bc: Optional[StepBroadcaster] = None
        self.group = None
        self._closing = threading.Event()
        self._secret = secrets_mod.token_bytes(32)
        self._sync_port = _free_port()
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        ctx = tmp.get_context("spawn")
        try:
            for r in range(1, world):
                p = ctx.Process(
                    target=tp_follower_main, name=f"rank-{r}" if pp * dp * sp * ep > 1 else f"tp-rank-{r}",
                    daemon=True,
                    args=(cfg, r, devices, init_method, self._sync_port, self._secret, model_cfg, params, num_pages),
                )
                p.start()
                self.procs.append(p)
            self.group = TPGroup.init(0, dp, tp, cfg.tp_backend, devices, init_method, ep=ep, pp=pp, sp=sp)
        except BaseException:
            self.close()
            raise
        logger.info("%d ranks (pp %d x dp %d x sp %d x ep %d x tp %d) on %s over %s", world, pp, dp, sp, ep, tp,
                    self.group.labels, cfg.tp_backend)

    def _alive(self) -> None:
        dead = [(p.name, p.exitcode) for p in self.procs if not p.is_alive()]
        if dead:
            raise RuntimeError(f"follower rank(s) exited before joining the step stream: {dead}")

    def wrap(self, runner) -> BroadcastingRunner:
        """The leader's runner behind the step stream, once every follower
        has connected (a follower that dies first ends the wait)."""
        self.bc = StepBroadcaster(self._sync_port, len(self.procs), secret=self._secret, alive=self._alive)
        threading.Thread(target=self._watch, name="tp-watchdog", daemon=True).start()
        return BroadcastingRunner(runner, self.bc)

    def _watch(self) -> None:
        while not self._closing.wait(1.0):
            try:
                self._alive()
            except RuntimeError:
                if self._closing.is_set():
                    return  # close() ended them (it sets the flag first)
                logger.critical("a follower rank exited while serving: %s; exiting",
                                [(p.name, p.exitcode) for p in self.procs if not p.is_alive()])
                os._exit(13)

    def close(self, timeout: float = 30.0) -> None:
        """End the stream (the followers leave their loops), reap every
        follower (terminated, then killed, past ``timeout``) and leave the
        group. Idempotent."""
        self._closing.set()
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
