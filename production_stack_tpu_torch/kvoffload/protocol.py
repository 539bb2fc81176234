"""Wire protocol of the KV cache server and the KV-index controller, the
port's copy of production_stack_tpu/kvoffload/protocol.py: one frame =
``u32 header_len | u32 payload_len | header JSON | payload bytes``. The
servers (kvoffload/cache_server.py, kvoffload/controller.py) and the
router-side controller client speak it with the asyncio endpoint; the
engine's remote tier (kvoffload/tiers.RemoteTier) and controller reporter
with the blocking client.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
from typing import Optional

_FRAME = struct.Struct("!II")
MAX_HEADER = 16 << 20
MAX_PAYLOAD = 1 << 30


def pack(header: dict, payload: bytes = b"") -> bytes:
    hdr = json.dumps(header).encode()
    return _FRAME.pack(len(hdr), len(payload)) + hdr + payload


# -- asyncio endpoint ---------------------------------------------------------


async def read_frame(reader: asyncio.StreamReader) -> tuple[dict, bytes]:
    raw = await reader.readexactly(_FRAME.size)
    hlen, plen = _FRAME.unpack(raw)
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise ValueError(f"oversized frame: header={hlen} payload={plen}")
    hdr = json.loads(await reader.readexactly(hlen)) if hlen else {}
    payload = await reader.readexactly(plen) if plen else b""
    return hdr, payload


async def write_frame(
    writer: asyncio.StreamWriter, header: dict, payload: bytes = b""
) -> None:
    writer.write(pack(header, payload))
    await writer.drain()


# -- blocking endpoint (engine-side worker thread) ----------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class BlockingClient:
    """Request/response client over one persistent connection; reconnects
    lazily after errors. Not thread-safe — each worker thread owns one."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None

    @classmethod
    def from_url(cls, url: str, **kw) -> "BlockingClient":
        host, port = parse_hostport(url)
        return cls(host, port, **kw)

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def request(self, header: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        try:
            sock = self._connect()
            sock.sendall(pack(header, payload))
            hlen, plen = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
            if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
                raise ValueError("oversized frame")
            hdr = json.loads(_recv_exact(sock, hlen)) if hlen else {}
            body = _recv_exact(sock, plen) if plen else b""
            return hdr, body
        except Exception:
            self.close()
            raise


def parse_hostport(url: str, default_port: int = 0) -> tuple[str, int]:
    """'host:port', 'tcp://host:port' or 'http://host:port' -> (host, port)."""
    if "://" in url:
        url = url.split("://", 1)[1]
    url = url.rstrip("/")
    if ":" in url:
        host, port = url.rsplit(":", 1)
        return host, int(port)
    return url, default_port
