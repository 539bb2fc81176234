"""Fabric wire format: versioned, CRC-framed (pages, scales) frames; the
port's copy of production_stack_tpu/kvfabric/wire.py, byte for byte the same
frames.

The fabric's transfer unit is a **(pages, scales) pair** — a batch of KV
pages plus, on quantized engines, the per-page per-kv-head scales that make
the int8 bytes meaningful. fp engines ship EMPTY scales (``quant=False``),
int8 engines ship the exact pool bytes + f32 scales (ops/quant.py contract,
the same layout serde v3's ``Int8PageSerde`` persists). Carrying the scales
inside the CRC'd frame is what lets int8 engines serve disaggregated
prefill: the raw device page path ships bare pool bytes, so a quantized page
would arrive without its scales.

Frame layout (one TCP payload; the op envelope around it is the kvoffload
frame protocol, ``protocol.py``):

    u32 header_len | header JSON | body

    header := {
      "fv":     FABRIC_WIRE_VERSION,        # readers refuse newer
      "keys":   [hash_hex, ...],            # one content hash per page
      "quant":  bool,                       # int8 (pages, scales) pair?
      "dtype":  "bfloat16" | "float32" | "int8" | ...,
      "shape":  [Lw, page, KH, D],          # per-page layer-WINDOW shape
      "layers": [lo, hi],                   # window into the full page
      "nlayers": L,                         # full page layer count
      "blen":   int, "crc": crc32(body),    # serde-style integrity seal
    }
    body := concat over pages of (k | v | sk | sv)
            # k, v: [Lw, page, KH, D];  sk, sv: [Lw, KH] f32 (quant only)

``layers`` is the streamed-prefill hook: the producer pushes each layer
window as the fused prefill write commits it, so the consumer assembles
pages incrementally and the decode side starts restoring before the last
layer lands. A whole-page frame is simply ``layers == [0, L]``.

Integrity mirrors the serde contract (serde.py): readers verify length and
CRC32 before trusting any byte, a frame from a future format version is
refused rather than misparsed, and corruption converts to a transfer MISS
(quarantine + tier fallback), never to silently-wrong KV.

TP invariance: frames carry whole logical pages ([.., KH, ..] over ALL kv
heads) exactly like tier blobs — the runner's page calls gather a tp
engine's head shards and slice them again on restore, so a tp=2 engine's
frames restore into a tp=1 peer bit-identically.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from production_stack_tpu_torch.kvoffload.serde import (
    KVIntegrityError,
    _dtype_name,
    _dtype_of,
)

_HDR = struct.Struct("!I")

# wire format version written by this build; readers accept <= this
FABRIC_WIRE_VERSION = 1
# one frame moves at most this many pages (sender-side batching bound; a
# reader refuses bigger headers outright — cheap DoS hygiene, same spirit
# as protocol.MAX_HEADER)
MAX_FRAME_PAGES = 1024


class FabricWireError(KVIntegrityError):
    """A fabric frame failed its version / length / CRC check. The receiver
    must quarantine the frame (count it, drop it) and the sender's caller
    falls back to the tier path — corrupt frames never become KV."""


def encode_frame(
    keys: "list[str]",
    ks: "list[np.ndarray]",
    vs: "list[np.ndarray]",
    sks: "list[np.ndarray] | None" = None,
    svs: "list[np.ndarray] | None" = None,
    *,
    layers: "tuple[int, int] | None" = None,
    nlayers: "int | None" = None,
) -> bytes:
    """Encode one (pages, scales) frame. ``ks``/``vs`` are per-page
    ``[Lw, page, KH, D]`` arrays; ``sks``/``svs`` are per-page ``[Lw, KH]``
    f32 scales for quantized pools (None/empty for fp engines). ``layers``
    is the (lo, hi) layer window these arrays cover; default = whole page."""
    if not keys or len(keys) != len(ks) or len(ks) != len(vs):
        raise ValueError("keys/ks/vs must align and be non-empty")
    if len(keys) > MAX_FRAME_PAGES:
        raise ValueError(f"frame exceeds {MAX_FRAME_PAGES} pages")
    quant = bool(sks)
    if quant and (len(sks) != len(keys) or len(svs or []) != len(keys)):
        raise ValueError("quant frames need one (sk, sv) pair per page")
    k0 = np.asarray(ks[0])
    shape = list(k0.shape)
    lw = shape[0]
    lo, hi = layers if layers is not None else (0, lw)
    if hi - lo != lw:
        raise ValueError(f"layer window {lo}:{hi} does not match shape {shape}")
    parts: "list[bytes]" = []
    for i in range(len(keys)):
        k, v = np.asarray(ks[i]), np.asarray(vs[i])
        if list(k.shape) != shape or list(v.shape) != shape:
            raise ValueError("all pages in a frame must share one shape")
        parts.append(np.ascontiguousarray(k).tobytes())
        parts.append(np.ascontiguousarray(v).tobytes())
        if quant:
            sk = np.ascontiguousarray(sks[i], np.float32)
            sv = np.ascontiguousarray(svs[i], np.float32)
            if sk.shape != (lw, shape[2]) or sv.shape != (lw, shape[2]):
                raise ValueError(
                    f"scales must be [Lw, KH]=({lw}, {shape[2]}), "
                    f"got {sk.shape}/{sv.shape}"
                )
            parts.append(sk.tobytes())
            parts.append(sv.tobytes())
    body = b"".join(parts)
    hdr = {
        "fv": FABRIC_WIRE_VERSION,
        "keys": list(keys),
        "quant": quant,
        "dtype": _dtype_name(k0.dtype),
        "shape": shape,
        "layers": [int(lo), int(hi)],
        "nlayers": int(nlayers if nlayers is not None else hi),
        "blen": len(body),
        "crc": zlib.crc32(body) & 0xFFFFFFFF,
    }
    enc = json.dumps(hdr).encode()
    return _HDR.pack(len(enc)) + enc + body


def verify_frame(blob: bytes) -> dict:
    """Integrity-check a frame without decoding its pages; returns the parsed
    header. Raises :class:`FabricWireError` on a malformed header, a future
    wire version, a truncated body, or a CRC mismatch."""
    try:
        (n,) = _HDR.unpack_from(blob)
        hdr = json.loads(bytes(blob[_HDR.size : _HDR.size + n]))
        if not isinstance(hdr, dict):
            raise ValueError("header is not an object")
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise FabricWireError(f"unreadable fabric frame header: {e}") from None
    fv = int(hdr.get("fv", 0))
    if fv < 1 or fv > FABRIC_WIRE_VERSION:
        raise FabricWireError(
            f"fabric frame v{fv} unsupported (this build reads "
            f"<= v{FABRIC_WIRE_VERSION})"
        )
    keys = hdr.get("keys")
    if not isinstance(keys, list) or not keys or len(keys) > MAX_FRAME_PAGES:
        raise FabricWireError("fabric frame has no/too many page keys")
    body = memoryview(blob)[_HDR.size + n :]
    if len(body) != int(hdr.get("blen", -1)):
        raise FabricWireError(
            f"truncated fabric frame: body {len(body)} bytes, "
            f"header says {hdr.get('blen')}"
        )
    if (zlib.crc32(body) & 0xFFFFFFFF) != int(hdr.get("crc", -1)):
        raise FabricWireError("fabric frame CRC mismatch (corrupt payload)")
    return hdr


def decode_frame(blob: bytes) -> dict:
    """Verify and decode one frame. Returns::

        {"keys": [...], "quant": bool, "layers": (lo, hi), "nlayers": L,
         "pages": [(k, v, sk, sv), ...]}   # sk/sv None on fp frames

    Raises :class:`FabricWireError` on any integrity failure (the caller
    quarantines and falls back to the tier path)."""
    hdr = verify_frame(blob)
    (n,) = _HDR.unpack_from(blob)
    body = memoryview(blob)[_HDR.size + n :]
    shape = tuple(int(x) for x in hdr["shape"])
    lw, _page, kh, _d = shape
    dt = _dtype_of(hdr["dtype"])
    quant = bool(hdr["quant"])
    pbytes = int(np.prod(shape)) * dt.itemsize
    sbytes = lw * kh * 4 if quant else 0
    stride = 2 * pbytes + 2 * sbytes
    keys = hdr["keys"]
    if len(body) != stride * len(keys):
        raise FabricWireError(
            f"fabric frame body {len(body)} bytes does not cover "
            f"{len(keys)} pages of {stride} bytes"
        )
    pages = []
    for i in range(len(keys)):
        off = i * stride
        k = np.frombuffer(body[off : off + pbytes], dt).reshape(shape)
        v = np.frombuffer(body[off + pbytes : off + 2 * pbytes], dt).reshape(shape)
        sk = sv = None
        if quant:
            so = off + 2 * pbytes
            sk = np.frombuffer(body[so : so + sbytes], np.float32).reshape(lw, kh)
            sv = np.frombuffer(
                body[so + sbytes : so + 2 * sbytes], np.float32
            ).reshape(lw, kh)
        pages.append((k, v, sk, sv))
    return {
        "keys": list(keys),
        "quant": quant,
        "layers": (int(hdr["layers"][0]), int(hdr["layers"][1])),
        "nlayers": int(hdr["nlayers"]),
        "pages": pages,
    }


def frame_to_blobs(frame: dict, serde) -> "list[tuple[str, bytes]]":
    """Convert a decoded WHOLE-page frame into ``(key, tier blob)`` pairs in
    the receiver's serde, so fabric-delivered pages flow through the exact
    store/connector/restore machinery tier blobs use (CRC on read, prefix
    chain, cross-dtype handling). Quant frames always serialize through
    ``Int8PageSerde.serialize_quant`` — the scales must survive verbatim —
    regardless of the receiver's configured serde; fp frames use the
    receiver's ``serde``. Layer-partial frames are a caller error (assemble
    with :class:`FrameAssembler` first)."""
    lo, hi = frame["layers"]
    if lo != 0 or hi != frame["nlayers"]:
        raise ValueError("frame_to_blobs needs whole-page frames")
    out = []
    if frame["quant"]:
        from production_stack_tpu_torch.kvoffload.serde import Int8PageSerde

        qserde = Int8PageSerde()
        for key, (k, v, sk, sv) in zip(frame["keys"], frame["pages"]):
            out.append((key, qserde.serialize_quant(k, sk, v, sv)))
    else:
        for key, (k, v, _sk, _sv) in zip(frame["keys"], frame["pages"]):
            out.append((key, serde.serialize(k, v)))
    return out


class FrameAssembler:
    """Receiver-side assembly of layer-streamed pages.

    The streamed-prefill producer ships each page as consecutive layer
    windows; this collects them per key and yields a whole-page frame dict
    once every layer landed. Bounded: at most ``max_pending`` keys stage at
    once (beyond that the oldest partial is dropped — the tier path covers
    it), so a producer that dies mid-page cannot grow receiver memory."""

    def __init__(self, max_pending: int = 512):
        self.max_pending = max_pending
        # key -> {"windows": {(lo, hi): (k, v, sk, sv)}, "nlayers": L,
        #         "quant": bool}
        self._pending: "dict[str, dict]" = {}
        self.dropped_partials = 0

    def add(self, frame: dict) -> "list[tuple[str, tuple]]":
        """Feed one decoded frame; returns completed ``(key, (k, v, sk, sv))``
        whole pages (layer axis re-joined, ready for frame_to_blobs-style
        serialization)."""
        lo, hi = frame["layers"]
        done = []
        for key, page in zip(frame["keys"], frame["pages"]):
            if lo == 0 and hi == frame["nlayers"]:
                done.append((key, page))
                continue
            ent = self._pending.get(key)
            if ent is None:
                while len(self._pending) >= self.max_pending:
                    self._pending.pop(next(iter(self._pending)))
                    self.dropped_partials += 1
                ent = self._pending[key] = {
                    "windows": {}, "nlayers": frame["nlayers"],
                    "quant": frame["quant"],
                }
            ent["windows"][(lo, hi)] = page
            covered = sorted(ent["windows"])
            # complete iff the sorted windows tile [0, nlayers) exactly
            pos = 0
            for wlo, whi in covered:
                if wlo != pos:
                    break
                pos = whi
            if pos != ent["nlayers"]:
                continue
            parts = [ent["windows"][w] for w in covered]
            k = np.concatenate([p[0] for p in parts], axis=0)
            v = np.concatenate([p[1] for p in parts], axis=0)
            sk = sv = None
            if ent["quant"]:
                sk = np.concatenate([p[2] for p in parts], axis=0)
                sv = np.concatenate([p[3] for p in parts], axis=0)
            done.append((key, (k, v, sk, sv)))
            del self._pending[key]
        return done
