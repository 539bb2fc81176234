"""KV chunk serializers (serde) for the offload tiers: the port's copy of
production_stack_tpu/kvoffload/serde.py, byte for byte the same blobs.

A *chunk* is one KV page across all layers: ``k, v: [L, page_size, KH, D]``.

- ``naive``: raw bytes, zero loss.
- ``int8``: per-(layer, head) symmetric int8 quantization of an fp page (a
  lossy transport encoding, ~2x smaller than bf16).
- ``int8page``: the quantized-pool passthrough (format v3): with
  ``kv_cache_dtype=int8`` (ops/quant.py) the pool already holds int8 pages
  and per-page, per-KV-head scales, and this serde ships those exact bytes,
  scales inside the CRC-framed body, so a spill and restore is bit-exact.

Blob layout: ``u32 header_len | header JSON | body``. The header records
``v`` (format version), ``blen`` (body length) and ``crc`` (CRC32 of the
body); readers call :func:`verify_blob` before trusting a blob, so a
corrupt page becomes a cache miss (recompute), never wrong KV. v1 blobs (no
``crc``) still parse; a blob from a future version is refused.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

try:  # numpy's bfloat16 dtype (the ml_dtypes package)
    import ml_dtypes

    BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    BF16 = np.dtype(np.float32)

_HDR = struct.Struct("!I")

# blob format version written by this build; readers accept <= this.
# v3 adds the quantized-page body layout (int8page serde).
SERDE_FORMAT_VERSION = 3


class KVIntegrityError(ValueError):
    """A blob failed its checksum / length / version check. The caller must
    treat the entry as a miss (quarantine + recompute), never deserialize."""


def _seal(hdr: dict, body: bytes, version: int = 2) -> bytes:
    """Finish a blob: stamp version + body length + CRC32 into the header.

    ``version`` is the MINIMUM format version able to parse this blob —
    fp blobs keep stamping v2 so a mixed-version fleet's older readers
    still accept them during a rolling upgrade; only quantized-page blobs
    (whose body layout is new) claim v3 and get refused by old readers
    instead of misparsed."""
    hdr["v"] = version
    hdr["blen"] = len(body)
    hdr["crc"] = zlib.crc32(body) & 0xFFFFFFFF
    enc = json.dumps(hdr).encode()
    return _HDR.pack(len(enc)) + enc + body


def verify_blob(blob: bytes) -> dict:
    """Integrity-check a blob without deserializing its payload; returns the
    parsed header. Raises :class:`KVIntegrityError` on a malformed frame, a
    future format version, a truncated body, or a CRC mismatch. v1 blobs
    (no ``crc`` field) pass — they predate checksums."""
    try:
        (n,) = _HDR.unpack_from(blob)
        hdr = json.loads(bytes(blob[_HDR.size : _HDR.size + n]))
        if not isinstance(hdr, dict):
            raise ValueError("header is not an object")
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise KVIntegrityError(f"unreadable blob header: {e}") from None
    version = int(hdr.get("v", 1))
    if version > SERDE_FORMAT_VERSION:
        raise KVIntegrityError(
            f"blob format v{version} is newer than supported "
            f"v{SERDE_FORMAT_VERSION}"
        )
    body = memoryview(blob)[_HDR.size + n :]
    if "blen" in hdr and len(body) != int(hdr["blen"]):
        raise KVIntegrityError(
            f"truncated blob: body {len(body)} bytes, header says {hdr['blen']}"
        )
    if "crc" in hdr and (zlib.crc32(body) & 0xFFFFFFFF) != int(hdr["crc"]):
        raise KVIntegrityError("blob CRC mismatch (corrupt payload)")
    return hdr


def _dtype_name(dt: np.dtype) -> str:
    return "bfloat16" if dt == BF16 else np.dtype(dt).name


def _dtype_of(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


class NaiveSerde:
    """Lossless raw-bytes serde."""

    name = "naive"

    def serialize(self, k: np.ndarray, v: np.ndarray) -> bytes:
        hdr = {
            "serde": self.name,
            "shape": list(k.shape),
            "dtype": _dtype_name(k.dtype),
        }
        return _seal(hdr, k.tobytes() + v.tobytes())

    @staticmethod
    def _split(blob: bytes) -> tuple[dict, memoryview]:
        (n,) = _HDR.unpack_from(blob)
        hdr = json.loads(blob[_HDR.size : _HDR.size + n])
        return hdr, memoryview(blob)[_HDR.size + n :]

    def deserialize(self, blob: bytes) -> tuple[np.ndarray, np.ndarray]:
        hdr, body = self._split(blob)
        dt = _dtype_of(hdr["dtype"])
        shape = tuple(hdr["shape"])
        nbytes = int(np.prod(shape)) * dt.itemsize
        k = np.frombuffer(body[:nbytes], dt).reshape(shape)
        v = np.frombuffer(body[nbytes : 2 * nbytes], dt).reshape(shape)
        return k, v


class Int8Serde(NaiveSerde):
    """Symmetric int8 quantization per (layer, kv-head): amax scale stored
    fp32. Halves bytes vs bf16 at <1% relative error on KV magnitudes."""

    name = "int8"

    @staticmethod
    def _quant(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        # x: [L, page, KH, D] -> scales [L, 1, KH, 1]
        xf = x.astype(np.float32)
        amax = np.abs(xf).max(axis=(1, 3), keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
        return q, scale

    def serialize(self, k: np.ndarray, v: np.ndarray) -> bytes:
        qk, sk = self._quant(k)
        qv, sv = self._quant(v)
        hdr = {
            "serde": self.name,
            "shape": list(k.shape),
            "dtype": _dtype_name(k.dtype),
        }
        return _seal(
            hdr, sk.tobytes() + qk.tobytes() + sv.tobytes() + qv.tobytes()
        )

    def deserialize(self, blob: bytes) -> tuple[np.ndarray, np.ndarray]:
        hdr, body = self._split(blob)
        shape = tuple(hdr["shape"])
        L, page, KH, D = shape
        dt = _dtype_of(hdr["dtype"])
        sbytes = L * KH * 4
        qbytes = int(np.prod(shape))

        def dequant(mv):
            s = np.frombuffer(mv[:sbytes], np.float32).reshape(L, 1, KH, 1)
            q = np.frombuffer(mv[sbytes : sbytes + qbytes], np.int8).reshape(shape)
            return (q.astype(np.float32) * s).astype(dt)

        k = dequant(body)
        v = dequant(body[sbytes + qbytes :])
        return k, v


class Int8PageSerde(NaiveSerde):
    """Quantized-POOL passthrough serde (format v3, ops/quant.py contract).

    Unlike :class:`Int8Serde` — which quantizes an fp page at serialize
    time and dequantizes at deserialize time (a lossy transport encoding) —
    this serde ships the pool's OWN int8 bytes and per-page per-kv-head
    scales verbatim: ``serialize_quant``/``deserialize_quant`` round-trip
    bit-exactly, so a spill + restore on a quantized engine reproduces the
    exact pool state (no requant drift), and every tier/hop moves half the
    bytes. ``deserialize`` (the generic fp entry point) dequantizes, so a
    NON-quantized engine pulling a v3 blob from the shared tier still gets
    usable fp KV; ``serialize``/``deserialize_quant`` quantize/accept fp
    input, covering the other cross-dtype direction.

    Body layout: ``sk [L, KH] f32 | qk [L, page, KH, D] int8 | sv | qv``.
    """

    name = "int8page"

    def serialize(self, k: np.ndarray, v: np.ndarray) -> bytes:
        from production_stack_tpu_torch.ops.quant import quantize_page_host

        qk, sk = quantize_page_host(np.asarray(k))
        qv, sv = quantize_page_host(np.asarray(v))
        return self.serialize_quant(qk, sk, qv, sv, orig_dtype=k.dtype)

    def serialize_quant(
        self, qk: np.ndarray, sk: np.ndarray, qv: np.ndarray, sv: np.ndarray,
        orig_dtype=None,
    ) -> bytes:
        """Pool bytes in, blob out — zero-copy of the quantized state."""
        hdr = {
            "serde": self.name,
            "shape": list(qk.shape),
            "dtype": _dtype_name(
                np.dtype(orig_dtype) if orig_dtype is not None else BF16
            ),
        }
        body = (
            np.ascontiguousarray(sk, np.float32).tobytes()
            + np.ascontiguousarray(qk, np.int8).tobytes()
            + np.ascontiguousarray(sv, np.float32).tobytes()
            + np.ascontiguousarray(qv, np.int8).tobytes()
        )
        return _seal(hdr, body, version=3)

    @staticmethod
    def _split_quant(blob: bytes):
        hdr, body = NaiveSerde._split(blob)
        L, page, KH, D = hdr["shape"]
        sbytes = L * KH * 4
        qbytes = L * page * KH * D

        def part(off):
            s = np.frombuffer(body[off : off + sbytes], np.float32)
            q = np.frombuffer(
                body[off + sbytes : off + sbytes + qbytes], np.int8
            )
            return (
                q.reshape(L, page, KH, D),
                s.reshape(L, KH),
            )

        qk, sk = part(0)
        qv, sv = part(sbytes + qbytes)
        return hdr, qk, sk, qv, sv

    def deserialize_quant(self, blob: bytes):
        """(qk, sk, qv, sv) — the exact pool bytes. Accepts fp blobs from
        other serdes too (cross-dtype restore): those quantize host-side
        with fresh per-page scales."""
        hdr, _ = NaiveSerde._split(blob)
        if hdr.get("serde") != self.name:
            from production_stack_tpu_torch.ops.quant import quantize_page_host

            k, v = get_serde(hdr.get("serde", "naive")).deserialize(blob)
            qk, sk = quantize_page_host(np.asarray(k))
            qv, sv = quantize_page_host(np.asarray(v))
            return qk, sk, qv, sv
        _, qk, sk, qv, sv = self._split_quant(blob)
        return qk, sk, qv, sv

    def deserialize(self, blob: bytes) -> tuple[np.ndarray, np.ndarray]:
        from production_stack_tpu_torch.ops.quant import dequantize_page_host

        hdr, qk, sk, qv, sv = self._split_quant(blob)
        dt = _dtype_of(hdr["dtype"])
        return (
            dequantize_page_host(qk, sk, dt),
            dequantize_page_host(qv, sv, dt),
        )


SERDES = {"naive": NaiveSerde, "int8": Int8Serde, "int8page": Int8PageSerde}


def get_serde(name: str):
    try:
        return SERDES[name]()
    except KeyError:
        raise ValueError(f"unknown serde {name!r}; options: {sorted(SERDES)}")


def deserialize(blob: bytes, verify: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Deserialize by the serde name recorded in the blob header — blobs from
    engines with a different configured serde (shared cache server, or a disk
    tier surviving a serde change) parse correctly. Verifies the checksum
    first — a corrupt blob raises :class:`KVIntegrityError` instead of
    producing silently-wrong KV; pass ``verify=False`` only when the blob
    just came from a read path that already verified it (TieredKVStore.get),
    to avoid paying the CRC twice on the hot restore path."""
    if verify:
        hdr = verify_blob(blob)
    else:
        hdr, _ = NaiveSerde._split(blob)
    return get_serde(hdr.get("serde", "naive")).deserialize(blob)
