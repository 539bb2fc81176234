"""The safetensors format, read and written with torch alone (no
``safetensors``, ``ml_dtypes`` or ``transformers``: the card's machine has
none of them, and numpy has no bfloat16 without ``ml_dtypes``).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the raw little-endian bytes;
offsets count from the end of the header.

- ``SafetensorsDir(path)`` indexes every ``*.safetensors`` file of a
  directory, in sorted order as HF's loaders do, and maps each file with
  ``mmap``. ``get(name)`` returns one tensor at a time, a view of the
  mapped bytes (bf16 as raw 16-bit words viewed as ``torch.bfloat16``):
  nothing is read before it is asked for, so a model is never held twice
  on the host. A name found in two files, or a dtype the reader does not
  take, is refused by name when the directory is indexed.
- ``save_sharded`` writes the format as HF lays a checkpoint out (shard
  names and ``model.safetensors.index.json``). It serves tests and
  ``chip_smoke.py``; nothing on the serving path writes.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Callable, Iterable, Mapping

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _read_header(f) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data) of an open
    safetensors file."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{f.name}: shorter than a safetensors header")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsDir:
    """Every tensor of a directory's ``*.safetensors`` files, read lazily."""

    def __init__(self, path: str):
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors in {path}")
        self._maps: list[mmap.mmap] = []
        self._index: dict[str, tuple[int, torch.dtype, tuple, int, int]] = {}
        where: dict[str, str] = {}
        for fname in files:
            with open(os.path.join(path, fname), "rb") as f:
                header, start = _read_header(f)
                size = os.fstat(f.fileno()).st_size
                # a private (copy-on-write) map: torch wants a writable
                # buffer, and nothing written to it reaches the file
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            for name, info in header.items():
                if name in where:
                    raise ValueError(f"tensor {name!r} is in both {where[name]} and {fname}")
                if info["dtype"] not in DTYPES:
                    raise ValueError(
                        f"{fname}: tensor {name!r} has dtype {info['dtype']}; the reader takes {sorted(DTYPES)}"
                    )
                dt = DTYPES[info["dtype"]]
                shape = tuple(int(s) for s in info["shape"])
                begin, end = info["data_offsets"]
                if end - begin != _numel(shape) * dt.itemsize or start + end > size:
                    raise ValueError(f"{fname}: tensor {name!r} has offsets {begin}..{end} for shape {shape} {dt}")
                where[name] = fname
                self._index[name] = (len(self._maps), dt, shape, start + begin, end - begin)
            self._maps.append(mm)

    def keys(self) -> list[str]:
        return list(self._index)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the CPU, a view of the mapped file (a copy
        only when its offset is not a multiple of its element size)."""
        try:
            fi, dt, shape, offset, nbytes = self._index[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} is not in the checkpoint") from None
        if nbytes == 0:
            return torch.empty(shape, dtype=dt)
        raw = torch.frombuffer(self._maps[fi], dtype=torch.uint8, count=nbytes, offset=offset)
        if offset % dt.itemsize:
            raw = raw.clone()
        return raw.view(dt).reshape(shape)


def _header_bytes(entries: Iterable[tuple[str, torch.dtype, tuple]]) -> bytes:
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, dt, shape in entries:
        if dt not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {dt} cannot be written ({sorted(DTYPES)})")
        n = _numel(shape) * dt.itemsize
        header[name] = {"dtype": _NAMES[dt], "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    return raw + b" " * (-len(raw) % 8)  # data starts 8-byte aligned, as HF writes it


def _write_tensor(f, t: torch.Tensor) -> None:
    t = t.detach().contiguous().cpu().reshape(-1)
    if t.numel():
        f.write(t.view(torch.uint8).numpy())


def save_sharded(
    directory: str,
    specs: Mapping[str, tuple[tuple, torch.dtype]],
    make: Callable[[str], torch.Tensor],
    max_shard_bytes: int = 5 * 10**9,
) -> list[str]:
    """Write the tensors ``specs`` names (``{name: (shape, dtype)}``, in
    order) as HF shards of at most ``max_shard_bytes`` each
    (``model-0000i-of-0000n.safetensors``, or ``model.safetensors`` when one
    file holds them all) and, for more than one shard, HF's
    ``model.safetensors.index.json``. ``make(name)`` gives each tensor when
    its shard is written, on any device, and moves to the host alone: only
    one tensor at a time need exist there. Returns the shard file names."""
    groups, size = [[]], 0
    for name, (shape, dt) in specs.items():
        n = _numel(shape) * dt.itemsize
        if groups[-1] and size + n > max_shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    files = (["model.safetensors"] if len(groups) == 1 else
             [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors" for i in range(len(groups))])
    os.makedirs(directory, exist_ok=True)
    for fname, group in zip(files, groups):
        head = _header_bytes((n, specs[n][1], tuple(specs[n][0])) for n in group)
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(struct.pack("<Q", len(head)))
            f.write(head)
            for n in group:
                t = make(n)
                if tuple(t.shape) != tuple(specs[n][0]) or t.dtype != specs[n][1]:
                    raise ValueError(f"make({n!r}) gave {tuple(t.shape)} {t.dtype}, the spec says {specs[n]}")
                _write_tensor(f, t)
    if len(files) > 1:
        total = sum(_numel(s) * d.itemsize for s, d in specs.values())
        index = {"metadata": {"total_size": total},
                 "weight_map": {n: fname for fname, group in zip(files, groups) for n in group}}
        with open(os.path.join(directory, INDEX_FILE), "w") as f:
            json.dump(index, f, indent=2)
    return files
