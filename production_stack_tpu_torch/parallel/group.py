"""The tp process group: one process per tensor-parallel rank, each on its
own device, joined by ``torch.distributed``.

The counterpart of production_stack_tpu/parallel/mesh.py for the one axis
the port serves, tp. Where the JAX engine lays a device mesh under one
program and lets GSPMD insert the collectives, the port runs one process
per rank (engine/engine.py starts them) and the forward calls its
collectives itself (parallel/tp.py).

The backend is named by the caller, never guessed: ``nccl`` (the default)
needs a CUDA device per rank and refuses two ranks on one device; ``gloo``
takes CUDA or CPU tensors and stages CUDA ones through the host, so two
ranks may share one card (a functional test of the path, not a speed
figure) and a CPU engine can run tp in tests. Rank r runs on
``devices[r]``: ``cuda:r`` unless ``tp_device_ids`` maps the ranks
(``"0,0"``: both on the first card).

``TPGroup`` counts what crosses the group (calls, bytes, host seconds inside
the collectives). On gloo a collective of CUDA tensors waits for the device
to finish the work queued before it, so its seconds include that wait.
"""

from __future__ import annotations

import datetime
import time
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# rendezvous and per-collective timeout: a rank that dies is seen at once
# (its sockets close); one that hangs ends the set after this long
TIMEOUT_S = 300.0


def parse_device_ids(spec: Optional[str], tp: int) -> Optional[list[int]]:
    """``"0,0"`` -> [0, 0]: one CUDA device index per rank (None: rank r on
    device r)."""
    if spec is None or spec == "":
        return None
    try:
        ids = [int(x) for x in str(spec).split(",")]
    except ValueError:
        raise ValueError(f"tp_device_ids {spec!r} must be comma-separated device indices") from None
    if len(ids) != tp or min(ids) < 0:
        raise ValueError(f"tp_device_ids {spec!r} must name one device index >= 0 for each of the {tp} tp ranks")
    return ids


def rank_devices(device, tp: int, device_ids: Optional[list[int]] = None) -> list[torch.device]:
    """The device of each rank: every rank on the CPU for a CPU engine, else
    ``cuda:<device_ids[r]>`` (``cuda:r`` by default). Raises for a CUDA
    index the machine lacks."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if device_ids is not None:
            raise ValueError("tp_device_ids name CUDA devices; a CPU engine runs every rank on the CPU")
        return [dev] * tp
    ids = device_ids if device_ids is not None else list(range(tp))
    n = torch.cuda.device_count()
    if max(ids) >= n:
        raise ValueError(
            f"tensor_parallel_size {tp} needs CUDA devices {sorted(set(ids))}, this machine has {n} devices; "
            "two ranks may share a card with --tp-backend gloo --tp-device-ids 0,0"
        )
    return [torch.device("cuda", i) for i in ids]


def check_backend(backend: str, devices: list[torch.device]) -> None:
    """Refuse a backend the ranks' devices cannot take; nothing switches to
    another backend quietly."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown tp_backend {backend!r}; options: {BACKENDS}")
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("tp_backend 'nccl' needs a CUDA device per rank; a CPU engine takes --tp-backend gloo")
    if len(set(devices)) < len(devices):
        raise ValueError(
            f"tp_backend 'nccl' refuses two ranks on one device ({[str(d) for d in devices]}); "
            "ask for --tp-backend gloo, which stages the collectives through the host"
        )


def device_labels(devices: list[torch.device]) -> list[str]:
    """One distinct label per rank: ``cuda:0`` for a single rank, else the
    device and the rank (``cuda:0/tp1``), so two ranks on one card stay two
    rows."""
    names = [f"{d.type}:{d.index or 0}" for d in devices]
    if len(devices) == 1:
        return names
    return [f"{name}/tp{r}" for r, name in enumerate(names)]


class TPGroup:
    """This process's rank in the tp group, with the collectives the port
    runs over it and their counts."""

    def __init__(self, rank: int, size: int, backend: str, devices: list[torch.device]):
        self.rank, self.size, self.backend = rank, size, backend
        self.devices = devices
        self.device = devices[rank]
        self.labels = device_labels(devices)
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    @classmethod
    def init(cls, rank: int, size: int, backend: str, devices: list[torch.device], init_method: str,
             timeout_s: float = TIMEOUT_S) -> "TPGroup":
        """Join the group as ``rank`` (a barrier: returns once every rank
        has joined), after making the rank's device current. The group is
        the process's default ``torch.distributed`` group: a process takes
        part in one tp group at a time."""
        check_backend(backend, devices)
        if dist.is_initialized():
            raise RuntimeError("this process is already in a tp group: one tp engine per process at a time")
        if devices[rank].type == "cuda":
            torch.cuda.set_device(devices[rank])
        dist.init_process_group(
            backend, init_method=init_method, world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        return cls(rank, size, backend, devices)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def _run(self, op, t: torch.Tensor) -> None:
        t0 = time.perf_counter()
        op(t)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += t.nbytes

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the ranks, in place."""
        self._run(dist.all_reduce, t)

    def broadcast(self, t: torch.Tensor) -> None:
        """Rank 0's ``t`` on every rank, in place."""
        self._run(lambda x: dist.broadcast(x, src=0), t)

    def stats(self) -> tuple[int, int, float]:
        return self.calls, self.bytes, self.seconds

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
