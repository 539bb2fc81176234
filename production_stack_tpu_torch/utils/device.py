"""Device selection for the port's entry points (engine, runner, loader).

They run on the card unless the caller asks for the CPU: the default is
``"cuda"``, and with no card present that is an error, not a quiet move to
the CPU (a CPU run would report CPU speed under the card's name).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
