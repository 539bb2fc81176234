"""numpy arrays (a JAX parameter tree) to tensors and back, with every bit
kept."""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor with the same bits. bf16 arrives as ml_dtypes'
    bfloat16, which torch cannot read: it moves as uint16 and is viewed
    back, so no value passes through float32."""
    arr = np.require(arr, requirements=["C", "W"])  # torch wants a writable buffer
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, in the JAX layout and dtype:
    bf16 as ml_dtypes' bfloat16 (``tensor_from_numpy``'s inverse)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def unstack_layers(stacked_tree: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """A layer-stacked tree ``{name: [L, ...]}`` as per-layer tensors named
    ``layers.{i}.{name}``, every bit kept."""
    out = {}
    for name, stacked in stacked_tree.items():
        if stacked.shape[0] != num_layers:
            raise ValueError(f"layer-stacked {name} has {stacked.shape[0]} layers, config {num_layers}")
        for i in range(num_layers):
            out[f"layers.{i}.{name}"] = tensor_from_numpy(stacked[i])
    return out
