"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling.

cos/sin are computed from integer positions on the fly: positions are ragged
per sequence, and recomputing costs about what a table gather would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style rope scaling (`rope_type: llama3` in HF configs)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


def _inv_freq(
    head_dim: int, theta: float, scaling: Optional[RopeScaling], device
) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    if scaling is None:
        return inv_freq
    # Llama-3 NTK-by-parts scaling
    low_wavelen = scaling.original_max_position / scaling.low_freq_factor
    high_wavelen = scaling.original_max_position / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / scaling.factor
    smooth = (scaling.original_max_position / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    smooth = smooth.clamp(0.0, 1.0)
    mid = (1.0 - smooth) * scaled + smooth * inv_freq
    return torch.where(
        wavelen > low_wavelen, scaled, torch.where(wavelen < high_wavelen, inv_freq, mid)
    )


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    scaling: Optional[RopeScaling] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape positions.shape + (head_dim // 2,), float32."""
    inv_freq = _inv_freq(head_dim, theta, scaling, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — the HF 'neox' convention of
    Llama/Qwen. x: [..., heads, head_dim]; cos/sin: [..., head_dim//2]
    broadcast over the heads axis."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
