"""Normalization ops: RMSNorm and LayerNorm with their statistics in float32
whatever the activation dtype (bf16 accumulation loses too much at hidden
>= 2048)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: x * rsqrt(mean(x^2) + eps) * weight, variance in fp32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rms_norm_1p(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma's RMSNorm with a zero-centred weight: x * rsqrt(mean(x^2) + eps)
    * (1 + weight), the statistics and (1 + weight) in fp32, cast to x's
    dtype at the end."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (the OPT family): (x - mean) * rsqrt(var + eps) * weight +
    bias, the statistics, weight and bias in fp32, cast to x's dtype at the
    end."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
