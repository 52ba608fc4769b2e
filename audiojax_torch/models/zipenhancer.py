"""ZipEnhancer pieces in PyTorch.

Counterpart of ``audiojax.models.zipenhancer``, with only
``instance_norm_tf``, which MossFormerGAN-SE uses; the rest of the model
comes with the ZipEnhancer slice.
"""
from __future__ import annotations

import torch

__all__ = ["instance_norm_tf"]


def instance_norm_tf(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d: per-(batch, channel) stats over (T, F); x (B, T, F, C)."""
    mu = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]
