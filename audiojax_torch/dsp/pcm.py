"""int16 PCM contract helpers and linear resampling (torch).

Counterpart of ``audiojax.dsp.pcm``: int16 PCM in → scale by 1/32768 →
(optional DC removal / resample) → network → ×32767 → clamp → int16 PCM out,
with the clamp staged through int32.
"""
from __future__ import annotations

import numpy as np
import torch

INV_INT16 = 1.0 / 32768.0
PCM_OUT_SCALE = 32767.0

__all__ = [
    "INV_INT16",
    "PCM_OUT_SCALE",
    "pcm_in",
    "pcm_out",
    "remove_dc",
    "resample_linear",
    "fold_windows",
    "unfold_windows",
]


def pcm_in(audio: torch.Tensor) -> torch.Tensor:
    """int16 (or float-typed int16-range) samples → float32 in [-1, 1)."""
    return audio.to(torch.float32) * INV_INT16


def pcm_out(x: torch.Tensor, dtype=torch.int16) -> torch.Tensor:
    """float in [-1, 1] → int16 PCM with an int32-staged clamp.

    Scale and clip run in float32 whatever the input dtype (32767 is not
    representable in bf16); the cast through int32 truncates toward zero,
    as the JAX package's does."""
    y = x.to(torch.float32) * PCM_OUT_SCALE
    y = torch.clamp(y, -32768.0, 32767.0)
    if dtype == torch.int16:
        return y.to(torch.int32).to(torch.int16)
    return y.to(dtype)


def remove_dc(x: torch.Tensor) -> torch.Tensor:
    """Subtract the per-signal mean over the whole clip."""
    return x - torch.mean(x, dim=-1, keepdim=True)


def resample_linear(x: torch.Tensor, out_length: int) -> torch.Tensor:
    """Linear resample of ``(..., L)`` to ``out_length`` samples.

    Matches ``F.interpolate(mode='linear', align_corners=False)``: output
    sample i reads input coordinate (i + 0.5) * L/out - 0.5, edge-clamped.
    """
    length = x.shape[-1]
    if out_length == length:
        return x
    coords = (np.arange(out_length, dtype=np.float64) + 0.5) * (length / out_length) - 0.5
    coords = np.clip(coords, 0.0, length - 1)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, length - 1)
    frac = torch.from_numpy((coords - i0).astype(np.float32)).to(x.device)
    i0 = torch.from_numpy(i0).to(x.device)
    i1 = torch.from_numpy(i1).to(x.device)
    return x[..., i0] * (1.0 - frac) + x[..., i1] * frac


def fold_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """Batch-fold ``(B, L=k*window)`` → ``(B*k, window)``."""
    b, length = x.shape
    if length % window:
        raise ValueError(f"length {length} not a multiple of window {window}")
    return x.reshape(b * (length // window), window)


def unfold_windows(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of :func:`fold_windows`: ``(B*k, W)`` → ``(B, k*W)``."""
    bk, w = x.shape
    return x.reshape(batch, (bk // batch) * w)
