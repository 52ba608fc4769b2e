"""MossFormer-family helpers in PyTorch.

Counterpart of ``audiojax.nn.mossformer``, with only the rotary tables that
MossFormerGAN's GAU uses; the FLASH layer and the gated FSMN blocks come with
the MossFormer2 slices.  The tables are computed in numpy float64, cast to
float32 and cached, as in the JAX package.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["rope_mm_tables"]


@lru_cache(maxsize=None)
def _rotary_tables_np(length: int, rot_dim: int, theta: float = 10000.0):
    freqs = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    ang = np.arange(length, dtype=np.float64)[:, None] * freqs[None, :]  # (T, rot/2)
    ang = np.repeat(ang, 2, axis=-1)  # interleave duplicate: (T, rot)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _rope_mm_tables_np(length: int, rot_dim: int, dim: int):
    cos, sin = _rotary_tables_np(length, rot_dim)
    cos_f = np.ones((length, dim), np.float32)
    sin_f = np.zeros((length, dim), np.float32)
    cos_f[:, :rot_dim] = cos
    sin_f[:, :rot_dim] = sin
    swap = np.zeros((dim, dim), np.float32)
    for m in range(rot_dim // 2):
        swap[2 * m + 1, 2 * m] = -1.0  # halfr[2m]   = -x[2m+1]
        swap[2 * m, 2 * m + 1] = 1.0   # halfr[2m+1] =  x[2m]
    return cos_f, sin_f, swap


@lru_cache(maxsize=None)
def rope_mm_tables(length: int, rot_dim: int, dim: int, device: torch.device):
    """RoPE-as-matmul tables ``(cos_full, sin_full, swap)`` on ``device``, with

        rotary(x) == x·cos_full + (x @ swap)·sin_full

    for x (..., length, dim): interleaved-pair rotation of the first
    ``rot_dim`` channels.  Each swap row has one ±1 entry, so the product is
    exact."""
    return tuple(torch.from_numpy(a).to(device) for a in _rope_mm_tables_np(length, rot_dim, dim))
