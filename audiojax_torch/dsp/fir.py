"""One-channel FIR filtering and zero-stuffing, in PyTorch.

Counterpart of ``audiojax.dsp.fir``.  The JAX package blocks the output into
rows and multiplies by a banded constant matrix, the TPU's form of a
one-channel convolution; the port keeps the contract,
``y[n] = Σ_t x[n + t − left] · taps[t]`` with zeros outside the signal, and
runs it as one ``F.conv1d`` of one channel in float32 (cuDNN on the card,
TF32 off).  Used by MossFormer2-SR's sinc upsampler and its crossover.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fir_gemm", "upsample_zero_stuff"]


@lru_cache(maxsize=None)
def _taps_on(taps: tuple, device: torch.device) -> torch.Tensor:
    """The taps as a (1, 1, k) conv weight on ``device``, once."""
    return torch.tensor(taps, dtype=torch.float32, device=device).reshape(1, 1, -1)


def fir_gemm(x: torch.Tensor, taps: np.ndarray, *, left: int = 0,
             out_len: int | None = None) -> torch.Tensor:
    """``y[n] = Σ_t x[n + t − left] · taps[t]`` with zero padding outside.

    x: ``(..., L)`` float32; taps: 1-D numpy; ``out_len`` defaults to L."""
    k = len(taps)
    lead, length = x.shape[:-1], x.shape[-1]
    n_out = int(out_len) if out_len is not None else length
    need = n_out + k - 1  # input samples the outputs read, the left pad included
    right = need - left - length
    xp = F.pad(x.reshape(-1, 1, length), (left, max(right, 0)))[..., :need]
    w = _taps_on(tuple(np.asarray(taps, np.float32).tolist()), x.device)
    return F.conv1d(xp, w).reshape(*lead, n_out)


def upsample_zero_stuff(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Insert ``ratio − 1`` zeros after every sample:
    ``(..., L) → (..., ratio·L − (ratio − 1))``."""
    n = x.shape[-1]
    stuffed = x.new_zeros((*x.shape[:-1], n, ratio))
    stuffed[..., 0] = x
    return stuffed.reshape(*x.shape[:-1], n * ratio)[..., : n * ratio - (ratio - 1)]
