"""ERB filterbank split/merge (GTCRN front-end) in PyTorch.

Counterpart of ``audiojax.nn.erb``: the lowest ``n_low`` STFT bins pass
through untouched; the remaining high bins are compressed onto ``n_erb``
triangular ERB-spaced bands and expanded back with the transposed filters.
Filters are numpy constants, copied to each device once.

Layout: channel-last ``(..., F, C)`` feature maps; the band product
contracts the F axis.  A model that carries its own bank (UL-UNAS's imported
``erb.fc`` / ``erb.ifc``) passes it as ``weight``, in the JAX package's
layout: ``(F_high, n_erb)`` to compress, ``(n_erb, F_high)`` to expand.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["erb_filters", "erb_compress", "erb_expand"]


def _hz_to_erb(f_hz, scale=21.4):
    return scale * np.log10(0.00437 * f_hz + 1.0)


def _erb_to_hz(e, scale=21.4):
    return (10.0 ** (e / scale) - 1.0) / 0.00437


@lru_cache(maxsize=None)
def erb_filters(n_low: int, n_erb: int, n_fft: int = 512, high_hz: float = 8000.0, fs: int = 16000,
                scale: float = 21.4) -> np.ndarray:
    """Triangular ERB filterbank over the high bins: returns (n_erb, F_high).

    F_high = n_fft//2 + 1 - n_low.  Band edges are ERB-uniform between the
    crossover frequency (bin ``n_low``) and ``high_hz``; the first/last bands
    get half-triangles, with the top band completing a partition of unity at
    the upper edge.
    """
    n_bins = n_fft // 2 + 1
    edges_erb = np.linspace(_hz_to_erb(n_low / n_fft * fs, scale), _hz_to_erb(high_hz, scale), n_erb)
    centers = np.round(_erb_to_hz(edges_erb, scale) / fs * n_fft).astype(np.int64)

    fb = np.zeros((n_erb, n_bins), dtype=np.float64)
    eps = 1e-12

    def rising(lo, hi):
        return (np.arange(lo, hi) - lo + eps) / (hi - lo + eps)

    def falling(lo, hi):
        return (hi - np.arange(lo, hi) + eps) / (hi - lo + eps)

    fb[0, centers[0] : centers[1]] = falling(centers[0], centers[1])
    for j in range(1, n_erb - 1):
        fb[j, centers[j - 1] : centers[j]] = rising(centers[j - 1], centers[j])
        fb[j, centers[j] : centers[j + 1]] = falling(centers[j], centers[j + 1])
    fb[-1, centers[-2] : centers[-1] + 1] = 1.0 - fb[-2, centers[-2] : centers[-1] + 1]
    return np.abs(fb[:, n_low:]).astype(np.float32)


@lru_cache(maxsize=None)
def _filters(n_low: int, n_erb: int, n_fft: int, scale: float, device: torch.device):
    fb = torch.from_numpy(erb_filters(n_low, n_erb, n_fft, scale=scale)).to(device)
    return fb, fb.t().contiguous()


def erb_compress(x: torch.Tensor, n_low: int, n_erb: int, n_fft: int = 512, *,
                 weight: torch.Tensor | None = None, scale: float = 21.4) -> torch.Tensor:
    """(…, F, C) → (…, n_low + n_erb, C): pass low bins, band the high bins."""
    fb = _filters(n_low, n_erb, n_fft, scale, x.device)[0] if weight is None else weight.t()
    banded = torch.matmul(fb, x[..., n_low:, :])
    return torch.cat([x[..., :n_low, :], banded], dim=-2)


def erb_expand(x: torch.Tensor, n_low: int, n_erb: int, n_fft: int = 512, *,
               weight: torch.Tensor | None = None, scale: float = 21.4) -> torch.Tensor:
    """(…, n_low + n_erb, C) → (…, F, C): transposed-filter expansion."""
    fb_t = _filters(n_low, n_erb, n_fft, scale, x.device)[1] if weight is None else weight.t()
    high = torch.matmul(fb_t, x[..., n_low:, :])
    return torch.cat([x[..., :n_low, :], high], dim=-2)
