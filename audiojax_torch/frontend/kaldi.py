"""Kaldi log-mel-fbank front end, folded into DFT bases, in PyTorch.

Counterpart of ``audiojax.frontend.kaldi``: it reproduces
``torchaudio.compliance.kaldi.fbank(dither=0, snip_edges=True,
remove_dc_offset=True, preemphasis 0.97, hamming, use_power=True,
use_log_fbank=True)``.

The per-frame pipeline (DC removal → pre-emphasis → window → N-point rDFT →
power) is linear up to the power, so it folds into one
``(frame_len, 2·bins)`` basis: with D the per-frame mean-removal matrix, P
the pre-emphasis filter and W the windowed DFT, the folded basis is
``W · diag(win) · P · D``.

The bases are numpy float64 at build time, cast once to float32 and copied
to each device once.  At run time: framing, one matrix product with the
folded basis, the power, one product with the mel bank, and a log.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.stft import StftConfig, _on_device, frame_signal
from ..dsp.windows import get_window

__all__ = ["kaldi_analysis_basis", "kaldi_mel_banks", "log_mel_fbank", "KALDI_LOG_EPS"]

KALDI_LOG_EPS = float(np.finfo(np.float32).eps)


@lru_cache(maxsize=None)
def kaldi_analysis_basis(frame_len: int, nfft: int, preemph: float = 0.97,
                         window: str = "hamming_symmetric", remove_dc: bool = True) -> np.ndarray:
    """(frame_len, 2·bins) folded analysis basis: [real | imag] columns."""
    bins = nfft // 2 + 1
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    f = np.arange(bins, dtype=np.float64)[None, :]
    omega = 2.0 * np.pi / nfft * n * f
    win = get_window(window, frame_len)[:, None]
    # windowed DFT basis, rows = sample position, cols = [cos | -sin] bins
    basis = np.concatenate([np.cos(omega) * win, -np.sin(omega) * win], axis=1)

    # fold pre-emphasis: row j of the input reaches the DFT through sample
    # positions j (weight 1) and j+1 (weight -preemph); row 0 additionally
    # keeps Kaldi's x[0] -= preemph*x[0] convention.
    folded = np.empty_like(basis)
    folded[0] = (1.0 - preemph) * basis[0] - preemph * basis[1]
    folded[1:-1] = basis[1:-1] - preemph * basis[2:]
    folded[-1] = basis[-1]
    if remove_dc:
        folded = folded - folded.mean(axis=0, keepdims=True)
    folded = folded.astype(np.float32)
    folded.flags.writeable = False  # cached: callers must not mutate
    return folded


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@lru_cache(maxsize=None)
def kaldi_mel_banks(n_mels: int, nfft: int, fs: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank → (bins, n_mels) with a zero Nyquist row.

    Triangles linear in mel over the FFT bins' centre frequencies
    (``torchaudio.compliance.kaldi.get_mel_banks``; ``high_freq <= 0`` means
    nyquist + high_freq), zero-padded with the Nyquist row, so one product
    applies it to the whole one-sided power spectrum.
    """
    nyquist = 0.5 * fs
    high = high_freq if high_freq > 0 else nyquist + high_freq
    n_bins = nfft // 2  # Kaldi excludes the Nyquist bin
    width = fs / nfft
    mel_low, mel_high = _mel(low_freq), _mel(high)
    delta = (mel_high - mel_low) / (n_mels + 1)
    mel_bins = _mel(np.arange(n_bins) * width)

    left = mel_low + np.arange(n_mels)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (mel_bins[None, :] - left) / delta
    down = (right - mel_bins[None, :]) / delta
    fb = np.where(mel_bins[None, :] <= center, up, down)
    fb = np.clip(fb, 0.0, None)
    fb = np.where((mel_bins[None, :] > left) & (mel_bins[None, :] < right), fb, 0.0)
    out = np.zeros((nfft // 2 + 1, n_mels), dtype=np.float32)
    out[:n_bins] = fb.T
    out.flags.writeable = False  # cached: callers must not mutate
    return out


def _basis_np(frame_len: int, nfft: int, preemph: float, window: str) -> np.ndarray:
    return np.array(kaldi_analysis_basis(frame_len, nfft, preemph, window))


def _mel_np(n_mels: int, nfft: int, fs: float) -> np.ndarray:
    return np.array(kaldi_mel_banks(n_mels, nfft, fs))


def log_mel_fbank(x: torch.Tensor, *, frame_len: int, hop: int, nfft: int, n_mels: int,
                  fs: float, preemph: float = 0.97, window: str = "hamming_symmetric",
                  power_scale: float = 1.0, frames: torch.Tensor | None = None) -> torch.Tensor:
    """(..., L) float audio → (..., T, n_mels) Kaldi log-mel features.

    ``power_scale`` restores the int16-domain magnitudes when the caller has
    scaled PCM by 1/32768.  Pass ``frames`` to share the framing with a mask
    STFT over the same geometry.
    """
    if frames is None:
        frames = frame_signal(x, StftConfig(frame_len, hop, center=False))
    dev = frames.device
    spec = torch.matmul(frames, _on_device(_basis_np, dev, frame_len, nfft, preemph, window))
    bins = nfft // 2 + 1
    power = (spec[..., :bins] ** 2 + spec[..., bins:] ** 2) * power_scale
    mel = torch.matmul(power, _on_device(_mel_np, dev, n_mels, nfft, float(fs)))
    return torch.log(torch.clamp(mel, min=KALDI_LOG_EPS))
