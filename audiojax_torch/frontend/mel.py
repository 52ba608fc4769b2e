"""Slaney-scale mel filterbanks (numpy), shared by Mel-Band Roformer's band
layout and MossFormer2-SR's log-mel analysis.

A copy of ``audiojax.frontend.mel``: ``torchaudio.functional.melscale_fbanks``
with ``norm='slaney', mel_scale='slaney'``, computed in float64 and cast to
float32 once.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["slaney_mel_fbanks", "hz_to_mel_slaney", "mel_to_hz_slaney"]


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    return np.where(log_region,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * (27.0 / np.log(6.4)), mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


@lru_cache(maxsize=None)
def slaney_mel_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: float,
                      norm: str = "slaney") -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank, slaney scale + slaney area norm."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = mel_to_hz_slaney(m_pts)

    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.clip(np.minimum(down, up), 0.0, None)
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    fb = fb.astype(np.float32)
    fb.flags.writeable = False  # cached: callers copy before they change it
    return fb
