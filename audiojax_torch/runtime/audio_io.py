"""PCM16 WAV I/O and host-side audio conditioning with the stdlib and numpy.

Counterpart of the WAV part of ``audiojax.runtime.audio_io``.  FLAC, the
ffmpeg hook and the native (C++) bridge are not ported yet.
"""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

__all__ = ["read_wav", "write_wav", "to_mono", "resample_np", "normalise_rms"]


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (int16 samples ``(channels, n)``, sample_rate)."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(frames, dtype="<i2")
    elif width == 4:
        data = (np.frombuffer(frames, dtype="<i4") >> 16).astype(np.int16)
    elif width == 1:
        data = ((np.frombuffer(frames, dtype=np.uint8).astype(np.int16) - 128) << 8).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    return data.reshape(-1, channels).T.copy(), rate


def write_wav(path, audio: np.ndarray, rate: int) -> Path:
    """Write int16 samples ``(channels, n)`` or ``(n,)`` as PCM16 WAV."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None]
    if audio.dtype != np.int16:
        audio = np.clip(audio, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.T.astype("<i2").tobytes())
    return path


def to_mono(audio: np.ndarray) -> np.ndarray:
    """(channels, n) int16 → (n,) int16 by channel averaging."""
    if audio.ndim == 1:
        return audio
    if audio.shape[0] == 1:
        return audio[0]
    return np.round(audio.astype(np.float32).mean(axis=0)).astype(np.int16)


def resample_np(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Host linear resample (align_corners=False), int16 in/out."""
    if rate_in == rate_out:
        return audio
    n = audio.shape[-1]
    out_n = int(round(n * rate_out / rate_in))
    coords = (np.arange(out_n, dtype=np.float64) + 0.5) * (n / out_n) - 0.5
    coords = np.clip(coords, 0, n - 1)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = coords - i0
    x = audio.astype(np.float32)
    y = x[..., i0] * (1.0 - frac) + x[..., i1] * frac
    return np.clip(np.round(y), -32768, 32767).astype(np.int16)


def normalise_rms(audio: np.ndarray, target_rms: float = 4096.0) -> np.ndarray:
    """Optional int16-domain RMS normalisation to ``target_rms``."""
    x = audio.astype(np.float32)
    rms = float(np.sqrt(np.mean(x * x)))
    if rms > 0.0:
        x *= target_rms / (rms + 1e-7)
    return np.clip(x, -32768.0, 32767.0).astype(np.int16)
