"""Audio I/O and host-side audio conditioning.

Counterpart of ``audiojax.runtime.audio_io``: ``read_audio`` dispatches on
the file's first bytes to the stdlib WAV reader, the native FLAC decoder
(``runtime/native.py``) or a decoder added with ``register_decoder``; any
other container goes through ffmpeg when one is configured
(``$AUDIOJAX_FFMPEG`` or PATH), and otherwise fails with an error that names
the detected format.  ``write_wav``, ``resample_np`` and ``normalise_rms``
take the native route for int16 data where the bridge is built, as in the
JAX package, and numpy otherwise.
"""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

from . import native

__all__ = ["read_audio", "read_wav", "register_decoder", "ffmpeg_path", "write_wav", "to_mono",
           "resample_np", "normalise_rms"]

# magic-byte prefix → decoder(path) -> (int16 (channels, n), rate); WAV and
# FLAC are built in
_DECODERS: list[tuple[bytes, object]] = []
SNIFF_BYTES = 32


def register_decoder(magic: bytes, decoder) -> None:
    """Register ``decoder(path) -> ((channels, n) int16, rate)`` for files
    whose first bytes equal ``magic`` (at most the 32 bytes read_audio reads)."""
    if len(magic) > SNIFF_BYTES:
        raise ValueError(f"decoder magic longer than the 32-byte sniff window: {len(magic)}")
    _DECODERS.insert(0, (magic, decoder))


def _sniff_container(head: bytes) -> str | None:
    """The container's name from its first bytes, for the error on a format
    that is not decoded here."""
    if head.startswith(b"ID3") or (len(head) >= 2 and head[0] == 0xFF
                                   and (head[1] & 0xE0) == 0xE0):
        return "MP3"
    if head.startswith(b"OggS"):
        return "OGG (Vorbis/Opus)"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "MP4/M4A (AAC)"
    if head.startswith(b"FORM"):
        return "AIFF"
    if head.startswith(b"#!AMR"):
        return "AMR"
    if head.startswith(b"\x30\x26\xb2\x75"):
        return "WMA/ASF"
    return None


def ffmpeg_path() -> str | None:
    """The converter: ``$AUDIOJAX_FFMPEG`` (a binary; set empty to disable
    the hook) or an ``ffmpeg`` on PATH."""
    import os
    import shutil

    env = os.environ.get("AUDIOJAX_FFMPEG")
    if env is not None:
        return env or None
    return shutil.which("ffmpeg")


def _decode_via_ffmpeg(path, ffmpeg: str) -> tuple[np.ndarray, int]:
    """Any container ffmpeg reads, converted to PCM16 WAV in a temporary file."""
    import subprocess
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run(
            [ffmpeg, "-y", "-v", "error", "-i", str(path),
             "-acodec", "pcm_s16le", "-f", "wav", tmp_path],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise ValueError(f"ffmpeg failed to decode {path}: {proc.stderr.strip()[:400]}")
        return read_wav(tmp_path)
    finally:
        Path(tmp_path).unlink(missing_ok=True)


def read_audio(path) -> tuple[np.ndarray, int]:
    """Decode a supported container → (int16 ``(channels, n)``, rate)."""
    with open(path, "rb") as fh:
        head = fh.read(SNIFF_BYTES)
    for magic, decoder in _DECODERS:
        if head.startswith(magic):
            return decoder(path)
    if head.startswith(b"fLaC"):
        return native.decode_flac(Path(path).read_bytes())
    if head.startswith(b"RIFF"):
        return read_wav(path)
    ffmpeg = ffmpeg_path()
    if ffmpeg:
        return _decode_via_ffmpeg(path, ffmpeg)
    kind = _sniff_container(head)
    detected = f"{kind} input" if kind else f"unrecognised container {head[:4]!r}"
    raise ValueError(
        f"{detected} in {path}: built-in decoders cover WAV and FLAC; convert "
        f"first (`ffmpeg -i {path} out.wav`), or install ffmpeg / set "
        f"AUDIOJAX_FFMPEG=/path/to/ffmpeg to decode in place, or register a "
        f"decoder via audio_io.register_decoder")


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
    if native.available():
        path.write_bytes(native.encode_wav_pcm16(audio, rate))
        return path
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
    if audio.dtype == np.int16 and native.available():
        return native.resample_linear(audio, out_n)
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
    if audio.dtype == np.int16 and native.available():
        return native.normalise_rms(audio, target_rms)
    x = audio.astype(np.float32)
    rms = float(np.sqrt(np.mean(x * x)))
    if rms > 0.0:
        x *= target_rms / (rms + 1e-7)
    return np.clip(x, -32768.0, 32767.0).astype(np.int16)
