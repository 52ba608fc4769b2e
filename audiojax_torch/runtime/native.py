"""ctypes bridge to the native (C++) host-side audio code.

Counterpart of ``audiojax.runtime.native``: ``native/audioio.cc`` (WAV
header and decode, fixed-window slicing, PCM16 encode, linear resampling,
int16 RMS normalisation, the Hann-taper overlap-add stitch and a FLAC
decoder) built with g++ on first use and loaded through ctypes.  The port
builds its own copy, ``_build/audioio-<hash>.so`` inside this package (the
hash covers the source and the flags), never beside the source: to a
per-process temporary path, then renamed into place, so concurrent processes
never load a half-written library.

Everything here has a numpy counterpart (``audio_io.py``, ``session.py``),
used where the bridge cannot be built, as in the JAX package.  Unlike the
JAX package, a failed build is recorded: ``build_error()`` gives the
compiler's message, so a caller that needs the bridge can say why it is
absent.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "build_error",
    "library_path",
    "decode_flac",
    "read_wav_mono16",
    "slice_windows",
    "encode_wav_pcm16",
    "resample_linear",
    "normalise_rms",
    "ola_stitch",
]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "audioio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
_error: str | None = None


def library_path() -> Path:
    """Where the bridge's library is (or will be) built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"audioio-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.build{os.getpid()}")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, so)


def _load():
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.wav_parse_header.restype = ctypes.c_int
        lib.wav_decode_mono16.restype = ctypes.c_int
        lib.slice_windows.restype = ctypes.c_int
        lib.wav_encode_pcm16.restype = ctypes.c_int64
        lib.resample_linear_i16.restype = ctypes.c_int
        lib.resample_linear_rows_i16.restype = ctypes.c_int
        lib.normalise_rms_i16.restype = ctypes.c_int
        lib.ola_stitch_i16.restype = ctypes.c_int
        lib.flac_parse_header.restype = ctypes.c_int
        lib.flac_decode_i16.restype = ctypes.c_int64
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as e:  # no g++, a failed build or load
        _error = f"{type(e).__name__}: {e}"
        _lib = None
    return _lib


def available() -> bool:
    """True when the bridge is built and loaded (built here at first call)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the bridge is absent (the compiler's or loader's message), or None."""
    _load()
    return _error


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native audioio unavailable: {_error}")
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def read_wav_mono16(path) -> tuple[np.ndarray, int]:
    """Native WAV decode → (int16 mono samples, sample_rate)."""
    lib = _lib_or_raise()
    data = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    ch, rate, bits, is_f = (ctypes.c_int32() for _ in range(4))
    n, off = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.wav_parse_header(_ptr(data), ctypes.c_int64(data.size), ctypes.byref(ch),
                              ctypes.byref(rate), ctypes.byref(bits), ctypes.byref(is_f),
                              ctypes.byref(n), ctypes.byref(off))
    if rc != 0:
        raise ValueError(f"invalid WAV file ({rc}): {path}")
    # bound-check before the header's frame count reaches C: a truncated data
    # chunk must not drive an out-of-bounds read, and a bit depth under 8
    # would divide by zero in the frame size
    if bits.value < 8:
        raise ValueError(f"unsupported WAV bit depth {bits.value}: {path}")
    frame_bytes = ch.value * (bits.value // 8)
    if off.value + n.value * frame_bytes > data.size:
        raise ValueError(
            f"truncated WAV: header claims {n.value} frames "
            f"({n.value * frame_bytes} bytes at offset {off.value}) but file "
            f"has {data.size} bytes: {path}")
    out = np.empty(n.value, np.int16)
    rc = lib.wav_decode_mono16(_ptr(data), off, n, ch, bits, is_f, _ptr(out))
    if rc != 0:
        raise ValueError(f"unsupported WAV payload ({rc}): {path}")
    return out, rate.value


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Native FLAC decode → (int16 samples ``(channels, n)``, sample_rate).

    Fail-closed: CRC or format errors raise, with no partial output.  A bit
    depth other than 16 is shifted to the int16 range."""
    lib = _lib_or_raise()
    buf = np.frombuffer(data, dtype=np.uint8)
    ch, rate, bits = (ctypes.c_int32() for _ in range(3))
    total = ctypes.c_int64()
    rc = lib.flac_parse_header(_ptr(buf), ctypes.c_int64(buf.size), ctypes.byref(ch),
                               ctypes.byref(rate), ctypes.byref(bits), ctypes.byref(total))
    if rc != 0:
        raise ValueError(f"invalid FLAC stream ({rc})")
    # total_samples may be 0 (unknown): start from a guess from the stream's
    # size and grow when the buffer fills, since a very compressible stream
    # (silence) exceeds any fixed ratio and a truncated decode must not pass
    cap = total.value if total.value > 0 else max(buf.size * 4 // max(ch.value, 1), 4096)
    while True:
        out = np.empty((cap, ch.value), np.int16)
        n = lib.flac_decode_i16(_ptr(buf), ctypes.c_int64(buf.size), _ptr(out),
                                ctypes.c_int64(cap))
        if n < 0:
            raise ValueError(f"FLAC decode failed ({n})")
        if n < cap or total.value > 0:
            break
        cap *= 4  # filled exactly with an unknown total: it may have been cut
    return out[:n].T.copy(), rate.value


def slice_windows(audio: np.ndarray, window: int, stride: int, pad_head: int,
                  num_windows: int) -> np.ndarray:
    """Native fixed-window slicing with a ``pad_head`` zero prefix and a zero
    tail: ``(num_windows, window)`` int16."""
    lib = _lib_or_raise()
    audio = np.ascontiguousarray(audio, np.int16)
    out = np.empty((num_windows, window), np.int16)
    rc = lib.slice_windows(_ptr(audio), ctypes.c_int64(audio.size), ctypes.c_int64(window),
                           ctypes.c_int64(stride), ctypes.c_int64(pad_head),
                           ctypes.c_int64(num_windows), _ptr(out))
    if rc != 0:
        raise ValueError("slice_windows failed")
    return out


def encode_wav_pcm16(samples: np.ndarray, rate: int) -> bytes:
    """Native PCM16 RIFF encode; ``samples`` is (channels, n) or (n,) int16."""
    lib = _lib_or_raise()
    samples = np.asarray(samples, np.int16)
    if samples.ndim == 1:
        samples = samples[None]
    channels, n = samples.shape
    interleaved = np.ascontiguousarray(samples.T)  # frame-major
    out = np.empty(44 + n * channels * 2, np.uint8)
    written = lib.wav_encode_pcm16(_ptr(interleaved), ctypes.c_int64(n),
                                   ctypes.c_int32(channels), ctypes.c_int32(rate), _ptr(out))
    if written != out.size:
        raise ValueError("wav_encode_pcm16 failed")
    return out.tobytes()


def resample_linear(audio: np.ndarray, out_n: int) -> np.ndarray:
    """Native linear resample along the last axis, int16 → int16."""
    lib = _lib_or_raise()
    audio = np.ascontiguousarray(audio, np.int16)
    lead = audio.shape[:-1]
    flat = audio.reshape(-1, audio.shape[-1])
    out = np.empty((flat.shape[0], out_n), np.int16)
    rc = lib.resample_linear_rows_i16(_ptr(flat), ctypes.c_int64(flat.shape[0]),
                                      ctypes.c_int64(flat.shape[1]), _ptr(out),
                                      ctypes.c_int64(out_n))
    if rc != 0:
        raise ValueError("resample_linear_rows_i16 failed")
    return out.reshape(*lead, out_n)


def normalise_rms(audio: np.ndarray, target_rms: float) -> np.ndarray:
    """Native int16 RMS normalisation (one RMS over the whole array)."""
    lib = _lib_or_raise()
    audio = np.ascontiguousarray(audio, np.int16)
    out = np.empty_like(audio)
    rc = lib.normalise_rms_i16(_ptr(audio), ctypes.c_int64(audio.size),
                               ctypes.c_double(target_rms), _ptr(out))
    if rc != 0:
        raise ValueError("normalise_rms_i16 failed")
    return out


def ola_stitch(windows: np.ndarray, stride_out: int) -> np.ndarray:
    """Native Hann-taper overlap-add stitch of ``(num, w_out)`` int16 windows."""
    lib = _lib_or_raise()
    windows = np.ascontiguousarray(windows, np.int16)
    num, w_out = windows.shape
    # zeros: with stride_out > w_out the library writes only the windows'
    # spans, and the gaps must be silence
    out = np.zeros((num - 1) * stride_out + w_out, np.int16)
    rc = lib.ola_stitch_i16(_ptr(windows), ctypes.c_int64(num), ctypes.c_int64(w_out),
                            ctypes.c_int64(stride_out), _ptr(out))
    if rc != 0:
        raise ValueError("ola_stitch_i16 failed")
    return out
