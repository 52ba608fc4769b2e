"""Fused STFT / ISTFT kernels for Hopper, with their launch counters.

Counterpart of ``audiojax.ops.stft_pallas``.  The kernels are CUDA C++ in
``csrc/stft.cu``, built for sm_90a by :mod:`._build` at first use and called
through ctypes on PyTorch's current stream.

B1, ``stft_packed_cuda`` — replaces ``stft_packed_pallas``
(``audiojax/ops/stft_pallas.py:207``, kernels ``_kernel`` and
``_kernel_kchunk``).  Centre padding stays a torch op before the launch; the
kernel frames and multiplies by the windowed DFT basis in one pass, so the
(B, T, n_fft) frame tensor never reaches device memory.

B2, ``istft_packed_cuda`` — replaces ``istft_packed_pallas``
(``audiojax/ops/stft_pallas.py:361``, kernels ``_ikernel`` and
``_ikernel_kchunk``).  The kernel fuses the iDFT product with the
overlap-add: each block owns a tile of output hop-rows and sums the frames
that cover them, so each output is written once and no atomics are needed.
The COLA reciprocal and the centre / ``out_length`` trim run as torch ops on
the kernel's raw output.

What bounds them: the functions themselves are bound by their traffic.  At
the GTCRN serving shape (16 windows of 32000 samples) each reads and writes
about 6 MB, about 2 µs at the H100's 3.35 TB/s, while an FFT's operations
take a fraction of that.  These kernels compute the DFT as a dense product
instead, 1.06 GFLOP per direction, so their own floor is the card's float32
(non-tensor-core) rate, about 16 µs; TF32 tensor cores would lose the int16
contract's precision.  They keep their tiles in shared memory and registers,
accumulate 32-term chunks with plain FMA and add the chunk partials with
Kahan compensation (see the note at the top of ``csrc/stft.cu``).  PERF.md
has their times against both.

Each wrapper takes the plain PyTorch version (``dsp.stft``) only for a tensor
on the CPU.  A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..dsp.stft import StftConfig, _out_end, inv_win_sum, istft_basis, pad_center, stft_basis
from ..dsp.stft import istft_packed as plain_istft_packed
from ..dsp.stft import stft_packed as plain_stft_packed
from . import _build

__all__ = [
    "launches",
    "reset_launches",
    "stft_packed_cuda",
    "istft_packed_cuda",
    "fast_stft_packed",
    "fast_istft_packed",
    "plain_stft_packed",
    "plain_istft_packed",
]

# Kernel launches since the last reset, by kernel name.  Each wrapper adds one
# where it launches its kernel, and nowhere else.
launches = {"stft_packed": 0, "istft_packed": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_stft_packed_f32.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.ajt_stft_packed_f32.restype = i
    lib.ajt_istft_raw_f32.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.ajt_istft_raw_f32.restype = i
    lib.ajt_error_string.argtypes = [i]
    lib.ajt_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ajt_error_string(rc).decode()} ({rc})")


def stft_packed_cuda(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(B, L) float32 CUDA → packed (B, T, 2F); contract of ``dsp.stft_packed``."""
    _check(x, "x", 2)
    lib = _lib()
    xp = pad_center(x, cfg).contiguous()
    b, lpad = xp.shape
    if lpad < cfg.n_fft:
        raise ValueError(f"input too short for STFT: {lpad} < n_fft={cfg.n_fft}")
    n_t = (lpad - cfg.n_fft) // cfg.hop + 1
    f2 = 2 * cfg.f_bins
    basis = stft_basis(cfg, x.device)
    out = torch.empty((b, n_t, f2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ajt_stft_packed_f32(xp.data_ptr(), basis.data_ptr(), out.data_ptr(), b, lpad,
                                     n_t, cfg.n_fft, cfg.hop, f2, stream)
    _raise_on(lib, rc, "stft_packed")
    launches["stft_packed"] += 1
    return out


def istft_packed_cuda(spec: torch.Tensor, cfg: StftConfig,
                      out_length: int | None = None) -> torch.Tensor:
    """Packed (B, T, 2F) float32 CUDA → (B, L_out); contract of ``dsp.istft_packed``."""
    _check(spec, "spec", 3)
    b, n_t, f2 = spec.shape
    if f2 != 2 * cfg.f_bins:
        raise ValueError(f"spec has {f2} packed bins, config needs {2 * cfg.f_bins}")
    k_seg = -(-cfg.n_fft // cfg.hop)
    n_rows = n_t + k_seg - 1
    raw_len = cfg.n_fft + cfg.hop * (n_t - 1)
    start = cfg.half if cfg.center else 0
    end = _out_end(cfg, n_t, raw_len, out_length)  # raises before any launch
    lib = _lib()
    ibasis = istft_basis(cfg, spec.device)
    raw = torch.empty((b, n_rows * cfg.hop), dtype=torch.float32, device=spec.device)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.ajt_istft_raw_f32(spec.data_ptr(), ibasis.data_ptr(), raw.data_ptr(), b, n_t,
                                   cfg.n_fft, cfg.hop, f2, stream)
    _raise_on(lib, rc, "istft_packed")
    launches["istft_packed"] += 1
    return raw[:, start:end] * inv_win_sum(cfg, n_t, out_length, spec.device)


def fast_stft_packed(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """STFT: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return plain_stft_packed(x, cfg)
    return stft_packed_cuda(x, cfg)


def fast_istft_packed(spec: torch.Tensor, cfg: StftConfig,
                      out_length: int | None = None) -> torch.Tensor:
    """ISTFT: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if spec.device.type == "cpu":
        return plain_istft_packed(spec, cfg, out_length)
    return istft_packed_cuda(spec, cfg, out_length)
