"""True depthwise 1-D convolution kernel for Hopper (B4), with its launch counter.

Counterpart of ``audiojax.ops.dwconv_pallas``.  The kernel is CUDA C++ in
``csrc/dwconv.cu``, built for sm_90a by :mod:`._build` at first use and
called through ctypes on PyTorch's current stream.

B4, ``dwconv1d_cuda`` — replaces ``dwconv1d_pallas``
(``audiojax/ops/dwconv_pallas.py:52``, kernel ``_kernel``), without the TPU's
C % 128 gate, and takes ``dilation`` so that ``dwconv1d_pallas_tiled`` (B5)
can be routed to it later.  Contract (``dwconv1d_jnp``'s, plus dilation):

    x (B, T, C), w (k, C), pads (lo, hi) ≥ 0, dilation ≥ 1
    y (B, T + lo + hi - dilation·(k-1), C)
    y[b, t, c] = Σ_i x_pad[b, t + i·dilation, c] · w[i, c], in f32, taps in order

What bounds it: bytes.  At the MossFormerGAN intra shape (964, 101, 256),
k=31, the input read once and the output written once are ~200 MB, ~60 µs at
3.35 TB/s, while its 1.5 GFLOP take ~23 µs at the f32 rate.  The kernel
stages each block's halo strip in shared memory with the zero padding filled
in (no padded copy in device memory), so every input element comes from
device memory about once (the halos of neighbouring time tiles from L2), and
writes every output once.  See the note at the top of ``csrc/dwconv.cu``.

``fast_dwconv1d`` takes the plain version (``dwconv1d_plain``) only for a
tensor on the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["launches", "reset_launches", "dwconv1d_cuda", "dwconv1d_plain", "fast_dwconv1d"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
launches = {"dwconv1d": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dwconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_dwconv1d_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.ajt_dwconv1d_f32.restype = i
    lib.ajt_dwconv_error_string.argtypes = [i]
    lib.ajt_dwconv_error_string.restype = ctypes.c_char_p
    return lib


def _out_len(x: torch.Tensor, w: torch.Tensor, pads, dilation: int) -> int:
    lo, hi = pads
    if lo < 0 or hi < 0 or dilation < 1:
        raise ValueError(f"pads must be >= 0 and dilation >= 1, got {pads}, {dilation}")
    t_out = x.shape[1] + lo + hi - dilation * (w.shape[0] - 1)
    if t_out <= 0:
        raise ValueError(f"non-positive output length {t_out}")
    return t_out


def dwconv1d_plain(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                   dilation: int = 1) -> torch.Tensor:
    """Shift-and-add mirror of ``dwconv1d_jnp`` (taps in order, f32)."""
    t_out = _out_len(x, w, pads, dilation)
    xp = F.pad(x, (0, 0, pads[0], pads[1]))
    acc = xp[:, :t_out] * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + xp[:, i * dilation : i * dilation + t_out] * w[i]
    return acc


def dwconv1d_cuda(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d on the card; contract of :func:`dwconv1d_plain`."""
    for t, name, ndim in ((x, "x", 3), (w, "w", 2)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, c = x.shape
    if w.shape[1] != c or w.device != x.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)}")
    t_out = _out_len(x, w, pads, dilation)
    lib = _lib()
    y = torch.empty((b, t_out, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ajt_dwconv1d_f32(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c,
                                  w.shape[0], pads[0], pads[1], dilation, stream)
    if rc != 0:
        raise RuntimeError(f"dwconv1d launch failed: {lib.ajt_dwconv_error_string(rc).decode()} "
                           f"({rc})")
    launches["dwconv1d"] += 1
    return y


def fast_dwconv1d(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return dwconv1d_plain(x, w, pads=pads, dilation=dilation)
    return dwconv1d_cuda(x, w, pads=pads, dilation=dilation)
