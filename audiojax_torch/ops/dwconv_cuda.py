"""Depthwise (B4) and grouped 2-in/1-out (B5) 1-D convolution kernels for
Hopper, with their launch counters.

Counterpart of ``audiojax.ops.dwconv_pallas``.  Both kernels are CUDA C++ in
``csrc/dwconv.cu``, built for sm_90a by :mod:`._build` at first use and
called through ctypes on PyTorch's current stream.

B4, ``dwconv1d_cuda`` — replaces ``dwconv1d_pallas``
(``audiojax/ops/dwconv_pallas.py:52``, kernel ``_kernel``), without the TPU's
C % 128 gate, and takes ``dilation``.  Contract (``dwconv1d_jnp``'s, plus
dilation):

    x (B, T, C), w (k, C), pads (lo, hi) ≥ 0, dilation ≥ 1
    y (B, T + lo + hi - dilation·(k-1), C)
    y[b, t, c] = Σ_i x_pad[b, t + i·dilation, c] · w[i, c], in f32, taps in order

B5, ``dwconv1d_grouped_cuda`` — replaces ``dwconv1d_pallas_tiled``
(``audiojax/ops/dwconv_pallas.py:120``, kernel ``_kernel_tiled``) on the one
path that reaches it: MossFormer2-SS's grouped 2-in/1-out dilated FSMN
memory, which the TPU deinterleaves into two tiled depthwise calls
(``audiojax/nn/core.py:235-252``).  Contract (``_grouped_single_out_conv1d``'s,
``audiojax/nn/core.py:171``, with M = 2 inputs per group):

    x (B, T, M·G), w (k, M, G), pads (lo, hi) ≥ 0, dilation ≥ 1
    y (B, T + lo + hi - dilation·(k-1), G)
    y[b, t, g] = Σ_i Σ_r x_pad[b, t + i·dilation, g·M + r] · w[i, r, g]  (i outer, r inner)

The lanes of group g are interleaved, [2g, 2g+1], as torch's ``groups=``
reads them.  True depthwise convs stay on B4 at any T; the time tiling that
is B5's point on the TPU is the kernel's own tiling for both here (tiles of
at most 64 outputs for B4 and 256 for B5, the halo from L2).

What bounds both: bytes.  At the MossFormerGAN intra shape (964, 101, 256),
k=31, the input read once and the output written once are ~200 MB, ~60 µs at
3.35 TB/s, while its 1.5 GFLOP take ~23 µs at the f32 rate; B5 at
MossFormer2-SS's (4, 3999, 512→256), k=39, d=2 moves ~49 MB, ~15 µs, against
0.32 GFLOP.  The kernels stage each block's halo strip in shared memory with
the zero padding filled in (no padded copy in device memory; B5 deinterleaves
the two lanes of a group while staging), so every input element comes from
device memory about once (the halos of neighbouring time tiles from L2), and
write every output once.  See the note at the top of ``csrc/dwconv.cu``.

``fast_dwconv1d`` and ``fast_dwconv1d_grouped`` take the plain versions
(``dwconv1d_plain``, ``dwconv1d_grouped_plain``) only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["launches", "reset_launches", "dwconv1d_cuda", "dwconv1d_plain", "fast_dwconv1d",
           "dwconv1d_grouped_cuda", "dwconv1d_grouped_plain", "fast_dwconv1d_grouped"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
launches = {"dwconv1d": 0, "dwconv1d_tiled": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dwconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_dwconv1d_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.ajt_dwconv1d_f32.restype = i
    lib.ajt_dwconv1d_grouped2_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.ajt_dwconv1d_grouped2_f32.restype = i
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


def _launch(fn: str, x: torch.Tensor, w: torch.Tensor, pads, dilation: int,
            groups: int) -> torch.Tensor:
    """Check x (B, T, M·G) and w (k, [M,] G) for the kernel, launch ``fn``, return y."""
    for t, name in ((x, "x"), (w, "w")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, _ = x.shape
    t_out = _out_len(x, w, pads, dilation)
    lib = _lib()
    y = torch.empty((b, t_out, groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, groups,
                              w.shape[0], pads[0], pads[1], dilation, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.ajt_dwconv_error_string(rc).decode()} "
                           f"({rc})")
    return y


def dwconv1d_cuda(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d on the card; contract of :func:`dwconv1d_plain`."""
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2] or w.device != x.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}: expected x (B, T, C) and w (k, C)")
    y = _launch("ajt_dwconv1d_f32", x, w, pads, dilation, x.shape[2])
    launches["dwconv1d"] += 1
    return y


def fast_dwconv1d(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return dwconv1d_plain(x, w, pads=pads, dilation=dilation)
    return dwconv1d_cuda(x, w, pads=pads, dilation=dilation)


# ── B5: grouped 2-in/1-out conv1d ──────────────────────────────────────────


def dwconv1d_grouped_plain(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                           dilation: int = 1) -> torch.Tensor:
    """Shift-and-add mirror of ``_grouped_single_out_conv1d``: x (B, T, M·G),
    w (k, M, G), group g contracting input lanes [g·M, (g+1)·M); f32 products
    and sums, taps outer, lanes inner."""
    k, m, g = w.shape
    if x.ndim != 3 or x.shape[2] != m * g:
        raise ValueError(f"x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    t_out = _out_len(x, w, pads, dilation)
    xr = F.pad(x, (0, 0, pads[0], pads[1])).reshape(x.shape[0], -1, g, m)
    acc = None
    for i in range(k):
        seg = xr[:, i * dilation : i * dilation + t_out]
        for r in range(m):
            term = seg[..., r] * w[i, r]
            acc = term if acc is None else acc + term
    return acc


def dwconv1d_grouped_cuda(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                          dilation: int = 1) -> torch.Tensor:
    """Grouped 2-in/1-out conv1d on the card; contract of
    :func:`dwconv1d_grouped_plain` with M = 2."""
    if (x.ndim != 3 or w.ndim != 3 or w.shape[1] != 2 or x.shape[2] != 2 * w.shape[2]
            or w.device != x.device):
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}: the kernel takes x (B, T, 2·G) and w (k, 2, G)")
    y = _launch("ajt_dwconv1d_grouped2_f32", x, w, pads, dilation, w.shape[2])
    launches["dwconv1d_tiled"] += 1
    return y


def fast_dwconv1d_grouped(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                          dilation: int = 1) -> torch.Tensor:
    """Grouped 2-in/1-out conv1d: the plain version for a CPU tensor, the kernel
    for a CUDA one."""
    if x.device.type == "cpu":
        return dwconv1d_grouped_plain(x, w, pads=pads, dilation=dilation)
    return dwconv1d_grouped_cuda(x, w, pads=pads, dilation=dilation)
