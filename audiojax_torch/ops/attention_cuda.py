"""Fused relu² quadratic attention kernel for Hopper (B6), with its launch counter.

Counterpart of ``audiojax.ops.attention_pallas`` (the rel-pos scores kernel,
B3, joins this module with the ZipEnhancer slice).  The kernel is CUDA C++
in ``csrc/quad_attention.cu``, built for sm_90a by :mod:`._build` at first use
and called through ctypes on PyTorch's current stream.

B6, ``quad_attention_cuda`` — replaces ``quad_attention_pallas``
(``audiojax/ops/attention_pallas.py:61``, kernel ``_kernel``).  Contract
(``quad_attention_jnp``'s):

    q, k (N, S, K), v (N, S, V), all float32  →  (N, S, V)
    out = relu(q kᵀ · scale)² v, the diagonal of the scores zeroed when mask_diag

with scores and the PV product in true float32 (no TF32), and no (N, S, S)
tensor in device memory.

What bounds it: f32 operations.  At the MossFormerGAN GAU shapes,
(964, 101, K=V=128) does N·S²·(2K+2V) ≈ 5.0 GFLOP, ~75 µs at 67 TFLOP/s,
against ~200 MB read and written, ~60 µs at 3.35 TB/s; the cross shape
(404, 241) does ≈ 12 GFLOP, ~179 µs.  The kernel keeps each block's query
tile, the key and value tiles and the score tile in shared memory, and the
output tile in registers (see the note at the top of the source).

``fast_quad_attention`` takes the plain version (``quad_attention_plain``)
only for a tensor on the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["launches", "reset_launches", "quad_attention_cuda", "quad_attention_plain",
           "fast_quad_attention"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
launches = {"quad_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quad_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_quad_attention_f32.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
    lib.ajt_quad_attention_f32.restype = i
    lib.ajt_quad_error_string.argtypes = [i]
    lib.ajt_quad_error_string.restype = ctypes.c_char_p
    return lib


def quad_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                         mask_diag: bool = False) -> torch.Tensor:
    """Mirror of ``quad_attention_jnp``: relu(q kᵀ·scale)² v."""
    attn = torch.square(torch.relu(torch.matmul(q, k.transpose(1, 2)) * scale))
    if mask_diag:
        s = q.shape[1]
        attn = attn.masked_fill(torch.eye(s, dtype=torch.bool, device=q.device), 0.0)
    return torch.matmul(attn, v)


def quad_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                        mask_diag: bool = False) -> torch.Tensor:
    """relu² attention on the card; contract of :func:`quad_attention_plain`."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must have rank 3, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, s, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:2] != (n, s) or not q.device == k.device == v.device:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if dk % 4 or dv % 4:
        raise ValueError(f"the kernel takes K and V that are multiples of 4, got {dk}, {dv}")
    lib = _lib()
    out = torch.empty((n, s, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ajt_quad_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        n, s, dk, dv, float(scale), int(mask_diag), stream)
    if rc != 0:
        raise RuntimeError(f"quad_attention launch failed: "
                           f"{lib.ajt_quad_error_string(rc).decode()} ({rc})")
    launches["quad_attention"] += 1
    return out


def fast_quad_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                        mask_diag: bool = False) -> torch.Tensor:
    """relu² attention: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return quad_attention_plain(q, k, v, scale=scale, mask_diag=mask_diag)
    return quad_attention_cuda(q, k, v, scale=scale, mask_diag=mask_diag)
