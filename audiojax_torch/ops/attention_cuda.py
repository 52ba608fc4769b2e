"""Attention kernels for Hopper (B6 relu² attention, B3 rel-pos scores),
with their launch counters.

Counterpart of ``audiojax.ops.attention_pallas``.  The kernels are CUDA C++
in ``csrc/quad_attention.cu`` and ``csrc/relpos_scores.cu``, built for sm_90a
by :mod:`._build` at first use and called through ctypes on PyTorch's current
stream.

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

B3, ``relpos_scores_cuda`` — replaces ``relpos_scores_pallas``
(``audiojax/ops/attention_pallas.py:195``, kernel ``_relpos_kernel``).
Contract (``relpos_scores_jnp``'s, the function ZipEnhancer runs):

    q, k (N, S, H·D), pp (N, S, H·pos_stride(P)), pe (H, P, S, S), float32
    probs (N, H, S, S) = softmax_j(q kᵀ + Σ_p pp·pe) per head, in float32

It is not the Pallas kernel's contract in two respects: that kernel rounds
``pe`` to bf16 and can write bf16 probabilities; here ``pe`` stays float32,
the probabilities are float32 and the softmax subtracts its row maximum in
float32.  q, k and pp may be lane slices of one projection (any row stride,
unit lane stride): the kernel reads them in place, with no copy.

What bounds it: bytes, mostly the (N, H, S, S) output.  At ZipEnhancer's
(964, 101) the output is 157 MB and q/k/pp ~112 MB, ~0.08 ms at 3.35 TB/s,
against ~3 GFLOP, ~0.045 ms at 67 TFLOP/s.  The kernel keeps a head's keys in
shared memory and each row of scores in registers, and writes only the
probabilities (see the note at the top of the source).

``fast_quad_attention`` and ``fast_relpos_scores`` take the plain versions
(``quad_attention_plain``, ``relpos_scores_plain``) only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["launches", "reset_launches", "quad_attention_cuda", "quad_attention_plain",
           "fast_quad_attention", "pos_stride", "relpos_scores_plain", "relpos_scores_cuda",
           "fast_relpos_scores"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
launches = {"quad_attention": 0, "relpos_scores": 0}


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


# ── B3: rel-pos attention scores ───────────────────────────────────────────


def pos_stride(n_pos: int) -> int:
    """Lane stride of one head's slot in the packed pos-projection (a copy of
    ``audiojax.ops.attention_pallas.pos_stride``): P rounded up to 8, the slot
    tail zero-padded."""
    return -(-n_pos // 8) * 8


@functools.cache
def _relpos_lib() -> ctypes.CDLL:
    lib = _build.load("relpos_scores")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ajt_relpos_scores_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll, p]
    lib.ajt_relpos_scores_f32.restype = i
    lib.ajt_relpos_error_string.argtypes = [i]
    lib.ajt_relpos_error_string.restype = ctypes.c_char_p
    return lib


def _relpos_heads(q: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, num_heads: int):
    """(H, D, P, slot stride) of a rel-pos scores call, or raise."""
    h, n_pos = pe.shape[0], pe.shape[1]
    if num_heads != h or q.shape[-1] % h or pp.shape[-1] % h:
        raise ValueError(f"num_heads {num_heads}, q {tuple(q.shape)}, pp {tuple(pp.shape)} and "
                         f"pe {tuple(pe.shape)} do not fit")
    stride = pp.shape[-1] // h
    if n_pos > stride:
        raise ValueError(f"pe has {n_pos} positional terms a head, pp's slot holds {stride}")
    return h, q.shape[-1] // h, n_pos, stride


def relpos_scores_plain(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, *,
                        num_heads: int) -> torch.Tensor:
    """Mirror of ``relpos_scores_jnp``: softmax(q kᵀ + Σ_p pp·pe) per head."""
    n, s, _ = q.shape
    h, d, n_pos, stride = _relpos_heads(q, pp, pe, num_heads)
    qh, kh = q.reshape(n, s, h, d), k.reshape(n, s, h, d)
    pph = pp.reshape(n, s, h, stride)[..., :n_pos]
    scores = torch.einsum("nihd,njhd->nhij", qh, kh)
    scores = scores + torch.einsum("nihp,hpij->nhij", pph, pe)
    return torch.softmax(scores, dim=-1)


def _rows(t: torch.Tensor, name: str, n: int, s: int, width: int) -> int:
    """The row stride of an (n, s, width) float32 CUDA tensor whose rows are
    evenly spaced with unit lane stride (a lane slice of a contiguous tensor
    is), or raise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (n, s, width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, s, width)}")
    ld = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != s * ld or ld < width:
        raise ValueError(f"{name} must have unit lane stride and evenly spaced rows, "
                         f"got strides {t.stride()}")
    return ld


def relpos_scores_cuda(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, *,
                       num_heads: int) -> torch.Tensor:
    """Rel-pos attention scores on the card; contract of :func:`relpos_scores_plain`.

    The kernel loads scalars, so a float32 tensor's own alignment is all it
    needs; shapes, dtypes, devices and row strides are checked here."""
    if q.ndim != 3 or pp.ndim != 3 or pe.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)}, pp {tuple(pp.shape)} and pe {tuple(pe.shape)} "
                         "must have ranks 3, 3 and 4")
    n, s, hd = q.shape
    h, d, n_pos, stride = _relpos_heads(q, pp, pe, num_heads)
    ldq = _rows(q, "q", n, s, hd)
    ldk = _rows(k, "k", n, s, hd)
    ldpp = _rows(pp, "pp", n, s, h * stride)
    if pe.device.type != "cuda" or pe.dtype != torch.float32 or not pe.is_contiguous():
        raise ValueError(f"pe must be a contiguous float32 CUDA tensor, got {pe.dtype} on "
                         f"{pe.device}")
    if tuple(pe.shape[2:]) != (s, s) or not q.device == k.device == pp.device == pe.device:
        raise ValueError(f"pe {tuple(pe.shape)} on {pe.device} does not fit q {tuple(q.shape)} "
                         f"on {q.device}")
    lib = _relpos_lib()
    out = torch.empty((n, h, s, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ajt_relpos_scores_f32(q.data_ptr(), k.data_ptr(), pp.data_ptr(), pe.data_ptr(),
                                       out.data_ptr(), n, s, h, d, n_pos, stride, ldq, ldk, ldpp,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"relpos_scores launch failed: "
                           f"{lib.ajt_relpos_error_string(rc).decode()} ({rc})")
    launches["relpos_scores"] += 1
    return out


def fast_relpos_scores(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, *,
                       num_heads: int) -> torch.Tensor:
    """Rel-pos attention scores: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return relpos_scores_plain(q, k, pp, pe, num_heads=num_heads)
    return relpos_scores_cuda(q, k, pp, pe, num_heads=num_heads)
