"""Attention kernels for Hopper (B6 relu² attention, B3 rel-pos scores),
with their launch plans and launch counters.

Counterpart of ``audiojax.ops.attention_pallas``.  The kernels are CUDA C++
in ``csrc/quad_attention.cu``, ``csrc/quad_attention_bf16.cu``,
``csrc/relpos_scores.cu`` and ``csrc/relpos_scores_bf16.cu``, built for
sm_90a by :mod:`._build` at first use and called through ctypes on PyTorch's
current stream.  Their geometry (tile sizes, grid, shared memory) comes from
the plain functions ``quad_launch``, ``quad_bf16_launch``, ``relpos_launch``
and ``relpos_bf16_launch`` here; the C launchers only check it.

B6, ``quad_attention_cuda`` — replaces ``quad_attention_pallas``
(``audiojax/ops/attention_pallas.py:61``, kernel ``_kernel``).  Contract
(``quad_attention_jnp``'s):

    q, k (N, S, K), v (N, S, V), all float32  →  (N, S, V)
    out = relu(q kᵀ · scale)² v, the diagonal of the scores zeroed when mask_diag

with scores and the PV product in true float32 (no TF32), and no (N, S, S)
tensor in device memory.

What bounds it: f32 operations, N·S²·(2K + 2V): MossFormer2-SS's FLASH group
(64, 256, K 128, V 2048) is 18.25 GFLOP, 0.272 ms at 67 TFLOP/s; the GAN's
(964, 101, 128, 128) 5.0 GFLOP, 0.075 ms.  A block owns (n, 64 query rows)
and forms their relu² score tile once into shared memory (69.6 KB at S =
256), then sweeps every value tile of 128 columns against it as a SIMT SGEMM
(8 × 8 register tiles, v copied by cp.async into two buffers), two blocks an
SM.  Its sums run in key order, as cuBLAS's do: on the card it equals
``quad_attention_plain`` bit for bit.  v passes through L2 once per row
tile (0.54 GB a call at SS).

B3, ``relpos_scores_cuda`` — replaces ``relpos_scores_pallas``
(``audiojax/ops/attention_pallas.py:195``, kernel ``_relpos_kernel``).
Contract (``relpos_scores_jnp``'s, the function ZipEnhancer runs):

    q, k (N, S, H·D), pp (N, S, H·pos_stride(P)), pe (H, P, S, S), float32
    probs (N, H, S, S) = softmax_j(q kᵀ + Σ_p pp·pe) per head, in float32

In the float32 plan it is not the Pallas kernel's contract in two respects:
that kernel rounds ``pe`` to bf16 and can write bf16 probabilities; here
``pe`` stays float32, the probabilities are float32 and the softmax
subtracts its row maximum in float32.  The bf16 plan takes the Pallas
kernel's bf16 ``pe`` and bf16 probabilities (below).  q, k and pp may be lane slices of one projection (any row stride,
unit lane stride): the kernel reads them in place, with no copy.

What bounds it: bytes, mostly the (N, H, S, S) output: 0.081 ms at
ZipEnhancer's (964, 101), 0.147 ms at (404, 241), at 3.35 TB/s.  A block
owns (h, a row tile, a range of nb batch rows), copies pe[h, :, rows, :]
into shared memory once and loops over its batch rows, each one's keys,
queries and positional terms double-buffered by cp.async: P/nb + D/R floats
of pe and keys through L2 a probability instead of the first design's P +
D/R (at (404, 241): R 32, nb 101, 215 KB of shared memory, 1.04 floats
against ~4.3).  The softmax takes one reciprocal a row.  Rows over 256 keys
keep the first design's two-pass kernel.  The notes at the top of the
sources give the counts of every chosen point.

Both kernels also take bfloat16 tensors (the bf16 serving plan), with the
Pallas kernels' own bf16 contracts: B6's scores and PV product stay f32
(attn never rounded) and the output is rounded once to bf16, or kept in f32
with ``out_dtype=torch.float32``, as the bf16 layers that add a linear
attention to it take it (the JAX models' f32 einsums).  B6 bf16 runs on the
tensor cores (``csrc/quad_attention_bf16.cu``, ``quad_bf16_launch``;
:func:`quad_plan` routes by dtype): the scores by ``mma.sync.m16n8k16``
(bf16 products, f32 sums), whose accumulators become the PV product's A
fragments, each f32 score split into three bf16 terms (hi, mid, lo: exactly
the score) so that the PV product's bf16 products stay exact; B3
takes a bf16 ``pe`` (the Pallas kernel rounds its table to bf16) and writes
bf16 probabilities (the Pallas kernel's default ``out_dtype``, q's dtype),
the softmax in f32.  B3 bf16 runs on the tensor cores too
(``csrc/relpos_scores_bf16.cu``, ``relpos_bf16_launch``) where
:func:`relpos_mma_route` says so (rows of at most 256 keys, D a multiple of
8 up to 64, at most 4 terms, aligned rows: every ZipEnhancer shape): q·kᵀ by
``mma.sync.m16n8k16``, the bias Σ_p pp·pe by the same instruction with a
block-diagonal A of each query row's terms, the softmax in the fragment
layout, the probabilities staged and written as 16-byte stores; the other
bf16 calls take the two-pass kernel.  :func:`relpos_plan` is the wrapper's
plan, by that rule.  Each dtype has its own launch counter
(``quad_attention_bf16``, ``relpos_scores_bf16``); a call's tensors all have
one dtype.

``fast_quad_attention`` and ``fast_relpos_scores`` take the plain versions
(``quad_attention_plain``, ``relpos_scores_plain``) only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.  Both are registered
operators too, ``audiojax_torch::quad_attention`` and
``audiojax_torch::relpos_scores``, which ``torch.export`` graphs record (see
``_build``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

__all__ = ["launches", "reset_launches", "QuadLaunch", "quad_launch", "QuadBf16Launch",
           "quad_bf16_smem", "quad_bf16_launch", "quad_plan", "launch_quad_attention",
           "quad_attention_cuda", "quad_attention_plain", "fast_quad_attention", "pos_stride",
           "RelposLaunch", "relpos_launch", "relpos_two_pass_launch", "RelposBf16Launch",
           "relpos_bf16_smem", "relpos_mma_route", "relpos_bf16_launch", "relpos_plan",
           "launch_relpos_scores", "relpos_scores_plain",
           "relpos_scores_cuda", "fast_relpos_scores", "quad_attention_op", "relpos_scores_op"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
# Inside a CUDA graph capture (``runtime.streaming.StreamingServer(jit=True)``)
# the wrapper counts the launch it records, once; a replay launches the
# recorded kernels without the wrapper, so a graphed path's launches are
# (launches counted during its capture) × (replays).
launches = {"quad_attention": 0, "relpos_scores": 0, "quad_attention_bf16": 0,
            "relpos_scores_bf16": 0}


SMEM_MAX = 232448  # dynamic shared memory a block can have on sm_90
SMEM_SM = 233472  # shared memory of one SM; each resident block also takes 1 KB
SM_COUNT = 132


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ── B6: launch plan ────────────────────────────────────────────────────────

QUAD_WARPS = ((2, 2), (4, 2))  # (WM, WN) the kernel is built for
QUAD_DC, QUAD_JC = 16, 32  # features of q/k and keys of v staged at a time
QUAD_SB = 2  # q/k feature chunks in the ring


@dataclasses.dataclass(frozen=True)
class QuadLaunch:
    wm: int  # warps along the query rows: 32·wm rows a block
    wn: int  # warps along the value columns: 64·wn columns a tile, 64·wn keys a score block
    row_tiles: int  # ceil(S / (32·wm))
    vsplit: int  # ranges of value tiles a row tile is split into, a block each
    seg: int  # keys of the score tile held in shared memory (S rounded up to 8 where it fits)
    threads: int
    blocks: int  # N · row_tiles · vsplit
    smem: int  # bytes


def quad_smem(wm: int, wn: int, seg: int) -> int:
    """Shared-memory bytes of B6 (``smem_floats`` in ``csrc/quad_attention.cu``):
    the key-major score tile of ``seg`` keys (row stride 32·wm + 4), then the
    larger of the two stagings: q rows and keys by 16 features (row stride
    20) in a ring of 2, and two v pieces of 32 keys × 64·wn columns."""
    bm, kb = 32 * wm, 64 * wn
    return 4 * (seg * (bm + 4) + max(QUAD_SB * (bm + kb) * (QUAD_DC + 4), 2 * QUAD_JC * 64 * wn))


def quad_launch(n: int, s: int, dk: int, dv: int, *, warps: tuple[int, int] = (2, 2),
                vsplit: int | None = None) -> QuadLaunch:
    """B6's geometry for q, k (n, s, dk), v (n, s, dv).

    Warps 2 × 2 (64 rows × 128 value columns, two blocks an SM: the fastest
    or within 1.5 % of it at every served shape in
    ``attention_geometry_sweep.py``'s tables); the score tile of all keys (S rounded up to 8)
    where it fits beside the staging buffers, else key segments with one
    value tile a block.  Value tiles are split over more blocks only while
    there are fewer blocks than SMs (each block forms its score tile again)."""
    if warps not in QUAD_WARPS:
        raise ValueError(f"B6 is built for warps {QUAD_WARPS}, got {warps}")
    wm, wn = warps
    s_pad, tiles = _cdiv(s, 8) * 8, _cdiv(dv, 64 * wn)
    room = (SMEM_MAX - quad_smem(wm, wn, 0)) // (4 * (32 * wm + 4)) // 8 * 8
    seg = min(s_pad, room)
    if seg < s_pad:  # key segments: the output tile stays in registers across them
        if vsplit not in (None, tiles):
            raise ValueError(f"S = {s} takes key segments, which need vsplit = {tiles}")
        vsplit = tiles
    elif vsplit is None:
        vsplit = 1
        while vsplit < tiles and n * _cdiv(s, 32 * wm) * vsplit < SM_COUNT:
            vsplit *= 2
        vsplit = min(vsplit, tiles)
    if not 1 <= vsplit <= tiles:
        raise ValueError(f"vsplit {vsplit} outside 1..{tiles}")
    row_tiles = _cdiv(s, 32 * wm)
    return QuadLaunch(wm, wn, row_tiles, vsplit, seg, 32 * wm * wn, n * row_tiles * vsplit,
                      quad_smem(wm, wn, seg))


# ── B6 bf16: launch plan (the tensor-core kernel) ──────────────────────────

QUAD_BF16_VT = 128  # value columns a tile
QUAD_BF16_MAX_WARPS = 7  # warps a block, 16 query rows each (two blocks an SM)
QUAD_BF16_KB = (32, 64)  # keys a piece the kernel takes


@dataclasses.dataclass(frozen=True)
class QuadBf16Launch:
    warps: int  # warps of 16 query rows: 16·warps rows a block
    row_tiles: int  # ceil(S / (16·warps))
    vsplit: int  # ranges of value tiles (128 columns) a row tile is split into, a block each
    kb: int  # keys a piece (32 or 64)
    keep: bool  # the split scores kept in shared memory across the block's value tiles
    threads: int
    blocks: int  # N · row_tiles · vsplit
    smem: int  # bytes


def quad_bf16_smem(warps: int, s: int, dk: int, kb: int, keep: bool) -> int:
    """Shared-memory bytes of B6 bf16 (``smem_bytes`` in
    ``csrc/quad_attention_bf16.cu``): the q rows and two pieces' k rows at
    row stride K rounded up to 16 plus 8, two pieces' v rows at 128 + 8, and
    with ``keep`` 1,536 bytes a warp and k16 step of the pieces' keys (S
    rounded up to ``kb``)."""
    kpad = _cdiv(dk, 16) * 16
    return (2 * (16 * warps + 2 * kb) * (kpad + 8) + 4 * kb * (QUAD_BF16_VT + 8)
            + (warps * _cdiv(s, kb) * kb // 16 * 3 * 512 if keep else 0))


def quad_bf16_launch(n: int, s: int, dk: int, dv: int, *, warps: int | None = None,
                     vsplit: int | None = None, kb: int | None = None,
                     keep: bool | None = None) -> QuadBf16Launch:
    """B6 bf16's geometry for q, k (n, s, dk), v (n, s, dv).

    The picks, from ``attention_geometry_sweep.py``'s tables: one warp a 16
    query rows, all of a row's at most 112 (S = 101: 7 warps, one row tile),
    else 4 warps (64 rows).  One value tile (V ≤ 128): pieces of 32 keys, no
    split.  Several: the split scores kept (``keep``) with pieces of 64 keys,
    and the value tiles split over the largest power of two of blocks that
    still fit one wave of one block an SM (the kept scores take most of an
    SM's shared memory); without keep, split until there are two blocks an
    SM.  Where a large K leaves no room, fewer warps, smaller pieces, no
    keep; the q rows of one warp and two pieces of 32 keys must fit in
    shared memory (K up to 1,328); a larger K raises."""
    tiles = _cdiv(dv, QUAD_BF16_VT)

    def fits(w: int, b: int, kp: bool) -> bool:
        return quad_bf16_smem(w, s, dk, b, kp) <= SMEM_MAX

    if warps is None:
        groups = _cdiv(s, 16)
        warps = groups if groups <= QUAD_BF16_MAX_WARPS else 4
        while warps > 1 and not fits(warps, kb or QUAD_BF16_KB[-1], bool(keep)):
            warps -= 1
    if not 1 <= warps <= QUAD_BF16_MAX_WARPS:
        raise ValueError(f"B6 bf16 takes 1 to {QUAD_BF16_MAX_WARPS} warps, got {warps}")
    if keep is None:
        keep = tiles > 1 and fits(warps, kb or 64, True)
    if kb is None:
        kb = 64 if keep else 32
    if kb not in QUAD_BF16_KB:
        raise ValueError(f"B6 bf16 takes pieces of {QUAD_BF16_KB} keys, got {kb}")
    smem = quad_bf16_smem(warps, s, dk, kb, keep)
    if smem > SMEM_MAX:
        raise ValueError(f"B6 bf16 at S = {s}, K = {dk}, {warps} warps, {kb} keys a piece"
                         f"{', scores kept' if keep else ''} needs {smem} bytes of shared "
                         f"memory (> {SMEM_MAX})")
    row_tiles = _cdiv(s, 16 * warps)
    if vsplit is None:
        vsplit = 1
        if keep:
            while 2 * vsplit <= tiles and n * row_tiles * 2 * vsplit <= SM_COUNT:
                vsplit *= 2
        else:
            while vsplit < tiles and n * row_tiles * vsplit < 2 * SM_COUNT:
                vsplit *= 2
            vsplit = min(vsplit, tiles)
    if not 1 <= vsplit <= tiles:
        raise ValueError(f"vsplit {vsplit} outside 1..{tiles}")
    return QuadBf16Launch(warps, row_tiles, vsplit, kb, bool(keep), 32 * warps,
                          n * row_tiles * vsplit, smem)


def quad_plan(n: int, s: int, dk: int, dv: int,
              dtype: torch.dtype) -> QuadLaunch | QuadBf16Launch:
    """The route rule: float32 inputs take the float32 kernel at
    :func:`quad_launch`'s geometry, bfloat16 ones the tensor-core kernel at
    :func:`quad_bf16_launch`'s."""
    return quad_launch(n, s, dk, dv) if dtype == torch.float32 else quad_bf16_launch(n, s, dk, dv)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quad_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_quad_attention_f32.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i,
                                           i, i, ctypes.c_longlong, p]
    lib.ajt_quad_attention_f32.restype = i
    lib.ajt_quad_error_string.argtypes = [i]
    lib.ajt_quad_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bf16_lib() -> ctypes.CDLL:
    lib = _build.load("quad_attention_bf16")
    p, i = ctypes.c_void_p, ctypes.c_int
    for out in ("f32", "bf16"):
        fn = getattr(lib, f"ajt_quad_attention_bf16_{out}")
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, i,
                       ctypes.c_longlong, p]
        fn.restype = i
    lib.ajt_quad_bf16_error_string.argtypes = [i]
    lib.ajt_quad_bf16_error_string.restype = ctypes.c_char_p
    return lib


def quad_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                         mask_diag: bool = False,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Mirror of ``quad_attention_jnp``: relu(q kᵀ·scale)² v, the scores and
    the PV product in f32 (bf16 operands widened, which is exact), the result
    in ``out_dtype`` (default v's dtype; float32 keeps the f32 sums, as the
    JAX models' ``preferred_element_type=float32`` einsums do)."""
    attn = torch.square(torch.relu(torch.matmul(q.float(), k.float().transpose(1, 2)) * scale))
    if mask_diag:
        s = q.shape[1]
        attn = attn.masked_fill(torch.eye(s, dtype=torch.bool, device=q.device), 0.0)
    return torch.matmul(attn, v.float()).to(out_dtype or v.dtype)


def launch_quad_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                          scale: float, mask_diag: bool,
                          plan: QuadLaunch | QuadBf16Launch) -> None:
    """Launch B6 on checked tensors into ``out`` at ``plan``'s geometry: the
    float32 kernel at a ``QuadLaunch``, the bf16 tensor-core kernel at a
    ``QuadBf16Launch``; counts nothing (``quad_attention_cuda`` counts its
    launch)."""
    n, s, dk = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, s, dk, v.shape[-1],
            float(scale), int(mask_diag))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if isinstance(plan, QuadBf16Launch):
            lib, err = _bf16_lib(), "ajt_quad_bf16_error_string"
            fn = getattr(lib, f"ajt_quad_attention_bf16_{_build.DTYPES[out.dtype]}")
            rc = fn(*args, plan.warps, plan.row_tiles, plan.vsplit, plan.kb, int(plan.keep),
                    plan.smem, stream)
        else:
            lib, err = _lib(), "ajt_quad_error_string"
            rc = lib.ajt_quad_attention_f32(*args, plan.wm, plan.wn, plan.row_tiles, plan.vsplit,
                                            plan.seg, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"quad_attention launch failed: "
                           f"{getattr(lib, err)(rc).decode()} ({rc})")


def quad_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                        mask_diag: bool = False,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """relu² attention on the card; contract of :func:`quad_attention_plain`,
    q, k and v all float32 or all bfloat16, the output in their dtype or
    (bfloat16 inputs) float32."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _build.DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16, as q is, got {t.dtype}")
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
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    plan = quad_plan(n, s, dk, dv, q.dtype)  # raises before any launch
    out = torch.empty((n, s, dv), dtype=out_dtype, device=q.device)
    launch_quad_attention(q, k, v, out, scale, mask_diag, plan)
    _build.count(launches, "quad_attention", q.dtype)
    return out


# an operator's out_dtype argument: "" for the inputs' own dtype
_OUT_DTYPES = {"": None, "float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.library.custom_op("audiojax_torch::quad_attention", mutates_args=())
def quad_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      mask_diag: bool, out_dtype: str) -> torch.Tensor:
    """B6 as a registered operator: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    fn = quad_attention_plain if q.device.type == "cpu" else quad_attention_cuda
    return fn(q, k, v, scale=scale, mask_diag=mask_diag, out_dtype=_OUT_DTYPES[out_dtype])


@quad_attention_op.register_fake
def _(q, k, v, scale, mask_diag, out_dtype):
    return v.new_empty((*q.shape[:2], v.shape[-1]), dtype=_OUT_DTYPES[out_dtype] or v.dtype)


@register_flop_formula(torch.ops.audiojax_torch.quad_attention)
def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """The score product and the PV product."""
    n, s, dk = q_shape
    return 2 * n * s * s * (dk + v_shape[-1])


def fast_quad_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                        mask_diag: bool = False,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """relu² attention: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _build.through_ops():
        name = "" if out_dtype is None else str(out_dtype).removeprefix("torch.")
        return torch.ops.audiojax_torch.quad_attention(q, k, v, float(scale), mask_diag, name)
    if q.device.type == "cpu":
        return quad_attention_plain(q, k, v, scale=scale, mask_diag=mask_diag,
                                    out_dtype=out_dtype)
    return quad_attention_cuda(q, k, v, scale=scale, mask_diag=mask_diag, out_dtype=out_dtype)


# ── B3: rel-pos attention scores ───────────────────────────────────────────


def pos_stride(n_pos: int) -> int:
    """Lane stride of one head's slot in the packed pos-projection (a copy of
    ``audiojax.ops.attention_pallas.pos_stride``): P rounded up to 8, the slot
    tail zero-padded."""
    return -(-n_pos // 8) * 8


@dataclasses.dataclass(frozen=True)
class RelposLaunch:
    route: str  # "batched" (S <= 256) or "two_pass"
    nj: int  # keys a lane: 32·nj >= S (8 and 256-key tiles on the two-pass route)
    rows: int  # batched: query rows a block (rows / 4 warps); two-pass: 32-row groups a block
    row_tiles: int  # batched: ceil(S / rows); two-pass: row ranges a (n, h)
    nb: int  # batched: batch rows a block (1 on the two-pass route)
    chunks: int  # batched: ceil(N / nb) batch ranges (N on the two-pass route)
    threads: int
    blocks: int
    smem: int  # bytes


def relpos_smem(nj: int, rows: int, d: int, n_pos: int) -> int:
    """Shared-memory bytes of B3's batched route (``batched_bytes`` in
    ``csrc/relpos_scores.cu``): pe[h, :, rows, :] in f32 at row stride 32·nj,
    and two buffers of floats, each 32·nj keys and ``rows`` query rows (row
    stride round_up(D, 8) + 4) and rows × P positional terms, rounded up to
    16 bytes."""
    ds = _cdiv(d, 8) * 8 + 4
    buf = _cdiv(((32 * nj + rows) * ds + rows * n_pos) * 4, 16) * 16
    return 4 * n_pos * rows * 32 * nj + 2 * buf


def _two_pass_smem(d: int, n_pos: int) -> int:
    """``keys_floats(8, D) + 32 (D + P)`` floats of ``relpos_tiled_kernel``."""
    return 4 * (_cdiv(d * 257, 4) * 4 + 32 * (d + n_pos))


def relpos_launch(n: int, s: int, h: int, d: int, n_pos: int, *, rows: int | None = None,
                  nb: int | None = None) -> RelposLaunch:
    """B3's float32 geometry for q, k (n, s, h·d) and pe (h, P, s, s).

    Rows of at most 256 keys take the batched route: row tiles of at most 32
    rows, balanced (S = 51 → 2 tiles of 28), of 16 rows at 65–128 keys (three
    blocks an SM; the fastest at ZipEnhancer's S = 101 and 121 in
    ``attention_geometry_sweep.py``'s tables), fewer where the shared memory
    needs it; the batch split so that the blocks fill one wave of the SMs at
    the blocks an SM that the shared memory allows, each block staging its pe
    rows once for nb batch rows.  Longer rows, or rows whose pe tile does not
    fit, take the two-pass route."""
    if s <= 256:
        nj = 1 << max(0, (_cdiv(s, 32) - 1).bit_length())
        r = rows if rows is not None else 16 if nj == 4 else _cdiv(_cdiv(s, _cdiv(s, 32)), 4) * 4
        if r % 4 or not 4 <= r <= 32:
            raise ValueError(f"rows {r}: a multiple of 4 from 4 to 32")
        while rows is None and r > 4 and relpos_smem(nj, r, d, n_pos) > SMEM_MAX:
            r -= 4
        smem = relpos_smem(nj, r, d, n_pos)
        if smem <= SMEM_MAX:
            row_tiles = _cdiv(s, r)
            per_sm = max(1, min(SMEM_SM // (smem + 1024), 2048 // (8 * r)))
            if nb is None:
                nb = _cdiv(n, max(1, min(n, SM_COUNT * per_sm // (h * row_tiles))))
            chunks = _cdiv(n, nb)
            return RelposLaunch("batched", nj, r, row_tiles, nb, chunks, 8 * r,
                                h * row_tiles * chunks, smem)
        if rows is not None:
            raise ValueError(f"rows {rows}: {smem} bytes of shared memory, more than {SMEM_MAX}")
    return relpos_two_pass_launch(n, s, h, d, n_pos)


def relpos_two_pass_launch(n: int, s: int, h: int, d: int, n_pos: int) -> RelposLaunch:
    """The first design's route (``relpos_tiled_kernel``, any S, float32 or
    bfloat16): a row's 32-row groups split over several blocks only while
    there are too few (n, h) pairs to fill the card."""
    groups = _cdiv(s, 32)
    per_chunk = _cdiv(groups, _cdiv(4096, n * h))
    chunks = _cdiv(groups, per_chunk)
    return RelposLaunch("two_pass", 8, per_chunk, chunks, 1, n, 256, n * h * chunks,
                        _two_pass_smem(d, n_pos))


# ── B3 bf16: launch plan (the tensor-core kernel) ──────────────────────────

RELPOS_BF16_TILES = 8  # 8-key tiles a warp at most (32 f32 scores a thread)
RELPOS_BF16_MAX_WARPS = 16
RELPOS_BF16_MAX_S = 256
RELPOS_BF16_MAX_D = 64
RELPOS_BF16_MAX_P = 4


@dataclasses.dataclass(frozen=True)
class RelposBf16Launch:
    wr: int  # row groups of 16 query rows a block
    kw: int  # warps a row group, each ceil(ceil(S / 8) / kw) ≤ 8 tiles of 8 of its keys
    row_tiles: int  # ceil(S / (16·wr))
    nb: int  # batch rows a block
    chunks: int  # ceil(N / nb)
    threads: int  # 32·wr·kw
    blocks: int  # H · row_tiles · chunks
    smem: int  # bytes


def relpos_bf16_smem(wr: int, kw: int, s: int, d: int) -> int:
    """Shared-memory bytes of B3 bf16 (``smem_bytes`` in
    ``csrc/relpos_scores_bf16.cu``): the pe rows (128 bytes a key and row
    group), two buffers of the keys (S rounded up to 8) and 16·wr query rows
    at row stride D rounded up to 16 plus 8 and their 4 terms, the output
    stage (16·wr rows of S and 8 elements of slack, rounded up to 16 bytes),
    and the row exchange (128 bytes a warp)."""
    s8, rows = _cdiv(s, 8) * 8, 16 * wr
    buf = 2 * ((s8 + rows) * (_cdiv(d, 16) * 16 + 8) + rows * 4)
    out = _cdiv(2 * (rows * s + 8), 16) * 16
    return 128 * wr * s8 + 2 * buf + out + 128 * wr * kw


def relpos_mma_route(s: int, d: int, n_pos: int, pstride: int, ldq: int, ldk: int, ldpp: int,
                     aligned: bool) -> bool:
    """The route rule of a bf16 call: the tensor-core kernel
    (``csrc/relpos_scores_bf16.cu``) takes rows of at most 256 keys, D a
    multiple of 8 up to 64, at most 4 terms in a slot whose stride is a
    multiple of 4, q and k rows on 16 bytes and pp rows on 8 (``ldq``,
    ``ldk`` multiples of 8, ``ldpp`` of 4, ``aligned``: q and k 16-byte and
    pp 8-byte aligned): every ZipEnhancer shape.  Every other bf16 call takes
    the two-pass kernel (``relpos_tiled_kernel``)."""
    return (s <= RELPOS_BF16_MAX_S and d % 8 == 0 and d <= RELPOS_BF16_MAX_D
            and n_pos <= RELPOS_BF16_MAX_P and pstride % 4 == 0 and ldq % 8 == 0
            and ldk % 8 == 0 and ldpp % 4 == 0 and aligned)


def relpos_bf16_launch(n: int, s: int, h: int, d: int, n_pos: int, *, wr: int | None = None,
                       kw: int | None = None, nb: int | None = None) -> RelposBf16Launch:
    """B3 bf16's geometry for q, k (n, s, h·d) and pe (h, P, s, s).

    A row group's keys split over the fewest warps that hold at most 8 tiles
    of 8 keys each (S = 101: 2, S = 241: 4).  All of a row's 16-row groups
    in one block where they fit 16 warps and the shared memory (S = 101: 7
    row groups, 14 warps), else the fewest row tiles that fit, balanced.
    The batch split so that the blocks fill one wave of the SMs at the
    blocks an SM that the shared memory allows, at least two batch rows a
    block, each block staging its pe rows once for its nb batch rows (the
    fastest or within 11 % of it at every served shape in
    ``attention_geometry_sweep.py``'s tables)."""
    if not (s <= RELPOS_BF16_MAX_S and d % 8 == 0 and d <= RELPOS_BF16_MAX_D
            and 1 <= n_pos <= RELPOS_BF16_MAX_P):
        raise ValueError(f"no B3 bf16 tensor-core plan for S {s}, D {d}, P {n_pos}")
    tiles = _cdiv(s, 8)
    kw = _cdiv(tiles, RELPOS_BF16_TILES) if kw is None else kw
    if kw < 1 or _cdiv(tiles, kw) > RELPOS_BF16_TILES:
        raise ValueError(f"{kw} warps a row group hold more than {RELPOS_BF16_TILES} tiles of "
                         f"8 keys at S = {s}")
    if wr is None:
        groups = _cdiv(s, 16)
        wr = max(1, min(groups, RELPOS_BF16_MAX_WARPS // kw))
        while wr > 1 and relpos_bf16_smem(wr, kw, s, d) > SMEM_MAX:
            wr -= 1
        wr = _cdiv(groups, _cdiv(groups, wr))  # balanced row tiles
    if not 1 <= wr * kw <= RELPOS_BF16_MAX_WARPS:
        raise ValueError(f"B3 bf16 takes 1 to {RELPOS_BF16_MAX_WARPS} warps a block, got "
                         f"{wr} row groups × {kw}")
    smem = relpos_bf16_smem(wr, kw, s, d)
    if smem > SMEM_MAX:
        raise ValueError(f"B3 bf16 at S = {s}, D = {d}, {wr} row groups needs {smem} bytes of "
                         f"shared memory (> {SMEM_MAX})")
    row_tiles, threads = _cdiv(s, 16 * wr), 32 * wr * kw
    per_sm = max(1, min(SMEM_SM // (smem + 1024), 2048 // threads))
    if nb is None:
        nb = max(min(n, 2), _cdiv(n, max(1, min(n, SM_COUNT * per_sm // (h * row_tiles)))))
    if nb < 1:
        raise ValueError(f"batch rows a block must be >= 1, got {nb}")
    chunks = _cdiv(n, nb)
    return RelposBf16Launch(wr, kw, row_tiles, nb, chunks, threads, h * row_tiles * chunks,
                            smem)


def relpos_plan(n: int, s: int, h: int, d: int, n_pos: int, dtype: torch.dtype, *,
                mma: bool = True) -> RelposLaunch | RelposBf16Launch:
    """The wrappers' plan: float32 takes :func:`relpos_launch`'s; bfloat16
    the tensor-core kernel's where the route rule (``mma``, from
    :func:`relpos_mma_route`) allows, else the two-pass kernel's."""
    if dtype == torch.float32:
        return relpos_launch(n, s, h, d, n_pos)
    if mma:
        return relpos_bf16_launch(n, s, h, d, n_pos)
    return relpos_two_pass_launch(n, s, h, d, n_pos)


@functools.cache
def _relpos_lib() -> ctypes.CDLL:
    lib = _build.load("relpos_scores")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ajt_relpos_batched_f32.argtypes = [p, p, p, p, p] + [i] * 6 + [ll] * 3 + [i] * 3 + [ll, p]
    lib.ajt_relpos_batched_f32.restype = i
    for dt in _build.DTYPES.values():
        two_pass = getattr(lib, f"ajt_relpos_two_pass_{dt}")
        two_pass.argtypes = [p, p, p, p, p] + [i] * 6 + [ll] * 3 + [i, ll, p]
        two_pass.restype = i
    lib.ajt_relpos_error_string.argtypes = [i]
    lib.ajt_relpos_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _relpos_bf16_lib() -> ctypes.CDLL:
    lib = _build.load("relpos_scores_bf16")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ajt_relpos_mma_bf16.argtypes = [p, p, p, p, p] + [i] * 6 + [ll] * 3 + [i] * 5 + [ll, p]
    lib.ajt_relpos_mma_bf16.restype = i
    lib.ajt_relpos_bf16_error_string.argtypes = [i]
    lib.ajt_relpos_bf16_error_string.restype = ctypes.c_char_p
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
    """Mirror of ``relpos_scores_jnp``: softmax(q kᵀ + Σ_p pp·pe) per head,
    in f32 (bf16 operands widened, which is exact), the probabilities in q's
    dtype."""
    n, s, _ = q.shape
    h, d, n_pos, stride = _relpos_heads(q, pp, pe, num_heads)
    qh, kh = q.float().reshape(n, s, h, d), k.float().reshape(n, s, h, d)
    pph = pp.float().reshape(n, s, h, stride)[..., :n_pos]
    scores = torch.einsum("nihd,njhd->nhij", qh, kh)
    scores = scores + torch.einsum("nihp,hpij->nhij", pph, pe.float())
    return torch.softmax(scores, dim=-1).to(q.dtype)


def _rows(t: torch.Tensor, name: str, n: int, s: int, width: int, dtype: torch.dtype) -> int:
    """The row stride of an (n, s, width) CUDA tensor of ``dtype`` whose rows
    are evenly spaced with unit lane stride (a lane slice of a contiguous
    tensor is), or raise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or dtype not in _build.DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, as q is, got {t.dtype}")
    if tuple(t.shape) != (n, s, width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, s, width)}")
    ld = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != s * ld or ld < width:
        raise ValueError(f"{name} must have unit lane stride and evenly spaced rows, "
                         f"got strides {t.stride()}")
    return ld


def launch_relpos_scores(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor,
                         out: torch.Tensor, num_heads: int,
                         plan: RelposLaunch | RelposBf16Launch) -> None:
    """Launch B3 on checked tensors into ``out`` at ``plan``'s geometry: the
    bf16 tensor-core kernel at a ``RelposBf16Launch``, else the float32
    batched kernel or the two-pass kernel of q's dtype; counts nothing
    (``relpos_scores_cuda`` counts its launch)."""
    n, s, _ = q.shape
    h, d, n_pos, stride = _relpos_heads(q, pp, pe, num_heads)
    args = (q.data_ptr(), k.data_ptr(), pp.data_ptr(), pe.data_ptr(), out.data_ptr(), n, s, h, d,
            n_pos, stride, q.stride(1), k.stride(1), pp.stride(1))
    dt = _build.DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if isinstance(plan, RelposBf16Launch):
            lib, err = _relpos_bf16_lib(), "ajt_relpos_bf16_error_string"
            rc = lib.ajt_relpos_mma_bf16(*args, plan.wr, plan.kw, plan.row_tiles, plan.nb,
                                         plan.chunks, plan.smem, stream)
        else:
            lib, err = _relpos_lib(), "ajt_relpos_error_string"
            if plan.route == "batched":
                rc = lib.ajt_relpos_batched_f32(*args, plan.nj, plan.rows, plan.nb, plan.smem,
                                                stream)
            else:
                rc = getattr(lib, f"ajt_relpos_two_pass_{dt}")(*args, plan.rows, plan.smem,
                                                               stream)
    if rc != 0:
        raise RuntimeError(f"relpos_scores launch failed: "
                           f"{getattr(lib, err)(rc).decode()} ({rc})")


def relpos_scores_cuda(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, *,
                       num_heads: int) -> torch.Tensor:
    """Rel-pos attention scores on the card; contract of :func:`relpos_scores_plain`,
    q, k, pp and pe all float32 or all bfloat16.

    The float32 kernel copies 4 elements at a time where the rows of q and
    k allow it, else 1, so a tensor's own alignment is all it needs; a
    bfloat16 call takes the tensor-core kernel or the two-pass kernel by
    :func:`relpos_mma_route`, from its shape, strides and alignment.
    Shapes, dtypes, devices and row strides are checked here."""
    if q.ndim != 3 or pp.ndim != 3 or pe.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)}, pp {tuple(pp.shape)} and pe {tuple(pe.shape)} "
                         "must have ranks 3, 3 and 4")
    n, s, hd = q.shape
    h, d, n_pos, stride = _relpos_heads(q, pp, pe, num_heads)
    _rows(q, "q", n, s, hd, q.dtype)
    _rows(k, "k", n, s, hd, q.dtype)
    _rows(pp, "pp", n, s, h * stride, q.dtype)
    if pe.device.type != "cuda" or pe.dtype != q.dtype or not pe.is_contiguous():
        raise ValueError(f"pe must be a contiguous CUDA tensor of q's dtype {q.dtype}, got "
                         f"{pe.dtype} on {pe.device}")
    if tuple(pe.shape[2:]) != (s, s) or not q.device == k.device == pp.device == pe.device:
        raise ValueError(f"pe {tuple(pe.shape)} on {pe.device} does not fit q {tuple(q.shape)} "
                         f"on {q.device}")
    aligned = q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and pp.data_ptr() % 8 == 0
    mma = relpos_mma_route(s, d, n_pos, stride, q.stride(1), k.stride(1), pp.stride(1), aligned)
    plan = relpos_plan(n, s, h, d, n_pos, q.dtype, mma=mma)
    out = torch.empty((n, h, s, s), dtype=q.dtype, device=q.device)
    launch_relpos_scores(q, k, pp, pe, out, h, plan)
    _build.count(launches, "relpos_scores", q.dtype)
    return out


@torch.library.custom_op("audiojax_torch::relpos_scores", mutates_args=())
def relpos_scores_op(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """B3 as a registered operator: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    fn = relpos_scores_plain if q.device.type == "cpu" else relpos_scores_cuda
    return fn(q, k, pp, pe, num_heads=num_heads)


@relpos_scores_op.register_fake
def _(q, k, pp, pe, num_heads):
    return q.new_empty((q.shape[0], num_heads, q.shape[1], q.shape[1]))


@register_flop_formula(torch.ops.audiojax_torch.relpos_scores)
def _(q_shape, k_shape, pp_shape, pe_shape, num_heads, *args, out_shape=None, **kwargs) -> int:
    """A probability: the D-term dot product, the P-term bias, max, subtract,
    exp, sum and divide."""
    d, n_pos = q_shape[-1] // num_heads, pe_shape[1]
    return math.prod(out_shape) * (2 * d + 2 * n_pos + 5)


def fast_relpos_scores(q: torch.Tensor, k: torch.Tensor, pp: torch.Tensor, pe: torch.Tensor, *,
                       num_heads: int) -> torch.Tensor:
    """Rel-pos attention scores: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _build.through_ops():
        return torch.ops.audiojax_torch.relpos_scores(q, k, pp, pe, num_heads)
    if q.device.type == "cpu":
        return relpos_scores_plain(q, k, pp, pe, num_heads=num_heads)
    return relpos_scores_cuda(q, k, pp, pe, num_heads=num_heads)
