"""Depthwise (B4) and grouped 2-in/1-out (B5) 1-D convolution kernels for
Hopper, with their launch counters.

Counterpart of ``audiojax.ops.dwconv_pallas``.  Both kernels are CUDA C++ in
``csrc/dwconv.cu`` (FFMA, float32 and bf16) and ``csrc/dwconv_bf16.cu``
(bf16 on the tensor cores), built for sm_90a by :mod:`._build` at first use
and called through ctypes on PyTorch's current stream.

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
reads them.

B4 and B5 bf16 on the tensor cores (``csrc/dwconv_bf16.cu``,
``dwconv_mma_launch``) — the bf16 serving plan's depthwise and grouped
convs: where :func:`mma_route` says so (bf16, C % 8 == 0 input lanes and x
16-byte aligned, k ≤ 49: every served shape), a channel's (B5: a lane's) 16
consecutive outputs are a Toeplitz matrix of its taps times a column of its
input, one ``mma.sync.m16n8k16`` a 16-position step of the window, 8 output
tiles of 16 its 8 columns; the window is staged channel-last by cp.async
and turned time-contiguous by ldmatrix.trans and stmatrix; B5 adds a
group's two lanes in f32 before the one rounding.  Same contracts, same
launch counters (``dwconv1d_bf16``, ``dwconv1d_tiled_bf16``); the other bf16
calls (C % 8 != 0, an unaligned x, longer kernels) keep the FFMA kernel's
bf16 instances.  :func:`dwconv_plan` is the wrappers' plan, by that rule.

Both FFMA kernels take float32 or bfloat16 (the bf16 serving plan; the dtype
``dwconv1d_pallas_tiled`` is only ever called with), x and w of one dtype
(the Pallas kernels raise on a mismatch, ``dwconv_pallas.py:67-68,144-145``,
and so do these); in bf16 the products and sums are the same f32 chain and
each output is rounded once to bf16, to nearest even.  Each dtype has its own
launch counter (``dwconv1d_bf16``, ``dwconv1d_tiled_bf16``).  True depthwise convs stay on B4 at any T.  Both wrappers take x
contiguous and w through its strides: the model's (C, 1, k) and (G, 2, k)
weights arrive as the views ``w[:, 0, :].t()`` and ``w.permute(2, 1, 0)``,
uncopied.

What bounds both: bytes.  At the MossFormerGAN intra shape (964, 98, 256),
k=31, the input read once and the output written once are ~194 MB, 57.8 µs
at 3.35 TB/s, while its 1.5 GFLOP take ~22 µs at the f32 rate; B5 at
MossFormer2-SS's (4, 3999, 512→256), k=39, d=2 moves ~49 MB, ~15 µs, against
0.32 GFLOP.  So the FMA loop has to run under the loads.  A block walks
several work items of one channel tile (a whole batch row where T_out ≤ 256,
else consecutive time tiles of one row with the halo carried over), with
item n+1's strip in flight by cp.async while item n computes; each thread
slides a register window of R strip rows over all k taps, one new row and
one tap vector a tap for R output vectors (2/R shared floats a FMA).  B5
stages the interleaved lane pairs as they lie.  The plan (``dwconv_launch``)
is computed here; the C launcher only checks it.  See the note at the top of
``csrc/dwconv.cu`` for the design and ``dwconv_geometry_sweep.py`` for the
times of each plan choice.

``fast_dwconv1d`` and ``fast_dwconv1d_grouped`` take the plain versions
(``dwconv1d_plain``, ``dwconv1d_grouped_plain``) only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.  Both are registered
operators too, ``audiojax_torch::dwconv1d`` and
``audiojax_torch::dwconv1d_grouped``, which ``torch.export`` graphs record
(see ``_build``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build

__all__ = ["launches", "reset_launches", "DwconvLaunch", "dwconv_launch", "DwconvMmaLaunch",
           "mma_route", "mma_smem", "dwconv_mma_launch", "dwconv_plan", "launch_dwconv1d",
           "launch_dwconv1d_grouped", "dwconv1d_cuda", "dwconv1d_plain", "fast_dwconv1d",
           "dwconv1d_grouped_cuda", "dwconv1d_grouped_plain", "fast_dwconv1d_grouped",
           "dwconv1d_op", "dwconv1d_grouped_op"]

# Kernel launches since the last reset.  The wrapper adds one where it
# launches its kernel, and nowhere else.
# Inside a CUDA graph capture (``runtime.streaming.StreamingServer(jit=True)``)
# the wrapper counts the launch it records, once; a replay launches the
# recorded kernels without the wrapper, so a graphed path's launches are
# (launches counted during its capture) × (replays).
launches = {"dwconv1d": 0, "dwconv1d_tiled": 0, "dwconv1d_bf16": 0, "dwconv1d_tiled_bf16": 0}

SMEM_MAX = 232448  # dynamic shared memory a block can have on sm_90
SM_COUNT = 132
MAX_BLOCKS = 2**31 - 1  # one grid dimension: item groups × channel tiles
R_BUILT = (8, 16)  # outputs a thread the kernels are built for
CT = 32  # input elements of a channel tile
SHORT_MAX_NTT = 32  # time threads of a whole-row item: T_out ≤ 32·8
LONG_NTT = 32  # time threads of a time tile
MAX_THREADS = {8: 512, 16: 256}  # threads a block by r (the kernels' __launch_bounds__)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ── the launch plan ────────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class DwconvLaunch:
    m: int  # input lanes a group (1: B4, 2: B5)
    gran: int  # elements a copy: 16 bytes (4 floats, 8 bf16) or 1
    vc: int  # input elements a thread in the FMA loop (4, or 1; m on 1-element copies)
    r: int  # outputs a thread, at stride dilation
    ntt: int  # time threads: (32 / vc)·ntt threads a block
    tile: int  # outputs of a work item, ntt·r
    carry: bool  # items are consecutive time tiles of one row, the halo carried
    ipb: int  # work items a block
    depth: int  # items in the ring: depth - 1 load while one computes
    direct: bool  # a thread's outputs consecutive (dilations too large for threads at stride)
    chunks: int  # carry: blocks along one batch row (1 otherwise)
    n_tiles: int  # carry: time tiles a batch row (1 otherwise)
    ring: int  # strip rows in shared memory
    grid: tuple[int, int]  # (item groups, channel tiles): block i is tile i % n of group i // n
    threads: int
    smem: int  # bytes: the ring and the block's taps
    esize: int = 4  # bytes an element of x and y: 4 (float32) or 2 (bfloat16)


@functools.lru_cache(maxsize=1024)  # the served shapes repeat on every forward
def dwconv_launch(b: int, t: int, c: int, k: int, lo: int, hi: int, dil: int, m: int, *,
                  vector: bool = True, r: int | None = None, vc: int | None = None,
                  ntt: int | None = None, ipb: int | None = None,
                  depth: int | None = None, esize: int = 4) -> DwconvLaunch:
    """B4's (m = 1) or B5's (m = 2) geometry for x (b, t, c), k taps, pads
    (lo, hi) and dilation ``dil``, of ``esize``-byte elements (4: float32, 2:
    bfloat16); ``vector``: C a multiple of a 16-byte copy's elements (4, or 8
    in bf16) and x 16-byte aligned (16-byte copies), else one element a copy.
    The ring holds ``esize``-byte strip rows, the taps f32.

    The picks, from ``dwconv_geometry_sweep.py``'s tables (PERF.md): a float4
    a thread (vc 4; one float where T_out ≤ 64 and there are fewer than 4
    items a SM, whose small blocks want more threads), time threads filling
    whole warps.  Where T_out fits 32 time threads of r = 8 outputs (T_out ≤
    256: the MossFormerGAN and ZipEnhancer shapes) an item is a whole batch
    row, two in the ring, 4 items a block where there are 8 or more a SM, 2
    where there are 2, else 1.  Longer rows
    take time tiles of 32 threads × 16 outputs with the halo carried, three
    in the ring where they fit, and chunks of tiles such that the grid is
    about one block a SM (2 tiles a block where the channel tiles alone give
    two blocks a SM).  Threads take their outputs at stride ``dil`` (a dense
    conv over their decimated rows) in groups of ``dil`` threads; where no
    such group fits a block (or ``ntt`` is not a multiple of ``dil``),
    consecutive outputs (``direct``).  Memoised: the plan is a function of
    its arguments alone."""
    t_out = t + lo + hi - dil * (k - 1)
    if m not in (1, 2) or c % m or min(b, t, c, k, dil) < 1 or min(lo, hi) < 0 or t_out < 1:
        raise ValueError(f"no B4/B5 plan for x ({b}, {t}, {c}), k {k}, pads ({lo}, {hi}), "
                         f"dilation {dil}, {m} lanes a group")
    if esize not in (4, 2):
        raise ValueError(f"the kernels take 4- or 2-byte elements, got {esize}")
    gran = 16 // esize if vector else 1
    if c % gran:
        raise ValueError(f"the vector path needs C % {gran} == 0, got C = {c}")
    grid_y = _cdiv(c, CT)
    items = b * grid_y  # batch rows × channel tiles
    if vc is None:  # one float a thread for few short rows: more threads a block
        vc = m if not vector else (1 if m == 1 and t_out <= 64 and items < 4 * SM_COUNT else 4)
    if vc not in (((1, 4) if m == 1 else (4,)) if vector else (m,)):
        raise ValueError(f"vc {vc} is not built for {'16-byte' if vector else '1-element'} "
                         f"copies and {m} lanes a group")
    lanes = CT // vc
    step = math.lcm(dil, 32 // lanes)  # time threads: whole warps, a multiple of the dilation
    whole_rows = t_out <= 8 * SHORT_MAX_NTT
    r = (8 if whole_rows else 16) if r is None else r
    if r not in R_BUILT:
        raise ValueError(f"the kernels are built for r in {R_BUILT}, got {r}")
    cap = MAX_THREADS[r] // lanes  # time threads a block can have
    if ntt is None:
        want = _cdiv(t_out, r) if whole_rows else LONG_NTT
        ntt = _cdiv(want, step) * step
        if ntt > cap:  # whole warps do not fit: groups of dil threads, else consecutive outputs
            ntt = min(_cdiv(want, dil) * dil, cap // dil * dil) or min(want, cap)
    direct = ntt % dil != 0
    if ntt < 1 or lanes * ntt > MAX_THREADS[r]:
        raise ValueError(f"{ntt} time threads: too many for r = {r}")
    if ipb is not None and ipb < 1:
        raise ValueError(f"items a block must be >= 1, got {ipb}")
    halo = dil * (k - 1)
    tile = ntt * r
    carry = tile < t_out

    def ring_of(d: int) -> int:
        return d * tile + halo if carry else d * (tile + halo)

    def smem_of(rows: int) -> int:  # the ring of esize-byte rows, then the f32 taps
        return (esize * rows + 4 * k) * CT

    if depth is None:
        depth = 3 if carry and smem_of(ring_of(3)) <= SMEM_MAX else 2
    if depth not in (2, 3):
        raise ValueError(f"the ring holds 2 or 3 items, got {depth}")
    ring = ring_of(depth)
    smem = smem_of(ring)
    if smem > SMEM_MAX:
        raise ValueError(f"B4/B5 plan needs {smem} bytes of shared memory (> {SMEM_MAX})")
    if carry:
        n_tiles = _cdiv(t_out, tile)
        if ipb is None:
            if items >= 2 * SM_COUNT:
                ipb = 2
            else:  # a power of two of chunks a row, about one block a SM
                chunks = 1 << max(0, round(math.log2(SM_COUNT / items)))
                ipb = _cdiv(n_tiles, min(chunks, n_tiles))
        ipb = min(ipb, n_tiles)
        chunks = _cdiv(n_tiles, ipb)
        grid_x = b * chunks
    else:
        n_tiles, chunks = 1, 1
        if ipb is None:
            ipb = 4 if items >= 8 * SM_COUNT else 2 if items >= 2 * SM_COUNT else 1
        ipb = min(ipb, b)
        grid_x = _cdiv(b, ipb)
    if grid_x * grid_y > MAX_BLOCKS:
        raise ValueError(f"{grid_x} × {grid_y} blocks exceed the grid's {MAX_BLOCKS}")
    return DwconvLaunch(m, gran, vc, r, ntt, tile, carry, ipb, depth, direct, chunks, n_tiles,
                        ring, (grid_x, grid_y), lanes * ntt, smem, esize)


# ── the bf16 tensor-core route of B4 ───────────────────────────────────────

MMA_CT = 16  # channels a block (32-byte rows): 4 warps, 4 channels each
MMA_TO = 128  # outputs a work item: 8 tiles of 16
MMA_THREADS = 128
MMA_BLOCKS_SM = 5  # blocks an SM (the kernel's __launch_bounds__)
MMA_BLOCKS_SM_GROUPED = 4  # the same for B5 (two lanes a group: 128 registers a thread)
MMA_DEPTHS = (2, 3, 4)  # items in the ring: depth - 1 in flight while one computes
MMA_MAX_KS = 4  # k16 steps of the Toeplitz product the kernel is built for: k ≤ 49


@dataclasses.dataclass(frozen=True)
class DwconvMmaLaunch:
    m: int  # input lanes an output: 1 (B4) or 2 (B5)
    ks: int  # k16 steps: 16·ks ≥ 15 + k
    ipr: int  # work items of 128 outputs a residue mod the dilation
    items: int  # batch · dilation · ipr
    ipb: int  # work items a block
    depth: int  # item slots in the ring: depth - 1 in flight while one computes
    window: int  # decimated input rows an item stages: 112 + 16·ks
    grid: tuple[int, int]  # (item groups, lane tiles of 16): block i is tile i % n of group i // n
    threads: int
    smem: int  # bytes: each warp's ring, its transposed window and its outputs


def mma_route(m: int, esize: int, vector: bool, k: int) -> bool:
    """The route rule: a bf16 depthwise (m = 1) or grouped 2-in/1-out (m = 2)
    conv on the vector path (C % 8 == 0 input lanes, x 16-byte aligned) with
    k ≤ 49 goes to the tensor-core kernel (``csrc/dwconv_bf16.cu``); every
    other call to the FFMA kernels (``csrc/dwconv.cu``): float32, C % 8 != 0,
    an unaligned x, longer kernels."""
    return m in (1, 2) and esize == 2 and vector and 15 + k <= 16 * MMA_MAX_KS


def mma_smem(ks: int, depth: int) -> int:
    """``smem_bytes`` of ``csrc/dwconv_bf16.cu``: ``depth`` windows of W =
    112 + 16·ks rows channel-last, the window time-contiguous (W + 8 a
    channel) and the 128 outputs channel-last, rows padded by 16 bytes, all
    bf16."""
    w = 112 + 16 * ks
    return 2 * (depth * w * (MMA_CT + 8) + MMA_CT * (w + 8) + MMA_TO * (MMA_CT + 8))


@functools.lru_cache(maxsize=1024)
def dwconv_mma_launch(b: int, t: int, c: int, k: int, lo: int, hi: int, dil: int, m: int = 1, *,
                      ipb: int | None = None, depth: int | None = None) -> DwconvMmaLaunch:
    """The tensor-core kernel's plan for a bf16 x (b, t, c) of ``m`` input
    lanes an output (1: B4, 2: B5; c counts input lanes), k taps, pads (lo,
    hi), dilation ``dil``.  Work items of 128 outputs of one residue mod the
    dilation; one wave of blocks (five an SM, B5 four: the kernel's
    registers and shared memory allow that many), each lane tile's items
    split evenly over its share of them; three ring slots where a block has three items or more,
    else two.  Memoised."""
    t_out = t + lo + hi - dil * (k - 1)
    if min(b, t, c, k, dil) < 1 or min(lo, hi) < 0 or t_out < 1 or c % 8 or m not in (1, 2):
        raise ValueError(f"no B{4 if m == 1 else 5} tensor-core plan for x ({b}, {t}, {c}), "
                         f"k {k}, pads ({lo}, {hi}), dilation {dil}")
    ks = _cdiv(15 + k, 16)
    if ks > MMA_MAX_KS:
        raise ValueError(f"the tensor-core kernel takes k ≤ {16 * MMA_MAX_KS - 15}, got {k}")
    ipr = _cdiv(_cdiv(t_out, dil), MMA_TO)
    items = b * dil * ipr
    grid_y = _cdiv(c, MMA_CT)
    if ipb is None:  # one wave: each channel tile's items split over its share of the slots
        slots = MMA_BLOCKS_SM if m == 1 else MMA_BLOCKS_SM_GROUPED
        ipb = _cdiv(items, max(1, slots * SM_COUNT // grid_y))
    if ipb < 1:
        raise ValueError(f"items a block must be >= 1, got {ipb}")
    ipb = min(ipb, items)
    depth = (3 if ipb >= 3 else 2) if depth is None else depth
    if depth not in MMA_DEPTHS:
        raise ValueError(f"the ring holds {MMA_DEPTHS} items, got {depth}")
    grid_x = _cdiv(items, ipb)
    if grid_x * grid_y > MAX_BLOCKS:
        raise ValueError(f"{grid_x} × {grid_y} blocks exceed the grid's {MAX_BLOCKS}")
    return DwconvMmaLaunch(m, ks, ipr, items, ipb, depth, 112 + 16 * ks, (grid_x, grid_y),
                           MMA_THREADS, mma_smem(ks, depth))


def dwconv_plan(b: int, t: int, c: int, k: int, lo: int, hi: int, dil: int, m: int, *,
                vector: bool = True, esize: int = 4) -> DwconvLaunch | DwconvMmaLaunch:
    """The wrappers' plan: the tensor-core kernel's where :func:`mma_route`
    says so, else :func:`dwconv_launch`'s."""
    if mma_route(m, esize, vector, k):
        return dwconv_mma_launch(b, t, c, k, lo, hi, dil, m)
    return dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector, esize=esize)


# ── the library ────────────────────────────────────────────────────────────


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("dwconv"))


@functools.cache
def _mma_lib() -> ctypes.CDLL:
    lib = _build.load("dwconv_bf16")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ajt_dwconv1d_mma_bf16.argtypes = [p, p, p] + [i] * 7 + [ll] * 2 + [i] * 6 + [ll, p]
    lib.ajt_dwconv1d_mma_bf16.restype = i
    lib.ajt_dwconv1d_grouped2_mma_bf16.argtypes = ([p, p, p] + [i] * 7 + [ll] * 3 + [i] * 6
                                                   + [ll, p])
    lib.ajt_dwconv1d_grouped2_mma_bf16.restype = i
    lib.ajt_dwconv_bf16_error_string.argtypes = [i]
    lib.ajt_dwconv_bf16_error_string.restype = ctypes.c_char_p
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C launchers' signatures on a library built from ``csrc/dwconv.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    plan = [i] * 15
    for dt in _build.DTYPES.values():
        getattr(lib, f"ajt_dwconv1d_{dt}").argtypes = [p, p, p] + [i] * 7 + [ll] * 2 + plan + [p]
        getattr(lib, f"ajt_dwconv1d_{dt}").restype = i
        getattr(lib, f"ajt_dwconv1d_grouped2_{dt}").argtypes = ([p, p, p] + [i] * 7 + [ll] * 3
                                                               + plan + [p])
        getattr(lib, f"ajt_dwconv1d_grouped2_{dt}").restype = i
    lib.ajt_dwconv_error_string.argtypes = [i]
    lib.ajt_dwconv_error_string.restype = ctypes.c_char_p
    return lib


def _stream(device: torch.device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _plan_args(plan: DwconvLaunch) -> tuple:
    return (plan.gran, plan.vc, plan.r, plan.ntt, plan.tile, int(plan.carry), plan.ipb,
            plan.depth, int(plan.direct), plan.chunks, plan.n_tiles, plan.ring, *plan.grid, plan.smem)


def _launch(lib: ctypes.CDLL, fn: str, x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, pads,
            dilation: int, plan: DwconvLaunch) -> None:
    b, t, _ = x.shape
    rc = getattr(lib, fn)(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, y.shape[2],
                          w.shape[0], pads[0], pads[1], dilation, *w.stride(), *_plan_args(plan),
                          _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.ajt_dwconv_error_string(rc).decode()} "
                           f"({rc})")


def launch_dwconv1d(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, pads, dilation: int,
                    plan: DwconvLaunch | DwconvMmaLaunch) -> None:
    """Launch B4 on checked x (B, T, C), w (k, C) (any strides) into y at
    ``plan``'s geometry, in x's dtype: the FFMA kernel at a ``DwconvLaunch``,
    the bf16 tensor-core kernel at a ``DwconvMmaLaunch``; counts nothing
    (``dwconv1d_cuda`` counts its launch)."""
    if not isinstance(plan, DwconvMmaLaunch):
        _launch(_lib(), f"ajt_dwconv1d_{_build.DTYPES[x.dtype]}", x, w, y, pads, dilation, plan)
        return
    lib = _mma_lib()
    b, t, c = x.shape
    rc = lib.ajt_dwconv1d_mma_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c,
                                   w.shape[0], pads[0], pads[1], dilation, *w.stride(), plan.ks,
                                   plan.ipr, plan.ipb, plan.depth, *plan.grid, plan.smem,
                                   _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ajt_dwconv1d_mma_bf16 launch failed: "
                           f"{lib.ajt_dwconv_bf16_error_string(rc).decode()} ({rc})")


def launch_dwconv1d_grouped(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, pads,
                            dilation: int, plan: DwconvLaunch | DwconvMmaLaunch) -> None:
    """Launch B5 on checked x (B, T, 2G), w (k, 2, G) (any strides) into y at
    ``plan``'s geometry, in x's dtype: the FFMA kernel at a ``DwconvLaunch``,
    the bf16 tensor-core kernel at a ``DwconvMmaLaunch``; counts nothing
    (``dwconv1d_grouped_cuda`` counts)."""
    if not isinstance(plan, DwconvMmaLaunch):
        _launch(_lib(), f"ajt_dwconv1d_grouped2_{_build.DTYPES[x.dtype]}", x, w, y, pads,
                dilation, plan)
        return
    lib = _mma_lib()
    b, t, c = x.shape
    rc = lib.ajt_dwconv1d_grouped2_mma_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, c,
                                            w.shape[0], pads[0], pads[1], dilation, *w.stride(),
                                            plan.ks, plan.ipr, plan.ipb, plan.depth, *plan.grid,
                                            plan.smem, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ajt_dwconv1d_grouped2_mma_bf16 launch failed: "
                           f"{lib.ajt_dwconv_bf16_error_string(rc).decode()} ({rc})")


# ── B4: depthwise conv1d ───────────────────────────────────────────────────


def _out_len(x: torch.Tensor, w: torch.Tensor, pads, dilation: int) -> int:
    lo, hi = pads
    if lo < 0 or hi < 0 or dilation < 1:
        raise ValueError(f"pads must be >= 0 and dilation >= 1, got {pads}, {dilation}")
    t_out = x.shape[1] + lo + hi - dilation * (w.shape[0] - 1)
    if t_out <= 0:
        raise ValueError(f"non-positive output length {t_out}")
    return t_out


def _same_dtype(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != w.dtype:  # the Pallas kernels' trace-time error
        raise TypeError(f"conv dtype mismatch: x {x.dtype} vs w {w.dtype}")


def dwconv1d_plain(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                   dilation: int = 1) -> torch.Tensor:
    """Shift-and-add mirror of ``dwconv1d_jnp``: f32 products and sums, taps
    in order, the result in x's dtype (a bf16 x and w are widened first)."""
    _same_dtype(x, w)
    t_out = _out_len(x, w, pads, dilation)
    xp = F.pad(x, (0, 0, pads[0], pads[1])).float()
    wf = w.float()
    acc = xp[:, :t_out] * wf[0]
    for i in range(1, w.shape[0]):
        acc = acc + xp[:, i * dilation : i * dilation + t_out] * wf[i]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """x and w on the card, both float32 or both bfloat16, x contiguous (w
    may have any strides)."""
    for t, name in ((x, "x"), (w, "w")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _build.DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    _same_dtype(x, w)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _plan_for(x: torch.Tensor, w: torch.Tensor, pads, dilation: int,
              m: int) -> DwconvLaunch | DwconvMmaLaunch:
    b, t, c = x.shape
    esize = x.element_size()
    vector = c % (16 // esize) == 0 and x.data_ptr() % 16 == 0
    return dwconv_plan(b, t, c, w.shape[0], pads[0], pads[1], dilation, m, vector=vector,
                       esize=esize)


def dwconv1d_cuda(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d on the card; contract of :func:`dwconv1d_plain`."""
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2] or w.device != x.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}: expected x (B, T, C) and w (k, C)")
    _check(x, w)
    t_out = _out_len(x, w, pads, dilation)
    plan = _plan_for(x, w, pads, dilation, 1)
    y = torch.empty((x.shape[0], t_out, x.shape[2]), dtype=x.dtype, device=x.device)
    launch_dwconv1d(x, w, y, pads, dilation, plan)
    _build.count(launches, "dwconv1d", x.dtype)
    return y


@torch.library.custom_op("audiojax_torch::dwconv1d", mutates_args=())
def dwconv1d_op(x: torch.Tensor, w: torch.Tensor, pad_lo: int, pad_hi: int,
                dilation: int) -> torch.Tensor:
    """B4 as a registered operator: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    fn = dwconv1d_plain if x.device.type == "cpu" else dwconv1d_cuda
    return fn(x, w, pads=(pad_lo, pad_hi), dilation=dilation)


@dwconv1d_op.register_fake
def _(x, w, pad_lo, pad_hi, dilation):
    return x.new_empty((x.shape[0], x.shape[1] + pad_lo + pad_hi - dilation * (w.shape[0] - 1),
                        x.shape[2]))


@register_flop_formula(torch.ops.audiojax_torch.dwconv1d)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """A multiply and an add a tap an output."""
    return 2 * math.prod(out_shape) * w_shape[0]


def fast_dwconv1d(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _build.through_ops():
        return torch.ops.audiojax_torch.dwconv1d(x, w, pads[0], pads[1], dilation)
    if x.device.type == "cpu":
        return dwconv1d_plain(x, w, pads=pads, dilation=dilation)
    return dwconv1d_cuda(x, w, pads=pads, dilation=dilation)


# ── B5: grouped 2-in/1-out conv1d ──────────────────────────────────────────


def dwconv1d_grouped_plain(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                           dilation: int = 1) -> torch.Tensor:
    """Shift-and-add mirror of ``_grouped_single_out_conv1d``: x (B, T, M·G),
    w (k, M, G), group g contracting input lanes [g·M, (g+1)·M); f32 products
    and sums, taps outer, lanes inner, the result in x's dtype."""
    k, m, g = w.shape
    if x.ndim != 3 or x.shape[2] != m * g:
        raise ValueError(f"x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    _same_dtype(x, w)
    t_out = _out_len(x, w, pads, dilation)
    xr = F.pad(x, (0, 0, pads[0], pads[1])).float().reshape(x.shape[0], -1, g, m)
    wf = w.float()
    acc = None
    for i in range(k):
        seg = xr[:, i * dilation : i * dilation + t_out]
        for r in range(m):
            term = seg[..., r] * wf[i, r]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def dwconv1d_grouped_cuda(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                          dilation: int = 1) -> torch.Tensor:
    """Grouped 2-in/1-out conv1d on the card; contract of
    :func:`dwconv1d_grouped_plain` with M = 2."""
    if (x.ndim != 3 or w.ndim != 3 or w.shape[1] != 2 or x.shape[2] != 2 * w.shape[2]
            or w.device != x.device):
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}: the kernel takes x (B, T, 2·G) and w (k, 2, G)")
    _check(x, w)
    t_out = _out_len(x, w, pads, dilation)
    plan = _plan_for(x, w, pads, dilation, 2)
    y = torch.empty((x.shape[0], t_out, w.shape[2]), dtype=x.dtype, device=x.device)
    launch_dwconv1d_grouped(x, w, y, pads, dilation, plan)
    _build.count(launches, "dwconv1d_tiled", x.dtype)
    return y


@torch.library.custom_op("audiojax_torch::dwconv1d_grouped", mutates_args=())
def dwconv1d_grouped_op(x: torch.Tensor, w: torch.Tensor, pad_lo: int, pad_hi: int,
                        dilation: int) -> torch.Tensor:
    """B5 as a registered operator: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    fn = dwconv1d_grouped_plain if x.device.type == "cpu" else dwconv1d_grouped_cuda
    return fn(x, w, pads=(pad_lo, pad_hi), dilation=dilation)


@dwconv1d_grouped_op.register_fake
def _(x, w, pad_lo, pad_hi, dilation):
    return x.new_empty((x.shape[0], x.shape[1] + pad_lo + pad_hi - dilation * (w.shape[0] - 1),
                        w.shape[2]))


@register_flop_formula(torch.ops.audiojax_torch.dwconv1d_grouped)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """A multiply and an add a tap and input lane an output."""
    return 2 * math.prod(out_shape) * w_shape[0] * w_shape[1]


def fast_dwconv1d_grouped(x: torch.Tensor, w: torch.Tensor, *, pads=(0, 0),
                          dilation: int = 1) -> torch.Tensor:
    """Grouped 2-in/1-out conv1d: the plain version for a CPU tensor, the kernel
    for a CUDA one."""
    if _build.through_ops():
        return torch.ops.audiojax_torch.dwconv1d_grouped(x, w, pads[0], pads[1], dilation)
    if x.device.type == "cpu":
        return dwconv1d_grouped_plain(x, w, pads=pads, dilation=dilation)
    return dwconv1d_grouped_cuda(x, w, pads=pads, dilation=dilation)
