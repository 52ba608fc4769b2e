"""STFT / ISTFT kernels for Hopper, with their launch counters.

Counterpart of ``audiojax.ops.stft_pallas``.  The kernels are CUDA C++ in
``csrc/stft.cu``, built for sm_90a by :mod:`._build` at first use and called
through ctypes on PyTorch's current stream.  Each call is one launch.

B1, ``stft_packed_cuda`` — replaces ``stft_packed_pallas``
(``audiojax/ops/stft_pallas.py:207``, kernels ``_kernel`` and
``_kernel_kchunk``).  Each block stages its tile's audio strip in shared
memory once, resolving the centre pad while it does, and reads the frames out
of it times the window.  Im X[n_fft/2], rounding noise for real input, is
the dot product with the plain basis's own column, so that its sign (which
ZipEnhancer's phase feature takes) is the plain version's.

B2, ``istft_packed_cuda`` — replaces ``istft_packed_pallas``
(``audiojax/ops/stft_pallas.py:361``, kernels ``_ikernel`` and
``_ikernel_kchunk``).  Each block transforms the frames that cover its tile
of output hop-rows, overlap-adds them in shared memory in frame order, and
writes only the samples of [start, end) times the COLA reciprocal into the
final (B, L_out) tensor: no atomics, each output written once.

What bounds them: bytes.  An FFT needs about 2.5·n·log2(n) operations a
frame, far less of the card's time than reading the input and writing the
output once (at the MossFormerGAN serving shape, 32 windows of 24000
samples, ~4.6 µs at 3.35 TB/s).  So both run a Stockham mixed-radix FFT in
shared memory over the host's plan (``dsp.stft.fft_plan``, its twiddles
computed in float64), read each input byte from device memory once and
write each output byte once.  B1 computes in float32 (twiddles rounded once
to float32); B2 in float64, whose error does not grow where an uncentred
signal's ends divide it by a small COLA envelope.  The twiddles, windows
and COLA reciprocal go to the card once per config.  See the note at the
top of ``csrc/stft.cu``.  PERF.md has their times.

The wrappers pick the launch geometry (frames per block for B1, hop-rows per
block and frames transformed at a time for B2): about 1024 complex points a
B1 block and 2048 a B2 block with its halo frames, fewer where that leaves
fewer than two blocks an SM (264), within the block's 227 KB of shared
memory (B2: all of a tile's frames at once in a third of it where the rows
allow, for three blocks an SM).
Each wrapper takes the plain PyTorch version (``dsp.stft``) only for a
tensor on the CPU.  A CUDA tensor launches the kernel or raises.  Both
routing points are registered operators too, ``audiojax_torch::stft_packed``
and ``audiojax_torch::istft_packed`` (``StftConfig`` flattened into their
arguments), which ``torch.export`` graphs record (see ``_build``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..dsp.stft import (StftConfig, _out_end, analysis_window, fft_plan, fft_table,
                        inv_win_sum, num_frames, nyquist_imag, synthesis_window)
from ..dsp.stft import istft_packed as plain_istft_packed
from ..dsp.stft import stft_packed as plain_stft_packed
from . import _build

__all__ = [
    "launches",
    "reset_launches",
    "stft_launch",
    "istft_launch",
    "launch_stft",
    "launch_istft",
    "stft_packed_cuda",
    "istft_packed_cuda",
    "fast_stft_packed",
    "fast_istft_packed",
    "plain_stft_packed",
    "plain_istft_packed",
    "stft_packed_op",
    "istft_packed_op",
]

# Kernel launches since the last reset, by kernel name.  Each wrapper adds one
# where it launches its kernel, and nowhere else.
# Inside a CUDA graph capture (``runtime.streaming.StreamingServer(jit=True)``)
# the wrapper counts the launch it records, once; a replay launches the
# recorded kernels without the wrapper, so a graphed path's launches are
# (launches counted during its capture) × (replays).
launches = {"stft_packed": 0, "istft_packed": 0}

SMEM_MAX = 232448  # dynamic shared memory a block can have on sm_90
MIN_BLOCKS = 2 * 132  # two blocks an SM, where there is that much work
# complex points a block aims to transform: B1 per block, B2 per block with
# its halo frames (chosen from launch-geometry sweeps on the H100)
B1_POINTS, B2_POINTS = 1024, 2048


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _row_stride(m: int) -> int:
    """A work-buffer row of ``m`` complex values, one skew slot every 16
    (``row_stride`` in ``csrc/stft.cu``)."""
    return m + (m - 1) // 16


def smem_bytes(m: int, rows: int, point_bytes: int, extra_bytes: int) -> int:
    """Two work buffers of ``rows`` rows of ``point_bytes`` complex values,
    then ``extra_bytes`` (``smem_bytes`` in ``csrc/stft.cu``)."""
    return 2 * point_bytes * rows * _row_stride(m) + extra_bytes


@dataclasses.dataclass(frozen=True)
class StftLaunch:
    n_t: int
    frames: int  # frames per block
    blocks: int
    smem: int


@dataclasses.dataclass(frozen=True)
class IstftLaunch:
    start: int
    end: int
    rows: int  # output hop-rows per block
    group: int  # frames transformed at a time
    blocks: int
    smem: int


def stft_launch(cfg: StftConfig, batch: int, length: int) -> StftLaunch:
    """B1's geometry for ``batch`` rows of ``length`` samples; raises
    ``ValueError`` where ``dsp.stft_packed`` does."""
    h = cfg.half if cfg.center else 0
    if cfg.center and cfg.pad_mode == "reflect" and length < h + 1:
        raise ValueError(f"reflect center-pad of {h} needs at least {h + 1} samples, "
                         f"got {length}")
    lpad = length + 2 * h
    if lpad < cfg.n_fft:
        raise ValueError(f"input too short for STFT: {lpad} < n_fft={cfg.n_fft}")
    n_t = (lpad - cfg.n_fft) // cfg.hop + 1
    m = fft_plan(cfg.n_fft).m

    def smem(frames: int) -> int:  # float32 points and the audio strip
        return smem_bytes(m, frames, 8, 4 * ((frames - 1) * cfg.hop + cfg.n_fft))

    frames = max(1, min(n_t, B1_POINTS // m))
    while frames > 1 and (smem(frames) > SMEM_MAX or batch * -(-n_t // frames) < MIN_BLOCKS):
        frames -= 1
    if smem(frames) > SMEM_MAX:
        raise ValueError(f"n_fft={cfg.n_fft}, hop={cfg.hop}: one frame needs {smem(frames)} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    return StftLaunch(n_t, frames, batch * -(-n_t // frames), smem(frames))


def istft_launch(cfg: StftConfig, batch: int, n_t: int,
                 out_length: int | None = None) -> IstftLaunch:
    """B2's geometry for ``batch`` rows of ``n_t`` frames; raises
    ``ValueError`` where ``dsp.istft_packed`` does."""
    raw_len = cfg.n_fft + cfg.hop * (n_t - 1)
    start = cfg.half if cfg.center else 0
    end = _out_end(cfg, n_t, raw_len, out_length)
    n_rows = max(1, (end - 1) // cfg.hop - start // cfg.hop + 1)
    m = fft_plan(cfg.n_fft).m
    k_seg = -(-cfg.n_fft // cfg.hop)

    def need(rows: int, group: int) -> int:  # float64 points, then the overlap-add rows
        return smem_bytes(m, group, 16, 8 * rows * cfg.hop)

    # fewer rows a block fill the card, but each block transforms the
    # k_seg − 1 halo frames beside its rows; all of a tile's frames in one
    # group within a third of the shared memory (three blocks an SM) where
    # the rows allow it
    least = min(n_rows, max(1, (k_seg - 1) // 2))
    rows = max(least, min(n_rows, B2_POINTS // m - (k_seg - 1)))
    while rows > least and batch * -(-n_rows // rows) < MIN_BLOCKS:
        rows -= 1
    while rows > least and need(rows, rows + k_seg - 1) > SMEM_MAX // 3:
        rows -= 1
    while rows > 1 and need(rows, 1) > SMEM_MAX:
        rows -= 1
    limit = SMEM_MAX // 3 if need(rows, 1) <= SMEM_MAX // 3 else SMEM_MAX
    group = rows + k_seg - 1
    while group > 1 and need(rows, group) > limit:
        group -= 1
    smem = need(rows, group)
    if smem > SMEM_MAX:
        raise ValueError(f"n_fft={cfg.n_fft}, hop={cfg.hop}: one frame needs {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    return IstftLaunch(start, end, rows, group, batch * -(-n_rows // rows), smem)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ajt_stft_packed_f32.argtypes = [p] * 5 + [i] * 10 + [p, p, i, p]
    lib.ajt_stft_packed_f32.restype = i
    lib.ajt_istft_packed_f32.argtypes = [p] * 5 + [i] * 10 + [p, p, i, p]
    lib.ajt_istft_packed_f32.restype = i
    lib.ajt_error_string.argtypes = [i]
    lib.ajt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _plan_args(n_fft: int) -> tuple:
    """The plan's scalars and host arrays, as the launchers take them."""
    plan = fft_plan(n_fft)
    n = len(plan.radices)
    return (plan.m, n, (ctypes.c_int * n)(*plan.radices), (ctypes.c_int * n)(*plan.offsets),
            plan.post_offset)


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


def launch_stft(x: torch.Tensor, cfg: StftConfig, out: torch.Tensor, frames: int) -> None:
    """Launch B1 on checked ``x`` into ``out`` (B, T, 2F), ``frames`` frames a
    block; counts nothing (``stft_packed_cuda`` counts its launch)."""
    lib = _lib()
    b, length = x.shape
    half = cfg.half if cfg.center else 0
    reflect = int(cfg.center and cfg.pad_mode == "reflect")
    win, tw = analysis_window(cfg, x.device), fft_table(cfg, x.device)
    nyq = nyquist_imag(cfg, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ajt_stft_packed_f32(x.data_ptr(), win.data_ptr(), nyq.data_ptr(), tw.data_ptr(),
                                     out.data_ptr(), b, length, out.shape[1], cfg.n_fft, cfg.hop,
                                     half, reflect, frames, *_plan_args(cfg.n_fft), stream)
    _raise_on(lib, rc, "stft_packed")


def launch_istft(spec: torch.Tensor, cfg: StftConfig, out: torch.Tensor,
                 out_length: int | None, start: int, rows: int, group: int) -> None:
    """Launch B2 on checked ``spec`` into ``out`` (B, L_out), ``rows`` hop-rows
    a block and ``group`` frames transformed at a time; counts nothing
    (``istft_packed_cuda`` counts its launch)."""
    lib = _lib()
    b, n_t, _ = spec.shape
    win, tw = synthesis_window(cfg, spec.device), fft_table(cfg, spec.device, np.float64)
    cola = inv_win_sum(cfg, n_t, out_length, spec.device)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = lib.ajt_istft_packed_f32(spec.data_ptr(), win.data_ptr(), tw.data_ptr(),
                                      cola.data_ptr(), out.data_ptr(), b, n_t, cfg.n_fft,
                                      cfg.hop, start, out.shape[1], rows, group,
                                      *_plan_args(cfg.n_fft), stream)
    _raise_on(lib, rc, "istft_packed")


def stft_packed_cuda(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(B, L) float32 CUDA → packed (B, T, 2F); contract of ``dsp.stft_packed``."""
    _check(x, "x", 2)
    b, length = x.shape
    geo = stft_launch(cfg, b, length)  # raises before any launch
    out = torch.empty((b, geo.n_t, 2 * cfg.f_bins), dtype=torch.float32, device=x.device)
    launch_stft(x, cfg, out, geo.frames)
    launches["stft_packed"] += 1
    return out


def istft_packed_cuda(spec: torch.Tensor, cfg: StftConfig,
                      out_length: int | None = None) -> torch.Tensor:
    """Packed (B, T, 2F) float32 CUDA → (B, L_out); contract of ``dsp.istft_packed``."""
    _check(spec, "spec", 3)
    b, n_t, f2 = spec.shape
    if f2 != 2 * cfg.f_bins:
        raise ValueError(f"spec has {f2} packed bins, config needs {2 * cfg.f_bins}")
    geo = istft_launch(cfg, b, n_t, out_length)  # raises before any launch
    out_len = geo.end - geo.start
    if out_len == 0:  # out_length=0: nothing to compute
        return spec.new_empty((b, 0))
    out = torch.empty((b, out_len), dtype=torch.float32, device=spec.device)
    launch_istft(spec, cfg, out, out_length, geo.start, geo.rows, geo.group)
    launches["istft_packed"] += 1
    return out


def _cfg_args(cfg: StftConfig) -> tuple:
    """``cfg`` as an operator's arguments (ints, strings, bools, floats)."""
    return (cfg.n_fft, cfg.hop, -1 if cfg.win_length is None else cfg.win_length, cfg.window,
            cfg.center, cfg.pad_mode, float(cfg.input_scale), float(cfg.output_scale))


def _cfg(n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale):
    return StftConfig(n_fft, hop, None if win_length < 0 else win_length, window, center,
                      pad_mode, input_scale, output_scale)


@torch.library.custom_op("audiojax_torch::stft_packed", mutates_args=())
def stft_packed_op(x: torch.Tensor, n_fft: int, hop: int, win_length: int, window: str,
                   center: bool, pad_mode: str, input_scale: float,
                   output_scale: float) -> torch.Tensor:
    """B1 as a registered operator: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    cfg = _cfg(n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale)
    return plain_stft_packed(x, cfg) if x.device.type == "cpu" else stft_packed_cuda(x, cfg)


@stft_packed_op.register_fake
def _(x, n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale):
    cfg = _cfg(n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale)
    return x.new_empty((*x.shape[:-1], num_frames(cfg, x.shape[-1]), 2 * cfg.f_bins))


@torch.library.custom_op("audiojax_torch::istft_packed", mutates_args=())
def istft_packed_op(spec: torch.Tensor, n_fft: int, hop: int, win_length: int, window: str,
                    center: bool, pad_mode: str, input_scale: float, output_scale: float,
                    out_length: int) -> torch.Tensor:
    """B2 as a registered operator (``out_length`` < 0: the whole signal)."""
    cfg = _cfg(n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale)
    length = None if out_length < 0 else out_length
    if spec.device.type == "cpu":
        return plain_istft_packed(spec, cfg, length)
    return istft_packed_cuda(spec, cfg, length)


@istft_packed_op.register_fake
def _(spec, n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale,
      out_length):
    cfg = _cfg(n_fft, hop, win_length, window, center, pad_mode, input_scale, output_scale)
    n_t = spec.shape[-2]
    end = _out_end(cfg, n_t, cfg.n_fft + cfg.hop * (n_t - 1),
                   None if out_length < 0 else out_length)
    return spec.new_empty((*spec.shape[:-2], end - (cfg.half if cfg.center else 0)))


def _fft_flops(n: int) -> float:
    """Operations of one length-``n`` FFT, 5/2·n·log2(n) (``chip_smoke.py``'s count)."""
    return 2.5 * n * math.log2(n)


@register_flop_formula(torch.ops.audiojax_torch.stft_packed)
def _(x_shape, n_fft, *args, out_shape=None, **kwargs) -> int:
    """Each frame's FFT and window product."""
    return int(math.prod(out_shape[:-1]) * (_fft_flops(n_fft) + n_fft))


@register_flop_formula(torch.ops.audiojax_torch.istft_packed)
def _(spec_shape, n_fft, *args, out_shape=None, **kwargs) -> int:
    """Each frame's FFT, window product and overlap-add, and the COLA scaling."""
    return int(math.prod(spec_shape[:-1]) * (_fft_flops(n_fft) + 2 * n_fft)
               + math.prod(out_shape))


def fast_stft_packed(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """STFT: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _build.through_ops():
        return torch.ops.audiojax_torch.stft_packed(x, *_cfg_args(cfg))
    if x.device.type == "cpu":
        return plain_stft_packed(x, cfg)
    return stft_packed_cuda(x, cfg)


def fast_istft_packed(spec: torch.Tensor, cfg: StftConfig,
                      out_length: int | None = None) -> torch.Tensor:
    """ISTFT: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _build.through_ops():
        return torch.ops.audiojax_torch.istft_packed(
            spec, *_cfg_args(cfg), -1 if out_length is None else out_length)
    if spec.device.type == "cpu":
        return plain_istft_packed(spec, cfg, out_length)
    return istft_packed_cuda(spec, cfg, out_length)
