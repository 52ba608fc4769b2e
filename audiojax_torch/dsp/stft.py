"""Matmul-DFT STFT / ISTFT in plain PyTorch — the twins of the CUDA kernels.

Counterpart of ``audiojax.dsp.stft``.  These functions are the CPU path and
the oracle that ``ops.stft_cuda``'s kernels are held against: framing plus
one (…·T, n_fft) × (n_fft, 2F) product for the STFT, and one
(…·T, 2F) × (2F, n_fft) product plus overlap-add, COLA reciprocal and
centre trim for the ISTFT.

Layouts: audio is ``(..., L)``; spectra are time-major packed
``(..., T, 2F)`` with [real | imag] on the last axis.  ``stft`` / ``istft``
/ ``istft_polar`` take the rectangular and polar forms and route through
the kernels' wrappers; ``stft_real`` is the cosine projection alone.

``stream_istft`` is the ISTFT of one streaming chunk with the overlap-add
tail carried between chunks and the steady-state COLA reciprocal
(``steady_cola_np``); it has no kernel of its own, as in the JAX package.

Bases, windows, the COLA reciprocal and the kernels' FFT plan (radix order
and twiddle table, ``fft_plan``) are computed in numpy float64 and cached per
config; their torch copies are cached per (config, device).
"""
from __future__ import annotations

import dataclasses
import sys
import types
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .windows import padded_window

__all__ = [
    "StftConfig",
    "num_frames",
    "istft_length",
    "pad_center",
    "frame_signal",
    "overlap_add",
    "stft",
    "stft_packed",
    "stft_real",
    "istft",
    "istft_packed",
    "istft_polar",
    "stream_istft",
    "steady_cola_np",
]


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Static STFT/ISTFT geometry; hashable so basis tables can be cached.

    ``input_scale`` / ``output_scale`` are folded into the DFT bases.
    """

    n_fft: int
    hop: int
    win_length: int | None = None
    window: str = "hann"
    center: bool = True
    pad_mode: str = "constant"  # 'constant' | 'reflect'
    input_scale: float = 1.0
    output_scale: float = 1.0

    @property
    def wl(self) -> int:
        return self.n_fft if self.win_length is None else self.win_length

    @property
    def half(self) -> int:
        return self.n_fft // 2

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1


def num_frames(cfg: StftConfig, length: int) -> int:
    """Number of full analysis frames for an input of ``length`` samples."""
    padded = length + 2 * cfg.half if cfg.center else length
    return (padded - cfg.n_fft) // cfg.hop + 1


def istft_length(cfg: StftConfig, n_frames: int) -> int:
    """Length of the ISTFT output for ``n_frames`` frames (after centre trim)."""
    raw = cfg.n_fft + cfg.hop * (n_frames - 1)
    return raw - 2 * cfg.half if cfg.center else raw


# ─────────────────────────────────────────────────────────────────────────────
# Precomputed constants (numpy float64, cached per config)
# ─────────────────────────────────────────────────────────────────────────────


@lru_cache(maxsize=None)
def _window_np(cfg: StftConfig) -> np.ndarray:
    return padded_window(cfg.window, cfg.wl, cfg.n_fft)


@lru_cache(maxsize=None)
def _stft_basis_np(cfg: StftConfig) -> np.ndarray:
    """(n_fft, 2F) windowed forward-DFT basis: [cos | -sin] * window * scale."""
    n = np.arange(cfg.n_fft, dtype=np.float64)[:, None]
    f = np.arange(cfg.f_bins, dtype=np.float64)[None, :]
    omega = 2.0 * np.pi / cfg.n_fft * n * f
    w = (_window_np(cfg) * cfg.input_scale)[:, None]
    basis = np.concatenate([np.cos(omega) * w, -np.sin(omega) * w], axis=1)
    return basis.astype(np.float32)


@lru_cache(maxsize=None)
def _istft_basis_np(cfg: StftConfig) -> np.ndarray:
    """(2F, n_fft) windowed inverse-DFT basis with one-sided 2/N scaling
    (bins 0 and Nyquist scaled 1/N, interior bins 2/N)."""
    k = np.arange(cfg.f_bins, dtype=np.float64)[:, None]
    n = np.arange(cfg.n_fft, dtype=np.float64)[None, :]
    omega = 2.0 * np.pi / cfg.n_fft * k * n
    scale = np.full((cfg.f_bins, 1), 2.0)
    scale[0, 0] = 1.0
    if cfg.n_fft % 2 == 0:
        scale[-1, 0] = 1.0
    w = _window_np(cfg)[None, :] / cfg.n_fft
    real_rows = scale * np.cos(omega) * w
    imag_rows = scale * -np.sin(omega) * w
    return np.concatenate([real_rows, imag_rows], axis=0).astype(np.float32)


@lru_cache(maxsize=None)
def _inv_win_sum_np(cfg: StftConfig, n_frames: int, out_length: int | None) -> np.ndarray:
    """Reciprocal COLA normaliser, pre-sliced to the output region.

    The window² overlap sum is computed in float64 and stored as its
    reciprocal; zeros map to 1 so silent COLA gaps pass zeros through
    instead of inf.  ``out_length`` takes exactly that many samples from the
    output start, reaching into the right centre-pad region where the COLA
    sum decays.
    """
    w2 = _window_np(cfg) ** 2
    raw = cfg.n_fft + cfg.hop * (n_frames - 1)
    acc = np.zeros(raw)
    for t in range(n_frames):
        acc[t * cfg.hop : t * cfg.hop + cfg.n_fft] += w2
    start = cfg.half if cfg.center else 0
    end = start + out_length if out_length is not None else (raw - start)
    acc = acc[start:end]
    inv = np.where(acc == 0.0, 1.0, 1.0 / np.maximum(acc, 1e-300))
    return (inv * cfg.output_scale).astype(np.float32)


# ─────────────────────────────────────────────────────────────────────────────
# FFT plan of the CUDA kernels (``ops.stft_cuda``)
# ─────────────────────────────────────────────────────────────────────────────

# Radices with their own butterflies in csrc/stft.cu; any other prime factor
# runs the generic radix-p stage.
FIXED_RADICES = (2, 3, 4, 5, 8)


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """A Stockham mixed-radix FFT of length ``m`` for one n_fft.

    Even n_fft transforms the n_fft/2 complex points z[i] = x[2i] + j·x[2i+1]
    and splits the result into the real input's spectrum; odd n_fft
    transforms all n_fft points.  Stage s (radix ``radices[s]``, ``ns`` the
    product of the radices before it) reads butterfly j's inputs at
    j + r·m/R and writes its outputs at (j − j mod ns)·R + j mod ns + r·ns.
    Its twiddles W_{ns·R}^{k·r} (k < ns, 0 < r < R) start at table entry
    ``offsets[s]``, k-major; a generic stage's R roots W_R^q follow them.
    For even n_fft, W_{n_fft}^k (0 ≤ k ≤ m) starts at ``post_offset``.
    """

    m: int
    radices: tuple[int, ...]
    offsets: tuple[int, ...]
    post_offset: int


def _radices(m: int) -> tuple[int, ...]:
    """Radix order: 8s, then 4s, greedily, then 2, 3, 5, then other primes
    ascending."""
    out = []
    for r in (8, 4):
        while m % r == 0:
            out.append(r)
            m //= r
    p = 2
    while m > 1:
        while m % p == 0:
            out.append(p)
            m //= p
        p += 1 if p == 2 else 2
    return tuple(out)


def _fft_stage_tables(n_fft: int) -> tuple[FftPlan, list[np.ndarray]]:
    m = n_fft // 2 if n_fft % 2 == 0 else n_fft
    radices = _radices(m)
    tables, offsets, ns, off = [], [], 1, 0
    for r in radices:
        kr = np.arange(ns)[:, None] * np.arange(1, r)[None, :]
        tw = np.exp(-2j * np.pi * kr.ravel() / (ns * r))
        if r not in FIXED_RADICES:
            tw = np.concatenate([tw, np.exp(-2j * np.pi * np.arange(r) / r)])
        offsets.append(off)
        tables.append(tw)
        off += tw.size
        ns *= r
    if n_fft % 2 == 0:
        tables.append(np.exp(-2j * np.pi * np.arange(m + 1) / n_fft))
    return FftPlan(m, radices, tuple(offsets), off), tables


@lru_cache(maxsize=None)
def fft_plan(n_fft: int) -> FftPlan:
    return _fft_stage_tables(n_fft)[0]


@lru_cache(maxsize=None)
def _fft_table_np(n_fft: int, dtype=np.float32) -> np.ndarray:
    """(entries, 2) [re, im] twiddle table of ``fft_plan(n_fft)``, computed
    in float64 and rounded once to ``dtype`` (float32 for B1, float64 for B2)."""
    t = np.concatenate(_fft_stage_tables(n_fft)[1])
    return np.stack([t.real, t.imag], axis=-1).astype(dtype)


@lru_cache(maxsize=None)
def _nyquist_imag_np(cfg: StftConfig) -> np.ndarray:
    """The plain basis's column of Im X[n_fft/2] (rounding noise times the
    window), which B1 takes its dot product with for even n_fft."""
    return np.ascontiguousarray(_stft_basis_np(cfg)[:, -1])


@lru_cache(maxsize=None)
def _analysis_window_np(cfg: StftConfig) -> np.ndarray:
    return (_window_np(cfg) * cfg.input_scale).astype(np.float32)


@lru_cache(maxsize=None)
def _synthesis_window_np(cfg: StftConfig) -> np.ndarray:
    """window / n_fft: the unnormalised inverse FFT's scale folded in."""
    return (_window_np(cfg) / cfg.n_fft).astype(np.float32)


@lru_cache(maxsize=None)
def _on_device(fn, device: torch.device, *args) -> torch.Tensor:
    """Device copy of a cached numpy table (one host→device copy per table)."""
    return torch.from_numpy(fn(*args)).to(device)


def stft_basis(cfg: StftConfig, device) -> torch.Tensor:
    return _on_device(_stft_basis_np, torch.device(device), cfg)


def istft_basis(cfg: StftConfig, device) -> torch.Tensor:
    return _on_device(_istft_basis_np, torch.device(device), cfg)


def inv_win_sum(cfg: StftConfig, n_frames: int, out_length: int | None, device) -> torch.Tensor:
    return _on_device(_inv_win_sum_np, torch.device(device), cfg, n_frames, out_length)


def fft_table(cfg: StftConfig, device, dtype=np.float32) -> torch.Tensor:
    return _on_device(_fft_table_np, torch.device(device), cfg.n_fft, dtype)


def analysis_window(cfg: StftConfig, device) -> torch.Tensor:
    return _on_device(_analysis_window_np, torch.device(device), cfg)


def nyquist_imag(cfg: StftConfig, device) -> torch.Tensor:
    return _on_device(_nyquist_imag_np, torch.device(device), cfg)


def synthesis_window(cfg: StftConfig, device) -> torch.Tensor:
    return _on_device(_synthesis_window_np, torch.device(device), cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Framing / overlap-add
# ─────────────────────────────────────────────────────────────────────────────


def pad_center(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Centre-pad ``half`` samples each side, reflect or constant."""
    if not cfg.center:
        return x
    h = cfg.half
    if cfg.pad_mode == "reflect":
        if x.shape[-1] < h + 1:
            # a short reflect pad would desynchronise the frame count from
            # num_frames()
            raise ValueError(
                f"reflect center-pad of {h} needs at least {h + 1} samples, "
                f"got {x.shape[-1]}")
        left = torch.flip(x[..., 1 : h + 1], dims=(-1,))
        right = torch.flip(x[..., -(h + 1) : -1], dims=(-1,))
        return torch.cat([left, x, right], dim=-1)
    return F.pad(x, (h, h))


def frame_signal(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Slice ``(..., L)`` into ``(..., T, n_fft)`` frames with stride ``hop``
    (a strided view of the centre-padded signal)."""
    x = pad_center(x, cfg)
    padded = x.shape[-1]
    if padded < cfg.n_fft:
        raise ValueError(f"input too short for STFT: {padded} < n_fft={cfg.n_fft}")
    return x.unfold(-1, cfg.n_fft, cfg.hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(..., T, N)`` frames at stride ``hop`` → ``(..., N + hop*(T-1))``.

    K = ceil(N/hop) shifted adds on a ``(T+K-1, hop)`` grid.
    """
    *lead, n_t, n = frames.shape
    k_seg = -(-n // hop)
    pad = k_seg * hop - n
    if pad:
        frames = F.pad(frames, (0, pad))
    fr = frames.reshape(*lead, n_t, k_seg, hop)
    out = frames.new_zeros((*lead, n_t + k_seg - 1, hop))
    for k in range(k_seg):
        out[..., k : k + n_t, :] += fr[..., :, k, :]
    raw = out.reshape(*lead, (n_t + k_seg - 1) * hop)
    return raw[..., : n + hop * (n_t - 1)]


# ─────────────────────────────────────────────────────────────────────────────
# Public STFT / ISTFT
# ─────────────────────────────────────────────────────────────────────────────


def stft_packed(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """STFT of ``(..., L)`` → packed ``(..., T, 2F)`` with [real | imag] lanes."""
    frames = frame_signal(x, cfg)
    return torch.matmul(frames, stft_basis(cfg, x.device))


def _out_end(cfg: StftConfig, n_t: int, raw_len: int, out_length: int | None) -> int:
    start = cfg.half if cfg.center else 0
    if out_length is None:
        return raw_len - start
    end = start + out_length
    if end > raw_len:
        # a silent short return would break static-shape consumers
        raise ValueError(
            f"out_length={out_length} exceeds the overlap-added signal: "
            f"{n_t} frames cover only {raw_len - start} output samples")
    return end


def istft_packed(spec: torch.Tensor, cfg: StftConfig, out_length: int | None = None) -> torch.Tensor:
    """ISTFT of packed ``(..., T, 2F)`` → ``(..., L_out)``.

    iDFT matmul → overlap-add → COLA reciprocal → centre trim; ``out_length``
    takes exactly that many samples from the output start.
    """
    n_t = spec.shape[-2]
    frames = torch.matmul(spec, istft_basis(cfg, spec.device))
    raw = overlap_add(frames, cfg.hop)
    start = cfg.half if cfg.center else 0
    end = _out_end(cfg, n_t, raw.shape[-1], out_length)
    return raw[..., start:end] * inv_win_sum(cfg, n_t, out_length, spec.device)


# ─────────────────────────────────────────────────────────────────────────────
# Rectangular and polar views over the packed transforms.  These route to
# the kernels on a CUDA tensor, as the models' calls do (``ops.stft_cuda``:
# B1 and B2 take (B, L) and (B, T, 2F), so the leading axes fold into B).
# ─────────────────────────────────────────────────────────────────────────────


def stft(x: torch.Tensor, cfg: StftConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of ``(..., L)`` → (real, imag), each ``(..., T, F)``."""
    from ..ops.stft_cuda import fast_stft_packed

    packed = fast_stft_packed(x.reshape(-1, x.shape[-1]).contiguous(), cfg)
    packed = packed.reshape(*x.shape[:-1], *packed.shape[1:])
    return packed[..., : cfg.f_bins], packed[..., cfg.f_bins :]


def stft_real(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """The real (cosine) projection alone, ``(..., T, F)``: the frames times
    the basis's real columns (no kernel, as in the JAX package)."""
    return torch.matmul(frame_signal(x, cfg), stft_basis(cfg, x.device)[:, : cfg.f_bins])


def istft(real: torch.Tensor, imag: torch.Tensor, cfg: StftConfig,
          out_length: int | None = None) -> torch.Tensor:
    """ISTFT from rectangular form, ``(..., T, F)`` each → ``(..., L_out)``."""
    from ..ops.stft_cuda import fast_istft_packed

    packed = torch.cat([real, imag], dim=-1)
    lead = packed.shape[:-2]
    y = fast_istft_packed(packed.reshape(-1, *packed.shape[-2:]).contiguous(), cfg, out_length)
    return y.reshape(*lead, y.shape[-1])


def istft_polar(magnitude: torch.Tensor, phase: torch.Tensor, cfg: StftConfig,
                out_length: int | None = None) -> torch.Tensor:
    """ISTFT from polar form."""
    return istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), cfg, out_length)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming ISTFT (state-carry serving)
# ─────────────────────────────────────────────────────────────────────────────


def steady_cola_np(cfg: StftConfig) -> np.ndarray:
    """Steady-state reciprocal COLA divisor: one hop of the hop-periodic
    window² overlap sum.  Streaming ISTFT paths tile it over the emitted
    samples."""
    w2 = _window_np(cfg) ** 2
    k = -(-cfg.n_fft // cfg.hop)
    acc = np.zeros(cfg.hop)
    for i in range(k):
        seg = w2[i * cfg.hop : (i + 1) * cfg.hop]
        acc[: len(seg)] += seg
    return (1.0 / np.maximum(acc, 1e-12)).astype(np.float32)


@lru_cache(maxsize=None)
def _steady_cola_tile_np(cfg: StftConfig, emit_len: int) -> np.ndarray:
    return np.tile(steady_cola_np(cfg), emit_len // cfg.hop)


def stream_istft(packed: torch.Tensor, cfg: StftConfig, ola_tail: torch.Tensor,
                 emit_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """iDFT + overlap-add of ONE streaming chunk of packed spectra.

    packed: (B, T, 2F) with T·hop == emit_len; ola_tail: (B, n_fft − hop)
    carried from the previous chunk.  Returns (float samples (B, emit_len)
    times the steady-state COLA reciprocal, new ola_tail).  The tables reach
    the device once (per config, and per ``emit_len`` for the reciprocal's
    tile), so a captured step copies nothing from the host."""
    frames = torch.matmul(packed, istft_basis(cfg, packed.device))
    raw = overlap_add(frames, cfg.hop)  # (B, T·hop + n_fft − hop)
    carry = cfg.n_fft - cfg.hop
    raw = torch.cat([raw[:, :carry] + ola_tail, raw[:, carry:]], dim=-1)
    divisor = _on_device(_steady_cola_tile_np, packed.device, cfg, emit_len)
    return raw[:, :emit_len] * divisor, raw[:, emit_len:]


class _CallableModule(types.ModuleType):
    """This module, callable as its :func:`stft`.  ``audiojax_torch.dsp``
    exports the function ``stft`` as the JAX package's ``dsp`` does, and its
    attribute ``stft`` stays this module, which callers import through the
    package (``from audiojax_torch.dsp import stft as D``): the one name
    serves both."""

    def __call__(self, x: torch.Tensor, cfg: StftConfig) -> tuple[torch.Tensor, torch.Tensor]:
        return stft(x, cfg)


sys.modules[__name__].__class__ = _CallableModule
