"""Plain float32 PyTorch operations that the benchmark's references are built from.

Nothing here imports the program under test: every function is written out
with ``torch`` and ``numpy`` alone (library convolutions, products and FFTs),
so the references share no code with the kernels they judge.  Feature maps
are channel-last ``(B, T, C)`` or ``(B, T, F, C)``; weights are in torch's
layouts: dense ``(in, out)``, conv1d ``(out, in/groups, k)``, conv2d
``(out, in/groups, kh, kw)``.

The functions that stand where the program runs a hand-written kernel
(:func:`conv1d` on its depthwise and grouped routes, :func:`quad_attention`,
:func:`stft`, :func:`istft`) append each call's kind and least work (its
operations, and its bytes with each input read once and each output written
once, float32) to the list that :func:`record_calls` opens, so the benchmark
can work out each kernel's least time at the shapes a request ran
(``benchmark.bounds`` has the card's peaks).  A reference module that
stands in for another kernel records it the same way, with :func:`record`
and its own arithmetic.  The operation counts are the function's least work,
whatever a kernel's design does again: a depthwise or grouped conv's
multiply-adds, the relu² attention's two products, an FFT of each frame by
the classic 5/2·n·log2(n) count plus the window product (and for the
inverse the overlap-add and the envelope's scaling).  The routing rule is
the program's published contract: a conv1d with one input channel a group,
as many groups as channels and stride 1 is a depthwise call; one with two
input channels and one output a group, ``C == 2·groups`` and stride 1 is a
grouped call.
"""
from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_calls: list | None = None
F32 = 4  # bytes an element


@contextlib.contextmanager
def record_calls():
    """Collect ``(kind, operations, bytes)`` of every kernel-shaped call made
    inside."""
    global _calls
    previous, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = previous


def record(kind: str, ops: float, nbytes: float) -> None:
    """Note one call of the kernel ``kind`` and its least work."""
    if _calls is not None:
        _calls.append((kind, float(ops), float(nbytes)))


def _fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    return y + p["b"] if "b" in p else y


def prelu(alpha, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def layer_norm(x: torch.Tensor, ndims: int = 1, eps: float = 1e-5, g=None, b=None):
    return F.layer_norm(x, x.shape[x.ndim - ndims:], g, b, eps)


def _pair(pad) -> tuple[int, int]:
    return (pad, pad) if isinstance(pad, int) else (int(pad[0]), int(pad[1]))


def conv1d(p, x: torch.Tensor, *, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """Channel-last conv1d, x (B, T, C) → (B, T', O); a negative pad crops."""
    w = p["w"]
    lo, hi = _pair(padding)
    if min(lo, hi) < 0:
        x = x[:, max(0, -lo): x.shape[1] - max(0, -hi)]
        lo, hi = max(0, lo), max(0, hi)
    b, t, c = x.shape
    k = w.shape[-1]
    t_out = t + lo + hi - dilation * (k - 1)
    if groups > 1 and stride == 1 and w.shape[1] == 1 and w.shape[0] == groups == c:
        record("dwconv", 2.0 * b * t_out * c * k, F32 * (b * t * c + k * c + b * t_out * c))
    elif (groups > 1 and stride == 1 and w.shape[1] == 2 and w.shape[0] == groups
          and c == 2 * groups):
        o = c // 2
        record("dwconv_grouped", 2.0 * b * t_out * o * 2 * k,
               F32 * (b * t * c + k * c + b * t_out * o))
    xc = F.pad(x.transpose(1, 2), (lo, hi))
    y = F.conv1d(xc, w, p.get("b"), stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv1d_transpose(p, x: torch.Tensor, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d geometry, run as a forward conv over the
    zero-stuffed input with the equivalent forward kernel ``p['w']``."""
    k = p["w"].shape[-1]
    if stride != 1:
        b, t, c = x.shape
        z = x.new_zeros((b, (t - 1) * stride + 1, c))
        z[:, ::stride] = x
        x = z
    eff = k - 1 - padding
    return conv1d(p, x, padding=(eff, eff))


def conv2d(p, x: torch.Tensor, *, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
           groups: int = 1) -> torch.Tensor:
    """Channel-last conv2d, x (B, H, W, C) → (B, H', W', O)."""
    (hl, hr), (wl, wr) = _pair(padding[0]), _pair(padding[1])
    xc = F.pad(x.permute(0, 3, 1, 2), (wl, wr, hl, hr))
    y = F.conv2d(xc, p["w"], p.get("b"), stride=tuple(stride), dilation=tuple(dilation),
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def quad_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                   mask_diag: bool = False) -> torch.Tensor:
    """relu(q·kᵀ·scale)² · v over (N, S, ·) in float32."""
    n, s, dk = q.shape
    dv = v.shape[-1]
    record("quad_attention", 2.0 * n * s * s * (dk + dv), F32 * n * s * (2 * dk + dv + dv))
    attn = torch.square(torch.relu(torch.matmul(q, k.transpose(1, 2)) * scale))
    if mask_diag:
        attn = attn.masked_fill(torch.eye(s, dtype=torch.bool, device=q.device), 0.0)
    return torch.matmul(attn, v)


def rotary(x: torch.Tensor, rot_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair rotary embedding of the first ``rot_dim`` channels of
    x (..., T, D) by position along T."""
    t = x.shape[-2]
    cos, sin = (torch.from_numpy(a).to(x.device) for a in _rotary_np(t, rot_dim, theta))
    head, tail = x[..., :rot_dim], x[..., rot_dim:]
    even, odd = head[..., 0::2], head[..., 1::2]
    rot = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1)
    return torch.cat([rot.flatten(-2), tail], dim=-1)


@lru_cache(maxsize=None)
def _rotary_np(length: int, rot_dim: int, theta: float):
    freqs = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    ang = np.arange(length, dtype=np.float64)[:, None] * freqs[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def sinusoid_np(length: int, dim: int) -> np.ndarray:
    """``[sin | cos]`` positional table (T, dim)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


# ── STFT / ISTFT: centred frames, a periodic window, numpy-free FFTs ─────────


@lru_cache(maxsize=None)
def window_np(name: str, n: int) -> np.ndarray:
    """Periodic Hamming or Hann window of ``n`` samples (float64)."""
    k = np.arange(n, dtype=np.float64)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / n)
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    raise ValueError(f"no window {name!r} in the reference")


def stft(x: torch.Tensor, n_fft: int, hop: int, window: str, pad_mode: str) -> torch.Tensor:
    """(B, L) → packed (B, T, 2F) [real | imag], centred frames."""
    b, length = x.shape
    half = n_fft // 2
    n_t = (length + 2 * half - n_fft) // hop + 1
    record("stft", b * n_t * (_fft_flops(n_fft) + n_fft),
           F32 * (b * length + n_fft + b * n_t * 2 * (half + 1)))
    xp = F.pad(x[:, None], (half, half), mode=pad_mode)[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    win = torch.from_numpy(window_np(window, n_fft).astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return torch.cat([spec.real, spec.imag], dim=-1)


@lru_cache(maxsize=None)
def _inv_envelope_np(window: str, n_fft: int, hop: int, n_t: int) -> np.ndarray:
    w2 = window_np(window, n_fft) ** 2
    raw = n_fft + hop * (n_t - 1)
    acc = np.zeros(raw)
    for t in range(n_t):
        acc[t * hop: t * hop + n_fft] += w2
    acc = acc[n_fft // 2: raw - n_fft // 2]
    return np.where(acc == 0.0, 1.0, 1.0 / np.maximum(acc, 1e-300)).astype(np.float32)


def istft(packed: torch.Tensor, n_fft: int, hop: int, window: str) -> torch.Tensor:
    """packed (B, T, 2F) → (B, hop·(T − 1)): inverse FFT, window, overlap-add,
    the window² envelope divided out, the centre pads trimmed."""
    b, n_t, f2 = packed.shape
    out_len = hop * (n_t - 1)
    record("istft", b * n_t * (_fft_flops(n_fft) + 2 * n_fft) + b * out_len,
           F32 * (b * n_t * 2 * (n_fft // 2 + 1) + n_fft + b * out_len))
    fb = f2 // 2
    spec = torch.complex(packed[..., :fb], packed[..., fb:])
    win = torch.from_numpy(window_np(window, n_fft).astype(np.float32)).to(packed.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win  # (B, T, n_fft)
    raw_len = n_fft + hop * (n_t - 1)
    raw = F.fold(frames.transpose(1, 2), (1, raw_len), (1, n_fft), stride=(1, hop))
    raw = raw.reshape(b, raw_len)[:, n_fft // 2: raw_len - n_fft // 2]
    inv = torch.from_numpy(_inv_envelope_np(window, n_fft, hop, n_t)).to(packed.device)
    return raw * inv


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class Table:
    """Rows ``(path, shape, lo, hi)`` of a model's parameters: each leaf is
    drawn uniform on [lo, hi).  Weights take Glorot's limit over their fan-in
    and fan-out in torch's layout; biases, gains, slopes and offsets a narrow
    band around the value a freshly built model holds, so that every path of
    the forward carries a number that matters."""

    BIAS = (-0.05, 0.05)

    def __init__(self):
        self.rows: list[tuple[str, tuple, float, float]] = []

    def add(self, path: str, shape, lo: float, hi: float) -> None:
        self.rows.append((path, tuple(int(s) for s in shape), float(lo), float(hi)))

    def weight(self, path: str, shape) -> None:
        shape = tuple(shape)
        if len(shape) == 2:  # dense (in, out)
            fan_in, fan_out = shape
        else:  # conv (out, in/groups, k…)
            fan_in, fan_out = int(np.prod(shape[1:])), shape[0]
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        self.add(path, shape, -lim, lim)

    def dense(self, path: str, din: int, dout: int, bias: bool = True) -> None:
        self.weight(f"{path}/w", (din, dout))
        if bias:
            self.add(f"{path}/b", (dout,), *self.BIAS)

    def conv(self, path: str, kernel: tuple, cin: int, cout: int, groups: int = 1,
             bias: bool = True) -> None:
        self.weight(f"{path}/w", (cout, cin // groups, *kernel))
        if bias:
            self.add(f"{path}/b", (cout,), *self.BIAS)

    def norm(self, path: str, c: int) -> None:
        self.gain(f"{path}/g", (c,))
        self.add(f"{path}/b", (c,), *self.BIAS)

    def gain(self, path: str, shape, value: float = 1.0) -> None:
        self.add(path, shape, 0.9 * value, 1.1 * value)

    def offset(self, path: str, shape) -> None:
        self.add(path, shape, *self.BIAS)
