"""ICCRN building blocks shared by SDAEC and Deep-Echo, in PyTorch.

Counterpart of ``audiojax.nn.cfb``: the convolutional-fusion block (CFB),
its cepstral unit (CepsUnit), the ICCRN LayerNorm over the (F, C) plane with
an unbiased variance, and the channel-wise LSTMs over frequency (CH_LSTM_F,
bidirectional) and time (CH_LSTM_T, stacked, with carried state).

Layout: channel-last ``(B, T, F, C)`` with F = 160 spectral bins (n_fft 319).
The cepstral transform is a 160-point real DFT over the frequency axis (81
quefrency bins), two true-float32 matrix products with bases computed in
float64 numpy (the forward cos/−sin table; the inverse the pseudo-inverse of
its stacked rows) and cast once to float32, as the JAX package does.  No
Pallas kernel is on this path: the products run on cuBLAS, the (1, 3)
frequency conv on cuDNN, and the LSTMs are Python loops of small launches
(``nn.rnn.lstm``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.stft import _on_device
from ..models.base import conv_np, dense_np
from . import core
from .rnn import init_lstm_numpy, lstm, lstm_bidir

__all__ = [
    "iccrn_layer_norm",
    "ch_lstm_f",
    "ch_lstm_t",
    "ceps_unit",
    "cfb",
    "init_iccrn_ln_numpy",
    "init_ch_lstm_f_numpy",
    "init_ch_lstm_t_numpy",
    "init_cfb_numpy",
]


def iccrn_layer_norm(p, x: torch.Tensor, eps_base: float) -> torch.Tensor:
    """Normalise over the (F, C) plane per (batch, frame) with the unbiased
    variance (the centred energy over c·f − 1); ``p``: w, b of shape (F, C).
    The gain is keyed ``w``, so a q8 plan quantizes it where it is large: it
    is read through ``core.as_weight`` (the JAX package reads it raw and
    refuses a q8dyn tree here)."""
    f, c = x.shape[-2], x.shape[-1]
    xc = x - torch.mean(x, dim=(-2, -1), keepdim=True)
    var_u = torch.sum(xc * xc, dim=(-2, -1), keepdim=True) / float(f * c - 1)
    return xc * torch.rsqrt(var_u + eps_base) * core.as_weight(p["w"]) + p["b"]


def ch_lstm_f(p, x: torch.Tensor, *, with_linear: bool = True) -> torch.Tensor:
    """Bidirectional LSTM over the frequency axis: x (B, T, F, C) → raw
    (B, T, F, 2·feat) or linear-projected (B, T, F, out)."""
    b, t, f, c = x.shape
    y = lstm_bidir(p["fwd"], p["bwd"], x.reshape(b * t, f, c))
    if with_linear:
        y = core.dense(p["linear"], y)
    return y.reshape(b, t, f, -1)


def ch_lstm_t(p, x: torch.Tensor, *, with_linear: bool = True, state=None,
              return_state: bool = False):
    """Unidirectional (optionally stacked) LSTM over the time axis:
    x (B, T, F, C) → (B, T, F, out).  ``state`` holds per-layer (h, c) pairs,
    each (B·F, hidden), batch-major: it carries the time recurrence across
    streaming chunks."""
    b, t, f, c = x.shape
    seq = x.transpose(1, 2).reshape(b * f, t, c)
    new_state = []
    for i, lp in enumerate(p["layers"]):
        seq, last = lstm(lp, seq, None if state is None else state[i], return_state=True)
        new_state.append(last)
    if with_linear:
        seq = core.dense(p["linear"], seq)
    out = seq.reshape(b, f, t, -1).transpose(1, 2)
    return (out, new_state) if return_state else out


@lru_cache(maxsize=None)
def _ceps_bases(n: int = 160) -> tuple[np.ndarray, np.ndarray]:
    """(forward (n, 2·F2), inverse (2·F2, n)) cepstral DFT bases, computed in
    float64 and cast once to float32 (``audiojax.nn.cfb._ceps_bases``)."""
    bins = n // 2 + 1
    t = np.arange(n, dtype=np.float64)[:, None]
    f = np.arange(bins, dtype=np.float64)[None, :]
    omega = 2.0 * np.pi * t * f / n
    fwd = np.concatenate([np.cos(omega), -np.sin(omega)], axis=1)  # (n, 2·bins)
    stack = np.concatenate([np.cos(omega).T, -np.sin(omega).T], axis=0)  # (2·bins, n)
    inv = np.linalg.pinv(stack)  # (n, 2·bins)
    return fwd.astype(np.float32), inv.T.astype(np.float32)


@lru_cache(maxsize=None)
def _ceps_analysis_np(n: int) -> np.ndarray:
    """The forward basis transposed, (2·F2, n): the left factor of the
    product over the frequency axis."""
    return np.ascontiguousarray(_ceps_bases(n)[0].T)


@lru_cache(maxsize=None)
def _ceps_synthesis_np(n: int) -> np.ndarray:
    """The inverse basis transposed, (n, 2·F2)."""
    return np.ascontiguousarray(_ceps_bases(n)[1].T)


def ceps_unit(p, x: torch.Tensor, eps_base: float) -> torch.Tensor:
    """Cepstral gating: 160-point real DFT over F → LN → bidirectional LSTM
    over quefrency → complex product with the cepstral spectrum → inverse DFT.
    x (B, T, 160, C) → (B, T, 160, C)."""
    n, ch = x.shape[-2], x.shape[-1]
    bins = n // 2 + 1
    spec = torch.matmul(_on_device(_ceps_analysis_np, x.device, n), x)  # (B, T, 2·bins, C)
    re, im = spec[..., :bins, :], spec[..., bins:, :]
    gate = ch_lstm_f(p["lstm"], iccrn_layer_norm(p["ln"], torch.cat([re, im], dim=-1),
                                                 eps_base))
    gr, gi = gate[..., :ch], gate[..., ch:]
    packed = torch.cat([gr * re - gi * im, gr * im + gi * re], dim=-2)  # (B, T, 2·bins, C)
    return torch.matmul(_on_device(_ceps_synthesis_np, x.device, n), packed)


def cfb(p, x: torch.Tensor, eps_base: float) -> torch.Tensor:
    """Convolutional-fusion block: gate = σ(1×1(LN0 x)); h = 1×1(x);
    y = conv_F3(LN1(g·h)) + CepsUnit(LN2(h − g·h))."""
    g = torch.sigmoid(core.dense(p["gate"], iccrn_layer_norm(p["ln0"], x, eps_base)))
    h = core.dense(p["input"], x)
    gx = g * h
    y = core.conv2d(p["conv"], iccrn_layer_norm(p["ln1"], gx, eps_base), padding=(0, 1))
    return y + ceps_unit(p["ceps"], iccrn_layer_norm(p["ln2"], h - gx, eps_base), eps_base)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draws in the JAX package's layouts)
# ─────────────────────────────────────────────────────────────────────────────


def init_iccrn_ln_numpy(f: int, c: int) -> dict:
    return {"w": np.ones((f, c), np.float32), "b": np.zeros((f, c), np.float32)}


def init_ch_lstm_f_numpy(rng: np.random.Generator, c_in: int, feat: int,
                         out: int | None = None) -> dict:
    p = {"fwd": init_lstm_numpy(rng, c_in, feat), "bwd": init_lstm_numpy(rng, c_in, feat)}
    if out is not None:
        p["linear"] = dense_np(rng, 2 * feat, out)
    return p


def init_ch_lstm_t_numpy(rng: np.random.Generator, c_in: int, feat: int,
                         out: int | None = None, num_layers: int = 1) -> dict:
    layers, d = [], c_in
    for _ in range(num_layers):
        layers.append(init_lstm_numpy(rng, d, feat))
        d = feat
    p = {"layers": layers}
    if out is not None:
        p["linear"] = dense_np(rng, feat, out)
    return p


def init_cfb_numpy(rng: np.random.Generator, c_in: int, c_out: int, f: int = 160,
                   f2: int = 81) -> dict:
    """``audiojax.nn.cfb.init_cfb``'s keys, shapes and distributions."""
    return {
        "gate": dense_np(rng, c_in, c_out),
        "input": dense_np(rng, c_in, c_out),
        "conv": conv_np(rng, (1, 3), c_out, c_out),
        "ln0": init_iccrn_ln_numpy(f, c_in),
        "ln1": init_iccrn_ln_numpy(f, c_out),
        "ln2": init_iccrn_ln_numpy(f, c_out),
        "ceps": {
            "ln": init_iccrn_ln_numpy(f2, 2 * c_out),
            "lstm": init_ch_lstm_f_numpy(rng, 2 * c_out, c_out, 2 * c_out),
        },
    }
