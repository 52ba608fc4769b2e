"""GTCRN — 16 kHz speech denoiser, offline path, in PyTorch.

Counterpart of ``audiojax.models.gtcrn``: ERB 65+64 band split, SFE subband
unfolding, conv encoder/decoder with causal group-temporal conv blocks
(dilations 1/2/5), TRA recurrent attention, two grouped dual-path GRU blocks
over frequency (width 33) and time, complex ratio mask, int16 PCM contract
with the STFT (512/256, hann_sqrt, reflect) on the card's kernels.

Layout is channel-last ``(B, T, F, C)`` throughout, as in the JAX package.
Streaming (state carry) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import fold_windows, pcm_in, pcm_out, remove_dc, resample_linear, unfold_windows
from ..dsp.stft import StftConfig
from ..nn import core, rnn
from ..nn.erb import erb_compress, erb_expand
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, conv_np, dense_np

__all__ = [
    "GtcrnConfig",
    "GTCRN",
    "sfe",
    "tra",
    "conv_block",
    "gt_conv_block",
    "dpgrnn",
    "gtcrn_backbone",
    "gtcrn_net",
    "gtcrn_forward",
    "init_gtcrn",
    "make_gtcrn",
]


@dataclasses.dataclass(frozen=True)
class GtcrnConfig:
    n_fft: int = 512
    hop: int = 256
    window: str = "hann_sqrt"
    pad_mode: str = "reflect"
    n_low: int = 65
    n_erb: int = 64
    channels: int = 16
    width: int = 33  # frequency width at the dual-path stage
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0  # batch-fold window length in samples; 0 = off
    center: bool = True
    erb_scale: float = 21.4
    dec_gt_deconv: bool = True  # decoder GT depth convs as transposed convs

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode=self.pad_mode, center=self.center)


# ─────────────────────────────────────────────────────────────────────────────
# Blocks
# ─────────────────────────────────────────────────────────────────────────────


def sfe(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Subband feature extraction: channel-last unfold over frequency.

    Output channel c*kernel+o is input channel c shifted by (o - k//2) bins.
    """
    half = (kernel - 1) // 2
    f = x.shape[-2]
    xp = F.pad(x, (0, 0, half, half))
    shifted = [xp[..., o : o + f, :] for o in range(kernel)]
    return torch.stack(shifted, dim=-1).reshape(*x.shape[:-1], x.shape[-1] * kernel)


def tra(p, x: torch.Tensor) -> torch.Tensor:
    """Temporal recurrent attention: GRU over per-frame channel energies."""
    z = torch.mean(x * x, dim=-2)  # (B, T, C)
    g = rnn.gru(p["gru"], z)
    a = torch.sigmoid(core.dense(p["fc"], g))
    return x * a[..., None, :]


def conv_block(p, x, *, stride, padding, groups=1, deconv=False, last=False):
    f = core.conv2d_transpose if deconv else core.conv2d
    y = f(p["conv"], x, stride=stride, padding=padding, groups=groups)
    return torch.tanh(y) if last else core.prelu(p, y)


def gt_conv_block(p, x: torch.Tensor, *, dilation: int, deconv: bool) -> torch.Tensor:
    """Group temporal conv block, offline.

    Causal over time: the encoder pads (k-1)·d zero frames on the left; the
    decoder uses a transposed conv and trims the (k-1)·d tail frames.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    pad_t = 2 * dilation  # (kernel_t - 1) * dilation with kernel_t = 3

    h = core.prelu(p["pc1"], core.conv2d(p["pc1"], sfe(x1)))
    if deconv:
        h = core.conv2d_transpose(p["depth"], h, padding=(0, 1), dilation=(dilation, 1),
                                  groups=h.shape[-1])
        h = h[:, :-pad_t]
    else:
        hx = F.pad(h, (0, 0, 0, 0, pad_t, 0))  # zero history frames
        h = core.conv2d(p["depth"], hx, padding=(0, 1), dilation=(dilation, 1),
                        groups=hx.shape[-1])
    h = core.prelu(p["depth_a"], h)
    h = core.conv2d(p["pc2"], h)
    h = tra(p["tra"], h)
    # interleave transformed/bypass channels: out[2i]=h[i], out[2i+1]=x2[i]
    return torch.stack([h, x2], dim=-1).reshape(*x.shape[:-1], 2 * half)


def dpgrnn(p, x: torch.Tensor, *, width: int, hidden: int) -> torch.Tensor:
    """Grouped dual-path RNN over (freq=width) then (time), each path with
    Linear + LayerNorm((width, hidden)) + residual."""
    b, t, w, c = x.shape

    intra = x.reshape(b * t, w, c)
    intra = rnn.grouped_gru_bidir(p["intra_fwd"], p["intra_bwd"], intra, groups=2)
    intra = core.dense(p["intra_fc"], intra).reshape(b, t, w, hidden)
    x = x + core.layer_norm(p["intra_ln"], intra, ndims=2, eps=1e-8)

    inter = x.transpose(1, 2).reshape(b * w, t, c)
    inter = rnn.grouped_gru(p["inter"], inter, groups=2)
    inter = core.dense(p["inter_fc"], inter).reshape(b, w, t, hidden)
    return x + core.layer_norm(p["inter_ln"], inter.transpose(1, 2), ndims=2, eps=1e-8)


# ─────────────────────────────────────────────────────────────────────────────
# Network
# ─────────────────────────────────────────────────────────────────────────────

_ENC_DIL = (1, 2, 5)


def gtcrn_backbone(p, feat: torch.Tensor, cfg: GtcrnConfig) -> torch.Tensor:
    """ERB-compressed feature map (B, T, F, C) → complex mask (B, T, F, 2)."""
    feat = erb_compress(feat, cfg.n_low, cfg.n_erb, cfg.n_fft, scale=cfg.erb_scale)
    feat = sfe(feat)  # (B, T, 129, 3C)

    e = conv_block(p["enc0"], feat, stride=(1, 2), padding=(0, 2))
    skips = [e]
    e = conv_block(p["enc1"], e, stride=(1, 2), padding=(0, 2), groups=2)
    skips.append(e)
    for i, d in enumerate(_ENC_DIL):
        e = gt_conv_block(p[f"enc_gt{i}"], e, dilation=d, deconv=False)
        skips.append(e)

    e = dpgrnn(p["dp1"], e, width=cfg.width, hidden=cfg.channels)
    e = dpgrnn(p["dp2"], e, width=cfg.width, hidden=cfg.channels)

    for i, d in enumerate(reversed(_ENC_DIL)):
        e = gt_conv_block(p[f"dec_gt{i}"], e + skips[4 - i], dilation=d,
                          deconv=cfg.dec_gt_deconv)
    e = conv_block(p["dec1"], e + skips[1], stride=(1, 2), padding=(0, 2), groups=2, deconv=True)
    m = conv_block(p["dec0"], e + skips[0], stride=(1, 2), padding=(0, 2), deconv=True, last=True)
    return erb_expand(m, cfg.n_low, cfg.n_erb, cfg.n_fft, scale=cfg.erb_scale)


def gtcrn_net(p, spec_ri: torch.Tensor, cfg: GtcrnConfig) -> torch.Tensor:
    """Enhance a packed spectrum: (B, T, 2F) → (B, T, 2F)."""
    fb = cfg.stft.f_bins
    re, im = spec_ri[..., :fb], spec_ri[..., fb:]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    feat = torch.stack([mag, re, im], dim=-1)  # (B, T, F, 3)
    m = gtcrn_backbone(p, feat, cfg)
    m0, m1 = m[..., 0], m[..., 1]
    return torch.cat([re * m0 - im * m1, im * m0 + re * m1], dim=-1)


def gtcrn_forward(params, audio: torch.Tensor, cfg: GtcrnConfig = GtcrnConfig()) -> torch.Tensor:
    """int16 PCM (B, L) → denoised int16 PCM (B, L).

    Resample sandwich, 1/32768 scale, DC removal, optional batch-fold, STFT
    kernel, network, ISTFT kernel, ×32767 + int16 clamp.
    """
    x = pcm_in(audio)
    if cfg.in_sample_rate > cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)
    x = remove_dc(x)
    if cfg.in_sample_rate < cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)

    batch = x.shape[0]
    model_len = x.shape[-1]
    # pad to a whole number of hops (or fold windows) so STFT→ISTFT is
    # length-exact
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = -(-model_len // align) * align
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    spec = fast_stft_packed(x.contiguous(), cfg.stft)
    enhanced = gtcrn_net(params, spec, cfg)
    y = fast_istft_packed(enhanced.contiguous(), cfg.stft)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, y.shape[-1] * cfg.out_sample_rate // cfg.sample_rate)
    return pcm_out(y)


def make_gtcrn(cfg: GtcrnConfig = GtcrnConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(gtcrn_forward, cfg=cfg)


class GTCRN(ParamModule):
    """GTCRN with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape.  ``params`` is the nested dict view
    that the functional API takes.
    """

    def __init__(self, params, cfg: GtcrnConfig = GtcrnConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return gtcrn_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _gru_np(rng, din, hidden, stack=()):
    s = 1.0 / np.sqrt(hidden)
    u = lambda *sh: rng.uniform(-s, s, stack + sh).astype(np.float32)
    return {"w_i": u(din, 3 * hidden), "w_h": u(hidden, 3 * hidden),
            "b_i": u(3 * hidden), "b_h": u(3 * hidden)}


def _alpha(c):
    return np.full((c,), 0.25, np.float32)


def _conv_block_np(rng, cin, cout, groups=1, last=False):
    p = {"conv": conv_np(rng, (1, 5), cin, cout, groups=groups)}
    if not last:
        p["alpha"] = _alpha(cout)
    return p


def _gt_block_np(rng, c):
    half, hid = c // 2, c
    return {
        "pc1": {**conv_np(rng, (1, 1), half * 3, hid), "alpha": _alpha(hid)},
        "depth": conv_np(rng, (3, 3), hid, hid, groups=hid),
        "depth_a": {"alpha": _alpha(hid)},
        "pc2": conv_np(rng, (1, 1), hid, half),
        "tra": {"gru": _gru_np(rng, half, 2 * half), "fc": dense_np(rng, 2 * half, half)},
    }


def _dpgrnn_np(rng, c, width):
    ln = lambda: {"g": np.ones((width, c), np.float32), "b": np.zeros((width, c), np.float32)}
    return {
        "intra_fwd": _gru_np(rng, c // 2, c // 4, stack=(2,)),
        "intra_bwd": _gru_np(rng, c // 2, c // 4, stack=(2,)),
        "intra_fc": dense_np(rng, c, c),
        "intra_ln": ln(),
        "inter": _gru_np(rng, c // 2, c // 2, stack=(2,)),
        "inter_fc": dense_np(rng, c, c),
        "inter_ln": ln(),
    }


def init_gtcrn_numpy(seed: int = 0, cfg: GtcrnConfig = GtcrnConfig()) -> dict:
    """Random GTCRN parameters as numpy arrays, with the JAX package's keys,
    shapes and layouts (``audiojax.models.gtcrn.init_gtcrn``), drawn from
    ``numpy.random.default_rng(seed)`` with the same distributions."""
    rng = np.random.default_rng(seed)
    c = cfg.channels
    params = {
        "enc0": _conv_block_np(rng, 9, c),
        "enc1": _conv_block_np(rng, c, c, groups=2),
        "dec1": _conv_block_np(rng, c, c, groups=2),
        "dec0": _conv_block_np(rng, c, 2, last=True),
        "dp1": _dpgrnn_np(rng, c, cfg.width),
        "dp2": _dpgrnn_np(rng, c, cfg.width),
    }
    for i in range(3):
        params[f"enc_gt{i}"] = _gt_block_np(rng, c)
        params[f"dec_gt{i}"] = _gt_block_np(rng, c)
    return params


def init_gtcrn(seed: int = 0, cfg: GtcrnConfig = GtcrnConfig(), device=None) -> dict:
    """Random GTCRN parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_gtcrn_numpy(seed, cfg), device)
