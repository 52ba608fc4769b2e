"""MossFormer2-SE-48K — 48 kHz speech enhancement (ClearVoice MossFormer2), in PyTorch.

Counterpart of ``audiojax.models.mossformer2_se``: Kaldi fbank (60 mels,
1920/384 frames, 2048-point DFT, pre-emphasis 0.97) + Δ + ΔΔ → GroupNorm(1)
→ 1×1 encoder (180 → 512) → scaled sinusoidal positions → ``depth`` ×
[FLASH layer + gated FSMN block] → LayerNorm → GroupNorm(1) + residual →
PReLU → gated (tanh · σ) tail → 1×1 decoder → ReLU mask on the 961-bin mask
STFT of the same frames (symmetric Hamming, uncentred) → ISTFT.

The signal is framed once: the frames feed both the Kaldi fbank and the mask
STFT, which is a float32 product of the frames with the plain DFT basis, as
in the JAX package (so no B1 on this path).  On the card each layer launches
B4 four times (FLASH ``in_conv`` and ``out_conv``, the FSMN's ``uv_conv`` and
its 39-tap memory) and B6 once (the FLASH group attention); the synthesis is
B2.

``compute_dtype="bfloat16"`` is the JAX package's bf16 plan: the parameter
tree's float32 leaves are cast once, the fbank and its deltas (a float32
island) are cast to bf16 once at the network's edge, and the FLASH layers
and gated FSMN blocks run in bf16 (B4 and B6 in their bf16 instances, the
linear attention in f32, as in MossFormer2-SS); the mask is widened back,
and the mask-STFT product, B2 and the int16 output stay float32.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import INV_INT16, fold_windows, pcm_in, pcm_out, resample_linear, unfold_windows
from ..dsp.stft import StftConfig, frame_signal, stft_basis
from ..frontend.kaldi import log_mel_fbank
from ..nn import core
from ..nn.mossformer import flash_layer, gated_fsmn_block, sinusoid_positions
from ..ops.stft_cuda import fast_istft_packed
from ..params import params_from_numpy
from .base import ParamModule, conv_np, dense_np
from .mossformer2_ss import group_norm_all

__all__ = [
    "MossFormer2SeConfig",
    "MossFormer2SE",
    "group_norm_all",
    "deltas",
    "mossformer2_se_net",
    "mossformer2_se_forward",
    "init_mossformer2_se_numpy",
    "init_mossformer2_se",
    "make_mossformer2_se",
]


@dataclasses.dataclass(frozen=True)
class MossFormer2SeConfig:
    n_mels: int = 60
    dim: int = 512
    depth: int = 24
    group_size: int = 256
    qk_dim: int = 128
    vu_dim: int = 1024
    rot_dim: int = 32
    fsmn_inner: int = 256
    lorder: int = 20
    dw_kernel: int = 17
    n_fft: int = 1920
    hop: int = 384
    kaldi_nfft: int = 2048
    preemph: float = 0.97
    sample_rate: int = 48000
    in_sample_rate: int = 48000
    out_sample_rate: int = 48000
    fold_window: int = 0
    # the mask network's dtype: "float32" or "bfloat16" (the fbank, the mask
    # STFT and B2 stay float32)
    compute_dtype: str = "float32"

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name

    @property
    def frame_cfg(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window="hamming_symmetric", center=False)

    @property
    def stft_bins(self) -> int:
        return self.n_fft // 2 + 1  # 961


def deltas(x: torch.Tensor) -> torch.Tensor:
    """torchaudio ``compute_deltas`` (win 5, replicate pad of 2 frames each
    end) by shifted slices.  x: (B, T, M)."""
    t = x.shape[1]
    xp = torch.cat([x[:, :1], x[:, :1], x, x[:, -1:], x[:, -1:]], dim=1)
    return (xp[:, 3:3 + t] - xp[:, 1:1 + t] + 2.0 * (xp[:, 4:4 + t] - xp[:, 0:t])) * 0.1


def mossformer2_se_net(p, fbank: torch.Tensor, cfg: MossFormer2SeConfig) -> torch.Tensor:
    """(B, T, 180) fbank and deltas → (B, T, 961) ReLU mask, float32; in
    between in ``cfg.compute_dtype``.  GroupNorm(1) normalises each batch row
    (window) over (T, C) on its own."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    core.expect_cast(p["in_norm"]["g"], dtype)
    fbank = fbank.to(dtype)
    x = core.dense(p["encoder"], group_norm_all(p["in_norm"], fbank))  # 180 → 512
    x = x + sinusoid_positions(x.shape[1], cfg.dim, x.device).to(x.dtype)[None] * p["pos_scale"]

    h = x
    for i in range(cfg.depth):
        h = flash_layer(p[f"flash{i}"], h, group_size=cfg.group_size, qk_dim=cfg.qk_dim,
                        rot_dim=cfg.rot_dim)
        h = gated_fsmn_block(p[f"fsmn{i}"], h, lorder=cfg.lorder)
    x = group_norm_all(p["intra_norm"], core.layer_norm(p["mm_norm"], h)) + x

    x = core.prelu(p["tail_act"], x)
    gate = core.dense(p["tail_gate"], x)
    d = cfg.dim
    x = torch.tanh(gate[..., :d]) * torch.sigmoid(gate[..., d:])
    return torch.relu(core.dense(p["decoder"], x)).float()


def mossformer2_se_forward(params, audio: torch.Tensor,
                           cfg: MossFormer2SeConfig = MossFormer2SeConfig()) -> torch.Tensor:
    """int16 PCM (B, L) at the input rate → denoised int16 PCM (B, L_out)."""
    x = pcm_in(audio)
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, int(round(x.shape[-1] * cfg.sample_rate / cfg.in_sample_rate)))

    batch = x.shape[0]
    model_len = x.shape[-1]
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = max(-(-model_len // align) * align, cfg.n_fft)
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    frames = frame_signal(x, cfg.frame_cfg)
    fbank = log_mel_fbank(x, frame_len=cfg.n_fft, hop=cfg.hop, nfft=cfg.kaldi_nfft,
                          n_mels=cfg.n_mels, fs=cfg.sample_rate, preemph=cfg.preemph,
                          power_scale=1.0 / (INV_INT16 * INV_INT16), frames=frames)
    d1 = deltas(fbank)
    feat = torch.cat([fbank, d1, deltas(d1)], dim=-1)  # (B, T, 180)
    spec = torch.matmul(frames, stft_basis(cfg.frame_cfg, x.device))

    mask = mossformer2_se_net(params, feat, cfg)
    y = fast_istft_packed((spec * torch.cat([mask, mask], dim=-1)).contiguous(), cfg.frame_cfg)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, int(round(model_len * cfg.out_sample_rate / cfg.sample_rate)))
    return pcm_out(y)


def make_mossformer2_se(cfg: MossFormer2SeConfig = MossFormer2SeConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(mossformer2_se_forward, cfg=cfg)


class MossFormer2SE(ParamModule):
    """MossFormer2-SE with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` at 48 kHz on the module's
    device and returns int16 PCM of the same shape."""

    def __init__(self, params, cfg: MossFormer2SeConfig = MossFormer2SeConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return mossformer2_se_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _norm_np(c):
    return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}


def _flash_np(rng, cfg):
    d, c = cfg.dim, 2 * cfg.vu_dim + cfg.qk_dim
    return {
        "in_norm": {"g": np.ones((), np.float32)},
        "in_lin": dense_np(rng, d, c),
        "in_conv": conv_np(rng, (cfg.dw_kernel,), c, c, groups=c, bias=False),
        "os_gamma": np.full((4, cfg.qk_dim), 0.1, np.float32),
        "os_beta": np.zeros((4, cfg.qk_dim), np.float32),
        "out_norm": {"g": np.ones((), np.float32)},
        "out_lin": dense_np(rng, cfg.vu_dim, d),
        "out_conv": conv_np(rng, (cfg.dw_kernel,), d, d, groups=d, bias=False),
    }


def _fsmn_np(rng, cfg):
    d, inner = cfg.dim, cfg.fsmn_inner
    return {
        "conv1": dense_np(rng, d, inner),
        "conv1_act": {"alpha": np.full((inner,), 0.25, np.float32)},
        "norm1": _norm_np(inner),
        "uv_lin": dense_np(rng, inner, 2 * inner),
        "uv_conv": conv_np(rng, (cfg.dw_kernel,), 2 * inner, 2 * inner, groups=2 * inner,
                           bias=False),
        "mem_lin": dense_np(rng, inner, inner),
        "mem_proj": dense_np(rng, inner, inner, bias=False),
        "mem_conv": conv_np(rng, (2 * cfg.lorder - 1,), inner, inner, groups=inner, bias=False),
        "norm2": _norm_np(inner),
        "conv2": dense_np(rng, inner, d),
    }


def init_mossformer2_se_numpy(seed: int = 0,
                              cfg: MossFormer2SeConfig = MossFormer2SeConfig()) -> dict:
    """Random MossFormer2-SE parameters as numpy arrays, with the keys, shapes
    and layouts of ``audiojax.models.mossformer2_se.init_mossformer2_se`` and
    its distributions, drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    d, feat = cfg.dim, 3 * cfg.n_mels
    p = {
        "in_norm": _norm_np(feat),
        "encoder": dense_np(rng, feat, d),
        "pos_scale": np.asarray(d**-0.5, np.float32),
        "mm_norm": _norm_np(d),
        "intra_norm": _norm_np(d),
        "tail_act": {"alpha": np.asarray(0.25, np.float32)},
        "tail_gate": dense_np(rng, d, 2 * d),
        "decoder": dense_np(rng, d, cfg.stft_bins, bias=False),
    }
    for i in range(cfg.depth):
        p[f"flash{i}"] = _flash_np(rng, cfg)
        p[f"fsmn{i}"] = _fsmn_np(rng, cfg)
    return p


def init_mossformer2_se(seed: int = 0, cfg: MossFormer2SeConfig = MossFormer2SeConfig(),
                        device=None) -> dict:
    """Random MossFormer2-SE parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_mossformer2_se_numpy(seed, cfg), device)
