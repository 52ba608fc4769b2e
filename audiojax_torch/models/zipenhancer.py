"""ZipEnhancer — the flagship 16 kHz speech enhancer (Zipformer2 dual-path), in PyTorch.

Counterpart of ``audiojax.models.zipenhancer``: per-window RMS norm → STFT
(400/100, hann, reflect) on the card's kernels → magnitude^0.3 compression
and phase → DenseEncoder (1×1 conv + 4 causal dense layers + strided
frequency conv) → 4 TSConformer encoders (dual-path Zipformer2 layers over
frequency then time; encoders 1–2 run on time/frequency-downsampled maps with
softmax-pooled frames, nearest upsampling and a bypass combiner) → mask and
phase dense decoders with sub-pixel frequency upsampling → magnitude^(1/0.3)
× unit phase vector → ISTFT → RMS denorm, NaN to 0, int16 clamp.

Layout: features channel-last ``(B, T, F, C)``; Zipformer sequences
batch-major ``(N, S, C)`` with N = B×T (frequency path) or B×F (time path).
On the card each layer's score stage runs on kernel B3 and its two conv
modules' depthwise convs on kernel B4 (``nn.zipformer``).

``compute_dtype="bfloat16"`` is the JAX package's bf16 serving plan: the
parameter tree's float32 leaves are cast once, the network from the stacked
[mag, phase] features to the mask and phase heads runs in bf16 (B3 and B4 in
their bf16 instances), and ``mag_mask`` and ``phase_ri`` return to float32:
the STFT, the feature path, the decompression, the ISTFT and the int16
output stay float32 islands.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import fold_windows, resample_linear, unfold_windows
from ..dsp.stft import StftConfig
from ..nn import core
from ..nn.zipformer import (bypass, compact_rel_pos, simple_downsample, simple_upsample,
                            zipformer_layer)
from ..ops.attention_cuda import pos_stride
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, conv_np, dense_np

__all__ = [
    "ZipEnhancerConfig",
    "ZipEnhancer",
    "instance_norm_tf",
    "dense_encoder",
    "dualpath_encoder",
    "downsampled_encoder",
    "decoder_pair",
    "zipenhancer_net",
    "zipenhancer_forward",
    "init_zipenhancer_numpy",
    "init_zipenhancer",
    "make_zipenhancer",
]


@dataclasses.dataclass(frozen=True)
class ZipEnhancerConfig:
    n_fft: int = 400
    hop: int = 100
    window: str = "hann"
    pad_mode: str = "reflect"
    compress: float = 0.3
    channels: int = 64
    dense_depth: int = 4
    num_heads: int = 4
    query_head_dim: int = 32
    pos_head_dim: int = 4
    value_head_dim: int = 12
    ff_hidden: int = 96
    nonlin_hidden: int = 48
    conv_kernel: int = 31
    pos_dim: int = 48
    # per-encoder (time_downsample, freq_downsample); 1 = plain dual-path
    encoder_downsample: tuple = ((1, 1), (2, 2), (4, 4), (1, 1))
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 24000  # 1.5 s fold windows
    # the Zipformer stack's dtype: "float32" or "bfloat16" (f32 DSP islands)
    compute_dtype: str = "float32"

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window, pad_mode=self.pad_mode)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1  # 201


def instance_norm_tf(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d: per-(batch, channel) stats over (T, F); x (B, T, F, C)."""
    mu = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _dense_block(p, x: torch.Tensor, depth: int) -> torch.Tensor:
    """Causal DenseBlockV2: kernel (2, 3) convs with dilation (2^i, 1) after a
    left pad of 2^i frames, InstanceNorm + PReLU, dense skip concat [h, skip]."""
    skip = x
    for i in range(depth):
        d = 1 << i
        layer = p[f"layer{i}"]
        h = F.pad(skip, (0, 0, 0, 0, d, 0))
        h = core.conv2d(layer["conv"], h, padding=(0, 1), dilation=(d, 1))
        h = core.prelu(layer["act"], instance_norm_tf(layer["norm"], h))
        x = h
        skip = torch.cat([h, skip], dim=-1)
    return x


def dense_encoder(p, x: torch.Tensor, cfg: ZipEnhancerConfig) -> torch.Tensor:
    """(B, T, F, 2) [mag, phase] → (B, T, F', C)."""
    x = core.conv2d(p["conv1"], x)
    x = core.prelu(p["act1"], instance_norm_tf(p["norm1"], x))
    x = _dense_block(p["dense"], x, cfg.dense_depth)
    x = core.conv2d(p["conv2"], x, stride=(1, 2), padding=(0, 1))
    return core.prelu(p["act2"], instance_norm_tf(p["norm2"], x))


def _layer(p, seq: torch.Tensor, length: int, cfg: ZipEnhancerConfig) -> torch.Tensor:
    """One Zipformer2 layer over sequences of ``length`` frames."""
    return zipformer_layer(p, seq, compact_rel_pos(length, cfg.pos_dim, seq.device),
                           num_heads=cfg.num_heads, query_head_dim=cfg.query_head_dim,
                           pos_head_dim=cfg.pos_head_dim)


def dualpath_encoder(p, x: torch.Tensor, cfg: ZipEnhancerConfig) -> torch.Tensor:
    """(B, T, F, C): one Zipformer2 layer over frequency, then one over time,
    each wrapped in an outer bypass."""
    b, t, f, c = x.shape
    seq = x.reshape(b * t, f, c)
    x = bypass(p["bypass_f"], seq, _layer(p["f_layer"], seq, f, cfg)).reshape(b, t, f, c)
    seq = x.transpose(1, 2).reshape(b * f, t, c)
    y = bypass(p["bypass_t"], seq, _layer(p["t_layer"], seq, t, cfg))
    return y.reshape(b, f, t, c).transpose(1, 2)


def downsampled_encoder(p, x: torch.Tensor, cfg: ZipEnhancerConfig, t_ds: int,
                        f_ds: int) -> torch.Tensor:
    """Dual-path encoder at (t/ds, f/ds) resolution with pooled frames and a
    bypass out-combiner."""
    b, t, f, c = x.shape
    seq = simple_downsample(p["down_t"], x.transpose(1, 2).reshape(b * f, t, c), t_ds)
    dt = seq.shape[1]
    seq = seq.reshape(b, f, dt, c).transpose(1, 2).reshape(b * dt, f, c)
    seq = simple_downsample(p["down_f"], seq, f_ds)
    df = seq.shape[1]

    seq = bypass(p["bypass_f"], seq, _layer(p["f_layer"], seq, df, cfg))
    seq = seq.reshape(b, dt, df, c).transpose(1, 2).reshape(b * df, dt, c)
    seq = bypass(p["bypass_t"], seq, _layer(p["t_layer"], seq, dt, cfg))

    seq = seq * p["combine_scale"]
    # upsample frequency, then time, and trim the pooling pad
    seq = seq.reshape(b, df, dt, c).transpose(1, 2).reshape(b * dt, df, c)
    seq = simple_upsample(seq, f_ds)[:, :f]
    seq = seq.reshape(b, dt, f, c).transpose(1, 2).reshape(b * f, dt, c)
    seq = simple_upsample(seq, t_ds)[:, :t]
    up = seq.reshape(b, f, t, c).transpose(1, 2)
    return x * (1.0 - p["combine_scale"]) + up


def _subpixel_up(q, h: torch.Tensor) -> torch.Tensor:
    """Conv to 2C channels, then sub-pixel frequency ×2: the channel order is
    c-major with the upscale factor minor."""
    h = core.conv2d(q["conv"], h, padding=(0, 1))  # (B, T, F', 2C)
    b, t, f, c2 = h.shape
    h = h.reshape(b, t, f, c2 // 2, 2).transpose(-2, -1).reshape(b, t, 2 * f, c2 // 2)
    return core.prelu(q["act"], instance_norm_tf(q["norm"], h))


def decoder_pair(p, x: torch.Tensor, cfg: ZipEnhancerConfig):
    """Mask and phase decoders: two dense blocks of the same topology,
    sub-pixel frequency ×2 upsampling, then the ReLU mask head and the
    rectangular phase head."""
    mx = _subpixel_up(p["mask_up"], _dense_block(p["mask_dense"], x, cfg.dense_depth))
    px = _subpixel_up(p["phase_up"], _dense_block(p["phase_dense"], x, cfg.dense_depth))
    mag_mask = torch.relu(core.conv2d(p["mask_out"], mx)[..., 0])  # kernel (1, 2): F → 201
    phase_ri = core.conv2d(p["phase_out"], px)  # (B, T, 201, 2)
    return mag_mask, phase_ri


def zipenhancer_net(params, mag: torch.Tensor, pha: torch.Tensor, cfg: ZipEnhancerConfig):
    """Compressed magnitude and phase (B, T, F) → (mag_mask, phase_ri) per
    frame, float32; in between in ``cfg.compute_dtype``."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    core.expect_cast(params["encoder"]["conv1"]["w"], dtype)
    x = dense_encoder(params["encoder"], torch.stack([mag, pha], dim=-1).to(dtype), cfg)
    for i, (t_ds, f_ds) in enumerate(cfg.encoder_downsample):
        enc = params[f"ts{i}"]
        if t_ds == 1 and f_ds == 1:
            x = dualpath_encoder(enc, x, cfg)
        else:
            x = downsampled_encoder(enc, x, cfg, t_ds, f_ds)
    mag_mask, phase_ri = decoder_pair(params["decoder"], x, cfg)
    return mag_mask.float(), phase_ri.float()


def zipenhancer_forward(params, audio: torch.Tensor,
                        cfg: ZipEnhancerConfig = ZipEnhancerConfig()) -> torch.Tensor:
    """int16 PCM (B, L) → denoised int16 PCM (B, L).

    The network takes int16-scale values: each fold window is divided by its
    RMS before the STFT and multiplied by it after the ISTFT; NaN becomes 0
    (Inf does not), then the output is clipped and truncated to int16."""
    x = audio.to(torch.float32)
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)

    batch = x.shape[0]
    model_len = x.shape[-1]
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = -(-model_len // align) * align
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    norm = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    x = x / norm

    pk = fast_stft_packed(x.contiguous(), cfg.stft)
    re, im = pk[..., : cfg.f_bins], pk[..., cfg.f_bins :]
    mag = torch.pow(re * re + im * im + 1e-9, cfg.compress * 0.5)
    pha = torch.atan2(im, re + 1e-5)

    mag_mask, phase_ri = zipenhancer_net(params, mag, pha, cfg)

    magnitude = torch.pow(mag_mask, 1.0 / cfg.compress)
    phase_norm = torch.linalg.vector_norm(phase_ri, dim=-1, keepdim=True)
    ok = phase_norm > 0.0
    # where the norm is 0 the unit phase is [1, 0]
    unit = torch.where(ok, phase_ri / torch.where(ok, phase_norm, 1.0),
                       F.pad(torch.ones_like(phase_norm), (0, 1)))
    spec = magnitude[..., None] * unit  # (B, T, F, 2)
    packed = torch.cat([spec[..., 0], spec[..., 1]], dim=-1)
    y = fast_istft_packed(packed, cfg.stft) * norm

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    y = torch.where(torch.isnan(y), 0.0, y)
    return torch.clamp(y, -32768.0, 32767.0).to(torch.int32).to(torch.int16)


def make_zipenhancer(cfg: ZipEnhancerConfig = ZipEnhancerConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(zipenhancer_forward, cfg=cfg)


class ZipEnhancer(ParamModule):
    """ZipEnhancer with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape."""

    def __init__(self, params, cfg: ZipEnhancerConfig = ZipEnhancerConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return zipenhancer_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _in_np(c):
    return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}


def _alpha(c):
    return {"alpha": np.full((c,), 0.25, np.float32)}


def _dense_block_np(rng, c, depth):
    return {f"layer{i}": {"conv": conv_np(rng, (2, 3), c * (i + 1), c), "norm": _in_np(c),
                          "act": _alpha(c)} for i in range(depth)}


def _zipformer_layer_np(rng, cfg: ZipEnhancerConfig):
    """``audiojax.nn.zipformer.init_zipformer_layer``'s keys, shapes and layouts."""
    dim, h = cfg.channels, cfg.num_heads
    ff = lambda: {"in": dense_np(rng, dim, cfg.ff_hidden), "out": dense_np(rng, cfg.ff_hidden, dim)}
    sa = lambda: {"in_proj": dense_np(rng, dim, h * cfg.value_head_dim),
                  "out_proj": dense_np(rng, h * cfg.value_head_dim, dim)}
    cm = lambda: {"in_proj": dense_np(rng, dim, 2 * dim),
                  "dw": conv_np(rng, (cfg.conv_kernel,), dim, dim, groups=dim),
                  "out_proj": dense_np(rng, dim, dim)}
    return {
        # [Q | K | P] lane packing, each head's P slot padded to pos_stride
        "attn": {"in_proj": dense_np(rng, dim, h * (2 * cfg.query_head_dim
                                                    + pos_stride(cfg.pos_head_dim))),
                 "linear_pos": dense_np(rng, cfg.pos_dim, h * cfg.pos_head_dim, bias=False)},
        "ff1": ff(), "ff2": ff(), "ff3": ff(),
        "nonlin": {"in_proj": dense_np(rng, dim, 3 * cfg.nonlin_hidden),
                   "out_proj": dense_np(rng, cfg.nonlin_hidden, dim)},
        "sa1": sa(), "sa2": sa(),
        "conv1": cm(), "conv2": cm(),
        "bypass_mid": np.full((dim,), 0.5, np.float32),
        "bypass": np.full((dim,), 0.5, np.float32),
        "norm": {"bias": np.zeros((dim,), np.float32), "log_scale": np.zeros((), np.float32)},
    }


def init_zipenhancer_numpy(seed: int = 0, cfg: ZipEnhancerConfig = ZipEnhancerConfig()) -> dict:
    """Random ZipEnhancer parameters as numpy arrays, with the JAX package's
    keys, shapes and layouts (``audiojax.models.zipenhancer.init_zipenhancer``),
    drawn from ``numpy.random.default_rng(seed)`` with the same distributions."""
    rng = np.random.default_rng(seed)
    c, depth = cfg.channels, cfg.dense_depth
    up = lambda: {"conv": conv_np(rng, (1, 3), c, 2 * c), "norm": _in_np(c), "act": _alpha(c)}
    params = {
        "encoder": {"conv1": conv_np(rng, (1, 1), 2, c), "norm1": _in_np(c), "act1": _alpha(c),
                    "dense": _dense_block_np(rng, c, depth),
                    "conv2": conv_np(rng, (1, 3), c, c), "norm2": _in_np(c), "act2": _alpha(c)},
        "decoder": {"mask_dense": _dense_block_np(rng, c, depth),
                    "phase_dense": _dense_block_np(rng, c, depth),
                    "mask_up": up(), "phase_up": up(),
                    "mask_out": conv_np(rng, (1, 2), c, 1),
                    "phase_out": conv_np(rng, (1, 2), c, 2)},
    }
    for i, (t_ds, f_ds) in enumerate(cfg.encoder_downsample):
        p = {"f_layer": _zipformer_layer_np(rng, cfg), "t_layer": _zipformer_layer_np(rng, cfg),
             "bypass_f": np.full((c,), 0.5, np.float32),
             "bypass_t": np.full((c,), 0.5, np.float32)}
        if (t_ds, f_ds) != (1, 1):
            p["combine_scale"] = np.full((c,), 0.5, np.float32)
            p["down_t"] = {"bias": np.zeros((t_ds,), np.float32)}
            p["down_f"] = {"bias": np.zeros((f_ds,), np.float32)}
        params[f"ts{i}"] = p
    return params


def init_zipenhancer(seed: int = 0, cfg: ZipEnhancerConfig = ZipEnhancerConfig(),
                     device=None) -> dict:
    """Random ZipEnhancer parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_zipenhancer_numpy(seed, cfg), device)
