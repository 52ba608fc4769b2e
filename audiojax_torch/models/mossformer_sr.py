"""MossFormer2-SR — speech super-resolution 16 kHz → 48 kHz, in PyTorch.

Counterpart of ``audiojax.models.mossformer_sr``: polyphase windowed-sinc ×3
upsampler (Kaiser β = 9, per-phase unit DC gain, the int16 scale folded in)
→ HiFi-GAN log-mel (80 slaney mels, 1024/256 hann, reflect pad (n_fft −
hop)/2, no centring) → MossFormer mask net (FLASH + gated FSMN, as
MossFormer2-SE) → HiFi-GAN generator (Snake activations, upsampling 8·8·2·2,
three residual blocks a stage, tanh) → bandwidth-substitution crossover,
out = generator + lowpass(input − generator), a 511-tap Kaiser sinc at
5.5 kHz.  Overlap-adding the windows (Hann taper) is ``Session``'s job.

The upsampler and the crossover are one-channel FIRs (``dsp.fir``); the mel
analysis is a product of the frames with the plain DFT basis, as in the JAX
package, so no B1 or B2 on this path.  On the card each of the 24 layers
launches B4 four times and B6 once (``nn.mossformer``).  The generator runs
channel-first ``(B, C, T)`` on cuDNN: its transposed convs as
``F.conv_transpose1d`` on the stored forward kernel (flipped and
transposed), which computes what the JAX package's input-dilated forward
conv computes without the stuffed zeros' products.

``compute_dtype="bfloat16"`` is the JAX package's bf16 plan: only the mask
net's parameters are cast (``prepare_params_sr``, the family spec's
``prepare_params``, which ``ParamModule`` calls), the log-mel is cast once at the mask net's
edge, the mask net runs in bf16 (B4 and B6 in their bf16 instances) and its
output is widened; the upsampler, the mel analysis, the HiFi-GAN generator
(never cast) and the crossover stay float32.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.fir import fir_gemm, upsample_zero_stuff
from ..dsp.pcm import INV_INT16
from ..dsp.stft import StftConfig, frame_signal, stft_basis
from ..frontend.mel import slaney_mel_fbanks
from ..nn import core
from ..nn.mossformer import flash_layer, gated_fsmn_block, sinusoid_positions
from ..params import params_from_numpy
from .base import ParamModule, conv_np, dense_np
from .mossformer2_se import _flash_np, _fsmn_np, _norm_np
from .mossformer2_ss import group_norm_all

__all__ = [
    "MossFormerSrConfig",
    "MossFormer2SR",
    "upsample_sinc",
    "snake",
    "hifigan_generator",
    "sr_masknet",
    "sr_log_mel",
    "prepare_params_sr",
    "mossformer_sr_forward",
    "init_mossformer_sr_numpy",
    "init_mossformer_sr",
    "make_mossformer_sr",
]


@dataclasses.dataclass(frozen=True)
class MossFormerSrConfig:
    n_mels: int = 80
    n_fft: int = 1024
    hop: int = 256
    dim: int = 512
    depth: int = 24
    group_size: int = 256
    qk_dim: int = 128
    vu_dim: int = 1024
    rot_dim: int = 32
    fsmn_inner: int = 256
    lorder: int = 20
    dw_kernel: int = 17
    upsample_ratio: int = 3
    resample_halfwidth: int = 32
    crossover_hz: float = 5500.0
    crossover_taps: int = 511
    crossover_beta: float = 8.0
    gen_channels: int = 1024
    gen_up_rates: tuple = (8, 8, 2, 2)
    gen_up_kernels: tuple = (16, 16, 4, 4)
    gen_res_kernels: tuple = (3, 7, 11)
    gen_res_dilations: tuple = (1, 3, 5)
    in_sample_rate: int = 16000
    out_sample_rate: int = 48000
    # the mask net's dtype: "float32" or "bfloat16" (the generator stays float32)
    compute_dtype: str = "float32"

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name

    @property
    def mel_cfg(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window="hann", center=False)


@lru_cache(maxsize=None)
def _upsample_kernel_np(ratio: int, halfwidth: int) -> np.ndarray:
    """Windowed-sinc interpolation kernel with per-phase unit DC gain and the
    int16 PCM scale folded in."""
    m = 2 * ratio * halfwidth + 1
    n = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    h = np.sinc(n / ratio) * np.kaiser(m, 9.0)
    for p in range(ratio):
        h[p::ratio] /= h[p::ratio].sum()
    return (h * INV_INT16).astype(np.float32)


@lru_cache(maxsize=None)
def _crossover_kernel_np(taps: int, fc: float, fs: float, beta: float) -> np.ndarray:
    taps = int(taps) | 1
    c = (taps - 1) // 2
    idx = np.arange(taps, dtype=np.float64) - c
    h = np.sinc(2.0 * fc / fs * idx) * np.kaiser(taps, beta)
    return (h / h.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def _mel_bank(cfg: MossFormerSrConfig, device: torch.device) -> torch.Tensor:
    fb = cfg.n_fft // 2 + 1
    return torch.from_numpy(slaney_mel_fbanks(fb, 0.0, 8000.0, cfg.n_mels,
                                              float(cfg.out_sample_rate)).copy()).to(device)


def upsample_sinc(audio: torch.Tensor, cfg: MossFormerSrConfig) -> torch.Tensor:
    """int16 (B, L) → normalised (B, ratio·L): zero-stuffing and the sinc FIR
    (symmetric, so correlation is convolution)."""
    ratio, hw = cfg.upsample_ratio, cfg.resample_halfwidth
    xd = upsample_zero_stuff(audio.to(torch.float32), ratio)
    return fir_gemm(xd, _upsample_kernel_np(ratio, hw), left=ratio * hw,
                    out_len=ratio * audio.shape[-1])


def snake(p, x: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin²(αx)/α on a channel-first (B, C, T) tensor,
    α per channel."""
    a = p["alpha"][:, None]
    return x + torch.square(torch.sin(a * x)) / (a + 1e-9)


def _conv(p, x: torch.Tensor, *, padding: int, dilation: int = 1) -> torch.Tensor:
    """Channel-first conv1d, 'same' geometry from a symmetric pad."""
    return F.conv1d(x, core.as_weight(p["w"]), p.get("b"), padding=padding, dilation=dilation)


def _conv_transpose(p, x: torch.Tensor, *, stride: int, padding: int) -> torch.Tensor:
    """ConvTranspose1d from the stored equivalent forward kernel (out, in, k):
    torch's (in, out, k) weight is that kernel flipped in time."""
    w = core.as_weight(p["w"]).flip(-1).transpose(0, 1)
    return F.conv_transpose1d(x, w, p.get("b"), stride=stride, padding=padding)


def _res_block(p, x: torch.Tensor, kernel: int, dilations) -> torch.Tensor:
    for j, d in enumerate(dilations):
        y = snake(p[f"a1_{j}"], x)
        y = _conv(p[f"c1_{j}"], y, padding=d * (kernel - 1) // 2, dilation=d)
        y = snake(p[f"a2_{j}"], y)
        y = _conv(p[f"c2_{j}"], y, padding=(kernel - 1) // 2)
        x = x + y
    return x


def hifigan_generator(p, mel: torch.Tensor, cfg: MossFormerSrConfig) -> torch.Tensor:
    """(B, T, n_mels) → waveform (B, T·prod(up_rates))."""
    x = _conv(p["pre"], mel.transpose(1, 2), padding=3)
    for i, (r, k) in enumerate(zip(cfg.gen_up_rates, cfg.gen_up_kernels)):
        x = snake(p[f"up_snake{i}"], x)
        x = _conv_transpose(p[f"up{i}"], x, stride=r, padding=(k - r) // 2)
        acc = None
        for j, rk in enumerate(cfg.gen_res_kernels):
            y = _res_block(p[f"res{i}_{j}"], x, rk, cfg.gen_res_dilations)
            acc = y if acc is None else acc + y
        x = acc / len(cfg.gen_res_kernels)
    x = snake(p["post_snake"], x)
    return torch.tanh(_conv(p["post"], x, padding=3)[:, 0])


def prepare_params_sr(params, cfg: MossFormerSrConfig):
    """SR's compute-dtype cast (``audiojax.models.mossformer_sr.
    prepare_params_sr``): the mask net's float32 leaves cast to
    ``cfg.compute_dtype``, the HiFi-GAN generator (``gen``) left float32."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    return {k: (v if k == "gen" else core.cast_f32_tree(v, dtype)) for k, v in params.items()}


def sr_masknet(p, mel: torch.Tensor, cfg: MossFormerSrConfig) -> torch.Tensor:
    """(B, T, n_mels) log-mel → (B, T, n_mels) enhanced mel for the generator,
    float32; in between in ``cfg.compute_dtype``."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    core.expect_cast(p["front_norm"]["g"], dtype)
    mel = mel.to(dtype)
    x = core.dense(p["front"], group_norm_all(p["front_norm"], mel))
    x = x + sinusoid_positions(x.shape[1], cfg.dim, x.device).to(x.dtype)[None] * p["pos_scale"]
    h = x
    for i in range(cfg.depth):
        h = flash_layer(p[f"flash{i}"], h, group_size=cfg.group_size, qk_dim=cfg.qk_dim,
                        rot_dim=cfg.rot_dim)
        h = gated_fsmn_block(p[f"fsmn{i}"], h, lorder=cfg.lorder)
    x = group_norm_all(p["intra_norm"], core.layer_norm(p["mm_norm"], h)) + x

    x = core.prelu({"alpha": p["tail_alpha"]}, x)
    gate = core.dense(p["tail_gate"], x)
    d = cfg.dim
    x = torch.tanh(gate[..., :d]) * torch.sigmoid(gate[..., d:])
    return torch.relu(core.dense(p["decoder"], x)).float()


def _reflect_ends(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect ``pad`` samples at each end of the last axis (edge excluded)."""
    return torch.cat([torch.flip(x[..., 1: pad + 1], (-1,)), x,
                      torch.flip(x[..., -(pad + 1): -1], (-1,))], dim=-1)


def sr_log_mel(up: torch.Tensor, cfg: MossFormerSrConfig) -> torch.Tensor:
    """The upsampled audio (B, 3L) → its HiFi-GAN log-mel (B, T, n_mels): reflect
    pad (n_fft − hop)/2, uncentred frames, the plain DFT basis, slaney mels."""
    frames = frame_signal(_reflect_ends(up, (cfg.n_fft - cfg.hop) // 2), cfg.mel_cfg)
    spec = torch.matmul(frames, stft_basis(cfg.mel_cfg, up.device))
    fb = cfg.n_fft // 2 + 1
    mag = torch.sqrt(spec[..., :fb] ** 2 + spec[..., fb:] ** 2 + 1e-9)
    return torch.log(torch.clamp(torch.matmul(mag, _mel_bank(cfg, up.device)), min=1e-5))


def mossformer_sr_forward(params, audio: torch.Tensor,
                          cfg: MossFormerSrConfig = MossFormerSrConfig()) -> torch.Tensor:
    """int16 (B, L) at 16 kHz → int16 (B, 3L) at 48 kHz."""
    in_len = audio.shape[-1]
    up = upsample_sinc(audio, cfg)  # (B, 3L), no alignment pad
    model_len = up.shape[-1]
    gen = hifigan_generator(params["gen"], sr_masknet(params, sr_log_mel(up, cfg), cfg), cfg)
    if gen.shape[-1] < model_len:  # reflect-extend the tail
        gp = model_len - gen.shape[-1]
        gen = torch.cat([gen, torch.flip(gen[..., -(gp + 1): -1], (-1,))], dim=-1)
    gen = gen[..., :model_len]

    # bandwidth substitution: out = gen + lowpass(up − gen)
    xo = _crossover_kernel_np(cfg.crossover_taps, cfg.crossover_hz,
                              float(cfg.out_sample_rate), cfg.crossover_beta)
    diff = _reflect_ends(up - gen, (len(xo) - 1) // 2)
    out = gen + fir_gemm(diff, xo, out_len=diff.shape[-1] - (len(xo) - 1))
    out = torch.clamp(out[..., : in_len * cfg.upsample_ratio], -1.0, 1.0) * 32768.0
    return torch.clamp(out.to(torch.int32), -32768, 32767).to(torch.int16)


def make_mossformer_sr(cfg: MossFormerSrConfig = MossFormerSrConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(mossformer_sr_forward, cfg=cfg)


class MossFormer2SR(ParamModule):
    """MossFormer2-SR with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` at 16 kHz on the module's
    device and returns int16 PCM ``(B, 3L)`` at 48 kHz."""

    def __init__(self, params, cfg: MossFormerSrConfig = MossFormerSrConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return mossformer_sr_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _generator_np(rng, cfg: MossFormerSrConfig) -> dict:
    ch = cfg.gen_channels
    alpha = lambda c: {"alpha": np.ones((c,), np.float32)}  # noqa: E731
    gen = {"pre": conv_np(rng, (7,), cfg.n_mels, ch)}
    for i, k in enumerate(cfg.gen_up_kernels):
        gen[f"up_snake{i}"] = alpha(ch)
        gen[f"up{i}"] = conv_np(rng, (k,), ch, ch // 2)  # the equivalent forward kernel
        ch //= 2
        for j, rk in enumerate(cfg.gen_res_kernels):
            rb = {}
            for jj in range(len(cfg.gen_res_dilations)):
                rb[f"a1_{jj}"] = alpha(ch)
                rb[f"c1_{jj}"] = conv_np(rng, (rk,), ch, ch)
                rb[f"a2_{jj}"] = alpha(ch)
                rb[f"c2_{jj}"] = conv_np(rng, (rk,), ch, ch)
            gen[f"res{i}_{j}"] = rb
    gen["post_snake"] = alpha(ch)
    gen["post"] = conv_np(rng, (7,), ch, 1)
    return gen


def init_mossformer_sr_numpy(seed: int = 0,
                             cfg: MossFormerSrConfig = MossFormerSrConfig()) -> dict:
    """Random MossFormer2-SR parameters as numpy arrays, with the keys, shapes
    and layouts of ``audiojax.models.mossformer_sr.init_mossformer_sr`` and
    its distributions, drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    d = cfg.dim
    p = {
        "front_norm": _norm_np(cfg.n_mels),
        "front": dense_np(rng, cfg.n_mels, d),
        "pos_scale": np.asarray(d**-0.5, np.float32),
        "mm_norm": _norm_np(d),
        "intra_norm": _norm_np(d),
        "tail_alpha": np.asarray(0.25, np.float32),
        "tail_gate": dense_np(rng, d, 2 * d),
        "decoder": dense_np(rng, d, cfg.n_mels, bias=False),
    }
    for i in range(cfg.depth):
        p[f"flash{i}"] = _flash_np(rng, cfg)
        p[f"fsmn{i}"] = _fsmn_np(rng, cfg)
    p["gen"] = _generator_np(rng, cfg)
    return p


def init_mossformer_sr(seed: int = 0, cfg: MossFormerSrConfig = MossFormerSrConfig(),
                       device=None) -> dict:
    """Random MossFormer2-SR parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_mossformer_sr_numpy(seed, cfg), device)
