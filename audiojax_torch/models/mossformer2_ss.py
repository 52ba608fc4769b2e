"""MossFormer2-SS-16K — two-speaker separation (time-domain encoder/decoder),
in PyTorch.

Counterpart of ``audiojax.models.mossformer2_ss``: two-stage RMS gain
normalisation (−25 dB target, then the high-energy re-norm), Conv1d encoder
(k=16, s=8) + ReLU, GroupNorm + 1×1 + sinusoidal positions, ``depth`` ×
[FLASH layer + dilated gated FSMN], per-speaker gated tail (speakers folded
into the batch), mask × encoding, transposed-conv decoder, per-speaker RMS
restore.  The PAD_HEAD warm-up samples are the session's business.

On the card each layer launches B4 four times (FLASH ``in_conv`` and
``out_conv``, the FSMN's ``uv_conv`` and the first memory level), B5 once
(the second memory level, a grouped 2-in/1-out dilated conv) and B6 once (the
FLASH group-local relu² attention).  The encoder and the decoder stay on
``F.conv1d``, plain products, as the JAX package leaves them to lax.

``compute_dtype="bfloat16"`` is the JAX package's bf16 serving plan: the
parameter tree's float32 leaves are cast once, and the network runs in bf16
from the normalised audio to the decoder (B4, B5 and B6 in their bf16
instances; the FLASH layers' linear attention in f32, as
``preferred_element_type`` asks); the RMS normalisation, the decoder's
output onwards and the int16 output stay float32.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import pcm_in, resample_linear
from ..nn import core
from ..nn.mossformer import flash_layer, gated_fsmn_block_dilated, sinusoid_positions
from ..params import params_from_numpy
from ..utils.profiling import span
from .base import ParamModule, conv_np, dense_np

__all__ = [
    "MossFormer2SsConfig",
    "MossFormer2SS",
    "group_norm_all",
    "norm_audio",
    "mossformer2_ss_net",
    "mossformer2_ss_forward",
    "init_mossformer2_ss_numpy",
    "init_mossformer2_ss",
    "make_mossformer2_ss",
]


@dataclasses.dataclass(frozen=True)
class MossFormer2SsConfig:
    num_spks: int = 2
    dim: int = 512
    depth: int = 24
    group_size: int = 256
    qk_dim: int = 128
    vu_dim: int = 1024
    rot_dim: int = 32
    fsmn_inner: int = 256
    lorder: int = 20
    mem_depth: int = 2
    dw_kernel: int = 17
    enc_kernel: int = 16
    enc_stride: int = 8
    norm_factor: float = 10.0 ** (-25.0 / 20.0)  # −25 dB RMS target
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    # the MossFormer stack's dtype: "float32" or "bfloat16"; the RMS
    # normalisation and the decoder's output stay float32
    compute_dtype: str = "float32"

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name


def group_norm_all(p, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """GroupNorm(1, C): normalise over (T, C) jointly, per-channel affine.
    x: (B, T, C).  (A copy of ``audiojax.models.mossformer2_se.group_norm_all``.)"""
    mu = torch.mean(x, dim=(-2, -1), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(-2, -1), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def norm_audio(x: torch.Tensor, norm_factor: float, eps: float = 1e-6):
    """Two-stage RMS normalisation.  x: normalised PCM (B, L).  Returns
    (normed, rms_in) where rms_in is the int16-domain restore level."""
    pow_x = x * x
    avg_pow = torch.mean(pow_x, dim=-1, keepdim=True)
    rms = torch.sqrt(avg_pow)
    scalar = norm_factor / (rms + eps)
    mask = (pow_x > avg_pow).to(x.dtype)
    cnt = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    high_rms = torch.sqrt(torch.sum(pow_x * mask, dim=-1, keepdim=True) / cnt)
    scalarx = norm_factor / (high_rms * scalar + eps)
    normed = x * scalar * scalarx
    gain = scalar * scalarx
    rms_in = rms * gain * (1.0 / (gain + eps)) * 32767.0
    return normed, rms_in


def mossformer2_ss_net(p, audio_normed: torch.Tensor, cfg: MossFormer2SsConfig) -> torch.Tensor:
    """normalised audio (B, L) → separated waves (B, spks, L_out), float32; in
    between in ``cfg.compute_dtype``."""
    x_enc, h = _encode(p, audio_normed, cfg)
    return _decode(p, x_enc, _masks(p, x_enc, h, cfg), cfg)


def _encode(p, audio_normed: torch.Tensor, cfg: MossFormer2SsConfig):
    """The encoder conv, the front and the positions: (encoding, the
    MossFormer stack's input), (B, n, dim) each."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    core.expect_cast(p["encoder"]["w"], dtype)
    audio_normed = audio_normed.to(dtype)
    x_enc = torch.relu(core.conv1d(p["encoder"], audio_normed[..., None], stride=cfg.enc_stride))
    n = x_enc.shape[1]  # (B, n, dim)

    h = core.dense(p["front"], group_norm_all(p["front_norm"], x_enc))
    h = h + sinusoid_positions(n, cfg.dim, h.device).to(h.dtype)[None] * p["pos_scale"]
    return x_enc, h


def _masks(p, x_enc: torch.Tensor, h: torch.Tensor, cfg: MossFormer2SsConfig) -> torch.Tensor:
    """The FLASH and FSMN layers (a stage span each) and the per-speaker
    gated tail: masks (B, n, spks, dim)."""
    b, n = x_enc.shape[:2]
    mdl_input = h
    for i in range(cfg.depth):
        with span("model.ss.flash"):
            h = flash_layer(p[f"flash{i}"], h, group_size=cfg.group_size, qk_dim=cfg.qk_dim,
                            rot_dim=cfg.rot_dim)
        with span("model.ss.fsmn"):
            h = gated_fsmn_block_dilated(p[f"fsmn{i}"], h, lorder=cfg.lorder)
    with span("model.ss.mask"):
        h = group_norm_all(p["intra_norm"], core.layer_norm(p["mm_norm"], h))
        mask = h + mdl_input

        # tail: scalar PReLU → per-speaker gates (speakers fold into the batch)
        mask = torch.where(mask >= 0, mask, p["tail_alpha"] * mask)
        gate = core.dense(p["tail_gate"], mask).reshape(b, n, cfg.num_spks, 2 * cfg.dim)
        m = torch.tanh(gate[..., : cfg.dim]) * torch.sigmoid(gate[..., cfg.dim :])
        return torch.relu(core.dense(p["mask_decoder"], m))  # (B, n, spks, dim)


def _decode(p, x_enc: torch.Tensor, m: torch.Tensor, cfg: MossFormer2SsConfig) -> torch.Tensor:
    """Masks × encoding through the transposed-conv decoder: (B, spks, L'),
    float32."""
    b, n = x_enc.shape[:2]
    sep = x_enc[:, :, None, :] * m
    sep = sep.movedim(2, 1).reshape(b * cfg.num_spks, n, cfg.dim)
    wav = core.conv1d_transpose(p["decoder"], sep, stride=cfg.enc_stride)  # (B·spks, L', 1)
    return wav[..., 0].reshape(b, cfg.num_spks, -1).float()


def mossformer2_ss_forward(params, audio: torch.Tensor,
                           cfg: MossFormer2SsConfig = MossFormer2SsConfig()):
    """int16 mix (B, L) → (separated_0, separated_1), int16 (B, L) each.

    Under ``torch.profiler`` each stage is a host span (``model.ss.encoder``,
    ``.flash`` and ``.fsmn`` a layer, ``.mask``, ``.decoder``)."""
    with span("model.ss.encoder"):
        x = pcm_in(audio)
        if cfg.in_sample_rate != cfg.sample_rate:
            x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)
        model_len = x.shape[-1]
        # align so that the transposed-conv decoder gives the length back exactly
        pad_to = (-(-(model_len - cfg.enc_kernel) // cfg.enc_stride) * cfg.enc_stride
                  + cfg.enc_kernel)
        if pad_to != model_len:
            x = F.pad(x, (0, pad_to - model_len))

        normed, rms_in = norm_audio(x, cfg.norm_factor)
        x_enc, h = _encode(params, normed, cfg)

    m = _masks(params, x_enc, h, cfg)

    with span("model.ss.decoder"):
        wav = _decode(params, x_enc, m, cfg)  # (B, spks, L')
        rms_out = torch.sqrt(torch.mean(wav * wav, dim=-1, keepdim=True))
        gain = torch.where(rms_out > 0.0, rms_in[:, None, :] / rms_out,
                           torch.zeros_like(rms_out))
        out = (wav * gain)[..., :model_len]  # already int16-domain through rms_in
        if cfg.out_sample_rate != cfg.sample_rate:
            out = resample_linear(out, model_len * cfg.out_sample_rate // cfg.sample_rate)
        out = torch.clamp(out, -32768.0, 32767.0).to(torch.int32).to(torch.int16)
        return tuple(out[:, s] for s in range(cfg.num_spks))


def make_mossformer2_ss(cfg: MossFormer2SsConfig = MossFormer2SsConfig()):
    """Return ``fn(params, mix_int16) -> (source_0, source_1)``."""
    return partial(mossformer2_ss_forward, cfg=cfg)


class MossFormer2SS(ParamModule):
    """MossFormer2-SS with its converted parameters as buffers.

    ``forward(audio)`` takes an int16 mix ``(B, L)`` on the module's device and
    returns a tuple of ``num_spks`` int16 sources of the same shape."""

    def __init__(self, params, cfg: MossFormer2SsConfig = MossFormer2SsConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return mossformer2_ss_forward(self.params, audio, self.cfg)


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
        "front": dense_np(rng, d, inner),
        "front_alpha": np.asarray(0.25, np.float32),
        "norm1": _norm_np(inner),
        "uv_lin": dense_np(rng, inner, 2 * inner),
        "uv_conv": conv_np(rng, (cfg.dw_kernel,), 2 * inner, 2 * inner, groups=2 * inner,
                           bias=False),
        "mem_lin": dense_np(rng, inner, inner),
        "mem_proj": dense_np(rng, inner, inner, bias=False),
        "mem_stack": [{
            "conv": conv_np(rng, (2 * cfg.lorder - 1,), inner * (j + 1), inner, groups=inner,
                            bias=False),
            "norm": _norm_np(inner),
            "act": {"alpha": np.full((inner,), 0.25, np.float32)},
        } for j in range(cfg.mem_depth)],
        "norm2": _norm_np(inner),
        "back": dense_np(rng, inner, d),
    }


def init_mossformer2_ss_numpy(seed: int = 0,
                              cfg: MossFormer2SsConfig = MossFormer2SsConfig()) -> dict:
    """Random MossFormer2-SS parameters as numpy arrays, with the JAX package's
    keys, shapes and layouts (``audiojax.models.mossformer2_ss.
    init_mossformer2_ss``; ``mem_stack`` a list), drawn from
    ``numpy.random.default_rng(seed)`` with the same distributions."""
    rng = np.random.default_rng(seed)
    d = cfg.dim
    p = {
        "encoder": conv_np(rng, (cfg.enc_kernel,), 1, d),
        "front_norm": _norm_np(d),
        "front": dense_np(rng, d, d),
        "pos_scale": np.asarray(d**-0.5, np.float32),
        "mm_norm": _norm_np(d),
        "intra_norm": _norm_np(d),
        "tail_alpha": np.asarray(0.25, np.float32),
        "tail_gate": dense_np(rng, d, cfg.num_spks * 2 * d),
        "mask_decoder": dense_np(rng, d, d, bias=False),
        "decoder": conv_np(rng, (cfg.enc_kernel,), d, 1),
    }
    for i in range(cfg.depth):
        p[f"flash{i}"] = _flash_np(rng, cfg)
        p[f"fsmn{i}"] = _fsmn_np(rng, cfg)
    return p


def init_mossformer2_ss(seed: int = 0, cfg: MossFormer2SsConfig = MossFormer2SsConfig(),
                        device=None) -> dict:
    """Random MossFormer2-SS parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_mossformer2_ss_numpy(seed, cfg), device)
