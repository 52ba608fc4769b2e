"""MossFormerGAN-SE-16K — ClearVoice SyncANet speech enhancer, in PyTorch.

Counterpart of ``audiojax.models.mossformergan_se``: STFT 400/100 (periodic
Hamming, reflect) on the card's kernels, power compression 0.3 of the
magnitude and of the complex pair, a DenseEncoder (1×1 conv + dilated dense
layers each ending in a frequency-axis UniDeepFsmn + strided frequency conv),
SyncANet blocks (intra path over frequency, inter path over time, each with a
grouped unfold conv, fused to_u‖to_v FFConvM, UniDeepFsmn, gate, transposed
refold conv and a MossFormer GAU, then an SE layer; then a 4-head triple
attention), a mask decoder and a complex decoder, power decompression, ISTFT
and the per-window RMS norm and denorm.

Layout is channel-last ``(B, T, F, C)``; GAU sequences are ``(N, S, C)``.
On the card every depthwise conv1d runs on kernel B4 (``ops.dwconv_cuda``,
through ``nn.core.conv1d``) and both relu² attentions of the GAU run on
kernel B6 (``ops.attention_cuda``).

``compute_dtype="bfloat16"`` is the JAX package's bf16 serving plan: the
parameter tree's float32 leaves are cast once and the network runs in bf16
from the compressed spectra to the mask and complex heads (B4 and B6 in
their bf16 instances; the GAU's linear and cross attention sums and the
triple attention's products in f32, as ``preferred_element_type`` asks);
the STFT, the compression, the decompression island (``final`` onwards),
the ISTFT and the int16 output stay float32.  The JAX package sends the
``dw_route="banded"`` FSMN memories to an XLA banded GEMM under bf16; the
port keeps its depthwise conv1d ones on B4 (the same function up to the
order of the f32 sums) and its (1, k) conv2d ones on cuDNN, as in its
float32 plan.
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
from ..nn.mossformer import rope_mm_tables
from ..ops.attention_cuda import fast_quad_attention
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from ..utils.profiling import span
from .base import ParamModule, conv_np, dense_np
from .zipenhancer import instance_norm_tf

__all__ = [
    "MossFormerGanConfig",
    "MossFormerGAN",
    "mossformer_gau",
    "se_layer",
    "triple_attention",
    "mossformergan_net",
    "mossformergan_forward",
    "init_mossformergan_numpy",
    "init_mossformergan",
    "make_mossformergan",
]


@dataclasses.dataclass(frozen=True)
class MossFormerGanConfig:
    n_fft: int = 400
    hop: int = 100
    window: str = "hamming"
    pad_mode: str = "reflect"
    compress: float = 0.3
    emb_dim: int = 64
    emb_ks: int = 4
    emb_hs: int = 1
    uv_channels: int = 128
    n_blocks: int = 6
    dense_depth: int = 4
    lorder: int = 20
    # GAU (MossFormer) dims
    mf_hidden: int = 128  # packed [v | u]
    mf_vdim: int = 64
    mf_qk: int = 128
    mf_rot: int = 32
    dw_kernel: int = 31
    # triple attention
    attn_heads: int = 4
    attn_q_ch: int = 4
    attn_v_ch: int = 16
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 24000
    compute_dtype: str = "float32"  # "float32" or "bfloat16" (f32 DSP islands)

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window, pad_mode=self.pad_mode)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1  # 201

    @property
    def n_freqs(self) -> int:
        return (self.f_bins + 2 - 3) // 2 + 1  # 101 sub-bands after the strided conv


# ─────────────────────────────────────────────────────────────────────────────
# Blocks
# ─────────────────────────────────────────────────────────────────────────────


def _ffconvm_fused(p, x: torch.Tensor, dw_kernel: int) -> torch.Tensor:
    """Fused to_u‖to_v FFConvM: affine-free LN → Linear → SiLU → depthwise
    conv residual."""
    h = F.silu(core.dense(p["lin"], core.layer_norm(None, x)))
    return h + core.conv1d(p["conv"], h, padding=(dw_kernel - 1) // 2, groups=h.shape[-1])


def _uni_fsmn(p, x: torch.Tensor, lorder: int) -> torch.Tensor:
    """UniDeepFsmn over the sequence axis: relu-linear → project → symmetric
    depthwise memory + inner residual."""
    p1 = core.dense(p["proj"], torch.relu(core.dense(p["lin"], x)))
    mem = core.conv1d(p["mem"], p1, padding=lorder - 1, groups=p1.shape[-1])
    return x + p1 + mem


def mossformer_gau(p, x: torch.Tensor, cfg: MossFormerGanConfig, b: int) -> torch.Tensor:
    """GatedFormer block: local relu² attention over the sequence axis,
    cross-token attention over the fold axis (diagonal masked), global linear
    attention; gated combine.

    x: (b·BT, Q, C) where BT is the cross axis (frames for the intra path)."""
    n, q_len, c = x.shape
    bt = n // b
    half = c // 2
    x_shift = F.pad(x[..., :half], (0, 0, 1, 0))[:, :q_len]  # token shift
    h = core.layer_norm(None, torch.cat([x_shift, x[..., half:]], dim=-1))
    huv = F.silu(core.dense(p["in_lin"], h))
    huv = huv + core.conv1d(p["in_conv"], huv, padding=(cfg.dw_kernel - 1) // 2,
                            groups=huv.shape[-1])
    hidden = huv[..., : cfg.mf_hidden].contiguous()  # B6 takes contiguous tensors
    qk = huv[..., cfg.mf_hidden :]

    # OffsetScale + RoPE, the rotate-half as a product with a signed pair-swap
    # matrix, the four diag(γᵢ)·swap products fused into one (qk → 4·qk)
    cos_f, sin_f, swap = rope_mm_tables(q_len, cfg.mf_rot, cfg.mf_qk, x.device, x.dtype)
    d_qk = cfg.mf_qk
    gamma_swap = torch.cat([p["gamma"][i][:, None] * swap for i in range(4)], dim=1)
    beta_swap = p["beta"] @ swap  # (4, qk)
    swapped = qk @ gamma_swap  # (N, Q, 4·qk)
    projs = []
    for i in range(4):
        direct = qk * p["gamma"][i] + p["beta"][i]
        sw = swapped[..., i * d_qk : (i + 1) * d_qk] + beta_swap[i]
        projs.append(direct * cos_f + sw * sin_f)
    quad_q, lin_q, quad_k, lin_k = projs

    # local relu² attention (B6) plus the global linear attention
    # ((lin_q lin_kᵀ)/Q) hidden and the cross attention below, all in f32;
    # their sum returns to the compute dtype once
    att_hidden = fast_quad_attention(quad_q, quad_k, hidden, scale=1.0 / q_len,
                                     out_dtype=torch.float32)
    att_hidden = att_hidden + core.matmul_f32(
        core.matmul_f32(lin_q, lin_k.transpose(1, 2)) / q_len, hidden)

    # cross-token attention over the fold axis, diagonal masked (B6): the
    # (b, BT, Q, ·) layout permuted to contiguous (b·Q, BT, ·) and back
    def across(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, bt, q_len, -1).transpose(1, 2).reshape(b * q_len, bt, -1).contiguous()

    cross = fast_quad_attention(across(quad_q), across(quad_k), across(hidden), scale=1.0 / bt,
                                mask_diag=True, out_dtype=torch.float32)
    att_hidden = att_hidden + cross.reshape(b, q_len, bt, -1).transpose(1, 2).reshape(n, q_len, -1)
    att_hidden = att_hidden.to(hidden.dtype)

    att_v, att_u = att_hidden[..., : cfg.mf_vdim], att_hidden[..., cfg.mf_vdim :]
    v, u = hidden[..., : cfg.mf_vdim], hidden[..., cfg.mf_vdim :]
    out = (att_u * v) * torch.sigmoid(att_v * u)

    o = F.silu(core.dense(p["out_lin"], core.layer_norm(None, out)))
    o = o + core.conv1d(p["out_conv"], o, padding=(cfg.dw_kernel - 1) // 2, groups=o.shape[-1])
    return x + o


def se_layer(p, x: torch.Tensor) -> torch.Tensor:
    """SELayer: sigmoid(MLP(avg-pool)) + sigmoid(MLP(max-pool)) channel gains.
    x: (B, T, F, C)."""
    avg = torch.mean(x, dim=(1, 2))
    mx = torch.amax(x, dim=(1, 2))
    ga = torch.sigmoid(core.dense(p["avg2"], torch.relu(core.dense(p["avg1"], avg))))
    gm = torch.sigmoid(core.dense(p["max2"], torch.relu(core.dense(p["max1"], mx))))
    return x * (ga + gm)[:, None, None, :]


def _sync_path(p, x: torch.Tensor, cfg: MossFormerGanConfig, *, axis: str) -> torch.Tensor:
    """One intra (axis='f') or inter (axis='t') SyncANet path. x: (B,T,F,C)."""
    b, t, f, c = x.shape
    h = core.layer_norm(None, x)  # LayerNormalization4D: over channels, per position
    if axis == "f":
        seq = h.reshape(b * t, f, c)
    else:
        seq = h.transpose(1, 2).reshape(b * f, t, c)
    # grouped unfold conv: kernel emb_ks, emb_ks outputs per channel
    seq = core.conv1d(p["unfold"], seq, stride=cfg.emb_hs, groups=c)
    huv = _ffconvm_fused(p["uv"], seq, cfg.dw_kernel)
    iu, iv = huv[..., : cfg.uv_channels], huv[..., cfg.uv_channels :]
    g = iv * _uni_fsmn(p["fsmn"], iu, cfg.lorder)
    g = core.conv1d_transpose(p["refold"], g, stride=cfg.emb_hs)  # back to full axis length
    g = mossformer_gau(p["mf"], g, cfg, b)
    if axis == "f":
        g = g.reshape(b, t, f, c)
    else:
        g = g.reshape(b, f, t, c).transpose(1, 2)
    return se_layer(p["se"], g) + x


def triple_attention(p, x: torch.Tensor, cfg: MossFormerGanConfig) -> torch.Tensor:
    """4-head attention over time with flattened (channel·freq) tokens.
    x: (B, T, F, C)."""
    b, t, f, c = x.shape
    h = cfg.attn_heads
    qc, vc = cfg.attn_q_ch, cfg.attn_v_ch
    qkv = core.prelu(p["qkv_act"], core.conv2d(p["qkv"], x))  # (B,T,F, 2hq + hv)
    qk = qkv[..., : 2 * h * qc].reshape(b, t, f, 2, h, qc)
    qk = torch.movedim(qk, (3, 4), (1, 2))  # (B, 2, h, t, f, qc)
    qk = core.layer_norm(None, qk.transpose(-1, -2), ndims=2)  # LN over (qc, f)
    qk = qk * p["qk_g"] + p["qk_b"]  # (2, h, 1, qc, f) broadcast
    vv = qkv[..., 2 * h * qc :].reshape(b, t, f, h, vc)
    vv = torch.movedim(vv, 3, 1)  # (B, h, t, f, vc)
    vv = core.layer_norm(None, vv.transpose(-1, -2), ndims=2)
    vv = vv * p["v_g"] + p["v_b"]  # (h, 1, vc, f) broadcast

    q = qk[:, 0].reshape(b, h, t, qc * f)
    k = qk[:, 1].reshape(b, h, t, qc * f)
    v = vv.reshape(b, h, t, vc * f)
    attn = torch.softmax(core.matmul_f32(q, k.transpose(-1, -2)), dim=-1).to(x.dtype)
    y = core.matmul_f32(attn, v).to(x.dtype).reshape(b, h, t, vc, f)
    y = y.permute(0, 2, 4, 1, 3).reshape(b, t, f, h * vc)  # h-major channels
    y = core.prelu(p["proj_act"], core.conv2d(p["proj"], y))
    # LayerNormalization4DCF: stats over (F, C) per (b, t)
    y = core.layer_norm(None, y, ndims=2) * p["cf_g"] + p["cf_b"]
    return y + x


def _dense_fsmn_block(p, x: torch.Tensor, depth: int, lorder: int) -> torch.Tensor:
    """Dilated dense layers, each ending in a FREQUENCY-axis UniDeepFsmn.
    x: (B, T, F, C)."""
    skip = x
    out = x
    for i in range(depth):
        d = 1 << i
        lp = p[f"layer{i}"]
        h = F.pad(skip, (0, 0, 0, 0, d, 0))
        h = core.conv2d(lp["conv"], h, padding=(0, 1), dilation=(d, 1))
        h = core.prelu(lp["act"], instance_norm_tf(lp["norm"], h))
        p1 = core.conv2d(lp["fsmn_proj"], torch.relu(core.conv2d(lp["fsmn_lin"], h)))
        mem = core.conv2d(lp["fsmn_mem"], p1, padding=(0, lorder - 1), groups=p1.shape[-1])
        out = h + p1 + mem
        skip = torch.cat([out, skip], dim=-1)
    return out


def _decoder(p, x: torch.Tensor, cfg: MossFormerGanConfig) -> torch.Tensor:
    """Dense-FSMN block → sub-pixel freq ×2 → head convs."""
    h = _dense_fsmn_block(p["dense"], x, cfg.dense_depth, cfg.lorder)
    h = core.conv2d(p["sp_conv"], h, padding=(0, 1))  # (B,T,F',2C)
    b, t, f, c2 = h.shape
    # torch SPConvTranspose2d: channels view (r, C) r-major, width f-major
    # with r fastest — merging the adjacent (f, r) axes gives that order
    return h.reshape(b, t, f * 2, c2 // 2)


def mossformergan_net(p, mag_c: torch.Tensor, spec_c: torch.Tensor,
                      cfg: MossFormerGanConfig) -> torch.Tensor:
    """compressed mag (B,T,F) + compressed complex (B,T,F,2) → enhanced packed
    (B,T,2F), float32; in between in ``cfg.compute_dtype``."""
    return _decompress(*_heads(p, mag_c, spec_c, cfg), cfg)


def _heads(p, mag_c: torch.Tensor, spec_c: torch.Tensor, cfg: MossFormerGanConfig):
    """The encoder, the SyncANet blocks and the two decoders, each a stage
    span: (mask (B,T,F), complex residual (B,T,F,2), ``spec_c``), all in
    ``cfg.compute_dtype``."""
    dtype = core.compute_dtype(cfg.compute_dtype)
    with span("model.gan.encoder"):
        core.expect_cast(p["enc_conv1"]["w"], dtype)
        mag_c, spec_c = mag_c.to(dtype), spec_c.to(dtype)
        x = torch.cat([mag_c[..., None], spec_c], dim=-1)  # (B,T,F,3)
        x = core.conv2d(p["enc_conv1"], x)
        x = core.prelu(p["enc_act1"], instance_norm_tf(p["enc_norm1"], x))
        x = _dense_fsmn_block(p["enc_dense"], x, cfg.dense_depth, cfg.lorder)
        x = core.conv2d(p["enc_conv2"], x, stride=(1, 2), padding=(0, 1))
        x = core.prelu(p["enc_act2"], instance_norm_tf(p["enc_norm2"], x))

    for i in range(cfg.n_blocks):
        blk = p[f"block{i}"]
        with span("model.gan.intra"):
            x = _sync_path(blk["intra"], x, cfg, axis="f")
        with span("model.gan.inter"):
            x = _sync_path(blk["inter"], x, cfg, axis="t")
        with span("model.gan.attention"):
            x = triple_attention(blk["attn"], x, cfg)

    with span("model.gan.mask_decoder"):  # → (B, T, F) mask
        m = _decoder(p["mask_dec"], x, cfg)
        m = core.conv2d(p["mask_conv1"], m)
        m = core.prelu(p["mask_act"], instance_norm_tf(p["mask_norm"], m))
        m = core.conv2d(p["mask_final"], m)[..., 0]  # kernel (1, 2): 202 → 201 bins
        mask = torch.where(m >= 0, m, p["mask_out_alpha"] * m)

    with span("model.gan.complex_decoder"):  # → (B, T, F, 2)
        cx = _decoder(p["cplx_dec"], x, cfg)
        cx = core.prelu(p["cplx_act"], instance_norm_tf(p["cplx_norm"], cx))
        cplx = core.conv2d(p["cplx_final"], cx)  # (B, T, 201, 2)
    return mask, cplx, spec_c


def _decompress(mask: torch.Tensor, cplx: torch.Tensor, spec_c: torch.Tensor,
                cfg: MossFormerGanConfig) -> torch.Tensor:
    """The masked spectrum plus the complex residual, decompressed in
    float32: packed (B,T,2F)."""
    final = (mask[..., None] * spec_c + cplx).float()  # the f32 decompress island
    power = torch.sum(final * final, dim=-1)
    # decompress: |final|^(1/c) unit-phase ≡ final · |final|²^((1/c − 1)/2)
    factor = torch.pow(torch.clamp(power, min=1e-12), (1.0 / cfg.compress - 1.0) * 0.5)
    final = final * factor[..., None]
    return torch.cat([final[..., 0], final[..., 1]], dim=-1)


def mossformergan_forward(params, audio: torch.Tensor,
                          cfg: MossFormerGanConfig = MossFormerGanConfig()) -> torch.Tensor:
    """int16 PCM (B, L) → denoised int16 PCM (B, L).

    The network takes int16-scale values (no 1/32768 scale): each fold window
    is divided by its RMS before the STFT and multiplied by it after the
    ISTFT; NaN becomes 0, then the output is clipped and truncated to int16.
    Under ``torch.profiler`` each stage is a host span (``model.gan.stft``,
    ``.encoder``, ``.intra``, ``.inter`` and ``.attention`` a block,
    ``.mask_decoder``, ``.complex_decoder``, ``.istft``)."""
    with span("model.gan.stft"):
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
        power = re * re + im * im
        mag_c = torch.pow(power, cfg.compress * 0.5)
        phase_scale = torch.pow(torch.clamp(power, min=float(np.finfo(np.float32).tiny)),
                                cfg.compress * 0.5 - 0.5)
        spec_c = torch.stack([re, im], dim=-1) * phase_scale[..., None]

    mask, cplx, spec_c = _heads(params, mag_c, spec_c, cfg)

    with span("model.gan.istft"):
        out = _decompress(mask, cplx, spec_c, cfg)
        y = fast_istft_packed(out.contiguous(), cfg.stft) * norm

        if cfg.fold_window:
            y = unfold_windows(y, batch)
        y = y[..., :model_len]
        if cfg.out_sample_rate != cfg.sample_rate:
            y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
        y = torch.where(torch.isnan(y), 0.0, y)
        return torch.clamp(y, -32768.0, 32767.0).to(torch.int32).to(torch.int16)


def make_mossformergan(cfg: MossFormerGanConfig = MossFormerGanConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(mossformergan_forward, cfg=cfg)


class MossFormerGAN(ParamModule):
    """MossFormerGAN-SE with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape."""

    def __init__(self, params, cfg: MossFormerGanConfig = MossFormerGanConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return mossformergan_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _in_np(c):
    return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}


def _alpha(c):
    return {"alpha": np.full((c,), 0.25, np.float32)}


def _dense_fsmn_np(rng, c, depth, lorder):
    return {f"layer{i}": {
        "conv": conv_np(rng, (2, 3), c * (i + 1), c),
        "norm": _in_np(c),
        "act": _alpha(c),
        "fsmn_lin": conv_np(rng, (1, 1), c, c),
        "fsmn_proj": conv_np(rng, (1, 1), c, c, bias=False),
        "fsmn_mem": conv_np(rng, (1, 2 * lorder - 1), c, c, groups=c, bias=False),
    } for i in range(depth)}


def _gau_np(rng, cfg):
    d_in = cfg.mf_hidden + cfg.mf_qk
    return {
        "in_lin": dense_np(rng, cfg.emb_dim, d_in),
        "in_conv": conv_np(rng, (cfg.dw_kernel,), d_in, d_in, groups=d_in, bias=False),
        "gamma": np.full((4, cfg.mf_qk), 0.1, np.float32),
        "beta": np.zeros((4, cfg.mf_qk), np.float32),
        "out_lin": dense_np(rng, cfg.mf_vdim, cfg.emb_dim),
        "out_conv": conv_np(rng, (cfg.dw_kernel,), cfg.emb_dim, cfg.emb_dim, groups=cfg.emb_dim,
                            bias=False),
    }


def _path_np(rng, cfg):
    c, uv = cfg.emb_dim, cfg.uv_channels
    in_ch = c * cfg.emb_ks
    return {
        "unfold": conv_np(rng, (cfg.emb_ks,), c, in_ch, groups=c),
        "uv": {"lin": dense_np(rng, in_ch, 2 * uv),
               "conv": conv_np(rng, (cfg.dw_kernel,), 2 * uv, 2 * uv, groups=2 * uv, bias=False)},
        "fsmn": {"lin": dense_np(rng, uv, uv),
                 "proj": dense_np(rng, uv, uv, bias=False),
                 "mem": conv_np(rng, (2 * cfg.lorder - 1,), uv, uv, groups=uv, bias=False)},
        "refold": conv_np(rng, (cfg.emb_ks,), uv, c),
        "mf": _gau_np(rng, cfg),
        "se": {"avg1": dense_np(rng, c, c // 4), "avg2": dense_np(rng, c // 4, c),
               "max1": dense_np(rng, c, c // 4), "max2": dense_np(rng, c // 4, c)},
    }


def _attn_np(rng, cfg):
    h, qc, vc, f = cfg.attn_heads, cfg.attn_q_ch, cfg.attn_v_ch, cfg.n_freqs
    out_ch = 2 * h * qc + h * vc
    return {
        "qkv": conv_np(rng, (1, 1), cfg.emb_dim, out_ch),
        "qkv_act": _alpha(out_ch),
        "qk_g": np.full((2, h, 1, qc, f), float((qc * f) ** -0.25), np.float32),
        "qk_b": np.zeros((2, h, 1, qc, f), np.float32),
        "v_g": np.ones((h, 1, vc, f), np.float32),
        "v_b": np.zeros((h, 1, vc, f), np.float32),
        "proj": conv_np(rng, (1, 1), h * vc, cfg.emb_dim),
        "proj_act": _alpha(cfg.emb_dim),
        "cf_g": np.ones((f, cfg.emb_dim), np.float32),
        "cf_b": np.zeros((f, cfg.emb_dim), np.float32),
    }


def init_mossformergan_numpy(seed: int = 0,
                             cfg: MossFormerGanConfig = MossFormerGanConfig()) -> dict:
    """Random MossFormerGAN parameters as numpy arrays, with the JAX package's
    keys, shapes and layouts (``audiojax.models.mossformergan_se.
    init_mossformergan``), drawn from ``numpy.random.default_rng(seed)`` with
    the same distributions."""
    rng = np.random.default_rng(seed)
    c, depth = cfg.emb_dim, cfg.dense_depth
    p = {
        "enc_conv1": conv_np(rng, (1, 1), 3, c),
        "enc_norm1": _in_np(c),
        "enc_act1": _alpha(c),
        "enc_dense": _dense_fsmn_np(rng, c, depth, cfg.lorder),
        "enc_conv2": conv_np(rng, (1, 3), c, c),
        "enc_norm2": _in_np(c),
        "enc_act2": _alpha(c),
        "mask_dec": {"dense": _dense_fsmn_np(rng, c, depth, cfg.lorder),
                     "sp_conv": conv_np(rng, (1, 3), c, 2 * c)},
        "mask_conv1": conv_np(rng, (1, 1), c, c),
        "mask_norm": _in_np(c),
        "mask_act": _alpha(c),
        "mask_final": conv_np(rng, (1, 2), c, 1),
        "mask_out_alpha": np.asarray(0.25, np.float32),
        "cplx_dec": {"dense": _dense_fsmn_np(rng, c, depth, cfg.lorder),
                     "sp_conv": conv_np(rng, (1, 3), c, 2 * c)},
        "cplx_norm": _in_np(c),
        "cplx_act": _alpha(c),
        "cplx_final": conv_np(rng, (1, 2), c, 2),
    }
    for i in range(cfg.n_blocks):
        p[f"block{i}"] = {"intra": _path_np(rng, cfg), "inter": _path_np(rng, cfg),
                          "attn": _attn_np(rng, cfg)}
    return p


def init_mossformergan(seed: int = 0, cfg: MossFormerGanConfig = MossFormerGanConfig(),
                       device=None) -> dict:
    """Random MossFormerGAN parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_mossformergan_numpy(seed, cfg), device)
