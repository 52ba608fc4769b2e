"""MossFormer-family blocks in PyTorch: FLASH (GAU) attention and the
dilated gated FSMN, with their rotary and positional tables.

Counterpart of ``audiojax.nn.mossformer``, with what MossFormerGAN's GAU
(the rotary tables) and MossFormer2-SS use: ``scale_norm``,
``sinusoid_positions``, ``flash_layer`` (MossFormer2-SE/SS form, the
ConvModules add their depthwise conv to their input), ``gated_fsmn_block``
(MossFormer2-SE), ``instance_norm_t`` and ``gated_fsmn_block_dilated``
(MossFormer2-SS).  Tables are computed in numpy float64, cast to float32 and
cached, as in the JAX package.

On the card the FLASH layer's group-local relu² attention runs on kernel B6
(``ops.attention_cuda``), every depthwise conv on B4, and the dilated FSMN's
grouped 2-in/1-out memory conv on B5 (``ops.dwconv_cuda``, through
``nn.core.conv1d``).  Channel-last ``(B, T, C)``.  In the bf16 plan the
blocks run in bf16 on their bf16 instances, the rotary tables are cast to
the activations' dtype as in the JAX package, and the FLASH layer's linear
attention and its sum with B6's output are f32 (``preferred_element_type``),
rounded once to bf16.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention_cuda import fast_quad_attention
from . import core

__all__ = ["rope_mm_tables", "scale_norm", "sinusoid_positions", "flash_layer",
           "gated_fsmn_block", "instance_norm_t", "gated_fsmn_block_dilated"]


@lru_cache(maxsize=None)
def _rotary_tables_np(length: int, rot_dim: int, theta: float = 10000.0):
    freqs = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    ang = np.arange(length, dtype=np.float64)[:, None] * freqs[None, :]  # (T, rot/2)
    ang = np.repeat(ang, 2, axis=-1)  # interleave duplicate: (T, rot)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _rope_mm_tables_np(length: int, rot_dim: int, dim: int):
    cos, sin = _rotary_tables_np(length, rot_dim)
    cos_f = np.ones((length, dim), np.float32)
    sin_f = np.zeros((length, dim), np.float32)
    cos_f[:, :rot_dim] = cos
    sin_f[:, :rot_dim] = sin
    swap = np.zeros((dim, dim), np.float32)
    for m in range(rot_dim // 2):
        swap[2 * m + 1, 2 * m] = -1.0  # halfr[2m]   = -x[2m+1]
        swap[2 * m, 2 * m + 1] = 1.0   # halfr[2m+1] =  x[2m]
    return cos_f, sin_f, swap


@lru_cache(maxsize=None)
def rope_mm_tables(length: int, rot_dim: int, dim: int, device: torch.device,
                   dtype: torch.dtype = torch.float32):
    """RoPE-as-matmul tables ``(cos_full, sin_full, swap)`` on ``device`` in
    ``dtype`` (the JAX package casts them to the activations'), with

        rotary(x) == x·cos_full + (x @ swap)·sin_full

    for x (..., length, dim): interleaved-pair rotation of the first
    ``rot_dim`` channels.  Each swap row has one ±1 entry, so the product is
    exact."""
    return tuple(torch.from_numpy(a).to(device, dtype)
                 for a in _rope_mm_tables_np(length, rot_dim, dim))


def scale_norm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """ScaleNorm: g · x / (‖x‖₂ · d^{-1/2} + eps)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * (x.shape[-1] ** -0.5)
    return x * (p["g"] / (norm + eps))


def _depthwise_res(p, x: torch.Tensor) -> torch.Tensor:
    """ConvModule: x + depthwise conv over time ('same' padding)."""
    k = core.weight_shape(p["w"])[-1]
    return x + core.conv1d(p, x, padding=(k - 1) // 2, groups=x.shape[-1])


@lru_cache(maxsize=None)
def _sinusoid_np(length: int, dim: int):
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


@lru_cache(maxsize=None)
def sinusoid_positions(length: int, dim: int, device: torch.device) -> torch.Tensor:
    """ScaledSinuEmbedding table (T, dim), ``[sin | cos]`` concatenated (not
    interleaved); the caller multiplies the learned scale."""
    return torch.from_numpy(_sinusoid_np(length, dim)).to(device)


@lru_cache(maxsize=None)
def _pair_swap_index(dim: int, rot_dim: int, device: torch.device) -> torch.Tensor:
    """Lane index of the pair swap 2m <-> 2m+1 over the first ``rot_dim`` lanes,
    on ``device`` once: a host-to-device copy in every layer would wait for the
    card each time."""
    perm = np.arange(dim)
    perm[:rot_dim] ^= 1
    return torch.from_numpy(perm).to(device)


def flash_layer(p, x: torch.Tensor, *, group_size: int, qk_dim: int, rot_dim: int = 32,
                eps: float = 1e-5) -> torch.Tensor:
    """One FLASH_ShareA_FFConvM layer. x: (B, T, D) → (B, T, D).

    Token shift → ScaleNorm → Linear + SiLU + depthwise ConvModule → OffsetScale
    into four heads with RoPE → group-local relu² attention (B6) plus global
    linear attention → gate → ScaleNorm + Linear + SiLU + ConvModule → residual.
    """
    b, t, d = x.shape
    half = d // 2
    x_shift = F.pad(x[..., :half], (0, 0, 1, 0))[:, :t]  # first half delayed a frame
    h = scale_norm(p["in_norm"], torch.cat([x_shift, x[..., half:]], dim=-1), eps=eps)
    proj = _depthwise_res(p["in_conv"], F.silu(core.dense(p["in_lin"], h)))

    vu2 = proj.shape[-1] - qk_dim
    vu = vu2 // 2
    v, u = proj[..., :vu], proj[..., vu:vu2]
    qk = proj[..., vu2:]

    # OffsetScale + RoPE in the JAX package's form: one shared qk @ swap
    # product (exact: one ±1 per swap column) serves all four heads,
    #   rope(qk·γᵢ + βᵢ) = qk·(γᵢ·cos) + (qk@swap)·(P(γᵢ)·sin) + (βᵢ·cos + (βᵢ@swap)·sin)
    cos_f, sin_f, swap = rope_mm_tables(t, rot_dim, qk_dim, x.device, x.dtype)
    gamma_p = p["os_gamma"][:, _pair_swap_index(qk_dim, rot_dim, x.device)]
    beta_swap = p["os_beta"] @ swap
    qk_swap = qk @ swap

    # groups zero-padded AFTER OffsetScale + RoPE, so padded keys stay zero
    pad = (-t) % group_size
    g = (t + pad) // group_size

    def grouped(a: torch.Tensor) -> torch.Tensor:  # contiguous (B·G, group, ·) for B6
        if pad:
            a = F.pad(a, (0, 0, 0, pad))
        return a.reshape(b * g, group_size, a.shape[-1]).contiguous()

    quad_q, lin_q, quad_k, lin_k = (
        qk * (p["os_gamma"][i] * cos_f) + qk_swap * (gamma_p[i] * sin_f)
        + (p["os_beta"][i] * cos_f + beta_swap[i] * sin_f)
        for i in range(4)
    )
    vug = proj[..., :vu2]

    # group-local relu² attention (B6) plus the global linear attention, both
    # in f32; their sum returns to the compute dtype once
    quad_out = fast_quad_attention(grouped(quad_q), grouped(quad_k), grouped(vug),
                                   scale=1.0 / group_size, out_dtype=torch.float32)
    lin_kv = core.matmul_f32(lin_k.transpose(1, 2), vug) / t  # (B, qk, vu2), f32
    att = quad_out.reshape(b, g * group_size, vu2)[:, :t] + core.matmul_f32(lin_q, lin_kv)
    att = att.to(x.dtype)
    att_v, att_u = att[..., :vu], att[..., vu:]
    out = (att_u * v) * torch.sigmoid(att_v * u)

    out = scale_norm(p["out_norm"], out, eps=eps)
    out = _depthwise_res(p["out_conv"], F.silu(core.dense(p["out_lin"], out)))
    return x + out


def gated_fsmn_block(p, x: torch.Tensor, *, lorder: int, eps: float = 1e-8) -> torch.Tensor:
    """Gated_FSMN_Block (MossFormer2-SE). x: (B, T, D).

    PReLU'd dense → LayerNorm → affine-free LayerNorm → fused ``uv`` Linear +
    SiLU + depthwise ConvModule (B4) → UniDeepFsmn memory on the u half:
    relu-linear, projection, a symmetric depthwise conv of 2·lorder − 1 taps
    (B4) and the inner residual → gate by the v half → LayerNorm, dense and
    the block residual."""
    h = core.prelu(p["conv1_act"], core.dense(p["conv1"], x))
    gf_in = core.layer_norm(p["norm1"], h, eps=eps)

    xn = core.layer_norm(None, gf_in, eps=eps)
    proj = _depthwise_res(p["uv_conv"], F.silu(core.dense(p["uv_lin"], xn)))
    inner = proj.shape[-1] // 2
    xu, xv = proj[..., :inner], proj[..., inner:]

    f1 = torch.relu(core.dense(p["mem_lin"], xu))
    xp = core.dense(p["mem_proj"], f1)
    mem = core.conv1d(p["mem_conv"], xp, padding=lorder - 1, groups=inner)
    xu = xu + xp + mem

    y = core.layer_norm(p["norm2"], xv * xu + gf_in, eps=eps)
    return core.dense(p["conv2"], y) + x


def instance_norm_t(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d: normalise each channel over time. x: (B, T, C)."""
    mu = torch.mean(x, dim=-2, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-2, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def gated_fsmn_block_dilated(p, x: torch.Tensor, *, lorder: int,
                             eps: float = 1e-8) -> torch.Tensor:
    """Gated_FSMN_Block_Dilated (MossFormer2-SS). x: (B, T, D).

    The memory is a dilated dense stack: level j convolves the concat of all
    earlier levels' outputs with dilation 2^j, then InstanceNorm + PReLU.
    Level 0 is a true depthwise conv (B4); level 1 reads two lanes a group, the
    grouped 2-in/1-out conv (B5)."""
    h = core.dense(p["front"], x)
    h = torch.where(h >= 0, h, p["front_alpha"] * h)  # scalar PReLU
    gf_in = core.layer_norm(p["norm1"], h, eps=eps)

    xn = core.layer_norm(None, gf_in, eps=eps)
    proj = _depthwise_res(p["uv_conv"], F.silu(core.dense(p["uv_lin"], xn)))
    inner = proj.shape[-1] // 2
    xu, xv = proj[..., :inner], proj[..., inner:]

    f1 = torch.relu(core.dense(p["mem_lin"], xu))
    dense_feat = core.dense(p["mem_proj"], f1)
    mem_out = dense_feat
    for j, mp in enumerate(p["mem_stack"]):
        dilation = 2**j
        mem_out = core.conv1d(mp["conv"], dense_feat, padding=dilation * (lorder - 1),
                              dilation=dilation, groups=inner)
        mem_out = core.prelu(mp["act"], instance_norm_t(mp["norm"], mem_out))
        if j + 1 < len(p["mem_stack"]):
            dense_feat = torch.cat([mem_out, dense_feat], dim=-1)
    xu = xu + mem_out

    y = core.layer_norm(p["norm2"], xv * xu + gf_in, eps=eps)
    return core.dense(p["back"], y) + x
