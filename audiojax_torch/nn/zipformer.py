"""Zipformer2 blocks for ZipEnhancer, in PyTorch.

Counterpart of ``audiojax.nn.zipformer``: BiasNorm, SwooshL/R, rel-position
multi-head attention weights (the positional table gathered into (S, S)
before the contraction, no skew trick), NonlinAttention (head-0 weights),
SelfAttention, the gated ConvolutionModule, BypassModule, SimpleDownsample
(softmax-weighted frame pooling) and SimpleUpsample (nearest repeat), plus
icefall's CompactRelPositionalEncoding table.

Layout: (N, S, C) batch-major sequences (N = folded batch × cross axis).  On
the card the score stage softmax(q kᵀ + Σ_p pp·pe) runs on kernel B3
(``ops.attention_cuda.fast_relpos_scores``), once per layer, and the conv
module's depthwise conv on kernel B4 (through ``nn.core.conv1d``).

In the bf16 plan the layer runs in bf16 with the JAX package's f32 islands:
the positional projection of the float32 table is float32 (``dense``
promotes), the score stage's products and softmax are f32 inside B3, which
takes the gathered table rounded to bf16 (as ``relpos_scores_pallas`` rounds
it; the jnp route keeps it float32) and writes bf16 probabilities, and the
two attention mixes multiply in f32 (``preferred_element_type``) and round
once to bf16.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention_cuda import fast_relpos_scores
from . import core

__all__ = [
    "swoosh_l",
    "swoosh_r",
    "bias_norm",
    "compact_rel_pos",
    "attention_weights",
    "self_attention",
    "nonlin_attention",
    "conv_module",
    "bypass",
    "simple_downsample",
    "simple_upsample",
    "zipformer_layer",
]


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL(x) = softplus(x − 4) − 0.08x − 0.035."""
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR(x) = softplus(x − 1) − 0.08x − 0.313261687."""
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(p, x: torch.Tensor) -> torch.Tensor:
    """BiasNorm: exp(log_scale) · x / rms(x − bias) over the channel axis."""
    rms = torch.sqrt(torch.mean(torch.square(x - p["bias"]), dim=-1, keepdim=True))
    return x / rms * torch.exp(p["log_scale"])


@lru_cache(maxsize=None)
def _compact_rel_pos_np(length: int, embed_dim: int, length_factor: float = 1.0) -> np.ndarray:
    """icefall CompactRelPositionalEncoding table: (2·length − 1, embed_dim).

    Relative offsets are log-compressed then atan-squashed; even columns carry
    cosines, odd columns sines, and the last column is 1."""
    t = np.arange(-(length - 1), length, dtype=np.float64)
    compression = embed_dim**0.5
    x = np.sign(t) * compression * (np.log(np.abs(t) + compression) - np.log(compression))
    x = np.arctan(x / (length_factor * embed_dim**0.5))
    freqs = 1.0 + np.arange(embed_dim // 2, dtype=np.float64)
    ang = x[:, None] * freqs[None, :]
    pe = np.zeros((len(t), embed_dim), dtype=np.float64)
    pe[:, 0::2] = np.cos(ang)
    pe[:, 1::2] = np.sin(ang)
    pe[:, -1] = 1.0
    return pe.astype(np.float32)


@lru_cache(maxsize=None)
def compact_rel_pos(length: int, embed_dim: int, device: torch.device) -> torch.Tensor:
    """The positional table on ``device``, cached: no host copy per call."""
    return torch.from_numpy(_compact_rel_pos_np(length, embed_dim)).to(device)


@lru_cache(maxsize=None)
def _rel_index_np(s: int) -> np.ndarray:
    """idx[i, j] = s−1−i+j into the (2s−1)-row positional table."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    return (s - 1 - i + j).astype(np.int32)


@lru_cache(maxsize=None)
def _rel_index(s: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rel_index_np(s).astype(np.int64)).to(device)


def attention_weights(p, x: torch.Tensor, pos: torch.Tensor, *, num_heads: int,
                      query_head_dim: int, pos_head_dim: int) -> torch.Tensor:
    """RelPositionMultiheadAttentionWeights → softmax scores (N, H, S, S).

    ``p['in_proj']`` maps C → [Q(H·q) | K(H·q) | P(H·stride)], each head's P
    slot zero-padded from pos_head_dim to an 8-lane stride; q, k and pp are
    lane slices of that one projection, which B3 reads in place.
    ``p['linear_pos']`` maps pos_emb → H·p."""
    s = x.shape[1]
    hd = num_heads * query_head_dim
    proj = core.dense(p["in_proj"], x)  # (N, S, 2·H·D + H·stride)
    q = proj[..., :hd]
    k = proj[..., hd : 2 * hd]
    pp = proj[..., 2 * hd :]  # (N, S, H·stride); slot tails are never read

    pe = core.dense(p["linear_pos"], pos)  # (2S−1, H·pos_head)
    pe = pe.reshape(-1, num_heads, pos_head_dim)
    # the relative table gathered into (S, S, H, P) before the contraction,
    # then (H, P, S, S) for the kernel
    pe_mat = pe[_rel_index(s, x.device)].permute(2, 3, 0, 1).to(q.dtype).contiguous()
    return fast_relpos_scores(q, k, pp, pe_mat, num_heads=num_heads)


def self_attention(p, x: torch.Tensor, attn: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """Apply shared attention weights to a value projection."""
    n, s, _ = x.shape
    v = core.dense(p["in_proj"], x).reshape(n, s, num_heads, -1)
    y = torch.einsum("nhij,njhv->nihv", attn.float(), v.float()).reshape(n, s, -1)
    return core.dense(p["out_proj"], y.to(x.dtype))


def nonlin_attention(p, x: torch.Tensor, attn0: torch.Tensor) -> torch.Tensor:
    """NonlinAttention: tanh-gated value path mixed by head-0 weights."""
    h = core.dense(p["in_proj"], x)
    hidden = h.shape[-1] // 3
    s, mid, y = h[..., :hidden], h[..., hidden : 2 * hidden], h[..., 2 * hidden :]
    mid = core.matmul_f32(attn0, torch.tanh(s) * mid).to(x.dtype)
    return core.dense(p["out_proj"], mid * y)


def conv_module(p, x: torch.Tensor) -> torch.Tensor:
    """Gated ConvolutionModule: in_proj → (value, σ gate) → depthwise conv →
    SwooshR → out_proj."""
    h = core.dense(p["in_proj"], x)
    c = h.shape[-1] // 2
    mid = h[..., :c] * torch.sigmoid(h[..., c:])
    k = core.weight_shape(p["dw"]["w"])[-1]
    mid = core.conv1d(p["dw"], mid, padding=(k - 1) // 2, groups=c)
    return core.dense(p["out_proj"], swoosh_r(mid))


def bypass(scale: torch.Tensor, src_orig: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """BypassModule: src_orig + (src − src_orig) · scale (per channel)."""
    return src_orig + (src - src_orig) * scale


def simple_downsample(p, x: torch.Tensor, factor: int) -> torch.Tensor:
    """Softmax-weighted pooling of ``factor`` frames (the last frame repeated
    to pad).  x: (N, S, C) → (N, ceil(S/factor), C)."""
    n, s, c = x.shape
    ds = -(-s // factor)
    pad = ds * factor - s
    if pad:
        x = torch.cat([x, x[:, -1:].expand(n, pad, c)], dim=1)
    w = torch.softmax(p["bias"], dim=0).reshape(1, 1, factor, 1)
    return torch.sum(x.reshape(n, ds, factor, c) * w, dim=2)


def simple_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest upsampling: every frame repeated ``factor`` times in place."""
    return torch.repeat_interleave(x, factor, dim=1)


def _feed_forward(p, x: torch.Tensor, act=swoosh_l) -> torch.Tensor:
    return core.dense(p["out"], act(core.dense(p["in"], x)))


def zipformer_layer(p, x: torch.Tensor, pos: torch.Tensor, *, num_heads: int,
                    query_head_dim: int, pos_head_dim: int) -> torch.Tensor:
    """One Zipformer2 encoder layer.

    The final BiasNorm and the layer bypass are explicit; an enclosing
    dual-path bypass, if any, is the caller's job."""
    src_orig = x
    attn = attention_weights(p["attn"], x, pos, num_heads=num_heads,
                             query_head_dim=query_head_dim, pos_head_dim=pos_head_dim)
    x = x + _feed_forward(p["ff1"], x)
    x = x + nonlin_attention(p["nonlin"], x, attn[:, 0])
    x = x + self_attention(p["sa1"], x, attn, num_heads=num_heads)
    x = x + conv_module(p["conv1"], x)
    x = x + _feed_forward(p["ff2"], x)
    x = bypass(p["bypass_mid"], src_orig, x)
    x = x + self_attention(p["sa2"], x, attn, num_heads=num_heads)
    x = x + conv_module(p["conv2"], x)
    x = x + _feed_forward(p["ff3"], x, act=swoosh_l)
    x = bias_norm(p["norm"], x)
    return bypass(p["bypass"], src_orig, x)
