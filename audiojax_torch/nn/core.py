"""Core NN building blocks in PyTorch — functional, channel-last.

Counterpart of ``audiojax.nn.core``, with only what GTCRN uses.  Functions
take a parameter dict and tensors; feature maps are channel-last
``(B, T, F, C)`` at every function's boundary, as in the JAX package, so the
tests compare like with like.

Weight layouts (set once by ``audiojax_torch.params.params_from_numpy``):
  dense             w: (in, out), b: (out,)
  conv2d            w: (out, in/groups, kh, kw)  — torch's Conv2d layout
  conv2d_transpose  w: the equivalent forward kernel in the same layout;
                    the transposed conv runs as a forward conv on the
                    stride-dilated (zero-inserted) input, as in the JAX
                    package, so no groups are needed to convert it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dense", "prelu", "conv2d", "conv2d_transpose", "layer_norm"]


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) @ w (in, out) + b."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def prelu(p, x: torch.Tensor) -> torch.Tensor:
    """PReLU with per-channel (or scalar) slope ``p['alpha']`` on the last axis."""
    return torch.where(x >= 0, x, p["alpha"] * x)


def _pair(pad) -> tuple[int, int]:
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def _conv(p, x_nchw: torch.Tensor, pads, dilation, groups, stride=(1, 1)) -> torch.Tensor:
    (hl, hr), (wl, wr) = pads
    if hl != hr or wl != wr or min(hl, wl) < 0:
        x_nchw = F.pad(x_nchw, (wl, wr, hl, hr))  # negative entries crop
        hl = wl = 0
    y = F.conv2d(x_nchw, p["w"], p.get("b"), stride=tuple(stride), padding=(hl, wl),
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d(p, x: torch.Tensor, *, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
           groups: int = 1) -> torch.Tensor:
    """Channel-last 2-D convolution: x (B, H, W, Cin) → (B, H', W', Cout)."""
    pads = (_pair(padding[0]), _pair(padding[1]))
    return _conv(p, x.permute(0, 3, 1, 2), pads, dilation, groups, stride)


def conv2d_transpose(p, x: torch.Tensor, *, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                     groups: int = 1) -> torch.Tensor:
    """Channel-last transposed 2-D conv with torch ``ConvTranspose2d`` geometry.

    out = (in - 1)·stride - 2·padding + dilation·(k - 1) + 1 per axis.
    """
    kh, kw = p["w"].shape[2:]
    sh, sw = stride
    xc = x.permute(0, 3, 1, 2)
    if (sh, sw) != (1, 1):
        b, c, h, w = xc.shape
        z = xc.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
        z[:, :, ::sh, ::sw] = xc
        xc = z
    ph = padding[0] if isinstance(padding[0], int) else padding[0][0]
    pw = padding[1] if isinstance(padding[1], int) else padding[1][0]
    eh, ew = dilation[0] * (kh - 1) - ph, dilation[1] * (kw - 1) - pw
    return _conv(p, xc, ((eh, eh), (ew, ew)), dilation, groups)


def layer_norm(p, x: torch.Tensor, *, ndims: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``ndims`` axes with affine ``g``/``b``."""
    g = b = None
    if p is not None and "g" in p:
        g, b = p["g"], p["b"]
    return F.layer_norm(x, x.shape[x.ndim - ndims:], g, b, eps)
