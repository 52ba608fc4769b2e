"""Core NN building blocks in PyTorch — functional, channel-last.

Counterpart of ``audiojax.nn.core``, with what the served families use.
Functions take a parameter dict and tensors; feature maps are channel-last
``(B, T, C)`` or ``(B, T, F, C)`` at every function's boundary, as in the JAX
package, so the tests compare like with like.

Weight layouts (set once by ``audiojax_torch.params.params_from_numpy``):
  dense             w: (in, out), b: (out,)
  conv1d            w: (out, in/groups, k)       — torch's Conv1d layout
  conv2d            w: (out, in/groups, kh, kw)  — torch's Conv2d layout
  conv*_transpose   w: the equivalent forward kernel in the same layout;
                    the transposed conv runs as a forward conv on the
                    stride-dilated (zero-inserted) input, as in the JAX
                    package, so no groups are needed to convert it.

Routing goes by contract, not by shape: every true depthwise conv1d (one
input channel per group, ``groups == C``, stride 1) runs on the depthwise
kernel B4 (``ops.dwconv_cuda``) at any width, length and dilation; every
grouped conv1d with two input channels and one output channel per group
(torch weight ``(G, 2, k)``, ``groups == G``, ``C == 2G``, stride 1) runs on
the grouped kernel B5; every other conv runs on ``F.conv1d`` / ``F.conv2d``.
A conv of one group is not grouped, as in the JAX package's routing: SDAEC's
(10, 2, 1) alignment conv, two input channels and one output, runs on
``F.conv1d``.

The bf16 compute plan follows the JAX package's dtype rules: the parameter
tree's float32 leaves are cast once (``cast_f32_tree``; never
``module.to(bfloat16)``, which would also cast the f32 islands' tables), an
op on two bf16 operands gives bf16, and a bf16 operand meeting a float32 one
is widened (``dense`` of a float32 input by a bf16 weight is float32, as
``jnp.matmul`` promotes).  Where the JAX package asks for a float32 result of
bf16 operands (``preferred_element_type=jnp.float32``), the port widens them,
which is exact, and multiplies in true float32 (``matmul_f32``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.dwconv_cuda import fast_dwconv1d, fast_dwconv1d_grouped

__all__ = ["COMPUTE_DTYPES", "compute_dtype", "cast_f32_tree", "expect_cast", "matmul_f32",
           "dense", "prelu", "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "layer_norm", "rms_norm"]

# the activation compute dtypes of the port's plans, by the configs' names
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``, or raise."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: the port's plans are {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def cast_f32_tree(tree, dtype: torch.dtype):
    """Counterpart of ``audiojax.nn.core.cast_f32_tree``: every float32 leaf
    of a parameter tree (dicts and lists of tensors) cast to ``dtype``, other
    leaves passed through; the tree itself for float32.  Idempotent."""
    if dtype == torch.float32:
        return tree
    if isinstance(tree, dict):
        return {k: cast_f32_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_f32_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def expect_cast(leaf: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless a network's parameter ``leaf`` (a float32 one in the
    float32 plan) has been cast to the plan's ``dtype``: a bf16 plan takes
    its tree cast once, where its module is built, and no forward casts it."""
    if leaf.dtype != dtype:
        raise TypeError(f"a {dtype} plan takes its parameters cast to {dtype} "
                        f"(runtime.registry.prepare_compute_params), got {leaf.dtype}")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a float32 result: ``jnp.matmul(..., preferred_element_type=
    jnp.float32)``.  bf16 operands are widened (exact) and multiplied in true
    float32; float32 operands are multiplied as they are."""
    return torch.matmul(a.float(), b.float())


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) @ w (in, out) + b, in the promoted dtype of x and w (a
    bf16 weight on a float32 input gives float32, as in the JAX package)."""
    w = p["w"]
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w)
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


def conv1d(p, x: torch.Tensor, *, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """Channel-last 1-D convolution: x (B, T, Cin) → (B, T', Cout).

    ``padding`` is an int or ``(lo, hi)``; a negative entry crops."""
    w = p["w"]
    lo, hi = _pair(padding)
    if min(lo, hi) < 0:  # crop first, so both routes see non-negative pads
        x = x[:, max(0, -lo): x.shape[1] - max(0, -hi)]
        lo, hi = max(0, lo), max(0, hi)
    c = x.shape[-1]
    # the kernels read w through its strides: the (k, C) and (k, 2, G) views go uncopied
    if groups > 1 and w.shape[1] == 1 and w.shape[0] == groups == c and stride == 1:
        y = fast_dwconv1d(x.contiguous(), w[:, 0, :].t(), pads=(lo, hi), dilation=dilation)
        return y + p["b"] if "b" in p else y
    if (groups > 1 and w.shape[1] == 2 and w.shape[0] == groups and c == 2 * groups
            and stride == 1):
        y = fast_dwconv1d_grouped(x.contiguous(), w.permute(2, 1, 0), pads=(lo, hi),
                                  dilation=dilation)
        return y + p["b"] if "b" in p else y
    xc = x.transpose(1, 2)
    if lo != hi:
        xc = F.pad(xc, (lo, hi))
        lo = 0
    y = F.conv1d(xc, w, p.get("b"), stride=stride, padding=lo, dilation=dilation,
                 groups=groups)
    return y.transpose(1, 2)


def conv1d_transpose(p, x: torch.Tensor, *, stride: int = 1, padding=0, dilation: int = 1,
                     groups: int = 1, output_padding: int = 0) -> torch.Tensor:
    """Channel-last transposed 1-D conv with torch ``ConvTranspose1d`` geometry,
    as a forward conv on the stride-dilated input (so a depthwise one runs on
    B4 too).

    out = (in - 1)·stride - 2·padding + dilation·(k - 1) + 1 + output_padding.
    """
    k = p["w"].shape[2]
    if stride != 1:
        b, t, c = x.shape
        z = x.new_zeros((b, (t - 1) * stride + 1, c))
        z[:, ::stride] = x
        x = z
    pad = padding if isinstance(padding, int) else padding[0]
    eff = dilation * (k - 1) - pad
    return conv1d(p, x, padding=(eff, eff + output_padding), dilation=dilation, groups=groups)


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


def rms_norm(p, x: torch.Tensor, *, eps: float = 1e-8) -> torch.Tensor:
    """RMS normalisation over the last axis with an optional gain ``p['g']``.

    The mean square is floored at the dtype's ``tiny`` even at ``eps=0``, so
    an all-zero row (a silent window, or the zero windows that round a
    request up to a power of two) gives 0, not 0·inf = NaN."""
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(torch.clamp(ms + eps, min=torch.finfo(x.dtype).tiny))
    if p is not None and "g" in p:
        y = y * p["g"]
    return y
