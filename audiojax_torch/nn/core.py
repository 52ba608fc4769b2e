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

A quantized weight (``{'q8', 'scale'}``, the q8 plans, ``utils/quantize.py``)
is read through ``as_weight`` (int8 values times their scales) by the convs,
the RNNs and the models that read weights themselves; ``dense`` takes the
dynamic int8 route on one (``dyn_int8_matmul``, the q8dyn plan's product).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.dwconv_cuda import fast_dwconv1d, fast_dwconv1d_grouped

__all__ = ["COMPUTE_DTYPES", "compute_dtype", "cast_f32_tree", "expect_cast", "matmul_f32",
           "is_q8", "as_weight", "weight_shape", "int_mm", "dyn_int8_matmul", "dense", "prelu",
           "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "layer_norm", "rms_norm"]

# the activation compute dtypes of the port's plans, by the configs' names
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``, or raise."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: the port's plans are {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def is_q8(w) -> bool:
    """True for a ``{'q8', 'scale'}`` quantized weight."""
    return isinstance(w, dict) and "q8" in w


def as_weight(w):
    """A quantized weight as ``q8 · scale`` in the scale's dtype (where it
    lies); a tensor passes through."""
    if is_q8(w):
        return w["q8"].to(w["scale"].dtype) * w["scale"]
    return w


def weight_shape(w) -> torch.Size:
    """A weight's shape, quantized or not."""
    return (w["q8"] if is_q8(w) else w).shape


def cast_f32_tree(tree, dtype: torch.dtype):
    """Counterpart of ``audiojax.nn.core.cast_f32_tree``: every float32 leaf
    of a parameter tree (dicts and lists of tensors) cast to ``dtype``, other
    leaves and quantized weights passed through; the tree itself for
    float32.  Idempotent."""
    if dtype == torch.float32 or is_q8(tree):
        return tree
    if isinstance(tree, dict):
        return {k: cast_f32_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_f32_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def expect_cast(leaf: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless a network's parameter ``leaf`` (a float32 one in the
    float32 plan) has been cast to the plan's ``dtype``: a bf16 plan takes
    its tree cast once, where its module is built, and no forward casts it.
    A quantized weight (a q8 plan, always float32 compute) passes."""
    if not is_q8(leaf) and leaf.dtype != dtype:
        raise TypeError(f"a {dtype} plan takes its parameters cast to {dtype} "
                        f"(runtime.registry.prepare_compute_params), got {leaf.dtype}")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a float32 result: ``jnp.matmul(..., preferred_element_type=
    jnp.float32)``.  bf16 operands are widened (exact) and multiplied in true
    float32; float32 operands are multiplied as they are."""
    return torch.matmul(a.float(), b.float())


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) → the exact int32 product by
    ``torch._int_mm``.  On the card (cuBLASLt) it takes M > 16 and K, N
    multiples of 8, so the operands are padded to that on every device with
    zeros, which add nothing to an integer sum, and the product sliced back."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def dyn_int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The q8dyn plan's product (``audiojax.nn.core.dyn_int8_matmul``): each
    row of ``x (..., in)`` quantized to int8 by its own symmetric scale, an
    exact int8 × int8 product summed in int32, rescaled by the row's scale
    and the weight's per-column one (``scale (1, out)``).  Float32 out.

    Never a float product: 127²·K passes 2²⁴ from K = 1,041, where float32
    sums stop being exact."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    xs = torch.clamp(amax, min=torch.finfo(torch.float32).tiny) * (1.0 / 127.0)
    # clip before the cast: a rounded x / xs can reach 128, which would wrap
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), q8).reshape(*lead, q8.shape[-1])
    return acc.to(torch.float32) * xs.to(torch.float32) * scale.reshape(-1)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) @ w (in, out) + b, in the promoted dtype of x and w (a
    bf16 weight on a float32 input gives float32, as in the JAX package).  A
    quantized ``w`` takes the dynamic int8 route (the q8dyn plan)."""
    w = p["w"]
    if is_q8(w):
        y = dyn_int8_matmul(x, w["q8"], w["scale"]).to(x.dtype)
        return y + p["b"] if "b" in p else y
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
    y = F.conv2d(x_nchw, as_weight(p["w"]), p.get("b"), stride=tuple(stride), padding=(hl, wl),
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv1d(p, x: torch.Tensor, *, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """Channel-last 1-D convolution: x (B, T, Cin) → (B, T', Cout).

    ``padding`` is an int or ``(lo, hi)``; a negative entry crops."""
    w = as_weight(p["w"])
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
    k = weight_shape(p["w"])[2]
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
    kh, kw = weight_shape(p["w"])[2:]
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
