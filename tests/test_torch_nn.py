"""The port's nn layer (core, rnn, erb, mossformer tables) against audiojax.nn
on the same weights.

Weights are drawn with numpy in the JAX package's layout and go to the port
through ``params_from_numpy``, so every case also checks that conversion.
Tolerances: both sides compute in float32 with sums in another order; the
stated atol is relative to the reference's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.models.zipenhancer import instance_norm_tf as j_instance_norm_tf
from audiojax.nn import core as jcore
from audiojax.nn import erb as jerb
from audiojax.nn import mossformer as jmossformer
from audiojax.nn import rnn as jrnn

from audiojax_torch.models.zipenhancer import instance_norm_tf as t_instance_norm_tf
from audiojax_torch.nn import core as tcore
from audiojax_torch.nn import erb as terb
from audiojax_torch.nn import mossformer as tmossformer
from audiojax_torch.nn import rnn as trnn
from audiojax_torch.params import params_from_numpy

TOL = 1e-5  # × max|ref|: float32 products of at most a few hundred terms
GRU_TOL = 2e-5  # recurrences compound rounding over up to 40 steps


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """(JAX tree of jnp arrays, port tree of CPU tensors) from a numpy tree."""
    jt = {k: _both(v)[0] if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}
    return jt, params_from_numpy(tree, device="cpu")


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_dense_prelu_layer_norm():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 33, 16)
    jp, tp = _both({"w": _rand(rng, 16, 16), "b": _rand(rng, 16), "alpha": _rand(rng, 16),
                    "ln": {"g": _rand(rng, 33, 16), "b": _rand(rng, 33, 16)}})
    xt = torch.from_numpy(x)
    _close(tcore.dense(tp, xt), jcore.dense(jp, jnp.asarray(x)))
    _close(tcore.prelu(tp, xt), jcore.prelu(jp, jnp.asarray(x)))
    _close(tcore.layer_norm(tp["ln"], xt, ndims=2, eps=1e-8),
           jcore.layer_norm(jp["ln"], jnp.asarray(x), ndims=2, eps=1e-8))


# (kh, kw, cin, cout, groups, stride, padding, dilation): GTCRN's forward convs
CONV_CASES = [
    (1, 5, 9, 16, 1, (1, 2), (0, 2), (1, 1)),   # enc0
    (1, 5, 16, 16, 2, (1, 2), (0, 2), (1, 1)),  # enc1, grouped + strided
    (1, 1, 24, 16, 1, (1, 1), (0, 0), (1, 1)),  # pointwise pc1
    (3, 3, 16, 16, 16, (1, 1), (0, 1), (2, 1)),  # depthwise, time dilation 2
    (3, 3, 16, 16, 16, (1, 1), (0, 1), (5, 1)),  # depthwise, time dilation 5
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"k{c[0]}x{c[1]}-g{c[4]}-d{c[7][0]}")
def test_conv2d(case):
    kh, kw, cin, cout, groups, stride, padding, dilation = case
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 14, 33, cin)
    jp, tp = _both({"w": _rand(rng, kh, kw, cin // groups, cout, scale=0.3),
                    "b": _rand(rng, cout)})
    kw_ = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    _close(tcore.conv2d(tp, torch.from_numpy(x), **kw_), jcore.conv2d(jp, jnp.asarray(x), **kw_))


# The two transposed-conv forms GTCRN calls: the strided grouped decoder conv
# (dec1, and dec0 with groups 1) and the dilated depthwise 3×3 of the decoder
# GT blocks.  (kh, kw, cin, cout, groups, stride, padding, dilation)
DECONV_CASES = [
    (1, 5, 16, 16, 2, (1, 2), (0, 2), (1, 1)),
    (1, 5, 16, 2, 1, (1, 2), (0, 2), (1, 1)),
    (3, 3, 16, 16, 16, (1, 1), (0, 1), (1, 1)),
    (3, 3, 16, 16, 16, (1, 1), (0, 1), (5, 1)),
]


@pytest.mark.parametrize("case", DECONV_CASES, ids=lambda c: f"k{c[0]}x{c[1]}-g{c[4]}-d{c[7][0]}")
def test_conv2d_transpose(case):
    kh, kw, cin, cout, groups, stride, padding, dilation = case
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 11, 17, cin)
    jp, tp = _both({"w": _rand(rng, kh, kw, cin // groups, cout, scale=0.3),
                    "b": _rand(rng, cout)})
    kw_ = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    out = tcore.conv2d_transpose(tp, torch.from_numpy(x), **kw_)
    ref = jcore.conv2d_transpose(jp, jnp.asarray(x), **kw_)
    _close(out, ref)
    # torch ConvTranspose2d geometry: (in - 1)·stride - 2·pad + dil·(k - 1) + 1
    assert out.shape[1] == (11 - 1) * stride[0] - 2 * padding[0] + dilation[0] * (kh - 1) + 1
    assert out.shape[2] == (17 - 1) * stride[1] - 2 * padding[1] + dilation[1] * (kw - 1) + 1


# (k, cin, cout, groups, stride, padding, dilation): MossFormerGAN's convs
# (depthwise k=31, the grouped unfold conv with 4 outputs per group) and the
# contract's other corners.  Depthwise cases run on the port's B4 route.
CONV1D_CASES = [
    (31, 64, 64, 64, 1, 15, 1),         # depthwise, 'same'
    (5, 32, 32, 32, 1, (4, 2), 2),      # depthwise, asymmetric pads, dilated
    (3, 8, 8, 1, 1, (-1, 2), 1),        # a negative pad crops
    (4, 16, 64, 16, 1, 0, 1),           # grouped, 4 outputs per group (unfold)
    (3, 8, 12, 1, 2, 1, 1),             # strided
    (3, 8, 8, 1, 1, 2, 2),              # dilated dense
]


@pytest.mark.parametrize("case", CONV1D_CASES,
                         ids=lambda c: f"k{c[0]}-g{c[3]}-s{c[4]}-p{c[5]}-d{c[6]}")
def test_conv1d(case):
    k, cin, cout, groups, stride, padding, dilation = case
    rng = np.random.default_rng(7)
    x = _rand(rng, 3, 40, cin)
    jp, tp = _both({"w": _rand(rng, k, cin // groups, cout, scale=0.3), "b": _rand(rng, cout)})
    kw_ = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    _close(tcore.conv1d(tp, torch.from_numpy(x), **kw_), jcore.conv1d(jp, jnp.asarray(x), **kw_))


# (k, cin, cout, groups, stride, padding, output_padding): the refold conv
# (stride 1) and strided forms with output_padding
DECONV1D_CASES = [
    (4, 16, 8, 1, 1, 0, 0),
    (4, 8, 8, 1, 2, 1, 1),
    (5, 8, 8, 8, 2, 2, 0),  # depthwise: runs on the B4 route
    (3, 8, 6, 2, 3, 0, 2),
]


@pytest.mark.parametrize("case", DECONV1D_CASES,
                         ids=lambda c: f"k{c[0]}-g{c[3]}-s{c[4]}-p{c[5]}-op{c[6]}")
def test_conv1d_transpose(case):
    k, cin, cout, groups, stride, padding, output_padding = case
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 13, cin)
    jp, tp = _both({"w": _rand(rng, k, cin // groups, cout, scale=0.3), "b": _rand(rng, cout)})
    kw_ = dict(stride=stride, padding=padding, groups=groups, output_padding=output_padding)
    out = tcore.conv1d_transpose(tp, torch.from_numpy(x), **kw_)
    _close(out, jcore.conv1d_transpose(jp, jnp.asarray(x), **kw_))
    # torch ConvTranspose1d geometry
    assert out.shape[1] == (13 - 1) * stride - 2 * padding + (k - 1) + 1 + output_padding


def test_instance_norm_and_rope_tables():
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 7, 11, 5)
    jp, tp = _both({"g": _rand(rng, 5), "b": _rand(rng, 5)})
    _close(t_instance_norm_tf(tp, torch.from_numpy(x)), j_instance_norm_tf(jp, jnp.asarray(x)))
    for out, ref in zip(tmossformer.rope_mm_tables(101, 32, 128, torch.device("cpu")),
                        jmossformer.rope_mm_tables(101, 32, 128)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _gru_np(rng, din, hidden, stack=()):
    s = 1.0 / np.sqrt(hidden)
    u = lambda *sh: rng.uniform(-s, s, stack + sh).astype(np.float32)
    return {"w_i": u(din, 3 * hidden), "w_h": u(hidden, 3 * hidden),
            "b_i": u(3 * hidden), "b_h": u(3 * hidden)}


@pytest.mark.parametrize("reverse", [False, True])
def test_gru(reverse):
    rng = np.random.default_rng(3)
    x = _rand(rng, 3, 40, 8)
    h0 = _rand(rng, 3, 16, scale=0.5)
    jp, tp = _both(_gru_np(rng, 8, 16))
    for h in (None, h0):
        out, h_last = trnn.gru(tp, torch.from_numpy(x), None if h is None else torch.from_numpy(h),
                               reverse=reverse, return_state=True)
        ref, ref_last = jrnn.gru(jp, jnp.asarray(x), None if h is None else jnp.asarray(h),
                                 reverse=reverse, return_state=True)
        _close(out, ref, GRU_TOL)
        _close(h_last, ref_last, GRU_TOL)


def test_grouped_gru_with_state():
    rng = np.random.default_rng(4)
    x = _rand(rng, 5, 30, 16)
    h0 = _rand(rng, 2, 5, 8, scale=0.5)
    jp, tp = _both(_gru_np(rng, 8, 8, stack=(2,)))
    out = trnn.grouped_gru(tp, torch.from_numpy(x), groups=2)
    _close(out, jrnn.grouped_gru(jp, jnp.asarray(x), groups=2), GRU_TOL)
    out, h_last = trnn.grouped_gru(tp, torch.from_numpy(x), groups=2, h0=torch.from_numpy(h0),
                                   return_state=True)
    ref, ref_last = jrnn.grouped_gru(jp, jnp.asarray(x), groups=2, h0=jnp.asarray(h0),
                                     return_state=True)
    _close(out, ref, GRU_TOL)
    _close(h_last, ref_last, GRU_TOL)


def test_grouped_gru_bidir():
    """Channel order: per group [fwd_g ‖ bwd_g], then the groups."""
    rng = np.random.default_rng(5)
    x = _rand(rng, 6, 33, 16)
    jf, tf = _both(_gru_np(rng, 8, 4, stack=(2,)))
    jb, tb = _both(_gru_np(rng, 8, 4, stack=(2,)))
    out = trnn.grouped_gru_bidir(tf, tb, torch.from_numpy(x), groups=2)
    _close(out, jrnn.grouped_gru_bidir(jf, jb, jnp.asarray(x), groups=2), GRU_TOL)


@pytest.mark.parametrize("scale", [21.4, 24.7])
def test_erb_compress_expand(scale):
    np.testing.assert_array_equal(terb.erb_filters(65, 64, 512, scale=scale),
                                  jerb.erb_filters(65, 64, 512, scale=scale))
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 7, 257, 3)
    c = terb.erb_compress(torch.from_numpy(x), 65, 64, 512, scale=scale)
    _close(c, jerb.erb_compress(jnp.asarray(x), 65, 64, 512, scale=scale))
    m = _rand(rng, 2, 7, 129, 2)
    _close(terb.erb_expand(torch.from_numpy(m), 65, 64, 512, scale=scale),
           jerb.erb_expand(jnp.asarray(m), 65, 64, 512, scale=scale))
