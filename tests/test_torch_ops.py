"""The plain versions of the port's kernels B3, B4, B5 and B6 against the JAX package.

``relpos_scores_plain``, ``dwconv1d_plain``, ``dwconv1d_grouped_plain`` and
``quad_attention_plain`` are
what the port runs on the CPU and what ``chip_smoke.py`` holds the CUDA
kernels to on the card.  Here they meet the JAX package's reference paths
(``relpos_scores_jnp``, ``dwconv1d_jnp``, ``quad_attention_jnp``, the CPU
route of ``audiojax.nn.core.conv1d`` for the grouped conv) and its Pallas
kernels run in interpret mode, on the same numpy inputs.  Tolerance:
1e-5 × max|ref|, float32 sums of at most a few hundred terms in another
order; B3's probabilities to atol 2e-5, the tolerance of the JAX package's
own rel-pos test (``tests/test_ops_pallas.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.ops.attention_pallas import pos_stride as j_pos_stride
from audiojax.ops.attention_pallas import (quad_attention_jnp, quad_attention_pallas,
                                           relpos_scores_jnp, relpos_scores_pallas)
from audiojax.nn import core as jcore
from audiojax.ops.dwconv_pallas import dwconv1d_jnp, dwconv1d_pallas, dwconv1d_pallas_tiled

from audiojax_torch.nn import core as tcore
from audiojax_torch.ops import attention_cuda, dwconv_cuda

TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(out: torch.Tensor, ref, tol=TOL):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)


# ── B4: depthwise conv1d ───────────────────────────────────────────────────


@pytest.mark.parametrize("pads", [(0, 0), (3, 3), (5, 1)])
def test_dwconv1d_plain_matches_jnp_and_pallas(pads):
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 3, 40, 128), _rand(rng, 7, 128)
    out = dwconv_cuda.dwconv1d_plain(torch.from_numpy(x), torch.from_numpy(w), pads=pads)
    _close(out, dwconv1d_jnp(jnp.asarray(x), jnp.asarray(w), pads=pads))
    _close(out, dwconv1d_pallas(jnp.asarray(x), jnp.asarray(w), pads=pads, block_rows=2,
                                interpret=True))


def test_dwconv1d_plain_dilated_matches_pallas_tiled():
    """Dilation 2, the contract of the TPU's time-tiled kernel (B5)."""
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 2, 300, 128), _rand(rng, 9, 128)
    out = dwconv_cuda.dwconv1d_plain(torch.from_numpy(x), torch.from_numpy(w), pads=(8, 8),
                                     dilation=2)
    ref = dwconv1d_pallas_tiled(jnp.asarray(x), jnp.asarray(w), pads=(8, 8), tile=128,
                                dilation=2, interpret=True)
    _close(out, ref)


def test_dwconv1d_output_length_checks():
    x, w = torch.zeros(1, 5, 4), torch.zeros(7, 4)
    with pytest.raises(ValueError, match="non-positive output length"):
        dwconv_cuda.dwconv1d_plain(x, w)
    with pytest.raises(ValueError, match="dilation"):
        dwconv_cuda.dwconv1d_plain(x, w, pads=(3, 3), dilation=0)


# ── B5: grouped 2-in/1-out conv1d ──────────────────────────────────────────


@pytest.mark.parametrize("dil,pads", [(1, (8, 8)), (2, (16, 16)), (2, (16, 0))])
def test_dwconv1d_grouped_plain_matches_jax(dil, pads):
    """Against ``audiojax.nn.core.conv1d`` with ``groups=G`` (its CPU route,
    ``_grouped_single_out_conv1d``) and against the TPU route: the stride-2
    deinterleave into two ``dwconv1d_pallas_tiled`` calls, in interpret mode.
    Group g reads the interleaved input lanes [2g, 2g+1]."""
    rng = np.random.default_rng(7)
    g, k, t = 128, 9, 300
    x, w = _rand(rng, 2, t, 2 * g), _rand(rng, k, 2, g)
    out = dwconv_cuda.dwconv1d_grouped_plain(torch.from_numpy(x), torch.from_numpy(w), pads=pads,
                                             dilation=dil)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _close(out, jcore.conv1d({"w": jw}, jx, padding=pads, dilation=dil, groups=g))
    _close(out, dwconv1d_pallas_tiled(jx[..., 0::2], jw[:, 0, :], pads=pads, dilation=dil,
                                      tile=128, interpret=True)
           + dwconv1d_pallas_tiled(jx[..., 1::2], jw[:, 1, :], pads=pads, dilation=dil,
                                   tile=128, interpret=True))


def test_grouped_conv_routes_to_b5(monkeypatch):
    """A (G, 2, k) conv with groups=G and C=2G reaches ``fast_dwconv1d_grouped``
    (on the CPU: its plain version, no launch); a true depthwise conv does not."""
    calls = []
    real = tcore.fast_dwconv1d_grouped
    monkeypatch.setattr(tcore, "fast_dwconv1d_grouped",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    dwconv_cuda.reset_launches()
    rng = np.random.default_rng(8)
    g, k = 16, 5
    x, w = _rand(rng, 2, 40, 2 * g), _rand(rng, k, 2, g)
    p = {"w": torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))}  # torch (G, 2, k)
    out = tcore.conv1d(p, torch.from_numpy(x), padding=4, dilation=2, groups=g)
    assert calls == [(k, 2, g)]
    assert not any(dwconv_cuda.launches.values())
    _close(out, jcore.conv1d({"w": jnp.asarray(w)}, jnp.asarray(x), padding=4, dilation=2,
                             groups=g))
    tcore.conv1d({"w": torch.zeros(2 * g, 1, k)}, torch.from_numpy(x), padding=2,
                 groups=2 * g)
    assert calls == [(k, 2, g)]  # the depthwise conv went to B4's route


def test_dwconv1d_grouped_checks():
    x, w = torch.zeros(1, 20, 8), torch.zeros(3, 2, 4)
    with pytest.raises(ValueError, match="does not fit"):
        dwconv_cuda.dwconv1d_grouped_plain(torch.zeros(1, 20, 6), w)
    with pytest.raises(ValueError, match="non-positive output length"):
        dwconv_cuda.dwconv1d_grouped_plain(x, w, dilation=10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dwconv_cuda.dwconv1d_grouped_cuda(x, w)
    with pytest.raises(ValueError, match=r"\(k, 2, G\)"):
        dwconv_cuda.dwconv1d_grouped_cuda(x, torch.zeros(3, 1, 8))


# ── B6: relu² attention ────────────────────────────────────────────────────


@pytest.mark.parametrize("n,s,k,v,mask", [(7, 33, 16, 24, False), (4, 20, 8, 8, True)])
def test_quad_attention_plain_matches_jnp_and_pallas(n, s, k, v, mask):
    rng = np.random.default_rng(0)
    q, kk, vv = _rand(rng, n, s, k), _rand(rng, n, s, k), _rand(rng, n, s, v)
    out = attention_cuda.quad_attention_plain(torch.from_numpy(q), torch.from_numpy(kk),
                                              torch.from_numpy(vv), scale=1.0 / s, mask_diag=mask)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv)
    _close(out, quad_attention_jnp(jq, jk, jv, scale=1.0 / s, mask_diag=mask))
    _close(out, quad_attention_pallas(jq, jk, jv, scale=1.0 / s, mask_diag=mask, block_rows=4,
                                      interpret=True))


# ── B3: rel-pos attention scores ───────────────────────────────────────────


def _relpos_inputs(rng, n, h, s, d, p):
    """q, k (N, S, H·D) and pp (N, S, H·stride) as lane slices of one packed
    projection, as ``attention_weights`` makes them; pe (H, P, S, S)."""
    stride = attention_cuda.pos_stride(p)
    pp = _rand(rng, n, s, h, stride)
    pp[..., p:] = 0.0  # slot tails are zero-padded by the producer
    proj = np.concatenate([_rand(rng, n, s, 2 * h * d), pp.reshape(n, s, h * stride)], axis=-1)
    pe = _rand(rng, h, p, s, s)
    return proj[..., : h * d], proj[..., h * d : 2 * h * d], proj[..., 2 * h * d :], pe


@pytest.mark.parametrize("n,h,s,d,p", [
    (7, 2, 33, 16, 4),
    (4, 4, 50, 32, 4),   # zipformer frequency-path geometry (scaled down)
    (3, 2, 21, 8, 2),
    (3, 2, 21, 8, 9),    # pos dim past one 8-lane stride slot
])
def test_relpos_scores_plain_matches_jnp(n, h, s, d, p):
    """The four shapes of the JAX package's rel-pos test, with float32 pe."""
    rng = np.random.default_rng(3)
    q, k, pp, pe = _relpos_inputs(rng, n, h, s, d, p)
    assert attention_cuda.pos_stride(p) == j_pos_stride(p)
    ref = np.asarray(relpos_scores_jnp(*(jnp.asarray(a) for a in (q, k, pp, pe)), num_heads=h))
    out = attention_cuda.relpos_scores_plain(*(torch.from_numpy(a) for a in (q, k, pp, pe)),
                                             num_heads=h)
    assert tuple(out.shape) == ref.shape == (n, h, s, s) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


def test_relpos_scores_plain_matches_pallas():
    """Against the Pallas kernel in interpret mode, with pe pre-rounded to
    bf16 (that kernel keeps its table in bf16; here both see the same values)."""
    rng = np.random.default_rng(4)
    q, k, pp, pe = _relpos_inputs(rng, 5, 2, 19, 8, 4)
    pe16 = jnp.asarray(pe).astype(jnp.bfloat16)
    ref = np.asarray(relpos_scores_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pp), pe16,
                                          interpret=True))
    out = attention_cuda.relpos_scores_plain(
        *(torch.from_numpy(a) for a in (q, k, pp)),
        torch.from_numpy(np.array(pe16.astype(jnp.float32))), num_heads=2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def test_relpos_scores_checks():
    rng = np.random.default_rng(5)
    q, k, pp, pe = (torch.from_numpy(a) for a in _relpos_inputs(rng, 2, 2, 6, 4, 4))
    with pytest.raises(ValueError, match="do not fit"):
        attention_cuda.relpos_scores_plain(q, k, pp, pe, num_heads=3)
    with pytest.raises(ValueError, match="slot holds"):
        attention_cuda.relpos_scores_plain(q, k, pp[..., :6], pe, num_heads=2)


# ── the kernel modules on the CPU ──────────────────────────────────────────


def test_fast_paths_take_plain_on_cpu():
    rng = np.random.default_rng(3)
    x, w = torch.from_numpy(_rand(rng, 2, 30, 8)), torch.from_numpy(_rand(rng, 5, 8))
    q, k, v = (torch.from_numpy(_rand(rng, 3, 11, 8)) for _ in range(3))
    before = (dict(dwconv_cuda.launches), dict(attention_cuda.launches))
    y = dwconv_cuda.fast_dwconv1d(x, w, pads=(2, 2), dilation=2)
    o = attention_cuda.fast_quad_attention(q, k, v, scale=0.5, mask_diag=True)
    assert (dwconv_cuda.launches, attention_cuda.launches) == before  # no kernel launched
    assert torch.equal(y, dwconv_cuda.dwconv1d_plain(x, w, pads=(2, 2), dilation=2))
    assert torch.equal(o, attention_cuda.quad_attention_plain(q, k, v, scale=0.5, mask_diag=True))


def test_fast_relpos_scores_takes_plain_on_cpu():
    attention_cuda.reset_launches()
    q, k, pp, pe = (torch.from_numpy(a)
                    for a in _relpos_inputs(np.random.default_rng(6), 3, 2, 10, 8, 4))
    out = attention_cuda.fast_relpos_scores(q, k, pp, pe, num_heads=2)
    assert attention_cuda.launches["relpos_scores"] == 0  # no kernel launched
    assert torch.equal(out, attention_cuda.relpos_scores_plain(q, k, pp, pe, num_heads=2))


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dwconv_cuda.dwconv1d_cuda(torch.zeros(1, 8, 4), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.quad_attention_cuda(torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                                           torch.zeros(1, 8, 4), scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.relpos_scores_cuda(torch.zeros(1, 8, 8), torch.zeros(1, 8, 8),
                                          torch.zeros(1, 8, 16), torch.zeros(2, 4, 8, 8),
                                          num_heads=2)
