"""The launch plans and tiled order of the port's attention kernels (B6, B3).

The kernels (``audiojax_torch/csrc/quad_attention.cu``,
``csrc/relpos_scores.cu``) run only on the card.  Their geometry comes from
plain functions of ``ops.attention_cuda`` (``quad_launch``,
``relpos_launch``), held here at every serving shape of ``chip_smoke.py``:
each output element owned by exactly one block (the kernels' own index
arithmetic, written out in numpy), shared memory within a block's 227 KB,
the grid within the card's limits.  What the kernels compute is emulated in
numpy in their tiled order, at the plans' geometry and at small shapes: B6's
score tile formed once (features summed in order), the PV product by value
tile with each output summing its keys in order (cuBLAS's order: the kernel
equals the plain version bit for bit on the card), key segments where the
score tile does not fit; B3's per-batch-row loop over
staged pe rows, the bias formed apart, one reciprocal a row.  The emulations
are held against the JAX package's ``quad_attention_jnp`` (1e-5 × max|ref|,
the tolerance of ``tests/test_torch_ops.py``) and ``relpos_scores_jnp``
(atol 2e-5, the tolerance of the JAX package's own rel-pos test).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.ops.attention_pallas import quad_attention_jnp, relpos_scores_jnp

import chip_smoke
from audiojax_torch.ops import attention_cuda as A

QUAD_TOL = 1e-5
RELPOS_ATOL = 2e-5
MAX_BLOCKS = 2**31 - 1

# (N, S, K, V, mask) of every B6 serving shape; (N, S) of every B3 one
B6_SERVED = ([(n, s, 128, 128, mask) for _, n, s, mask in chip_smoke.B6_CASES]
             + [(n, s, 128, 2048, False) for _, n, s in
                chip_smoke.B6_SS_CASES + chip_smoke.B6_SE_CASES])
B3_SERVED = [(n, s) for _, n, s in chip_smoke.B3_CASES]
B3_H, B3_D, B3_P = 4, 32, 4


def _cdiv(a, b):
    return -(-a // b)


def _covered_once(ranges, length):
    """Each index of [0, length) lies in exactly one of the half-open ranges."""
    count = np.zeros(length, np.int64)
    for lo, hi in ranges:
        count[lo:hi] += 1
    return bool((count == 1).all())


# ── B6: ownership and limits ───────────────────────────────────────────────


def _quad_blocks(plan, n, s, dv):
    """(n, rows, value tiles) of every block, as ``quad_attention_kernel``
    derives them from blockIdx.x."""
    bm, vt = 32 * plan.wm, 64 * plan.wn
    tiles = _cdiv(dv, vt)
    per = _cdiv(tiles, plan.vsplit)
    b = np.arange(plan.blocks)
    vs = b % plan.vsplit
    rt = (b // plan.vsplit) % plan.row_tiles
    nn = b // (plan.vsplit * plan.row_tiles)
    t_lo, t_hi = vs * per, np.minimum(tiles, vs * per + per)
    return nn, rt * bm, np.minimum(s, rt * bm + bm), t_lo, t_hi


@pytest.mark.parametrize("n,s,dk,dv,mask", B6_SERVED,
                         ids=[f"{n}x{s}-K{k}-V{v}" + ("-mask" if m else "")
                              for n, s, k, v, m in B6_SERVED])
def test_quad_plan_owns_each_output_once_and_fits(n, s, dk, dv, mask):
    plan = A.quad_launch(n, s, dk, dv)
    assert plan.smem <= A.SMEM_MAX and plan.blocks <= MAX_BLOCKS
    assert plan.threads == 32 * plan.wm * plan.wn <= 1024
    assert plan.seg == _cdiv(s, 8) * 8  # every served row's score tile fits whole
    nn, r_lo, r_hi, t_lo, t_hi = _quad_blocks(plan, n, s, dv)
    # the block's (n, row tile, value split) triples are all distinct and cover
    # the grid; rows and value columns are each covered once by its factors
    assert plan.blocks == n * plan.row_tiles * plan.vsplit
    assert np.array_equal(np.bincount(nn, minlength=n), np.full(n, plan.row_tiles * plan.vsplit))
    first = nn == 0
    assert len(set(zip(r_lo[first], t_lo[first]))) == first.sum()  # no two blocks alike
    assert _covered_once(set(zip(r_lo[first], r_hi[first])), s)
    vt = 64 * plan.wn
    col_ranges = {(lo * vt, min(dv, hi * vt)) for lo, hi in zip(t_lo[first], t_hi[first])
                  if lo < hi}
    assert _covered_once(col_ranges, dv)
    # shared memory: the score tile of S rounded up to 8 keys (row stride
    # BM + 4), then the larger staging (q/k chunks of 16 features at row
    # stride 20; v pieces of 32 keys × VT; each double-buffered)
    bm, kb = 32 * plan.wm, 64 * plan.wn
    assert plan.smem == 4 * (plan.seg * (bm + 4) + max(2 * (bm + kb) * 20, 2 * 32 * vt))


def test_quad_plan_picks_and_key_segments():
    """2 × 2 warps at every served shape; SS's 256 blocks fill the card (two
    an SM) without a value split; a row too long for the score tile takes
    key segments, with one value tile a block."""
    ss = A.quad_launch(64, 256, 128, 2048)
    assert (ss.wm, ss.wn, ss.vsplit, ss.blocks) == (2, 2, 1, 256)
    assert 2 * (ss.smem + 1024) <= A.SMEM_SM
    gan = A.quad_launch(964, 101, 128, 128)
    assert (gan.wm, gan.wn, gan.row_tiles, gan.seg) == (2, 2, 2, 104)
    small = A.quad_launch(2, 60, 128, 2048)
    assert small.vsplit > 1 and small.blocks >= small.row_tiles * 2
    long = A.quad_launch(2, 3000, 128, 512)
    assert long.seg < 3000 and long.seg % 8 == 0 and long.vsplit == 512 // (64 * long.wn)
    assert long.smem <= A.SMEM_MAX
    with pytest.raises(ValueError, match="vsplit"):
        A.quad_launch(2, 3000, 128, 512, vsplit=1)
    with pytest.raises(ValueError, match="built for"):
        A.quad_launch(2, 60, 128, 128, warps=(1, 1))


# ── B6: the tiled order, emulated ──────────────────────────────────────────


def _emulate_quad(q, k, v, scale, mask, plan):
    """``quad_attention_kernel`` block by block, in float32: each segment's
    scores summed over features in order, relu²'d and masked, then the PV
    product by value tile, each output summing its keys in order (the
    kernel stages them 32 at a time)."""
    n_all, s, dk = q.shape
    dv = v.shape[-1]
    f32 = np.float32
    out = np.full((n_all, s, dv), np.nan, f32)
    s_pad = _cdiv(s, 8) * 8
    nn, r_lo, r_hi, t_lo, t_hi = _quad_blocks(plan, n_all, s, dv)
    vt = 64 * plan.wn
    for n, m0, m1, ta, tb in zip(nn, r_lo, r_hi, t_lo, t_hi):
        o = {t: np.zeros((m1 - m0, vt), f32) for t in range(ta, tb)}
        for k_lo in range(0, s_pad, plan.seg):
            keys = np.arange(k_lo, min(k_lo + plan.seg, s))
            acc = np.zeros((m1 - m0, len(keys)), f32)
            for d in range(dk):
                acc = acc + q[n, m0:m1, d, None] * k[n, keys, d][None, :]
            p = np.maximum(acc * f32(scale), f32(0))
            p = p * p
            if mask:
                p[np.arange(m0, m1)[:, None] == keys[None, :]] = 0
            for t in range(ta, tb):
                cols = slice(t * vt, min(dv, t * vt + vt))
                vv = np.zeros((s, vt), f32)
                vv[:, : cols.stop - cols.start] = v[n, :, cols]
                for j in range(len(keys)):  # keys in order, in chunks of 32 that add no rounding
                    o[t] = o[t] + p[:, j, None] * vv[keys[j]][None, :]
        for t in range(ta, tb):
            w = min(dv, t * vt + vt) - t * vt
            out[n, m0:m1, t * vt : t * vt + w] = o[t][:, :w]
    return out


@pytest.mark.parametrize("n,s,dk,dv,mask,warps,seg", [
    (2, 37, 20, 136, True, (2, 2), None),   # ragged rows, keys and value tiles
    (2, 45, 16, 264, False, (2, 2), None),  # three value tiles of 128, one ragged
    (1, 70, 12, 72, True, (4, 2), None),    # one row tile of 128
    (2, 50, 8, 64, True, (2, 2), 16),       # key segments of 16
])
def test_emulated_quad_kernel_matches_jax(n, s, dk, dv, mask, warps, seg):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((n, s, d)).astype(np.float32) for d in (dk, dk, dv))
    plan = A.quad_launch(n, s, dk, dv, warps=warps)
    if seg is not None:  # force the key-segment route at a small shape
        tiles = _cdiv(dv, 64 * plan.wn)
        plan = A.QuadLaunch(plan.wm, plan.wn, plan.row_tiles, tiles, seg, plan.threads,
                            n * plan.row_tiles * tiles, A.quad_smem(plan.wm, plan.wn, seg))
    out = _emulate_quad(q, k, v, 1.0 / s, mask, plan)
    ref = np.asarray(quad_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        scale=1.0 / s, mask_diag=mask))
    assert not np.isnan(out).any()  # every element written
    np.testing.assert_allclose(out, ref, atol=QUAD_TOL * np.abs(ref).max(), rtol=0)
    plain = A.quad_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale=1.0 / s,
                                   mask_diag=mask).numpy()
    np.testing.assert_allclose(out, plain, atol=QUAD_TOL * np.abs(plain).max(), rtol=0)


# ── B3: ownership and limits ───────────────────────────────────────────────


def _relpos_blocks(plan, n, s, h):
    """(h, rows, batch rows) of every block, as the kernels derive them."""
    b = np.arange(plan.blocks)
    if plan.route == "batched":
        chunk = b % plan.chunks
        rt = (b // plan.chunks) % plan.row_tiles
        hh = b // (plan.chunks * plan.row_tiles)
        r0 = rt * plan.rows
        return (hh, r0, np.minimum(s, r0 + plan.rows), chunk * plan.nb,
                np.minimum(n, chunk * plan.nb + plan.nb))
    chunk = b % plan.row_tiles  # the two-pass route: row ranges of a (n, h)
    nh = b // plan.row_tiles
    r0 = chunk * plan.rows * 32
    return nh % h, r0, np.minimum(s, r0 + plan.rows * 32), nh // h, nh // h + 1


@pytest.mark.parametrize("n,s", B3_SERVED, ids=[f"{n}x{s}" for n, s in B3_SERVED])
def test_relpos_plan_owns_each_output_once_and_fits(n, s):
    plan = A.relpos_launch(n, s, B3_H, B3_D, B3_P)
    assert plan.route == ("batched" if s <= 256 else "two_pass")
    assert plan.smem <= A.SMEM_MAX and plan.blocks <= MAX_BLOCKS
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    hh, r_lo, r_hi, n_lo, n_hi = _relpos_blocks(plan, n, s, B3_H)
    # every (h, row, n) is owned by exactly one block: per head, the row
    # ranges of the blocks that hold batch row 0 cover [0, S) once, and the
    # batch ranges of the blocks that hold row 0 cover [0, N) once
    for h in range(B3_H):
        mine = hh == h
        at_n0 = mine & (n_lo == 0)
        assert _covered_once(list(zip(r_lo[at_n0], r_hi[at_n0])), s)
        at_r0 = mine & (r_lo == 0)
        assert _covered_once(list(zip(n_lo[at_r0], n_hi[at_r0])), n)
        assert mine.sum() == at_n0.sum() * at_r0.sum()  # rows × batch ranges, no more
    if plan.route == "batched":
        assert 32 * plan.nj >= s and plan.threads == 8 * plan.rows
        assert plan.smem == A.relpos_smem(plan.nj, plan.rows, B3_D, B3_P)


def test_relpos_plan_reuses_pe_across_the_batch():
    """At ZipEnhancer's two largest 6 s shapes each block stages its pe rows
    once for tens of batch rows: floats of pe through L2 a probability P/nb
    ≤ 0.1 (the first design read P = 4), of keys D/R ≤ 2; the blocks fill one
    wave at the blocks an SM that the shared memory allows."""
    for n, s in ((964, 101), (404, 241)):
        plan = A.relpos_launch(n, s, B3_H, B3_D, B3_P)
        assert plan.nb >= 16 and B3_P / plan.nb <= 0.1 and B3_D / plan.rows <= 2
        per_sm = min(A.SMEM_SM // (plan.smem + 1024), 2048 // plan.threads)
        assert plan.blocks <= per_sm * A.SM_COUNT
    with pytest.raises(ValueError, match="multiple of 4"):
        A.relpos_launch(10, 50, 2, 8, 4, rows=6)


# ── B3: the tiled order, emulated ──────────────────────────────────────────


def _emulate_relpos(q, k, pp, pe, h, plan):
    """``relpos_batched_kernel`` block by block, in float32: per batch row of
    the block, scores summed over features in order, the bias formed apart
    from the staged pe rows, softmax with one reciprocal a row."""
    n_all, s, hd = q.shape
    d, n_pos = hd // h, pe.shape[1]
    stride = pp.shape[-1] // h
    f32 = np.float32
    out = np.full((n_all, h, s, s), np.nan, f32)
    owned = np.zeros((n_all, h, s), np.int64)
    hh, r_lo, r_hi, n_lo, n_hi = _relpos_blocks(plan, n_all, s, h)
    for head, i0, i1, na, nb in zip(hh, r_lo, r_hi, n_lo, n_hi):
        pes = pe[head, :, i0:i1, :]  # staged once for the block's batch rows
        for n in range(na, nb):
            qs = q[n, i0:i1, head * d : (head + 1) * d]
            ks = k[n, :, head * d : (head + 1) * d]
            ps = pp[n, i0:i1, head * stride : head * stride + n_pos]
            acc = np.zeros((i1 - i0, s), f32)
            for dd in range(d):
                acc = acc + qs[:, dd, None] * ks[None, :, dd]
            bias = np.zeros_like(acc)
            for p in range(n_pos):
                bias = bias + ps[:, p, None] * pes[p]
            acc = acc + bias
            e = np.exp(acc - acc.max(-1, keepdims=True))
            inv = f32(1) / e.sum(-1, keepdims=True, dtype=f32)
            out[n, head, i0:i1] = e * inv
            owned[n, head, i0:i1] += 1
    assert (owned == 1).all()
    return out


@pytest.mark.parametrize("n,h,s,d,p,rows,nb", [
    (7, 2, 33, 16, 4, None, None),
    (9, 4, 50, 32, 4, None, 2),     # the frequency-path geometry, scaled down
    (5, 2, 61, 8, 9, 16, 3),        # P past one 8-lane slot; row tiles of 16
    (3, 2, 26, 8, 2, 28, None),     # one ragged row tile
])
def test_emulated_relpos_kernel_matches_jax(n, h, s, d, p, rows, nb):
    rng = np.random.default_rng(12)
    stride = A.pos_stride(p)
    pp = rng.standard_normal((n, s, h, stride)).astype(np.float32)
    pp[..., p:] = 0.0  # slot tails are zero-padded by the producer
    proj = np.concatenate([rng.standard_normal((n, s, 2 * h * d)).astype(np.float32),
                           pp.reshape(n, s, h * stride)], axis=-1)
    q, k, ppv = proj[..., : h * d], proj[..., h * d : 2 * h * d], proj[..., 2 * h * d :]
    pe = rng.standard_normal((h, p, s, s)).astype(np.float32)
    plan = A.relpos_launch(n, s, h, d, p, rows=rows, nb=nb)
    assert plan.route == "batched"
    out = _emulate_relpos(q, k, ppv, pe, h, plan)
    ref = np.asarray(relpos_scores_jnp(*(jnp.asarray(a) for a in (q, k, ppv, pe)), num_heads=h))
    np.testing.assert_allclose(out, ref, atol=RELPOS_ATOL, rtol=0)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
