"""The launch plans, the route rule and the tiled order of the bf16 instances
of B6 and B4 on the tensor cores.

The kernels (``audiojax_torch/csrc/quad_attention_bf16.cu``,
``csrc/dwconv_bf16.cu``) run only on the card.  Their geometry comes from
plain functions (``ops.attention_cuda.quad_bf16_launch``,
``ops.dwconv_cuda.dwconv_mma_launch`` behind ``dwconv_plan``), held here at
every bf16 serving shape of ``chip_smoke.py`` (6 s: the bf16 plans serve no
30 s request): each output owned by exactly one block (the kernels' own
index arithmetic, written out in numpy), shared memory within a block's 227
KB, the grid within the card's limits.  The route rule is held at the served
and the off-path shapes, and the float32 plans are held to be the ones they
were.

What the kernels compute is emulated in numpy in their tile order, each
``mma.sync.m16n8k16`` as the exact sum of its 16 bf16 products added to its
accumulator and rounded once to f32:

- B6: per 32 keys, the scores of 16-feature steps each summed from zero and
  added to the running score in f32; scale, relu², the mask in f32; the
  three-term split hi = rn(a), mid = rn(a − hi), lo = rn(a − hi − mid); the
  PV product of two 16-key steps into one accumulator, lo terms first, then
  mid, then hi, added to the output in f32.  Held against
  ``quad_attention_jnp`` on bf16-representable inputs: 1e-5 × max|ref|
  (float32 out, the JAX function on the f32 values) and one bf16 ulp (bf16
  out, the Pallas contract's one rounding); and, as on the card, within 2×
  the plain version's float64 error.
- B4: the Toeplitz fragments of a channel's taps times the Hankel columns of
  8 output tiles of 16, per work item of 128 outputs of one residue mod the
  dilation, the sums rounded once to bf16.  Held against ``dwconv1d_jnp`` in
  bf16 within one bf16 ulp (a dilated kernel written out with zero taps,
  which adds exact zeros to the same f32 sums).
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.ops.attention_pallas import quad_attention_jnp
from audiojax.ops.dwconv_pallas import dwconv1d_jnp

import chip_smoke
from audiojax_torch.ops import attention_cuda as A
from audiojax_torch.ops import dwconv_cuda as D

QUAD_TOL = 1e-5
ULP = 2.0 ** -7  # chip_smoke.BF16_ULP
MAX_BLOCKS = 2**31 - 1
f32 = np.float32

# (N, S, K, V, mask) of every bf16 B6 serving shape
B6_BF16 = ([(n, s, 128, 128, mask) for _, n, s, mask in chip_smoke.six_s(chip_smoke.B6_CASES)]
           + [(n, s, 128, 2048, False) for _, n, s in chip_smoke.six_s(
               chip_smoke.B6_SS_CASES + chip_smoke.B6_SE_CASES + chip_smoke.B6_SR_CASES)])
# (B, T, C, k, lo, hi, dilation) of every bf16 B4 serving shape
B4_BF16 = [(*shape, k, *pads, dil) for _, shape, k, pads, dil in chip_smoke.six_s(
    chip_smoke.B4_CASES + chip_smoke.B4_SS_CASES + chip_smoke.B4_SE_CASES
    + chip_smoke.B4_SR_CASES)]


def _cdiv(a, b):
    return -(-a // b)


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16, to nearest even, as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=f32)).bfloat16().float().numpy()


def _mma(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One m16n8k16 step (batched over leading axes): the exact sum of the
    bf16 products added to ``acc``, rounded once to f32."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(f32)


def _within_ulp(out: np.ndarray, ref: np.ndarray) -> None:
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.all(np.abs(out - ref) <= ULP * np.abs(ref) + 1e-6)


# ── B6 bf16: ownership and limits ──────────────────────────────────────────


def _quad_bf16_blocks(plan, n, s, dv):
    """(n, rows, value tiles) of every block, as ``quad_attention_kernel_bf16`` derives
    them from blockIdx.x."""
    bm, tiles = 16 * plan.warps, _cdiv(dv, A.QUAD_BF16_VT)
    per = _cdiv(tiles, plan.vsplit)
    b = np.arange(plan.blocks)
    vs = b % plan.vsplit
    rt = (b // plan.vsplit) % plan.row_tiles
    nn = b // (plan.vsplit * plan.row_tiles)
    return nn, rt * bm, np.minimum(s, rt * bm + bm), vs * per, np.minimum(tiles, vs * per + per)


@pytest.mark.parametrize("n,s,dk,dv,mask", B6_BF16,
                         ids=[f"{n}x{s}-K{k}-V{v}" + ("-mask" if m else "")
                              for n, s, k, v, m in B6_BF16])
def test_quad_bf16_plan_owns_each_output_once_and_fits(n, s, dk, dv, mask):
    plan = A.quad_bf16_launch(n, s, dk, dv)
    assert plan.smem == A.quad_bf16_smem(plan.warps, s, dk, plan.kb, plan.keep) <= A.SMEM_MAX
    assert plan.blocks == n * plan.row_tiles * plan.vsplit <= MAX_BLOCKS
    assert plan.threads == 32 * plan.warps <= 32 * A.QUAD_BF16_MAX_WARPS
    assert plan.row_tiles == _cdiv(s, 16 * plan.warps) and plan.kb in A.QUAD_BF16_KB
    nn, r_lo, r_hi, t_lo, t_hi = _quad_bf16_blocks(plan, n, s, dv)
    owned = np.zeros((n, s, _cdiv(dv, A.QUAD_BF16_VT)), np.int64)
    for a, r0, r1, t0, t1 in zip(nn, r_lo, r_hi, t_lo, t_hi):
        owned[a, r0:r1, t0:t1] += 1
    assert (owned == 1).all()


def test_quad_bf16_plan_picks():
    """7 warps (one row tile) at the GAN's S = 101 and 32-key pieces; kept
    scores at V = 2048 with the value tiles split to one wave of one block an
    SM; a large K takes fewer warps; past the room, the plan raises."""
    gan = A.quad_bf16_launch(964, 101, 128, 128)
    assert (gan.warps, gan.row_tiles, gan.vsplit, gan.kb, gan.keep) == (7, 1, 1, 32, False)
    ss, se, sr = (A.quad_bf16_launch(n, 256, 128, 2048) for n in (64, 4, 16))
    assert (ss.warps, ss.kb, ss.keep, ss.vsplit) == (4, 64, True, 1)
    assert (se.vsplit, sr.vsplit) == (8, 2) and se.blocks <= A.SM_COUNT >= sr.blocks
    long = A.quad_bf16_launch(2, 3000, 128, 512)  # no room to keep the scores
    assert not long.keep and long.smem <= A.SMEM_MAX
    assert A.quad_bf16_launch(4, 256, 1328, 128).warps == 1
    with pytest.raises(ValueError, match="shared memory"):
        A.quad_bf16_launch(4, 256, 1332, 128)
    with pytest.raises(ValueError, match="warps"):
        A.quad_bf16_launch(4, 256, 128, 128, warps=8)
    with pytest.raises(ValueError, match="pieces"):
        A.quad_bf16_launch(4, 256, 128, 128, kb=16)


# ── B6 bf16: the tiled order, emulated ─────────────────────────────────────


def _emulate_quad_bf16(q, k, v, scale, mask, plan):
    """``quad_attention_kernel_bf16`` block by block on bf16-representable f32 arrays:
    the output in f32 (before the bf16 kernel's one rounding)."""
    n_all, s, dk = q.shape
    dv = v.shape[-1]
    vt, s16, kpad = A.QUAD_BF16_VT, _cdiv(s, 16) * 16, _cdiv(dk, 16) * 16
    nkb = _cdiv(s16, plan.kb)
    keys_all = nkb * plan.kb
    out = np.full((n_all, s, dv), np.nan, f32)
    nn, r_lo, r_hi, t_lo, t_hi = _quad_bf16_blocks(plan, n_all, s, dv)
    for a, m0, m1, ta, tb in zip(nn, r_lo, r_hi, t_lo, t_hi):
        bm = 16 * plan.warps
        qs = np.zeros((bm, kpad), f32)
        qs[: m1 - m0, :dk] = q[a, m0:m1]
        ks = np.zeros((keys_all, kpad), f32)
        ks[:s, :dk] = k[a]
        for t in range(ta, tb):
            vs = np.zeros((keys_all, vt), f32)
            w = min(dv, t * vt + vt) - t * vt
            vs[:s, :w] = v[a, :, t * vt : t * vt + w]
            o = np.zeros((bm, vt), f32)
            for key0 in range(0, keys_all, 32):
                upper = key0 + 16 < s16  # the kernel skips a step of padding alone
                sc = np.zeros((bm, 32), f32)
                for d in range(0, kpad, 16):
                    part = _mma(np.zeros_like(sc), qs[:, d : d + 16],
                                ks[key0 : key0 + 32, d : d + 16].T)
                    sc = sc + part
                p = np.maximum(sc * f32(scale), f32(0))
                p = p * p
                rows = (m0 + np.arange(bm))[:, None]
                keys = (key0 + np.arange(32))[None, :]
                p[(keys >= s) | (mask & (rows == keys))] = 0
                hi = _bf16(p)
                mid = _bf16(p - hi)
                lo = _bf16(p - hi - mid)
                acc = np.zeros((bm, vt), f32)
                for term in (lo, mid, hi):  # two key steps into one accumulator
                    for kk in range(2 if upper else 1):
                        acc = _mma(acc, term[:, 16 * kk : 16 * kk + 16],
                                   vs[key0 + 16 * kk : key0 + 16 * kk + 16])
                o = o + acc
            out[a, m0:m1, t * vt : t * vt + w] = o[: m1 - m0, :w]
    return out


@pytest.mark.parametrize("n,s,dk,dv,mask,kw", [
    (2, 37, 20, 136, True, {}),             # ragged S, K and V; the mask
    (2, 45, 16, 264, False, {}),            # three value tiles, kept scores
    (1, 70, 12, 72, True, dict(warps=2)),   # two row tiles, K % 8 != 0 (8-byte copies)
    (2, 50, 8, 260, True, dict(kb=64, keep=False, vsplit=3)),
    (3, 101, 32, 32, False, {}),            # the GAN's row shape, narrow
])
def test_emulated_quad_attention_kernel_bf16_matches_jax(n, s, dk, dv, mask, kw):
    rng = np.random.default_rng(18)
    q, k, v = (_bf16(rng.standard_normal((n, s, d))) for d in (dk, dk, dv))
    plan = A.quad_bf16_launch(n, s, dk, dv, **kw)
    out = _emulate_quad_bf16(q, k, v, 1.0 / s, mask, plan)
    assert not np.isnan(out).any()  # every element written once
    ref32 = np.asarray(quad_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          scale=1.0 / s, mask_diag=mask))
    np.testing.assert_allclose(out, ref32, atol=QUAD_TOL * np.abs(ref32).max(), rtol=0)
    ref16 = quad_attention_jnp(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                               scale=1.0 / s, mask_diag=mask)
    _within_ulp(_bf16(out), np.asarray(ref16.astype(jnp.float32)))
    # the card's float64 gate (chip_smoke._hold): within 2x the plain version's error
    ref64 = chip_smoke.ref_quad64(*(a.astype(np.float64) for a in (q, k, v)), 1.0 / s, mask)
    plain = A.quad_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale=1.0 / s,
                                   mask_diag=mask).numpy()
    assert chip_smoke.rel_err(out, ref64) <= 2.0 * chip_smoke.rel_err(plain, ref64)


def test_three_term_split_is_exact():
    """hi + mid + lo == a for f32 scores of every magnitude the kernel meets."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(20000) ** 2 * 10.0 ** rng.uniform(-6, 4, 20000)).astype(f32)
    hi = _bf16(a)
    mid = _bf16(a - hi)
    lo = _bf16(a - hi - mid)
    assert np.array_equal(hi.astype(np.float64) + mid + lo, a.astype(np.float64))


# ── B4 bf16: the route rule, ownership and limits ─────────────────────────


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil", B4_BF16,
                         ids=[f"{b}x{t}x{c}-k{k}-d{d}" for b, t, c, k, lo, hi, d in B4_BF16])
def test_mma_plan_owns_each_output_once_and_fits(b, t, c, k, lo, hi, dil):
    plan = D.dwconv_plan(b, t, c, k, lo, hi, dil, 1, vector=True, esize=2)
    assert isinstance(plan, D.DwconvMmaLaunch)  # a served bf16 shape: the tensor cores
    assert plan.smem == D.mma_smem(plan.ks, plan.depth) <= D.SMEM_MAX
    assert plan.grid[0] * plan.grid[1] <= MAX_BLOCKS and plan.threads == D.MMA_THREADS
    assert 16 * plan.ks >= 15 + k and plan.window == 112 + 16 * plan.ks
    assert plan.grid[1] == _cdiv(c, D.MMA_CT) and plan.depth in D.MMA_DEPTHS
    # every (batch row, output) owned by exactly one (item group, item, tile
    # row); every channel tile by one block of each item group
    t_out = t + lo + hi - dil * (k - 1)
    owned = np.zeros((b, t_out), np.int64)
    for grp in range(plan.grid[0]):
        for idx in range(grp * plan.ipb, min(plan.items, grp * plan.ipb + plan.ipb)):
            per_row = dil * plan.ipr
            bb, rem = divmod(idx, per_row)
            rho, u0 = rem // plan.ipr, rem % plan.ipr * D.MMA_TO
            tt = rho + dil * (u0 + np.arange(D.MMA_TO))
            owned[bb, tt[tt < t_out]] += 1
    assert (owned == 1).all()


def test_route_rule():
    """bf16 depthwise convs on the vector path with k ≤ 49 take the tensor
    cores, dilation 3 too, and so does B5's grouped conv in bf16; C % 8 !=
    0, an x off 16 bytes, k past 49 and every float32 conv take the FFMA
    kernels, whose plans are ``dwconv_launch``'s as they were."""
    for _, (b, t, c), k, pads, dil, offset in chip_smoke.B4_OFFPATH_CASES:
        vector = c % 8 == 0 and offset == 0  # the wrapper's test, in bf16
        plan = D.dwconv_plan(b, t, c, k, *pads, dil, 1, vector=vector, esize=2)
        assert isinstance(plan, D.DwconvMmaLaunch) == vector
        if not vector:
            assert plan == D.dwconv_launch(b, t, c, k, *pads, dil, 1, vector=False, esize=2)
    assert D.mma_route(1, 2, True, 49) and not D.mma_route(1, 2, True, 50)
    assert D.mma_route(2, 2, True, 39) and not D.mma_route(1, 4, True, 31)
    assert not D.mma_route(2, 4, True, 39) and not D.mma_route(2, 2, False, 39)
    served = (chip_smoke.B4_CASES + chip_smoke.B4_SS_CASES + chip_smoke.B4_SE_CASES
              + chip_smoke.B4_SR_CASES + chip_smoke.B4_DFSMN_CASES)
    for _, (b, t, c), k, pads, dil in served:
        assert D.dwconv_plan(b, t, c, k, *pads, dil, 1) == D.dwconv_launch(b, t, c, k, *pads,
                                                                         dil, 1)
    for _, (b, t, c), k, pads, dil in chip_smoke.B5_SS_CASES:
        plan = D.dwconv_plan(b, t, c, k, *pads, dil, 2, esize=2)
        assert plan == D.dwconv_mma_launch(b, t, c, k, *pads, dil, 2)
        assert D.dwconv_plan(b, t, c, k, *pads, dil, 2) == D.dwconv_launch(b, t, c, k, *pads,
                                                                         dil, 2)


def test_mma_plan_picks_and_refusals():
    """One wave of five blocks an SM: the GAN's intra uv splits its 964 rows
    over 41 item groups of 24; few items, one a block."""
    gan = D.dwconv_mma_launch(964, 98, 256, 31, 15, 15, 1)
    assert (gan.ks, gan.ipr, gan.ipb, gan.depth, gan.grid) == (3, 1, 24, 3, (41, 16))
    assert gan.grid[0] * gan.grid[1] <= D.MMA_BLOCKS_SM * D.SM_COUNT
    se = D.dwconv_mma_launch(4, 246, 256, 39, 19, 19, 1)
    assert (se.ks, se.ipr, se.ipb, se.depth) == (4, 2, 1, 2)
    dil = D.dwconv_mma_launch(4, 4000, 256, 39, 38, 38, 2)
    assert (dil.ipr, dil.items) == (16, 4 * 2 * 16)  # 2000 outputs a residue
    with pytest.raises(ValueError, match="k ≤ 49"):
        D.dwconv_mma_launch(2, 100, 16, 50, 0, 0, 1)
    with pytest.raises(ValueError, match="no B4 tensor-core plan"):
        D.dwconv_mma_launch(2, 100, 12, 5, 0, 0, 1)
    with pytest.raises(ValueError, match="ring holds"):
        D.dwconv_mma_launch(2, 100, 16, 5, 0, 0, 1, depth=5)


# ── B4 bf16: the tiled order, emulated ─────────────────────────────────────


def _emulate_dwconv_mma(x, w, lo, hi, dil, plan):
    """``dwconv_kernel_bf16_mma`` item by item on bf16-representable f32 arrays,
    x (B, T, C), w (k, C): the outputs rounded once to bf16, each written
    once (NaN where none is)."""
    b, t, c = x.shape
    k = w.shape[0]
    t_out = t + lo + hi - dil * (k - 1)
    ks, win, ct = plan.ks, plan.window, D.MMA_CT
    y = np.full((b, t_out, c), np.nan, f32)
    r = np.arange(16)[:, None]
    s = np.arange(16 * ks)[None, :]
    tap = s - r  # A[r][s] = w[s - r]
    for blk in range(plan.grid[0] * plan.grid[1]):
        grp, c0 = blk // plan.grid[1], blk % plan.grid[1] * ct
        chans = np.arange(c0, min(c0 + ct, c))
        taps = np.zeros((len(chans), 16, 16 * ks), f32)  # the Toeplitz fragments
        ok = (tap >= 0) & (tap < k)
        taps[:, ok] = w[tap[ok]][:, chans].T
        for idx in range(grp * plan.ipb, min(plan.items, grp * plan.ipb + plan.ipb)):
            bb, rem = divmod(idx, dil * plan.ipr)
            rho, u0 = rem // plan.ipr, rem % plan.ipr * D.MMA_TO
            tin = rho + dil * (u0 + np.arange(win)) - lo
            xs = np.zeros((len(chans), win), f32)  # the window, time-contiguous
            inside = (tin >= 0) & (tin < t)
            xs[:, inside] = x[bb, tin[inside]][:, chans].T
            # the Hankel columns: B[s][n] = xs[16 n + s]
            hank = xs[:, 16 * np.arange(8)[None, :] + np.arange(16 * ks)[:, None]]
            d = np.zeros((len(chans), 16, 8), f32)
            for kk in range(ks):
                d = _mma(d, taps[:, :, 16 * kk : 16 * kk + 16], hank[:, 16 * kk : 16 * kk + 16])
            outs = _bf16(d).transpose(0, 2, 1).reshape(len(chans), D.MMA_TO)  # u0 + 16 n + r
            tt = rho + dil * (u0 + np.arange(D.MMA_TO))
            keep = tt < t_out
            assert np.isnan(y[bb, tt[keep]][:, chans]).all()  # written once
            y[bb, tt[keep][:, None], chans[None, :]] = outs[:, keep].T
    return y


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,kw", [
    (3, 40, 32, 31, 15, 15, 1, {}),              # ragged T_out (40 of 128), k31: 3 steps
    (2, 150, 24, 17, 8, 8, 1, dict(ipb=2)),      # two items a row, a half channel tile
    (2, 90, 16, 39, 19, 19, 1, dict(depth=3)),   # k39: 4 steps
    (2, 100, 16, 39, 38, 38, 2, dict(ipb=3)),    # dilation 2: two residues
    (2, 61, 8, 31, 15, 15, 1, {}),               # C = 8
    (2, 33, 16, 7, 5, 1, 1, dict(ipb=4)),        # asymmetric pads, k7: 2 steps
    (1, 70, 16, 5, 9, 9, 3, {}),                 # dilation 3
])
def test_emulated_dwconv_kernel_bf16_mma_matches_jax(b, t, c, k, lo, hi, dil, kw):
    rng = np.random.default_rng(b * 1000 + t + k)
    x = _bf16(rng.standard_normal((b, t, c)))
    w = _bf16(rng.standard_normal((k, c)) / np.sqrt(k))
    plan = D.dwconv_mma_launch(b, t, c, k, lo, hi, dil, **kw)
    y = _emulate_dwconv_mma(x, w, lo, hi, dil, plan)
    wd = np.zeros((dil * (k - 1) + 1, c), f32)  # the dilated kernel, zero taps between
    wd[::dil] = w
    ref = dwconv1d_jnp(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wd).astype(jnp.bfloat16),
                       pads=(lo, hi))
    _within_ulp(y, np.asarray(ref.astype(jnp.float32)))
    plain = D.dwconv1d_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                             pads=(lo, hi), dilation=dil).float().numpy()
    _within_ulp(y, plain)


# ── the wrappers without a card ────────────────────────────────────────────


class _StubLib:
    """Records every call into a kernel library, with its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_b6_route_rule_and_launch_arguments(monkeypatch):
    """float32 takes ``quad_launch``'s plan and the float32 kernel, as
    before; bfloat16 ``quad_bf16_launch``'s and the tensor-core kernel, its
    output float32 or bfloat16; the launcher passes the plan as it is."""
    assert A.quad_plan(3, 40, 16, 16, torch.float32) == A.quad_launch(3, 40, 16, 16)
    assert A.quad_plan(3, 40, 16, 16, torch.bfloat16) == A.quad_bf16_launch(3, 40, 16, 16)
    for n, s, dk, dv, _ in B6_BF16:  # the float32 plans at the served shapes, unchanged
        assert A.quad_plan(n, s, dk, dv, torch.float32) == A.quad_launch(n, s, dk, dv)
    f32_lib, bf16_lib = _StubLib(), _StubLib()
    monkeypatch.setattr(A, "_lib", lambda: f32_lib)
    monkeypatch.setattr(A, "_bf16_lib", lambda: bf16_lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros(3, 40, 16)
    for dtype, out_dtype in ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.float32)):
        qq, out = q.to(dtype), torch.empty(3, 40, 16, dtype=out_dtype)
        A.launch_quad_attention(qq, qq, qq, out, 0.5, True, A.quad_plan(3, 40, 16, 16, dtype))
    assert [c[0] for c in bf16_lib.calls] == ["ajt_quad_attention_bf16_f32",
                                              "ajt_quad_attention_bf16_bf16"]
    assert [c[0] for c in f32_lib.calls] == ["ajt_quad_attention_f32"]
    plan = A.quad_bf16_launch(3, 40, 16, 16)
    assert bf16_lib.calls[0][1][4:] == (3, 40, 16, 16, 0.5, 1, plan.warps, plan.row_tiles,
                                        plan.vsplit, plan.kb, int(plan.keep), plan.smem, 0)


def test_b4_wrapper_routes_by_the_rule(monkeypatch):
    """``dwconv1d_cuda`` on bf16: a served shape launches the tensor-core
    kernel, C = 66 the FFMA kernel's bf16 instance; both count under
    ``dwconv1d_bf16``; a float32 call the float32 FFMA instance."""
    ffma, mma = _StubLib(), _StubLib()
    monkeypatch.setattr(D, "_lib", lambda: ffma)
    monkeypatch.setattr(D, "_mma_lib", lambda: mma)
    monkeypatch.setattr(D, "_check", lambda *args: None)
    monkeypatch.setattr(D, "_stream", lambda device: 0)
    before = dict(D.launches)
    wt = torch.randn(64, 1, 31)
    x = torch.zeros(3, 40, 64, dtype=torch.bfloat16)
    D.dwconv1d_cuda(x, wt.bfloat16()[:, 0, :].t(), pads=(15, 15))
    x66 = torch.zeros(3, 40, 66, dtype=torch.bfloat16)
    D.dwconv1d_cuda(x66, torch.zeros(31, 66, dtype=torch.bfloat16), pads=(15, 15))
    D.dwconv1d_cuda(x.float(), wt[:, 0, :].t(), pads=(15, 15))
    (name, args), = mma.calls
    plan = D.dwconv_mma_launch(3, 40, 64, 31, 15, 15, 1)
    assert name == "ajt_dwconv1d_mma_bf16" and args[10:12] == (1, 31)  # w's strides, uncopied
    assert args[12:-1] == (plan.ks, plan.ipr, plan.ipb, plan.depth, *plan.grid, plan.smem)
    assert [c[0] for c in ffma.calls] == ["ajt_dwconv1d_bf16", "ajt_dwconv1d_f32"]
    assert D.launches == {**before, "dwconv1d_bf16": before["dwconv1d_bf16"] + 2,
                          "dwconv1d": before["dwconv1d"] + 1}
