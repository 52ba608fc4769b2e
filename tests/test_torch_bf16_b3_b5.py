"""The launch plans, the route rules and the tiled order of the bf16
instances of B3 and B5 on the tensor cores.

The kernels (``audiojax_torch/csrc/relpos_scores_bf16.cu`` and the grouped
entry of ``csrc/dwconv_bf16.cu``) run only on the card.  Their geometry comes
from plain functions (``ops.attention_cuda.relpos_bf16_launch`` behind
``relpos_plan``, ``ops.dwconv_cuda.dwconv_mma_launch`` behind
``dwconv_plan``), held here at every bf16 serving shape of ``chip_smoke.py``
(6 s): each output owned by exactly one block and warp (the kernels' own
index arithmetic, written out in numpy), shared memory within a block's 227
KB, the grid within the card's limits.  The route rules are held at the
served and the off-path shapes, and the float32 plans are held to be the ones
they were.

What the kernels compute is emulated in numpy in their tile order, each
``mma.sync.m16n8k16`` as the exact sum of its 16 bf16 products added to its
accumulator and rounded once to f32:

- B3: per batch row, each warp's 8-key tiles: q·kᵀ as D/16 k16 steps chained
  from zero; the bias as four k16 steps of the block-diagonal A (4 query
  rows × 4 terms a step) against the staged pe, chained from zero and added
  in f32; keys past S at -inf; the softmax with each warp's maxima and sums
  combined over the row group's warps in order, one reciprocal a row, each
  probability rounded once to bf16.  Held against ``relpos_scores_jnp`` on
  bf16 inputs (q, k and pp lane slices of one projection) within one bf16
  ulp, and, as on the card, within 2× the plain version's float64 error.
- B5: per work item of 128 outputs of one residue mod the dilation, each
  group's two lanes as Toeplitz fragments of its taps times Hankel columns
  of that lane's window, each lane's k16 steps chained in its own
  accumulator, the two added in f32 and rounded once to bf16.  Held against
  ``audiojax.nn.core._grouped_single_out_conv1d`` in bf16 within one bf16
  ulp.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.nn.core import _grouped_single_out_conv1d
from audiojax.ops.attention_pallas import relpos_scores_jnp

import chip_smoke
from audiojax_torch.ops import attention_cuda as A
from audiojax_torch.ops import dwconv_cuda as D

ULP = 2.0 ** -7  # chip_smoke.BF16_ULP
MAX_BLOCKS = 2**31 - 1
f32 = np.float32
H, DH, P = 4, 32, 4  # ZipEnhancer's heads, head width, positional terms
LD = 2 * H * DH + H * A.pos_stride(P)  # the projection's row: q, k, pp lanes

# (N, S) of every bf16 B3 serving shape on the tensor cores (6 s, S ≤ 256)
B3_BF16 = [(n, s) for _, n, s in chip_smoke.six_s(chip_smoke.B3_CASES) if s <= 256]
# (B, T, 2G, k, lo, hi, dilation) of every bf16 B5 serving shape
B5_BF16 = [(*shape, k, *pads, dil) for _, shape, k, pads, dil in
           chip_smoke.six_s(chip_smoke.B5_SS_CASES)]


def _cdiv(a, b):
    return -(-a // b)


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16, to nearest even, as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=f32)).bfloat16().float().numpy()


def _mma(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One m16n8k16 step (batched over leading axes and over the columns of
    several 8-key tiles): the exact sum of the bf16 products added to
    ``acc``, rounded once to f32."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(f32)


def _within_ulp(out: np.ndarray, ref: np.ndarray) -> None:
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.all(np.abs(out - ref) <= ULP * np.abs(ref) + 1e-6)


# ── B3 bf16: ownership, limits and the route rule ─────────────────────────


def _relpos_blocks(plan, n: int, s: int, h: int):
    """(head, first row, row end, first batch row, batch row end) of every
    block, as ``relpos_mma_kernel_bf16`` derives them from blockIdx.x."""
    b = np.arange(plan.blocks)
    chunk = b % plan.chunks
    rt = (b // plan.chunks) % plan.row_tiles
    hh = b // (plan.chunks * plan.row_tiles)
    r0 = rt * 16 * plan.wr
    return (hh, r0, np.minimum(s, r0 + 16 * plan.wr), chunk * plan.nb,
            np.minimum(n, chunk * plan.nb + plan.nb))


def _warp_tiles(plan, s: int):
    """(row group, first tile, tiles) of each warp of a block."""
    tpw = _cdiv(_cdiv(s, 8), plan.kw)
    return [(w % plan.wr, tpw * (w // plan.wr),
             min(tpw, _cdiv(s, 8) - tpw * (w // plan.wr))) for w in range(plan.wr * plan.kw)]


@pytest.mark.parametrize("n,s", B3_BF16, ids=[f"{n}x{s}" for n, s in B3_BF16])
def test_relpos_bf16_plan_owns_each_output_once_and_fits(n, s):
    plan = A.relpos_plan(n, s, H, DH, P, torch.bfloat16)
    assert isinstance(plan, A.RelposBf16Launch)  # a served bf16 shape: the tensor cores
    assert plan.smem == A.relpos_bf16_smem(plan.wr, plan.kw, s, DH) <= A.SMEM_MAX
    assert _cdiv(_cdiv(s, 8), plan.kw) <= A.RELPOS_BF16_TILES
    assert plan.threads == 32 * plan.wr * plan.kw <= 32 * A.RELPOS_BF16_MAX_WARPS
    assert plan.blocks == H * plan.row_tiles * plan.chunks <= MAX_BLOCKS
    assert plan.row_tiles == _cdiv(s, 16 * plan.wr) and plan.chunks == _cdiv(n, plan.nb)
    owned = np.zeros((H, s, n), np.int64)  # (head, query row, batch row)
    for h, r0, r1, n0, n1 in zip(*_relpos_blocks(plan, n, s, H)):
        owned[h, r0:r1, n0:n1] += 1
    assert (owned == 1).all()
    keys = np.zeros((plan.wr, _cdiv(s, 8)), np.int64)  # each row group's tiles, one warp each
    for rg, j0, nt in _warp_tiles(plan, s):
        keys[rg, j0 : j0 + max(nt, 0)] += 1
    assert (keys == 1).all()


def test_relpos_bf16_plan_picks_and_refusals():
    """Two warps a row group at S = 101 (13 tiles), four at S = 241 (31); all
    seven row groups of S = 101 in one block, 14 warps, its pe rows staged
    once for 30 batch rows; the S = 241 rows in four tiles of four groups."""
    f = A.relpos_bf16_launch(964, 101, H, DH, P)
    assert (f.wr, f.kw, f.row_tiles, f.nb, f.threads, f.blocks) == (7, 2, 1, 30, 448, 132)
    t = A.relpos_bf16_launch(404, 241, H, DH, P)
    assert (t.wr, t.kw, t.row_tiles, t.nb, t.threads) == (4, 4, 4, 51, 512)
    assert A.relpos_bf16_launch(244, 26, H, DH, P).nb == 2  # at least two batch rows a block
    with pytest.raises(ValueError, match="tiles"):
        A.relpos_bf16_launch(4, 101, H, DH, P, kw=1)
    with pytest.raises(ValueError, match="warps"):
        A.relpos_bf16_launch(4, 101, H, DH, P, kw=4, wr=7)
    with pytest.raises(ValueError, match="no B3 bf16"):
        A.relpos_bf16_launch(4, 257, H, DH, P)


def test_relpos_route_rule():
    """The served bf16 shapes take the tensor-core kernel; rows past 256 keys,
    D % 8 != 0 or past 64, more than 4 terms, a slot stride off 4, rows off
    16 bytes (q, k) or 8 (pp) take the two-pass kernel; the float32 plans are
    the batched kernel's as they were."""
    for n, s in B3_BF16:
        assert A.relpos_mma_route(s, DH, P, 8, LD, LD, LD, True)
    assert not A.relpos_mma_route(601, DH, P, 8, LD, LD, LD, True)
    for d, p, stride, ld, ldpp, aligned in ((12, 4, 8, LD, LD, True), (72, 4, 8, LD, LD, True),
                                            (32, 5, 8, LD, LD, True), (32, 3, 6, LD, LD, True),
                                            (32, 4, 8, LD + 4, LD, True),
                                            (32, 4, 8, LD, LD + 2, True),
                                            (32, 4, 8, LD, LD, False)):
        assert not A.relpos_mma_route(101, d, p, stride, ld, ld, ldpp, aligned)
    two = A.relpos_plan(16, 601, H, DH, P, torch.bfloat16, mma=False)
    assert two == A.relpos_two_pass_launch(16, 601, H, DH, P) and two.route == "two_pass"
    assert A.relpos_plan(16, 101, H, 12, P, torch.bfloat16, mma=False).route == "two_pass"
    for n, s in B3_BF16 + [(16, 601)]:
        assert A.relpos_plan(n, s, H, DH, P, torch.float32) == A.relpos_launch(n, s, H, DH, P)
    # the float32 plans, as the parent design left them
    assert A.relpos_launch(964, 101, H, DH, P) == A.RelposLaunch(
        "batched", 4, 16, 7, 69, 14, 128, 392, 74752)
    assert A.relpos_launch(404, 241, H, DH, P) == A.RelposLaunch(
        "batched", 8, 32, 8, 101, 4, 256, 128, 215040)
    assert A.relpos_launch(16, 601, H, DH, P) == A.RelposLaunch(
        "two_pass", 8, 1, 19, 1, 16, 256, 1216, 37504)


# ── B3 bf16: the tiled order, emulated ─────────────────────────────────────


def _emulate_relpos_bf16(q, k, pp, pe, h, plan):
    """``relpos_mma_kernel_bf16`` block by block and warp by warp on
    bf16-representable f32 arrays (q, k (N, S, H·D), pp (N, S, H·stride), pe
    (H, P, S, S)): the probabilities rounded once to bf16, each written once
    (NaN where none is)."""
    n_all, s, hd = q.shape
    d, n_pos = hd // h, pe.shape[1]
    stride = pp.shape[-1] // h
    dp, s8 = _cdiv(d, 16) * 16, _cdiv(s, 8) * 8
    out = np.full((n_all, h, s, s), np.nan, f32)
    warps = _warp_tiles(plan, s)
    for head, r0, r1, n0, n1 in zip(*_relpos_blocks(plan, n_all, s, h)):
        rows, R = r1 - r0, 16 * plan.wr
        pes = np.zeros((n_pos, R, s8), f32)  # staged once for the block's batch rows
        pes[:, :rows, :s] = pe[head, :, r0:r1]
        for n in range(n0, n1):
            qs = np.zeros((R, dp), f32)
            qs[:rows, :d] = q[n, r0:r1, head * d : (head + 1) * d]
            ks = np.zeros((s8, dp), f32)
            ks[:s, :d] = k[n, :, head * d : (head + 1) * d]
            ps = np.zeros((R, 4), f32)
            ps[:rows, :n_pos] = pp[n, r0:r1, head * stride : head * stride + n_pos]
            part = {}  # (row group, warp) -> (its keys, its scores)
            for rg, j0, nt in warps:
                if 16 * rg >= rows or nt <= 0:
                    continue
                qr, keys = qs[16 * rg : 16 * rg + 16], slice(8 * j0, 8 * (j0 + nt))
                acc = np.zeros((16, 8 * nt), f32)
                for st in range(dp // 16):  # q·kᵀ: the k16 steps chained from zero
                    acc = _mma(acc, qr[:, 16 * st : 16 * st + 16],
                               ks[keys, 16 * st : 16 * st + 16].T)
                bias = np.zeros_like(acc)
                for st in range(4):  # the bias: 4 query rows x 4 terms a step
                    a_s = np.zeros((16, 16), f32)
                    b_s = np.zeros((16, 8 * nt), f32)
                    for i in range(4 * st, 4 * st + 4):
                        a_s[i, 4 * (i - 4 * st) : 4 * (i - 4 * st) + 4] = ps[16 * rg + i]
                        b_s[4 * (i - 4 * st) : 4 * (i - 4 * st) + 4] = pes[:, 16 * rg + i, keys]
                    bias = _mma(bias, a_s, b_s)
                acc = acc + bias
                acc[:, np.arange(8 * j0, 8 * (j0 + nt)) >= s] = -np.inf
                part[rg, j0] = acc
            for rg in range(plan.wr):
                mine = sorted((j0, acc) for (g, j0), acc in part.items() if g == rg)
                if not mine:
                    continue
                m = np.max([acc.max(-1) for _, acc in mine], axis=0)[:, None]
                es = [np.exp(acc - m).astype(f32) for _, acc in mine]
                total = np.zeros((16,), f32)
                for e in es:  # each warp's sum, then over the row group's warps in order
                    total = (total + e.sum(-1, dtype=f32)).astype(f32)
                inv = (f32(1) / total)[:, None]
                prob = _bf16(np.concatenate(es, axis=-1)[:, :s] * inv)
                i0, i1 = r0 + 16 * rg, min(r1, r0 + 16 * rg + 16)
                assert np.isnan(out[n, head, i0:i1]).all()  # written once
                out[n, head, i0:i1] = prob[: i1 - i0]
    return out


@pytest.mark.parametrize("n,s,kw", [
    (3, 26, {}),                  # 4 tiles, one warp a row group, a batch split
    (4, 51, dict(nb=3)),          # ragged batch ranges
    (2, 101, {}),                 # ZipEnhancer's f path: 13 tiles over two warps
    (5, 101, dict(wr=2, nb=2)),   # four row tiles, the last one of 5 rows
    (2, 140, {}),                 # past 128 keys: three warps a row group
    (2, 61, dict(kw=2, wr=1)),    # four row tiles of one group, two warps a group
])
def test_emulated_relpos_kernel_bf16_matches_jax(n, s, kw):
    rng = np.random.default_rng(19 * s + n)
    proj = _bf16(0.5 * rng.standard_normal((n, s, LD)))  # q, k, pp: lane slices of one projection
    q, k, pp = proj[..., : H * DH], proj[..., H * DH : 2 * H * DH], proj[..., 2 * H * DH :]
    pe = _bf16(0.5 * rng.standard_normal((H, P, s, s)))
    plan = A.relpos_bf16_launch(n, s, H, DH, P, **kw)
    out = _emulate_relpos_bf16(q, k, pp, pe, H, plan)
    assert not np.isnan(out).any()  # every element written once
    ref = relpos_scores_jnp(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, pp, pe)),
                            num_heads=H)
    _within_ulp(out, np.asarray(ref.astype(jnp.float32)))
    tq, tk, tpp, tpe = (torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
                        for a in (q, k, pp, pe))
    plain = A.relpos_scores_plain(tq, tk, tpp, tpe, num_heads=H).float().numpy()
    _within_ulp(out, plain)
    # the card's float64 gate (chip_smoke._hold_bf16): within 2x the plain version's error
    ref64 = chip_smoke.ref_relpos64(*(a.astype(np.float64) for a in (q, k, pp, pe)))
    assert chip_smoke.rel_err(out, ref64) <= 2.0 * chip_smoke.rel_err(plain, ref64)


# ── B5 bf16: ownership, limits and the route rule ─────────────────────────


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil", B5_BF16,
                         ids=[f"{b}x{t}x{c}-k{k}-d{d}" for b, t, c, k, lo, hi, d in B5_BF16])
def test_b5_mma_plan_owns_each_output_once_and_fits(b, t, c, k, lo, hi, dil):
    plan = D.dwconv_plan(b, t, c, k, lo, hi, dil, 2, vector=True, esize=2)
    assert isinstance(plan, D.DwconvMmaLaunch) and plan.m == 2  # the tensor cores
    assert plan.smem == D.mma_smem(plan.ks, plan.depth) <= D.SMEM_MAX
    assert plan.grid[0] * plan.grid[1] <= MAX_BLOCKS and plan.threads == D.MMA_THREADS
    assert 16 * plan.ks >= 15 + k and plan.window == 112 + 16 * plan.ks
    assert plan.grid[1] == _cdiv(c, D.MMA_CT) and plan.depth in D.MMA_DEPTHS
    # one wave of four blocks an SM (the grouped instance's registers)
    assert plan.grid[0] * plan.grid[1] <= D.MMA_BLOCKS_SM_GROUPED * D.SM_COUNT
    t_out = t + lo + hi - dil * (k - 1)
    owned = np.zeros((b, t_out), np.int64)
    for grp in range(plan.grid[0]):
        for idx in range(grp * plan.ipb, min(plan.items, grp * plan.ipb + plan.ipb)):
            bb, rem = divmod(idx, dil * plan.ipr)
            rho, u0 = rem // plan.ipr, rem % plan.ipr * D.MMA_TO
            tt = rho + dil * (u0 + np.arange(D.MMA_TO))
            owned[bb, tt[tt < t_out]] += 1
    assert (owned == 1).all()
    groups = np.zeros(c // 2, np.int64)  # each group's output lane by one lane tile
    for tile in range(plan.grid[1]):
        groups[tile * D.MMA_CT // 2 : (tile + 1) * D.MMA_CT // 2] += 1
    assert (groups == 1).all()


def test_b5_route_rule():
    """bf16 B5 on the vector path with k ≤ 49 takes the tensor cores; C % 8
    != 0, an x off 16 bytes, k past 49 and every float32 call take the FFMA
    kernel, whose plans are ``dwconv_launch``'s as they were; the off-path
    case of ``chip_smoke.py`` phase 24 is one of them."""
    for _, (b, t, c), k, pads, dil, offset in chip_smoke.B5_OFFPATH_CASES:
        vector = c % 8 == 0 and offset == 0  # the wrapper's test, in bf16
        assert not vector
        assert D.dwconv_plan(b, t, c, k, *pads, dil, 2, vector=vector, esize=2) == D.dwconv_launch(
            b, t, c, k, *pads, dil, 2, vector=False, esize=2)
    assert isinstance(D.dwconv_plan(2, 300, 132, 39, 38, 38, 2, 2, vector=False, esize=2),
                      D.DwconvLaunch)
    assert isinstance(D.dwconv_plan(2, 300, 32, 51, 25, 25, 1, 2, esize=2), D.DwconvLaunch)
    # the float32 plan at the served shape, as the parent design left it
    assert D.dwconv_plan(4, 3999, 512, 39, 38, 38, 2, 2) == D.DwconvLaunch(
        2, 4, 4, 16, 32, 512, True, 4, 3, False, 2, 8, 1612, (8, 16), 256, 211328, 4)


# ── B5 bf16: the tiled order, emulated ─────────────────────────────────────


def _emulate_grouped_mma(x, w, lo, hi, dil, plan):
    """``dwconv_grouped_kernel_bf16_mma`` item by item on bf16-representable
    f32 arrays, x (B, T, 2G), w (k, 2, G): each group's two lanes in their own
    accumulators, added in f32, rounded once to bf16; each output written
    once (NaN where none is)."""
    b, t, c = x.shape
    k, g_all = w.shape[0], w.shape[2]
    t_out = t + lo + hi - dil * (k - 1)
    ks, win = plan.ks, plan.window
    y = np.full((b, t_out, g_all), np.nan, f32)
    r = np.arange(16)[:, None]
    tap = np.arange(16 * ks)[None, :] - r  # A[r][s] = w[s - r]
    ok = (tap >= 0) & (tap < k)
    for blk in range(plan.grid[0] * plan.grid[1]):
        grp, c0 = blk // plan.grid[1], blk % plan.grid[1] * D.MMA_CT
        groups = np.arange(c0 // 2, min(c0 + D.MMA_CT, c) // 2)
        taps = np.zeros((2, len(groups), 16, 16 * ks), f32)  # each lane's Toeplitz fragments
        for lane in range(2):
            taps[lane][:, ok] = w[tap[ok], lane][:, groups].T
        for idx in range(grp * plan.ipb, min(plan.items, grp * plan.ipb + plan.ipb)):
            bb, rem = divmod(idx, dil * plan.ipr)
            rho, u0 = rem // plan.ipr, rem % plan.ipr * D.MMA_TO
            tin = rho + dil * (u0 + np.arange(win)) - lo
            inside = (tin >= 0) & (tin < t)
            d = []
            for lane in range(2):
                xs = np.zeros((len(groups), win), f32)  # the lane's window, time-contiguous
                xs[:, inside] = x[bb, tin[inside]][:, 2 * groups + lane].T
                hank = xs[:, 16 * np.arange(8)[None, :] + np.arange(16 * ks)[:, None]]
                acc = np.zeros((len(groups), 16, 8), f32)
                for kk in range(ks):
                    acc = _mma(acc, taps[lane][:, :, 16 * kk : 16 * kk + 16],
                               hank[:, 16 * kk : 16 * kk + 16])
                d.append(acc)
            outs = _bf16(d[0] + d[1]).transpose(0, 2, 1).reshape(len(groups), D.MMA_TO)
            tt = rho + dil * (u0 + np.arange(D.MMA_TO))
            keep = tt < t_out
            assert np.isnan(y[bb, tt[keep]][:, groups]).all()  # written once
            y[bb, tt[keep][:, None], groups[None, :]] = outs[:, keep].T
    return y


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,kw", [
    (2, 150, 32, 17, 8, 8, 1, {}),               # k17: 2 steps, two items a row
    (2, 301, 48, 39, 38, 38, 2, dict(ipb=3)),    # the SS memory's k39 d2, ragged T
    (3, 77, 24, 39, 19, 19, 1, dict(depth=3)),   # a half lane tile (4 groups)
    (1, 200, 16, 17, 0, 16, 2, dict(ipb=2)),     # asymmetric pads, dilation 2
])
def test_emulated_grouped_kernel_bf16_mma_matches_jax(b, t, c, k, lo, hi, dil, kw):
    rng = np.random.default_rng(b * 1000 + t + k)
    x = _bf16(rng.standard_normal((b, t, c)))
    w = _bf16(rng.standard_normal((k, 2, c // 2)) / np.sqrt(2 * k))
    plan = D.dwconv_mma_launch(b, t, c, k, lo, hi, dil, 2, **kw)
    y = _emulate_grouped_mma(x, w, lo, hi, dil, plan)
    ref = _grouped_single_out_conv1d(jnp.asarray(w).astype(jnp.bfloat16),
                                     jnp.asarray(x).astype(jnp.bfloat16), (lo, hi), dil)
    _within_ulp(y, np.asarray(ref.astype(jnp.float32)))
    plain = D.dwconv1d_grouped_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
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


def test_b3_launcher_passes_each_plan(monkeypatch):
    """``launch_relpos_scores``: a ``RelposBf16Launch`` goes to the
    tensor-core entry with its geometry as it is, a bf16 two-pass plan to
    the two-pass kernel's bf16 entry, a float32 batched plan to the float32
    entry."""
    f32_lib, mma_lib = _StubLib(), _StubLib()
    monkeypatch.setattr(A, "_relpos_lib", lambda: f32_lib)
    monkeypatch.setattr(A, "_relpos_bf16_lib", lambda: mma_lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    n, s = 3, 40
    proj = torch.zeros(n, s, LD)
    pe = torch.zeros(H, P, s, s)
    for dtype, plan in ((torch.bfloat16, A.relpos_bf16_launch(n, s, H, DH, P)),
                        (torch.bfloat16, A.relpos_two_pass_launch(n, s, H, DH, P)),
                        (torch.float32, A.relpos_launch(n, s, H, DH, P))):
        pr = proj.to(dtype)
        q, k, pp = pr[..., : H * DH], pr[..., H * DH : 2 * H * DH], pr[..., 2 * H * DH :]
        A.launch_relpos_scores(q, k, pp, pe.to(dtype), torch.empty(n, H, s, s, dtype=dtype), H,
                               plan)
    (name, args), = mma_lib.calls
    plan = A.relpos_bf16_launch(n, s, H, DH, P)
    assert name == "ajt_relpos_mma_bf16"
    assert args[5:] == (n, s, H, DH, P, 8, LD, LD, LD, plan.wr, plan.kw, plan.row_tiles,
                        plan.nb, plan.chunks, plan.smem, 0)
    assert [c[0] for c in f32_lib.calls] == ["ajt_relpos_two_pass_bf16", "ajt_relpos_batched_f32"]


def test_b5_wrapper_routes_by_the_rule(monkeypatch):
    """``dwconv1d_grouped_cuda`` on bf16: a served shape launches the
    tensor-core kernel with the model's weight view uncopied, C = 132
    (C % 8 != 0) the FFMA kernel's bf16 instance; both count under
    ``dwconv1d_tiled_bf16``; a float32 call the float32 FFMA instance."""
    ffma, mma = _StubLib(), _StubLib()
    monkeypatch.setattr(D, "_lib", lambda: ffma)
    monkeypatch.setattr(D, "_mma_lib", lambda: mma)
    monkeypatch.setattr(D, "_check", lambda *args: None)
    monkeypatch.setattr(D, "_stream", lambda device: 0)
    before = dict(D.launches)
    wt = torch.randn(32, 2, 39)  # the model's (G, 2, k)
    x = torch.zeros(2, 300, 64, dtype=torch.bfloat16)
    D.dwconv1d_grouped_cuda(x, wt.bfloat16().permute(2, 1, 0), pads=(38, 38), dilation=2)
    x132 = torch.zeros(2, 300, 132, dtype=torch.bfloat16)
    D.dwconv1d_grouped_cuda(x132, torch.zeros(39, 2, 66, dtype=torch.bfloat16), pads=(38, 38),
                            dilation=2)
    D.dwconv1d_grouped_cuda(x.float(), wt.permute(2, 1, 0), pads=(38, 38), dilation=2)
    (name, args), = mma.calls
    plan = D.dwconv_mma_launch(2, 300, 64, 39, 38, 38, 2, 2)
    assert name == "ajt_dwconv1d_grouped2_mma_bf16" and args[10:13] == (1, 39, 78)
    assert args[13:-1] == (plan.ks, plan.ipr, plan.ipb, plan.depth, *plan.grid, plan.smem)
    assert [c[0] for c in ffma.calls] == ["ajt_dwconv1d_grouped2_bf16", "ajt_dwconv1d_grouped2_f32"]
    assert D.launches == {**before, "dwconv1d_tiled_bf16": before["dwconv1d_tiled_bf16"] + 2,
                          "dwconv1d_tiled": before["dwconv1d_tiled"] + 1}
