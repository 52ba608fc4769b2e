"""The launch plan and tiled order of the port's conv kernels (B4, B5).

The kernels (``audiojax_torch/csrc/dwconv.cu``: ``dwconv_kernel``,
``dwconv_grouped_kernel``) run only on the card.  Their geometry comes from
the plain function ``ops.dwconv_cuda.dwconv_launch``, held here at every B4
and B5 shape of ``chip_smoke.py``: each output owned by exactly one (block,
work item, thread), written out in numpy from the kernels' own index
arithmetic; the ring of strip rows, replayed in the kernels' order (items
n+1 .. n+depth-1 staged before item n is read), holds every row an item
reads, the dilation·(k-1) halo rows of a carried time tile included; shared
memory within a block's 227 KB; the grid within the card's limits.  What
the kernels compute is emulated in numpy in their order (the ring, each
thread's outputs at stride dilation, the register windows, taps in order,
B5's lane pairs, fmaf as an exact product and one rounding) at small
shapes, and held against the JAX package's ``dwconv1d_jnp`` (dilation 1)
and ``conv1d`` with groups (dilated, grouped) at 1e-5 × max|ref| (the
tolerance of ``tests/test_torch_ops.py``).  The wrappers are held without a
card through a stub library.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.nn import core as jcore
from audiojax.ops.dwconv_pallas import dwconv1d_jnp

import chip_smoke
from audiojax_torch.nn import core as tcore
from audiojax_torch.ops import dwconv_cuda as D

TOL = 1e-5

# (B, T, C, k, lo, hi, dilation, M, vector) of every B4 and B5 shape in
# chip_smoke.py: the served ones on the vector path, the off-path ones on the
# path their C and alignment take
SHAPES = ([(*shape, k, *pads, dil, 1, True) for _, shape, k, pads, dil in
           chip_smoke.B4_CASES + chip_smoke.B4_SS_CASES + chip_smoke.B4_DFSMN_CASES
           + chip_smoke.B4_SE_CASES]
          + [(*shape, k, *pads, dil, 2, True) for _, shape, k, pads, dil in
             chip_smoke.B5_SS_CASES]
          + [(*shape, k, *pads, dil, 1, shape[2] % 4 == 0 and offset == 0)
             for _, shape, k, pads, dil, offset in chip_smoke.B4_OFFPATH_CASES])
IDS = [f"m{m}-{b}x{t}x{c}-k{k}-{lo}.{hi}-d{d}" + ("" if v else "-scalar")
       for b, t, c, k, lo, hi, d, m, v in SHAPES]


def _t_out(t, k, lo, hi, dil):
    return t + lo + hi - dil * (k - 1)


def _items(plan, bx, batch, k, dil):
    """(batch row, first output, ring slot base, first row to stage) of each
    work item of block bx, as ``item_of`` in csrc/dwconv.cu derives them."""
    halo = dil * (k - 1)
    span = plan.tile + halo
    if plan.carry:
        b, j0 = bx // plan.chunks, (bx % plan.chunks) * plan.ipb
        n_items = min(plan.ipb, plan.n_tiles - j0)
        return [(b, (j0 + n) * plan.tile, n * plan.tile % plan.ring, halo if n else 0)
                for n in range(n_items)]
    n_items = min(plan.ipb, batch - bx * plan.ipb)
    return [(bx * plan.ipb + n, 0, n * span % plan.ring, 0) for n in range(n_items)]


def _thread_runs(plan, dil):
    """(q of each time thread, output stride): its outputs are q + j·stride,
    j < r; the stride is the dilation, or 1 for a direct plan."""
    tt = np.arange(plan.ntt)
    if plan.direct:
        return tt * plan.r, 1
    return tt // dil * dil * plan.r + tt % dil, dil


# ── the plan at every served shape ─────────────────────────────────────────


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,m,vector", SHAPES, ids=IDS)
def test_plan_owns_each_output_once_and_fits(b, t, c, k, lo, hi, dil, m, vector):
    plan = D.dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector)
    t_out = _t_out(t, k, lo, hi, dil)
    ct, lanes = D.CT, D.CT // plan.vc
    assert plan.smem == 4 * (plan.ring + k) * ct <= D.SMEM_MAX
    assert plan.threads == lanes * plan.ntt <= D.MAX_THREADS[plan.r]
    assert plan.ntt % dil == 0 and not plan.direct
    assert plan.grid[0] * plan.grid[1] <= D.MAX_BLOCKS
    assert plan.threads % 32 == 0 or dil > 2  # whole warps at the served dilations
    # channels: tile y, lane l own output channels [y·ct/m + l·vin/m, … + vin/m),
    # written where the first lies below G
    g, vo = c // m, plan.vc // m
    y, lane = np.meshgrid(np.arange(plan.grid[1]), np.arange(lanes), indexing="ij")
    first = (y * (ct // m) + lane * vo).ravel()
    first = first[first < g]
    chans = np.zeros(first.size * vo + g, np.int64)
    np.add.at(chans, (first[:, None] + np.arange(vo)).ravel(), 1)
    assert (chans[:g] == 1).all() and not chans[g:].any()
    # time: every (batch row, output) exactly once
    count = np.zeros((b, t_out), np.int64)
    q, os = _thread_runs(plan, dil)
    outs = q[:, None] + os * np.arange(plan.r)[None, :]
    assert np.unique(outs).size == outs.size and outs.min() == 0 and outs.max() < plan.tile
    for bx in range(plan.grid[0]):
        for bb, t0, _, _ in _items(plan, bx, b, k, dil):
            tt = (t0 + outs).ravel()
            np.add.at(count[bb], tt[tt < t_out], 1)
    assert (count == 1).all()


def _replay_ring(plan, bx, batch, k, dil):
    """The rows each slot holds when each item is read, staged in the
    kernels' order; asserts that item n reads exactly rows t0 .. t0+span-1
    of its batch row."""
    span = plan.tile + dil * (k - 1)
    items = _items(plan, bx, batch, k, dil)
    tag = np.full((plan.ring, 2), -1, np.int64)

    def stage(n):
        b, t0, sb, first = items[n]
        q = np.arange(first, span)
        assert sb + span - 1 < 2 * plan.ring  # one conditional subtraction wraps a slot
        tag[(sb + q) % plan.ring] = np.stack([np.full_like(q, b), t0 + q], axis=1)

    for n in range(min(plan.depth - 1, len(items))):
        stage(n)
    for n, (b, t0, sb, _) in enumerate(items):
        if n + plan.depth - 1 < len(items):
            stage(n + plan.depth - 1)
        q = np.arange(span)
        held = tag[(sb + q) % plan.ring]
        assert (held[:, 0] == b).all() and (held[:, 1] == t0 + q).all(), (bx, n)
    return items


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,m,vector", SHAPES, ids=IDS)
def test_ring_holds_every_row_and_carries_the_halo(b, t, c, k, lo, hi, dil, m, vector):
    plan = D.dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector)
    halo = dil * (k - 1)
    q, os = _thread_runs(plan, dil)
    # the last row a thread reads lies in its item's span
    assert (q + (plan.r - 1) * os + (k - 1) * dil).max() < plan.tile + halo
    if plan.carry:
        assert plan.ring >= plan.depth * plan.tile + halo
    else:
        assert plan.tile >= _t_out(t, k, lo, hi, dil)
        assert plan.ring >= plan.depth * (plan.tile + halo)
    for bx in sorted({0, plan.grid[0] - 1}):
        items = _replay_ring(plan, bx, b, k, dil)
        if plan.carry:  # later tiles stage only their new rows: the halo is carried
            assert all(first == halo for *_, first in items[1:])


def _tap_copies(k, nthreads, unit_i):
    """(i, channel lane) of each thread's 4-byte tap copies, in the order of
    the staging loops of csrc/dwconv.cu: where i is w's unit stride each
    thread starts at (lane, tap) = divmod(tid, k) and steps by nthreads with a
    carry, else copy e = tid + j·nthreads takes tap e // 32, lane e % 32.
    Returns (i, cl) arrays of shape (copies a thread, nthreads), -1 where a
    thread has no copy left."""
    per = []
    for tid in range(nthreads):
        got = []
        if unit_i:
            dl, di = divmod(nthreads, k)
            cl, i = divmod(tid, k)
            while cl < D.CT:
                got.append((i, cl))
                i, cl = i + di, cl + dl
                if i >= k:
                    i, cl = i - k, cl + 1
        else:
            got = [(e // D.CT, e % D.CT) for e in range(tid, k * D.CT, nthreads)]
        per.append(got)
    rounds = max(len(g) for g in per)
    out = np.full((2, rounds, nthreads), -1)
    for tid, got in enumerate(per):
        for j, (i, cl) in enumerate(got):
            out[:, j, tid] = i, cl
    return out


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,m,vector", SHAPES, ids=IDS)
@pytest.mark.parametrize("unit_i", [True, False], ids=["tap-major", "lane-major"])
def test_taps_staged_once_each_warp_coalesced(b, t, c, k, lo, hi, dil, m, vector, unit_i):
    """Every tap of the block's tile is copied once, and each warp's copies of
    one round read one run of neighbouring floats of w: the model's
    tap-major view (stride 1 along i), or a contiguous (k, C) weight."""
    plan = D.dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector)
    i, cl = _tap_copies(k, plan.threads, unit_i)
    live = i >= 0
    assert np.array_equal(np.sort((i * D.CT + cl)[live]), np.arange(k * D.CT))
    addr = cl * k + i if unit_i else i * c + cl  # w's float offsets (channel tile 0)
    for j in range(i.shape[0]):
        for w0 in range(0, plan.threads, 32):
            run = addr[j, w0:w0 + 32][live[j, w0:w0 + 32]]
            assert np.array_equal(run, run[0] + np.arange(run.size)) if run.size else True


def test_served_plans_carry_or_take_whole_rows():
    """Every shape whose output rows fit 32 time threads of 8 (T_out ≤ 256: the
    GAN, ZipEnhancer, DFSMN and MossFormer2-SE shapes) takes whole batch rows;
    every MossFormer2-SS shape carries its halo over at least two tiles a
    block."""
    for b, t, c, k, lo, hi, dil, m, vector in SHAPES[:-len(chip_smoke.B4_OFFPATH_CASES)]:
        plan = D.dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector)
        if t + lo + hi - dil * (k - 1) <= 256:
            assert not plan.carry and plan.ipb >= 1
        else:
            assert plan.carry and plan.ipb >= 2


@pytest.mark.parametrize("kw", [dict(r=4), dict(vc=3), dict(depth=4), dict(ntt=200),
                                dict(ipb=0)])
def test_plan_refuses_what_is_not_built(kw):
    with pytest.raises(ValueError):
        D.dwconv_launch(4, 100, 64, 9, 4, 4, 2, 1, **kw)


def test_plan_takes_consecutive_outputs_past_the_thread_cap():
    plan = D.dwconv_launch(2, 90, 16, 3, 40, 40, 70, 1)
    assert plan.direct and plan.threads <= D.MAX_THREADS[plan.r]
    assert not D.dwconv_launch(2, 90, 16, 3, 40, 40, 3, 1).direct
    # time threads that are not a multiple of the dilation take consecutive outputs too
    assert D.dwconv_launch(2, 90, 16, 3, 40, 40, 3, 1, ntt=4).direct


def test_plan_refuses_shapes():
    with pytest.raises(ValueError, match="C % 4"):
        D.dwconv_launch(2, 50, 66, 5, 2, 2, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        D.dwconv_launch(2, 5000, 64, 4000, 2000, 2000, 1, 1)
    with pytest.raises(ValueError, match="no B4/B5 plan"):
        D.dwconv_launch(2, 5, 64, 9, 0, 0, 1, 1)
    with pytest.raises(ValueError, match="no B4/B5 plan"):
        D.dwconv_launch(2, 50, 63, 5, 2, 2, 1, 2)
    scalar = D.dwconv_launch(2, 50, 66, 5, 2, 2, 1, 1, vector=False)
    assert (scalar.gran, scalar.vc) == (1, 1)
    assert D.dwconv_launch(2, 50, 66, 5, 2, 2, 1, 2, vector=False).vc == 2
    with pytest.raises(ValueError, match="vc 4"):
        D.dwconv_launch(2, 50, 66, 5, 2, 2, 1, 1, vector=False, vc=4)
    for vc in (1, 2):
        with pytest.raises(ValueError, match=f"vc {vc}"):
            D.dwconv_launch(2, 50, 64, 5, 2, 2, 1, 2, vc=vc)
    with pytest.raises(ValueError, match="vc 2"):
        D.dwconv_launch(2, 50, 64, 5, 2, 2, 1, 1, vc=2)


# ── the kernels' order, emulated ───────────────────────────────────────────


def _fma(x, w, acc):
    """fmaf: the exact product and sum, rounded once to float32."""
    return (x.astype(np.float64) * w + acc).astype(np.float32)


def _thread_fma(acc, x, tv, m):
    """``tap_fma`` on a whole tile row: acc (ct/m,) += x (ct,) · tv (ct,); lane
    0, then lane 1 for B5."""
    for r in range(m):
        acc = _fma(x[r::m], tv[r::m], acc)
    return acc


def _row_stationary(acc, rows, taps, k, rr, m):
    """B4's loop at r = 8 where k >= r: row r adds x_r · w[r - j] to output j,
    a window of r taps (tap i in slot i mod r) loading one tap a row; the
    last r - 1 rows read their taps directly."""
    tw = [None] * rr
    for r in range(rr - 1):  # rows 0 .. r-2: outputs 0 .. r
        tw[r] = taps[r]
        xr = next(rows)
        for j in range(r + 1):
            acc[j] = _thread_fma(acc[j], xr, tw[r - j], m)
    for mi in range(k - rr + 1):  # rows and taps r-1 .. k-1: every output
        tw[(mi + rr - 1) % rr] = taps[rr - 1 + mi]
        xr = next(rows)
        for j in range(rr):
            acc[j] = _thread_fma(acc[j], xr, tw[(mi + rr - 1 - j) % rr], m)
    for sp in range(rr - 1):  # rows k .. k+r-2: outputs sp+1 .. r-1
        xr = next(rows)
        for j in range(sp + 1, rr):
            acc[j] = _thread_fma(acc[j], xr, taps[k + sp - j], m)


def _emulate(x, w, lo, hi, dil, plan):
    """y of the kernel at ``plan``: x (B, T, M·G), w (k, M, G) float32.  The
    ring, the items in their order, and each thread's loop: B4 at r = 8 with
    k >= r row-stationary (``_row_stationary``), else a window of r rows
    sliding over the taps (tap i loads row i + r - 1 into slot (i + r - 1) mod r)."""
    b, t, c = x.shape
    k, m, g = w.shape
    t_out = _t_out(t, k, lo, hi, dil)
    span = plan.tile + dil * (k - 1)
    ct, rr = D.CT, plan.r
    y = np.full((b, t_out, g), np.nan, np.float32)
    q_of, os = _thread_runs(plan, dil)
    for by in range(plan.grid[1]):
        c0 = by * ct
        lanes = np.arange(c0, c0 + ct)
        ok = lanes < c
        taps = np.zeros((k, ct), np.float32)  # taps[i][M·gl + r] = w[i, r, g0 + gl]
        taps[:, ok] = w[:, lanes[ok] % m, lanes[ok] // m]
        for bx in range(plan.grid[0]):
            items = _items(plan, bx, b, k, dil)
            ring = np.full((plan.ring, ct), np.nan, np.float32)

            def stage(n):
                bb, t0, sb, first = items[n]
                for qq in range(first, span):
                    tin = t0 + qq - lo
                    row = np.zeros(ct, np.float32)
                    if 0 <= tin < t:
                        row[ok] = x[bb, tin, lanes[ok]]
                    ring[(sb + qq) % plan.ring] = row

            for n in range(min(plan.depth - 1, len(items))):
                stage(n)
            for n, (bb, t0, sb, _) in enumerate(items):
                if n + plan.depth - 1 < len(items):
                    stage(n + plan.depth - 1)
                for q in q_of:
                    if t0 + q >= t_out:
                        continue
                    acc = [np.zeros(ct // m, np.float32) for _ in range(rr)]
                    if plan.direct:  # output j reads row q + j + i·dil at tap i
                        for i in range(k):
                            for j in range(rr):
                                xr = ring[(sb + q + j + i * dil) % plan.ring]
                                acc[j] = _thread_fma(acc[j], xr, taps[i], m)
                    else:
                        rows = iter([ring[(sb + q + i * dil) % plan.ring]
                                     for i in range(rr + k - 1)])
                        if m == 1 and rr == 8 and k >= rr:
                            _row_stationary(acc, rows, taps, k, rr, m)
                        else:
                            win = [next(rows) for _ in range(rr - 1)] + [None]
                            for i in range(k):
                                win[(i + rr - 1) % rr] = next(rows)
                                for j in range(rr):
                                    acc[j] = _thread_fma(acc[j], win[(i + j) % rr], taps[i], m)
                    for j in range(rr):
                        tt = t0 + q + j * os
                        if tt < t_out:
                            gs = np.arange(c0 // m, (c0 + ct) // m)
                            y[bb, tt, gs[gs < g]] = acc[j][gs < g]
    return y


# (B, T, C, k, lo, hi, dilation, M, vector, plan overrides): both row modes,
# pads 0 and asymmetric, dilations 1, 2, 3, the scalar paths, depth 3, r 16,
# k below r, and k >= r with k mod r = 0, 3, 4 (whole groups of taps and a
# partial one)
EMULATED = [
    (3, 30, 64, 7, 3, 3, 1, 1, True, {}),
    (5, 24, 40, 5, 0, 0, 1, 1, True, dict(ipb=2, vc=4, r=8)),
    (3, 33, 20, 5, 1, 4, 2, 1, True, dict(ipb=2, vc=1)),
    (2, 41, 66, 4, 2, 5, 3, 1, False, dict(ntt=3, ipb=2)),
    (2, 60, 16, 9, 8, 8, 2, 1, True, dict(ntt=2, ipb=3, depth=3)),
    (2, 70, 12, 5, 0, 7, 3, 1, True, dict(ntt=3, ipb=2)),
    (3, 30, 16, 7, 6, 6, 2, 2, True, dict(ipb=2, vc=4, r=8)),
    (2, 70, 24, 7, 6, 6, 2, 2, True, dict(ntt=2, ipb=3)),
    (2, 50, 18, 5, 3, 1, 3, 2, False, dict(ntt=3, ipb=2, depth=3)),
    (2, 45, 10, 4, 0, 0, 1, 2, False, {}),
    (2, 40, 36, 20, 9, 10, 1, 1, True, dict(vc=4, r=8, ipb=2)),
    (2, 48, 16, 19, 18, 18, 2, 2, True, dict(vc=4, r=16)),
    (2, 44, 32, 17, 8, 8, 1, 1, True, dict(vc=1, r=16, ntt=2)),
    (2, 90, 16, 3, 40, 40, 70, 1, True, {}),  # dilation 70: consecutive outputs
    (2, 120, 12, 4, 30, 30, 20, 2, True, dict(ntt=3, ipb=2)),  # and carried tiles
]


@pytest.mark.parametrize("b,t,c,k,lo,hi,dil,m,vector,kw", EMULATED,
                         ids=[f"m{e[7]}-{e[0]}x{e[1]}x{e[2]}-k{e[3]}-d{e[6]}-{i}"
                              for i, e in enumerate(EMULATED)])
def test_emulated_kernel_matches_jax(b, t, c, k, lo, hi, dil, m, vector, kw):
    rng = np.random.default_rng(b * 100 + t + c)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((k, m, c // m)) / np.sqrt(m * k)).astype(np.float32)
    plan = D.dwconv_launch(b, t, c, k, lo, hi, dil, m, vector=vector, **kw)
    y = _emulate(x, w, lo, hi, dil, plan)
    if m == 1 and dil == 1:
        ref = np.asarray(dwconv1d_jnp(jnp.asarray(x), jnp.asarray(w[:, 0]), pads=(lo, hi)))
    else:  # w (k, M, G) is conv1d's (k, Cin/groups, Cout); its depthwise route for M = 1
        ref = np.asarray(jcore.conv1d({"w": jnp.asarray(w)}, jnp.asarray(x), padding=(lo, hi),
                                      dilation=dil, groups=c // m))
    assert y.shape == ref.shape and np.isfinite(y).all()
    assert np.abs(y - ref).max() <= TOL * np.abs(ref).max()


# ── the wrappers without a card ────────────────────────────────────────────


class _StubLib:
    """Records every call into the kernel library, with its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def stub_lib(monkeypatch):
    """The wrappers with their device check off and a library that records calls."""
    stub = _StubLib()
    monkeypatch.setattr(D, "_lib", lambda: stub)
    monkeypatch.setattr(D, "_check", lambda *args: None)
    monkeypatch.setattr(D, "_stream", lambda device: 0)
    return stub


def test_wrappers_raise_before_any_launch(stub_lib):
    before = dict(D.launches)
    x = torch.zeros(2, 20, 8)
    with pytest.raises(ValueError, match="does not fit"):
        D.dwconv1d_cuda(x, torch.zeros(3, 6))
    with pytest.raises(ValueError, match="non-positive output length"):
        D.dwconv1d_cuda(x, torch.zeros(25, 8))
    with pytest.raises(ValueError, match="pads must be"):
        D.dwconv1d_cuda(x, torch.zeros(3, 8), pads=(-1, 0))
    with pytest.raises(ValueError, match="shared memory"):
        D.dwconv1d_cuda(torch.zeros(1, 9000, 8), torch.zeros(9000, 8), pads=(4000, 4000))
    with pytest.raises(ValueError, match=r"\(k, 2, G\)"):
        D.dwconv1d_grouped_cuda(x, torch.zeros(3, 2, 3))
    with pytest.raises(ValueError, match="non-positive output length"):
        D.dwconv1d_grouped_cuda(x, torch.zeros(9, 2, 4), dilation=3)
    assert stub_lib.calls == [] and D.launches == before


def test_strided_weights_reach_the_launcher_uncopied(stub_lib):
    before = dict(D.launches)
    x = torch.zeros(2, 40, 8)
    wt = torch.randn(8, 1, 5)  # the model's (C, 1, k)
    D.dwconv1d_cuda(x, wt[:, 0, :].t(), pads=(2, 2))
    (name, args), = stub_lib.calls
    assert name == "ajt_dwconv1d_f32"
    assert args[1] == wt.data_ptr() and args[10:12] == (1, 5)  # w itself, strides (si, sc)
    plan = D.dwconv_launch(2, 40, 8, 5, 2, 2, 1, 1)
    assert args[12:-1] == D._plan_args(plan)
    g = torch.randn(4, 2, 7)  # the model's (G, 2, k)
    D.dwconv1d_grouped_cuda(x, g.permute(2, 1, 0), pads=(6, 6), dilation=2)
    name, args = stub_lib.calls[1]
    assert name == "ajt_dwconv1d_grouped2_f32"
    assert args[1] == g.data_ptr() and args[10:13] == (1, 7, 14)
    assert D.launches == {**before, "dwconv1d": before["dwconv1d"] + 1,
                          "dwconv1d_tiled": before["dwconv1d_tiled"] + 1}


def test_unaligned_x_takes_the_scalar_path(stub_lib):
    buf = torch.zeros(2 * 40 * 8 + 1)
    x = buf[1:].view(2, 40, 8)  # contiguous, 4 bytes past a 16-byte boundary
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    D.dwconv1d_cuda(x, torch.zeros(5, 8), pads=(2, 2))
    (_, args), = stub_lib.calls
    assert args[12:14] == (1, 1)  # 4-byte copies, one float a thread


def test_cpu_route_takes_the_plain_version_with_strided_weights():
    before = dict(D.launches)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 30, 8)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((8, 1, 5)).astype(np.float32))
    y = D.fast_dwconv1d(x, wt[:, 0, :].t(), pads=(2, 2), dilation=2)
    assert torch.equal(y, D.dwconv1d_plain(x, wt[:, 0, :].t().contiguous(), pads=(2, 2),
                                           dilation=2))
    g = torch.from_numpy(rng.standard_normal((4, 2, 5)).astype(np.float32))
    y2 = D.fast_dwconv1d_grouped(x, g.permute(2, 1, 0), pads=(4, 4), dilation=2)
    assert torch.equal(y2, D.dwconv1d_grouped_plain(x, g.permute(2, 1, 0).contiguous(),
                                                    pads=(4, 4), dilation=2))
    assert D.launches == before


def test_conv1d_route_passes_weight_views(monkeypatch):
    """``nn/core.py:conv1d`` hands both kernels views of the model's weight,
    with no copy."""
    seen = []
    for name in ("fast_dwconv1d", "fast_dwconv1d_grouped"):
        real = getattr(tcore, name)
        monkeypatch.setattr(tcore, name,
                            lambda x, w, _r=real, **kw: seen.append(w) or _r(x, w, **kw))
    x = torch.randn(2, 30, 8)
    dw = {"w": torch.randn(8, 1, 5)}
    gw = {"w": torch.randn(4, 2, 5)}
    tcore.conv1d(dw, x, padding=2, groups=8)
    tcore.conv1d(gw, x, padding=4, dilation=2, groups=4)
    assert [w.data_ptr() for w in seen] == [dw["w"].data_ptr(), gw["w"].data_ptr()]
    assert [w.is_contiguous() for w in seen] == [False, False]
    assert [tuple(w.shape) for w in seen] == [(5, 8), (5, 2, 4)]
