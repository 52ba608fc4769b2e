#!/usr/bin/env python3
"""Time the attention kernels (B6, B3) at several launch geometries, on one card.

    python3 attention_geometry_sweep.py [--parent DIR] [--bf16-only]

At each 6 s serving shape of ``chip_smoke.py`` (B6: MossFormerGAN's four GAU
attentions and MossFormer2-SS's FLASH group, with its 30 s shape; B3:
ZipEnhancer's six score stages) this prints the plain version's device time,
the wrapper's geometry, and the kernel's device time at each geometry tried
(µs, CUDA events behind a spin kernel, median of 20; ``chip_smoke.device_ms``),
launched through ``ops/attention_cuda.py``'s ``launch_quad_attention`` and
``launch_relpos_scores`` (which count nothing).  B6 tries both warp layouts
it is built for (2×2, 4×2) and, where there are several value tiles, 1, 2
and 4 value splits; B3 tries row tiles of 16, 24 and 32 rows (and the
wrapper's) with the wrapper's batch split and with a half and a quarter of
its batch rows a block.  Every result is held to the wrapper's own within
1e-6 × max|ref| (the geometries do not change the order of any sum), and the
last line of each shape says how far the wrapper's pick is from the best.

B6 bf16 (the tensor-core kernel, ``csrc/quad_attention_bf16.cu``) at every
bf16 serving shape of ``chip_smoke.py`` (6 s: B6_CASES, B6_SS_CASES,
B6_SE_CASES, B6_SR_CASES; float32 out, as the layers take it): the plain
version's µs, the wrapper's geometry, and the kernel at 4 and 7 warps (where
S allows), pieces of 32 and 64 keys, scores formed again a value tile or
kept, and 1 to 16 value splits; every geometry equal to the wrapper's result
bit for bit (none changes the order of a sum).  With ``--parent DIR`` (an
unpacked earlier tree of this repository), the same shapes' times of that
tree's B6 bf16 kernel, measured by its own code in a process of its own,
before and after the new kernel's (parent, change, parent).  Then the
kernel's float64 error and time beside the plain version's error at two
shapes, with the k16 steps of its sums chained in the mma accumulator by
each of ``SUM_CHAINS`` (the source's ``kQkChain`` and ``kPvChain``, text
edits built by ``_build.load_source``).
B3 bf16 (the tensor-core kernel, ``csrc/relpos_scores_bf16.cu``) at every
bf16 serving shape of ``chip_smoke.py`` (6 s B3_CASES of at most 256 keys):
its bound, the plain version's and the float32 instance's µs at the same
shape, the wrapper's geometry, and the kernel at row groups a block 1, 2,
3, 4, 8 and all of a row's, the fewest warps a row group that hold 8 tiles
of keys and twice as many, and the plan's batch split, half and twice it;
every geometry within one bf16 ulp of the plain version.  With
``--parent DIR``, the parent tree's B3 bf16 at the same shapes, before and
after the new kernel's.
``--bf16-only`` skips the float32 B6 and B3 sweeps.  Without CUDA it exits 1.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys

import torch

import chip_smoke as c

TOL_SAME_ORDER = 1e-6
# (label, N, S, mask, K, V): every bf16 B6 serving shape (6 s)
B6_BF16 = ([(label, n, s, mask, 128, 128) for label, n, s, mask in c.six_s(c.B6_CASES)]
           + [(label, n, s, False, 128, 2048) for label, n, s in
              c.six_s(c.B6_SS_CASES + c.B6_SE_CASES + c.B6_SR_CASES)])
# (label, N, S): every bf16 B3 serving shape (6 s), H 4, D 32, P 4
B3_BF16 = [(label, n, s) for label, n, s in c.six_s(c.B3_CASES) if s <= 256]
# an earlier tree's B3 bf16 at the shapes in argv[1], run from that tree's
# root by its own code (q, k, pp lane slices of one projection, as the model
# has them)
OLD_B3 = r"""
import json, sys, torch
import chip_smoke as c
from audiojax_torch.ops import attention_cuda as A
dev = torch.device("cuda")
times = []
for n, s in json.loads(sys.argv[1]):
    proj = (0.5 * torch.randn((n, s, 288), device=dev)).to(torch.bfloat16)
    q, k, pp = proj[..., :128], proj[..., 128:256], proj[..., 256:]
    pe = (0.5 * torch.randn((4, 4, s, s), device=dev)).to(torch.bfloat16)
    times.append(c.device_ms(lambda: A.relpos_scores_cuda(q, k, pp, pe, num_heads=4)) * 1e3)
print(json.dumps(times))
"""
# an earlier tree's B6 bf16 (bf16 in, float32 out) at the shapes in argv[1],
# run from that tree's root by its own code
OLD_B6 = r"""
import json, sys, torch
import chip_smoke as c
from audiojax_torch.ops import attention_cuda as A
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
times = []
for n, s, mask, dk, dv in json.loads(sys.argv[1]):
    q, k = (torch.randn((n, s, dk), generator=gen, device=dev).to(torch.bfloat16) for _ in "qk")
    v = torch.randn((n, s, dv), generator=gen, device=dev).to(torch.bfloat16)
    times.append(c.device_ms(lambda: A.quad_attention_cuda(
        q, k, v, scale=1.0 / s, mask_diag=mask, out_dtype=torch.float32)) * 1e3)
print(json.dumps(times))
"""


def _hold(name: str, label: str, geo, out: torch.Tensor, ref: torch.Tensor) -> None:
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    if not err <= TOL_SAME_ORDER:
        c.fail(f"{name} {label} {geo}: {err:.3e} from the wrapper's result")


def _pick_line(name: str, label: str, pick, times: dict) -> None:
    best = min(times, key=times.get)
    print(f"{name} {label}: wrapper's pick {pick} {times[pick]:.1f} us, best {best} "
          f"{times[best]:.1f} us ({times[pick] / times[best] - 1.0:+.1%})", flush=True)


def sweep_b6(dev) -> None:
    from audiojax_torch.ops import attention_cuda as A

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(label, n, s, mask, 128, 128) for label, n, s, mask in c.B6_CASES[:4]]
    shapes += [(label, n, s, False, 128, 2048) for label, n, s in c.B6_SS_CASES]
    for label, n, s, mask, dk, dv in shapes:
        q, k = (torch.randn((n, s, dk), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((n, s, dv), generator=gen, device=dev)
        ref = A.quad_attention_cuda(q, k, v, scale=1.0 / s, mask_diag=mask)
        out = torch.empty_like(ref)
        pick = A.quad_launch(n, s, dk, dv)
        plain_us = c.device_ms(lambda: A.quad_attention_plain(q, k, v, scale=1.0 / s,
                                                              mask_diag=mask)) * 1e3
        print(f"== B6 {label} ({n}, {s}, K{dk}, V{dv}){' mask' if mask else ''}: plain "
              f"{plain_us:.1f} us; wrapper {pick}", flush=True)
        times = {}
        for warps in A.QUAD_WARPS:
            tiles = -(-dv // (64 * warps[1]))
            for vsplit in sorted({1, min(2, tiles), min(4, tiles)}):
                geo = A.quad_launch(n, s, dk, dv, warps=warps, vsplit=vsplit)
                key = (geo.wm, geo.wn, geo.vsplit)
                us = c.device_ms(lambda: A.launch_quad_attention(q, k, v, out, 1.0 / s, mask,
                                                                 geo)) * 1e3
                _hold("B6", label, geo, out, ref)
                times[key] = us
        print("B6 " + label + ": wm x wn / vsplit: us  " + "  ".join(
            f"{wm}x{wn}/{vs}: {us:.1f}" for (wm, wn, vs), us in times.items()), flush=True)
        _pick_line("B6", label, (pick.wm, pick.wn, pick.vsplit), times)
        del q, k, v, ref, out


def sweep_b3(dev) -> None:
    from audiojax_torch.ops import attention_cuda as A

    h, d, n_pos = 4, 32, 4
    stride = A.pos_stride(n_pos)
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, n, s in c.B3_CASES[:6]:
        proj = 0.5 * torch.randn((n, s, 2 * h * d + h * stride), generator=gen, device=dev)
        q, k, pp = proj[..., : h * d], proj[..., h * d : 2 * h * d], proj[..., 2 * h * d :]
        pe = 0.5 * torch.randn((h, n_pos, s, s), generator=gen, device=dev)
        ref = A.relpos_scores_cuda(q, k, pp, pe, num_heads=h)
        out = torch.empty_like(ref)
        pick = A.relpos_launch(n, s, h, d, n_pos)
        plain_us = c.device_ms(lambda: A.relpos_scores_plain(q, k, pp, pe, num_heads=h)) * 1e3
        print(f"== B3 {label} ({n}, {s}) H{h} D{d} P{n_pos}: plain {plain_us:.1f} us; "
              f"wrapper {pick}", flush=True)
        times = {}
        for rows in sorted({16, 24, 32, pick.rows}):
            base = A.relpos_launch(n, s, h, d, n_pos, rows=rows)
            for nb in sorted({base.nb, max(1, base.nb // 2), max(1, base.nb // 4)}):
                geo = A.relpos_launch(n, s, h, d, n_pos, rows=rows, nb=nb)
                us = c.device_ms(lambda: A.launch_relpos_scores(q, k, pp, pe, out, h, geo)) * 1e3
                _hold("B3", label, geo, out, ref)
                times[(geo.rows, geo.nb)] = us
        print("B3 " + label + ": rows/nb: us  " + "  ".join(
            f"{r}/{nb}: {us:.1f}" for (r, nb), us in times.items()), flush=True)
        _pick_line("B3", label, (pick.rows, pick.nb), times)
        del proj, q, k, pp, pe, ref, out


def parent_times(parent: str, snippet: str, shapes: list) -> list:
    """An earlier tree's kernel times (µs) at ``shapes``, by ``snippet`` run
    from that tree's root in a process of its own (its own build)."""
    proc = subprocess.run([sys.executable, "-c", snippet, json.dumps(shapes)], cwd=parent,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        c.fail(f"the parent tree's timing failed:\n{proc.stdout[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sweep_b6_bf16(dev, parent: str | None) -> None:
    from audiojax_torch.ops import attention_cuda as A

    shapes = [[n, s, mask, dk, dv] for _, n, s, mask, dk, dv in B6_BF16]
    old = [parent_times(parent, OLD_B6, shapes)] if parent else []
    gen = torch.Generator(device=dev).manual_seed(0)
    new = []
    for label, n, s, mask, dk, dv in B6_BF16:
        q, k = (torch.randn((n, s, dk), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn((n, s, dv), generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(scale=1.0 / s, mask_diag=mask, out_dtype=torch.float32)
        ref = A.quad_attention_cuda(q, k, v, **kw)
        out = torch.empty_like(ref)
        pick = A.quad_bf16_launch(n, s, dk, dv)
        plain_us = c.device_ms(lambda: A.quad_attention_plain(q, k, v, **kw)) * 1e3
        print(f"== B6 bf16 {label} ({n}, {s}, K{dk}, V{dv}){' mask' if mask else ''} -> f32: "
              f"plain {plain_us:.1f} us; wrapper {pick}", flush=True)
        tiles = -(-dv // A.QUAD_BF16_VT)
        times = {}
        for warps in sorted({4, min(7, -(-s // 16))}):
            for kb in A.QUAD_BF16_KB:
                for keep in (False, True):
                    for vsplit in sorted({min(vs, tiles) for vs in (1, 2, 4, 8, 16)}):
                        try:
                            geo = A.quad_bf16_launch(n, s, dk, dv, warps=warps, kb=kb,
                                                     keep=keep, vsplit=vsplit)
                        except ValueError:  # shared memory past the card's
                            continue
                        us = c.device_ms(lambda: A.launch_quad_attention(
                            q, k, v, out, 1.0 / s, mask, geo)) * 1e3
                        if not torch.equal(out, ref):
                            c.fail(f"B6 bf16 {label} {geo}: differs from the wrapper's result")
                        times[(warps, kb, int(keep), geo.vsplit)] = us
        ranked = sorted(times, key=times.get)
        print("B6 bf16 " + label + ": warps/kb/keep/vsplit: us  " + "  ".join(
            f"{'/'.join(map(str, key))}: {times[key]:.1f}" for key in ranked), flush=True)
        mine = (pick.warps, pick.kb, int(pick.keep), pick.vsplit)
        new.append(times[mine])
        _pick_line("B6 bf16", label, mine, times)
        del q, k, v, ref, out
    if parent:
        old.append(parent_times(parent, OLD_B6, shapes))
    for i, (label, n, s, mask, dk, dv) in enumerate(B6_BF16):
        was = " / ".join(f"{t[i]:.1f}" for t in old) if old else "not measured"
        print(f"B6 bf16 {label} ({n}, {s}, K{dk}, V{dv}): new {new[i]:.1f} us at the wrapper's "
              f"pick; parent tree {was} us (before / after)", flush=True)


def sweep_b3_bf16(dev, parent: str | None) -> None:
    """B3 bf16 (``csrc/relpos_scores_bf16.cu``) at every geometry tried, each
    within one bf16 ulp of the plain version (the row sums' order follows
    the key split), beside the plain version, the float32 instance and the
    parent tree's kernel at the same shape."""
    from audiojax_torch.ops import attention_cuda as A

    h, d, n_pos = 4, 32, 4
    shapes = [[n, s] for _, n, s in B3_BF16]
    old = [parent_times(parent, OLD_B3, shapes)] if parent else []
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for label, n, s in B3_BF16:
        proj32 = 0.5 * torch.randn((n, s, 2 * h * d + h * A.pos_stride(n_pos)), generator=gen,
                                   device=dev)
        pe32 = 0.5 * torch.randn((h, n_pos, s, s), generator=gen, device=dev)
        proj, pe = proj32.to(torch.bfloat16), pe32.to(torch.bfloat16)
        q, k, pp = proj[..., : h * d], proj[..., h * d : 2 * h * d], proj[..., 2 * h * d :]
        q32, k32, pp32 = (proj32[..., : h * d], proj32[..., h * d : 2 * h * d],
                          proj32[..., 2 * h * d :])
        want = A.relpos_scores_plain(q, k, pp, pe, num_heads=h).float()
        out = torch.empty((n, h, s, s), dtype=torch.bfloat16, device=dev)
        pick = A.relpos_bf16_launch(n, s, h, d, n_pos)
        others = {
            "plain": c.device_ms(lambda: A.relpos_scores_plain(q, k, pp, pe, num_heads=h)) * 1e3,
            "float32 kernel": c.device_ms(lambda: A.relpos_scores_cuda(
                q32, k32, pp32, pe32, num_heads=h)) * 1e3,
        }
        es = proj.element_size()
        # q, k and the P used terms of pp (not its padded slots), pe, probs
        used = n * s * h * (2 * d + n_pos)
        bound_us = c.bound(n * h * s * s * 5.0, es * (used + pe.numel() + want.numel()),
                           bf16_flops=n * h * s * s * (2.0 * d + 2.0 * n_pos))[0] * 1e3
        print(f"== B3 bf16 {label} ({n}, {s}) H{h} D{d} P{n_pos}: bound {bound_us:.2f} us; "
              + ", ".join(f"{name} {us:.1f} us" for name, us in others.items())
              + f"; wrapper {pick}", flush=True)
        tiles = -(-s // 8)
        times = {}
        for kw, wr in itertools.product((-(-tiles // 8), 2 * -(-tiles // 8)),
                                        sorted({1, 2, 3, 4, 8, -(-s // 16)})):
            try:
                base = A.relpos_bf16_launch(n, s, h, d, n_pos, wr=wr, kw=kw)
            except ValueError:  # more warps or shared memory than the kernel takes
                continue
            for nb in sorted({base.nb, max(1, base.nb // 2), 2 * base.nb}):
                geo = A.relpos_bf16_launch(n, s, h, d, n_pos, wr=wr, kw=kw, nb=nb)
                key = (geo.wr, geo.kw, geo.nb)
                if key in times:
                    continue
                times[key] = c.device_ms(lambda: A.launch_relpos_scores(
                    q, k, pp, pe, out, h, geo)) * 1e3
                over = (out.float() - want).abs() > c.BF16_ULP * want.abs() + 1e-6
                if bool(over.any()):
                    c.fail(f"B3 bf16 {label} {geo}: {int(over.sum())} elements part from "
                           "plain by more than one bf16 ulp")
        ranked = sorted(times, key=times.get)
        print("B3 bf16 " + label + ": wr/kw/nb: us  " + "  ".join(
            f"{'/'.join(map(str, key))}: {times[key]:.1f}" for key in ranked), flush=True)
        mine = (pick.wr, pick.kw, pick.nb)
        rows.append((label, n, s, times[mine], others))
        best = ranked[0]
        print(f"B3 bf16 {label}: wrapper's pick {'/'.join(map(str, mine))} {times[mine]:.1f} us "
              f"({bound_us / times[mine]:.0%} of bound), best {'/'.join(map(str, best))} "
              f"{times[best]:.1f} us ({times[mine] / times[best] - 1.0:+.1%})", flush=True)
        del proj32, pe32, proj, pe, q, k, pp, want, out
    if parent:
        old.append(parent_times(parent, OLD_B3, shapes))
    for i, (label, n, s, new_us, others) in enumerate(rows):
        was = " / ".join(f"{t[i]:.1f}" for t in old) if old else "not measured"
        print(f"B3 bf16 {label} ({n}, {s}): new {new_us:.1f} us at the wrapper's pick; parent "
              f"tree {was} us (before / after); " + ", ".join(
                  f"{name} {us:.1f}" for name, us in others.items()), flush=True)


SUM_CHAINS = ((1, 1), (1, 2), (2, 2), (8, 2))  # (kQkChain, kPvChain) held against float64


def sum_order_errors(dev) -> None:
    """Float64 error and device µs of the kernel with the k16 steps of its
    sums chained in the mma accumulator by each of SUM_CHAINS (text edits of
    the source's kQkChain and kPvChain, built by ``_build.load_source``),
    beside the plain version's error, at the GAN's and SS's shapes."""
    import ctypes
    import re

    from audiojax_torch.ops import _build
    from audiojax_torch.ops import attention_cuda as A

    src = (_build.CSRC / "quad_attention_bf16.cu").read_text()
    pat = r"constexpr int kQkChain = (\d+);\nconstexpr int kPvChain = (\d+);"
    found = re.search(pat, src)
    if not found:
        c.fail("quad_attention_bf16.cu no longer holds its kQkChain and kPvChain")
    source = tuple(int(v) for v in found.groups())
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for qk, pv in SUM_CHAINS:
        text = re.sub(pat, f"constexpr int kQkChain = {qk};\nconstexpr int kPvChain = {pv};", src)
        lib = _build.load_source(f"quad_attention_bf16_qk{qk}_pv{pv}", text)
        fn = lib.ajt_quad_attention_bf16_f32
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, i,
                       ctypes.c_longlong, p]
        fn.restype = i
        fns[(qk, pv)] = fn
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, s, dv in ((964, 101, 128), (64, 256, 2048)):
        q, k = (torch.randn((n, s, 128), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn((n, s, dv), generator=gen, device=dev).to(torch.bfloat16)
        rows = c._f64_rows(n, 8, dev)
        ref = c.ref_quad64(*(a[rows].double().cpu().numpy() for a in (q, k, v)), 1.0 / s, False)
        plain = A.quad_attention_plain(q, k, v, scale=1.0 / s, out_dtype=torch.float32)
        e_plain = c.rel_err(plain[rows].cpu().numpy(), ref)
        out = torch.empty_like(plain)
        g = A.quad_bf16_launch(n, s, 128, dv)
        cells = []
        for (qk, pv), fn in fns.items():
            run = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, s, 128,
                             dv, 1.0 / s, 0, g.warps, g.row_tiles, g.vsplit, g.kb, int(g.keep),
                             g.smem, torch.cuda.current_stream().cuda_stream)
            if run() != 0:
                c.fail(f"the chain variant qk {qk} pv {pv} did not launch")
            torch.cuda.synchronize()
            e = c.rel_err(out[rows].cpu().numpy(), ref)
            us = c.device_ms(run) * 1e3
            mark = " (source)" if (qk, pv) == source else ""
            cells.append(f"qk {qk} pv {pv}{mark} {e:.3e} ({e / e_plain:.2f}x plain), {us:.1f} us")
        print(f"B6 bf16 ({n}, {s}, K128, V{dv}) float64 error / max|ref|, plain {e_plain:.3e}; "
              + "; ".join(cells), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_geometry_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    c.build_all()
    if "--bf16-only" not in args:
        sweep_b6(dev)
        sweep_b3(dev)
    sweep_b3_bf16(dev, parent)
    sweep_b6_bf16(dev, parent)
    sum_order_errors(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
