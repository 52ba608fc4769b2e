#!/usr/bin/env python3
"""Time the depthwise (B4) and grouped (B5) conv kernels at each plan choice, on one card.

    python3 dwconv_geometry_sweep.py [--parent DIR] [--bf16-only]

At every B4 and B5 serving shape of ``chip_smoke.py`` (MossFormerGAN's eight,
ZipEnhancer's six, MossFormer2-SS's six B4 and two B5 shapes) this prints the
wrapper's plan (``ops/dwconv_cuda.py:dwconv_launch``) and the kernel's device
time (µs, CUDA events behind a spin kernel, median of 20;
``chip_smoke.device_ms``) at each choice of outputs a thread (r 8, 16),
input floats a thread in the FMA loop (vc 4 or 1; B5 4), items a block
(1, 2, 4 and the wrapper's), ring depth (2, 3 items) and time
threads (whole warps as the wrapper takes them; for a whole-row item also
the fewest that cover it, for time tiles also 8, 16, 32), launched through the
uncounted ``launch_dwconv1d`` / ``launch_dwconv1d_grouped``.  The weights
are the model's layout seen through a view, as ``nn/core.py`` passes them.
The wrapper's result is held against the plain version (1e-5 × max|ref|)
and every other choice against the wrapper's bit for bit: no choice changes
the order of any sum.  Then each shape says how far the wrapper's pick is
from the best, and what the pick takes with the weight as that view and
as a contiguous copy (the strided read's cost).

B4 bf16 (the tensor-core kernel, ``csrc/dwconv_bf16.cu``) at every bf16
serving shape of ``chip_smoke.py`` (6 s: B4_CASES, B4_SS_CASES, B4_SE_CASES,
B4_SR_CASES): the wrapper's plan (``dwconv_mma_launch``), the kernel at 1,
2, 4, 8, 16 and 32 items a block and each ring depth it takes (and at the
wrapper's pick), each result equal to the wrapper's bit for bit and the
wrapper's within one bf16 ulp of the plain version; beside it the plain version, cuDNN's bf16 conv and the float32
instance at the same shape.  With ``--parent DIR`` (an unpacked earlier tree
of this repository), the same shapes' times of that tree's B4 bf16 kernel,
measured by its own code in a process of its own, before and after
(parent, change, parent).  B5 bf16 (the same kernel, two lanes a group) at
MossFormer2-SS's 6 s shape likewise, beside the plain version, cuDNN's bf16
grouped conv, the float32 instance and the parent tree's B5 bf16.
``--bf16-only`` skips the float32 sweeps.  Without CUDA it exits 1.
"""
from __future__ import annotations

import itertools
import sys

import torch

import chip_smoke as c
from attention_geometry_sweep import parent_times

# (label, (B, T, C), k, pads, dilation): every bf16 B4 serving shape (6 s)
B4_BF16 = c.six_s(c.B4_CASES + c.B4_SS_CASES + c.B4_SE_CASES + c.B4_SR_CASES)
# an earlier tree's B4 bf16 at the shapes in argv[1], run from that tree's
# root by its own code (the model's weight view, as nn/core.py passes it)
OLD_B4 = r"""
import json, sys, torch
import chip_smoke as c
from audiojax_torch.ops import dwconv_cuda as D
dev = torch.device("cuda")
times = []
for (b, t, ch), k, pads, dil in json.loads(sys.argv[1]):
    x = torch.randn((b, t, ch), device=dev).to(torch.bfloat16)
    w = (torch.randn((ch, 1, k), device=dev) / k ** 0.5).to(torch.bfloat16)[:, 0, :].t()
    times.append(c.device_ms(lambda: D.dwconv1d_cuda(x, w, pads=tuple(pads), dilation=dil)) * 1e3)
print(json.dumps(times))
"""


def _time(times: dict, label: str, m: int, b: int, t: int, ch: int, k: int, pads: tuple,
          dil: int, r: int, vc: int, ipb, depth: int, ntt, launch, out, ref) -> None:
    """Time one plan choice into ``times`` (skipped where it does not fit);
    its result must equal the wrapper's bit for bit."""
    from audiojax_torch.ops import dwconv_cuda as D

    try:
        plan = D.dwconv_launch(b, t, ch, k, *pads, dil, m, r=r, vc=vc, ipb=ipb,
                               depth=depth, ntt=ntt)
    except ValueError:  # shared memory or threads past the card's limits
        return
    key = (plan.r, plan.vc, plan.ntt, plan.ipb, plan.depth)
    if key in times:
        return
    times[key] = c.device_ms(lambda: launch(plan)) * 1e3
    if not torch.equal(out, ref):
        c.fail(f"B{4 if m == 1 else 5} {label} {key}: differs from the wrapper's result")


def _sweep(label: str, m: int, b: int, t: int, ch: int, k: int, pads: tuple, dil: int,
           gen, dev) -> None:
    from audiojax_torch.ops import dwconv_cuda as D

    g = ch // m
    x = torch.randn((b, t, ch), generator=gen, device=dev)
    wt = torch.randn((g, m, k), generator=gen, device=dev) / (m * k) ** 0.5  # torch (G, M, k)
    if m == 1:
        w, run, plain, launch = (wt[:, 0, :].t(), D.dwconv1d_cuda, D.dwconv1d_plain,
                                 D.launch_dwconv1d)
    else:
        w, run, plain, launch = (wt.permute(2, 1, 0), D.dwconv1d_grouped_cuda,
                                 D.dwconv1d_grouped_plain, D.launch_dwconv1d_grouped)
    ref = run(x, w, pads=pads, dilation=dil)
    want = plain(x, w, pads=pads, dilation=dil)
    err = float((ref - want).abs().max()) / float(want.abs().max())
    if not err <= c.TOL_B4_B6:
        c.fail(f"B{4 if m == 1 else 5} {label}: wrapper vs plain {err:.3e}")
    pick = D.dwconv_launch(b, t, ch, k, *pads, dil, m)
    out = torch.empty_like(ref)
    bound_us = c.bound(2.0 * m * b * ref.shape[1] * g * k,
                       4.0 * (b * t * ch + k * ch + ref.numel()))[0] * 1e3
    print(f"== B{4 if m == 1 else 5} {label} ({b}, {t}, {ch}{f'→{g}' if m == 2 else ''}) "
          f"k{k} pads {pads} d{dil}: bound {bound_us:.2f} us; wrapper {pick}", flush=True)
    t_out = ref.shape[1]
    times = {}
    for r in (8, 16):
        runs = -(-t_out // r)
        # time threads: whole warps (the wrapper's, None); for a whole-row item
        # also the fewest that cover it, for time tiles also 8, 16 and 32
        ntts = ((None, -(-runs // dil) * dil) if runs <= 32 else
                (None, *(-(-n // dil) * dil for n in (8, 16, 32))))
        for vc, ipb, depth, ntt in itertools.product((1, 4) if m == 1 else (4,),
                                                     (1, 2, 4, None), (2, 3), ntts):
            _time(times, label, m, b, t, ch, k, pads, dil, r, vc, ipb, depth, ntt,
                  lambda plan: launch(x, w, out, pads, dil, plan), out, ref)
    ranked = sorted(times, key=times.get)
    print("  r/vc/ntt/ipb/depth: us  " + "  ".join(
        f"{'/'.join(map(str, key))}: {times[key]:.2f}" for key in ranked), flush=True)
    mine = (pick.r, pick.vc, pick.ntt, pick.ipb, pick.depth)
    best = ranked[0]
    print(f"B{4 if m == 1 else 5} {label}: wrapper's pick {'/'.join(map(str, mine))} "
          f"{times[mine]:.2f} us ({bound_us / times[mine]:.0%} of bound), best "
          f"{'/'.join(map(str, best))} {times[best]:.2f} us "
          f"({times[mine] / times[best] - 1.0:+.1%})", flush=True)
    wc = w.contiguous()  # the strided weight read against a contiguous one, at the pick
    view_us = c.device_ms(lambda: launch(x, w, out, pads, dil, pick)) * 1e3
    contig_us = c.device_ms(lambda: launch(x, wc, out, pads, dil, pick)) * 1e3
    if not torch.equal(out, ref):
        c.fail(f"B{4 if m == 1 else 5} {label}: a contiguous weight changes the result")
    print(f"B{4 if m == 1 else 5} {label}: at the pick, weight view {view_us:.2f} us, "
          f"contiguous {contig_us:.2f} us ({view_us / contig_us - 1.0:+.1%})", flush=True)


def sweep_b4_bf16(dev, parent: str | None) -> None:
    import torch.nn.functional as F

    from audiojax_torch.ops import dwconv_cuda as D

    shapes = [[list(shape), k, list(pads), dil] for _, shape, k, pads, dil in B4_BF16]
    old = [parent_times(parent, OLD_B4, shapes)] if parent else []
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, (b, t, ch), k, pads, dil in B4_BF16:
        x32 = torch.randn((b, t, ch), generator=gen, device=dev)
        w32 = (torch.randn((ch, 1, k), generator=gen, device=dev) / k ** 0.5)[:, 0, :].t()
        x, w = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        ref = D.dwconv1d_cuda(x, w, pads=pads, dilation=dil)
        want = D.dwconv1d_plain(x, w, pads=pads, dilation=dil).float()
        if not bool(((ref.float() - want).abs() <= c.BF16_ULP * want.abs() + 1e-6).all()):
            c.fail(f"B4 bf16 {label}: the wrapper parts from plain by more than one bf16 ulp")
        pick = D.dwconv_plan(b, t, ch, k, *pads, dil, 1, esize=2)
        if not isinstance(pick, D.DwconvMmaLaunch):
            c.fail(f"B4 bf16 {label}: a served shape off the tensor-core route")
        out = torch.empty_like(ref)
        xt = F.pad(x.transpose(1, 2), pads).contiguous()
        wt = w.t().contiguous()[:, None, :]
        others = {
            "plain": c.device_ms(lambda: D.dwconv1d_plain(x, w, pads=pads, dilation=dil)) * 1e3,
            "cuDNN bf16": c.device_ms(lambda: F.conv1d(xt, wt, dilation=dil, groups=ch)) * 1e3,
            "float32 kernel": c.device_ms(lambda: D.dwconv1d_cuda(x32, w32, pads=pads,
                                                                  dilation=dil)) * 1e3,
        }
        bound_us = c.bound(0.0, 2.0 * (b * t * ch + k * ch + ref.numel()),
                           bf16_flops=2.0 * ref.numel() * k)[0] * 1e3
        print(f"== B4 bf16 {label} ({b}, {t}, {ch}) k{k} pads {pads} d{dil}: bound "
              f"{bound_us:.2f} us; " + ", ".join(f"{n} {us:.2f} us" for n, us in others.items())
              + f"; wrapper {pick}", flush=True)
        times = {}
        tried = itertools.product((1, 2, 4, 8, 16, 32), D.MMA_DEPTHS)
        for ipb, depth in [(pick.ipb, pick.depth), *tried]:
            plan = D.dwconv_mma_launch(b, t, ch, k, *pads, dil, ipb=ipb, depth=depth)
            key = (plan.ipb, plan.depth)
            if key in times or plan.smem > D.SMEM_MAX:
                continue
            times[key] = c.device_ms(lambda: D.launch_dwconv1d(x, w, out, pads, dil, plan)) * 1e3
            if not torch.equal(out, ref):
                c.fail(f"B4 bf16 {label} {key}: differs from the wrapper's result")
        ranked = sorted(times, key=times.get)
        print("  ipb/depth: us  " + "  ".join(
            f"{'/'.join(map(str, key))}: {times[key]:.2f}" for key in ranked), flush=True)
        mine = (pick.ipb, pick.depth)
        best = ranked[0]
        print(f"B4 bf16 {label}: wrapper's pick {'/'.join(map(str, mine))} {times[mine]:.2f} us "
              f"({bound_us / times[mine]:.0%} of bound), best {'/'.join(map(str, best))} "
              f"{times[best]:.2f} us ({times[mine] / times[best] - 1.0:+.1%})", flush=True)
        rows.append((label, times[mine], others))
        del x32, w32, x, w, ref, want, out, xt, wt
    if parent:
        old.append(parent_times(parent, OLD_B4, shapes))
    for i, (label, new_us, others) in enumerate(rows):
        was = " / ".join(f"{t[i]:.2f}" for t in old) if old else "not measured"
        print(f"B4 bf16 {label}: new {new_us:.2f} us; parent tree {was} us (before / after); "
              + ", ".join(f"{n} {us:.2f}" for n, us in others.items()), flush=True)


# an earlier tree's B5 bf16 at the shapes in argv[1] (the model's (G, 2, k)
# weight seen as (k, 2, G), as nn/core.py passes it)
OLD_B5 = r"""
import json, sys, torch
import chip_smoke as c
from audiojax_torch.ops import dwconv_cuda as D
dev = torch.device("cuda")
times = []
for (b, t, ch), k, pads, dil in json.loads(sys.argv[1]):
    x = torch.randn((b, t, ch), device=dev).to(torch.bfloat16)
    w = (torch.randn((ch // 2, 2, k), device=dev) / (2 * k) ** 0.5).to(torch.bfloat16)
    w = w.permute(2, 1, 0)
    times.append(c.device_ms(lambda: D.dwconv1d_grouped_cuda(x, w, pads=tuple(pads),
                                                             dilation=dil)) * 1e3)
print(json.dumps(times))
"""


def sweep_b5_bf16(dev, parent: str | None) -> None:
    """B5 bf16 on the tensor cores (``csrc/dwconv_bf16.cu``, two lanes a
    group) at MossFormer2-SS's 6 s shape: the plan at 1 to 32 items a block
    and each ring depth, every result equal to the wrapper's bit for bit and
    the wrapper's within one bf16 ulp of the plain version; beside it the
    plain version, cuDNN's bf16 grouped conv, the float32 instance and the
    parent tree's kernel."""
    import torch.nn.functional as F

    from audiojax_torch.ops import dwconv_cuda as D

    cases = c.six_s(c.B5_SS_CASES)
    shapes = [[list(shape), k, list(pads), dil] for _, shape, k, pads, dil in cases]
    old = [parent_times(parent, OLD_B5, shapes)] if parent else []
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, (b, t, ch), k, pads, dil in cases:
        g = ch // 2
        x32 = torch.randn((b, t, ch), generator=gen, device=dev)
        w32 = (torch.randn((g, 2, k), generator=gen, device=dev) / (2 * k) ** 0.5).permute(2, 1, 0)
        x, w = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        ref = D.dwconv1d_grouped_cuda(x, w, pads=pads, dilation=dil)
        want = D.dwconv1d_grouped_plain(x, w, pads=pads, dilation=dil).float()
        if not bool(((ref.float() - want).abs() <= c.BF16_ULP * want.abs() + 1e-6).all()):
            c.fail(f"B5 bf16 {label}: the wrapper parts from plain by more than one bf16 ulp")
        pick = D.dwconv_plan(b, t, ch, k, *pads, dil, 2, esize=2)
        if not isinstance(pick, D.DwconvMmaLaunch):
            c.fail(f"B5 bf16 {label}: a served shape off the tensor-core route")
        out = torch.empty_like(ref)
        xt = F.pad(x.transpose(1, 2), pads).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        others = {
            "plain": c.device_ms(lambda: D.dwconv1d_grouped_plain(x, w, pads=pads,
                                                                  dilation=dil)) * 1e3,
            "cuDNN bf16": c.device_ms(lambda: F.conv1d(xt, wt, dilation=dil, groups=g)) * 1e3,
            "float32 kernel": c.device_ms(lambda: D.dwconv1d_grouped_cuda(
                x32, w32, pads=pads, dilation=dil)) * 1e3,
        }
        bound_us = c.bound(0.0, 2.0 * (b * t * ch + k * ch + ref.numel()),
                           bf16_flops=2.0 * ref.numel() * 2 * k)[0] * 1e3
        print(f"== B5 bf16 {label} ({b}, {t}, {ch}→{g}) k{k} pads {pads} d{dil}: bound "
              f"{bound_us:.2f} us; " + ", ".join(f"{n} {us:.2f} us" for n, us in others.items())
              + f"; wrapper {pick}", flush=True)
        times = {}
        tried = itertools.product((1, 2, 4, 8, 16, 32), D.MMA_DEPTHS)
        for ipb, depth in [(pick.ipb, pick.depth), *tried]:
            plan = D.dwconv_mma_launch(b, t, ch, k, *pads, dil, 2, ipb=ipb, depth=depth)
            key = (plan.ipb, plan.depth)
            if key in times or plan.smem > D.SMEM_MAX:
                continue
            times[key] = c.device_ms(lambda: D.launch_dwconv1d_grouped(x, w, out, pads, dil,
                                                                       plan)) * 1e3
            if not torch.equal(out, ref):
                c.fail(f"B5 bf16 {label} {key}: differs from the wrapper's result")
        ranked = sorted(times, key=times.get)
        print("  ipb/depth: us  " + "  ".join(
            f"{'/'.join(map(str, key))}: {times[key]:.2f}" for key in ranked), flush=True)
        mine = (pick.ipb, pick.depth)
        best = ranked[0]
        print(f"B5 bf16 {label}: wrapper's pick {'/'.join(map(str, mine))} {times[mine]:.2f} us "
              f"({bound_us / times[mine]:.0%} of bound), best {'/'.join(map(str, best))} "
              f"{times[best]:.2f} us ({times[mine] / times[best] - 1.0:+.1%})", flush=True)
        rows.append((label, times[mine], others))
        del x32, w32, x, w, ref, want, out, xt, wt
    if parent:
        old.append(parent_times(parent, OLD_B5, shapes))
    for i, (label, new_us, others) in enumerate(rows):
        was = " / ".join(f"{t[i]:.2f}" for t in old) if old else "not measured"
        print(f"B5 bf16 {label}: new {new_us:.2f} us; parent tree {was} us (before / after); "
              + ", ".join(f"{n} {us:.2f}" for n, us in others.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dwconv_geometry_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    c.build_all()
    if "--bf16-only" not in args:
        gen = torch.Generator(device=dev).manual_seed(3)
        served = [case for case in c.B4_CASES if case[4] == 1] + c.B4_SS_CASES
        for label, (b, t, ch), k, pads, dil in served:
            _sweep(label, 1, b, t, ch, k, pads, dil, gen, dev)
        for label, (b, t, ch), k, pads, dil in c.B5_SS_CASES:
            _sweep(label, 2, b, t, ch, k, pads, dil, gen, dev)
    sweep_b4_bf16(dev, parent)
    sweep_b5_bf16(dev, parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
