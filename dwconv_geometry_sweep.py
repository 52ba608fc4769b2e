#!/usr/bin/env python3
"""Time the depthwise (B4) and grouped (B5) conv kernels at each plan choice, on one card.

    python3 dwconv_geometry_sweep.py

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
as a contiguous copy (the strided read's cost).  Without CUDA it exits 1.
"""
from __future__ import annotations

import itertools
import sys

import torch

import chip_smoke as c


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


def main() -> int:
    if not torch.cuda.is_available():
        print("dwconv_geometry_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    c.build_all()
    gen = torch.Generator(device=dev).manual_seed(3)
    served = [case for case in c.B4_CASES if case[4] == 1] + c.B4_SS_CASES
    for label, (b, t, ch), k, pads, dil in served:
        _sweep(label, 1, b, t, ch, k, pads, dil, gen, dev)
    for label, (b, t, ch), k, pads, dil in c.B5_SS_CASES:
        _sweep(label, 2, b, t, ch, k, pads, dil, gen, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
