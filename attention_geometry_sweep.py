#!/usr/bin/env python3
"""Time the attention kernels (B6, B3) at several launch geometries, on one card.

    python3 attention_geometry_sweep.py

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
Without CUDA it exits 1.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as c

TOL_SAME_ORDER = 1e-6


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


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_geometry_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    c.build_all()
    sweep_b6(dev)
    sweep_b3(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
