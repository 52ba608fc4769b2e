#!/usr/bin/env python3
"""Where the bf16 tensor-core kernels' time goes (B6 ``quad_attention_bf16.cu``,
B4 ``dwconv_bf16.cu``), on one card.

    python3 bf16_kernel_probe.py

Two kinds of variants of each source, built by text edits through
``_build.load_source`` into ``audiojax_torch/_build/`` and launched through
the modules' own plans (``quad_bf16_launch``, ``dwconv_mma_launch``):

- a part switched off (its loop bound made zero by a condition the compiler
  cannot fold): B6 without its PV product, its score product, its copies or
  its stores; B4 without its copies, its products, its stores or its
  transposes.  Each is timed at the GAN's and SS's shapes (µs, CUDA events
  behind a spin kernel, median of 20; ``chip_smoke.device_ms``) beside the
  whole kernel.  The variants compute garbage: they are timed, not checked.
- clock64 marks at the phase boundaries of each block's loop (thread 0 of
  each block, summed by atomicAdd): B6's cycles a piece in the wait for its
  copies and the barrier, the issue of the next piece's copies, the scores
  and the PV product; B4's cycles a work item in the wait and barriers, the
  transposes, the next item's copies, the products and the stores.

The card's name and power limit lead the output.  Without CUDA it exits 1.
"""
from __future__ import annotations

import ctypes
import sys

import torch

import chip_smoke as c

CLOCK_HEAD = """
__device__ unsigned long long g_ph[8];
#define PH(i) do { long long _n = clock64(); if (threadIdx.x == 0) \\
  atomicAdd(&g_ph[i], (unsigned long long)(_n - _t)); _t = _n; } while (0)
"""
CLOCK_TAIL = """
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_ph, sizeof(g_ph));
}
extern "C" int probe_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z));
}
"""
B6_PARTS = {
    "no PV product": [("for (int c4 = 0; c4 < 4; ++c4) {",
                       "for (int c4 = 0; c4 < (a.s < 0 ? 4 : 0); ++c4) {")],
    "no score product": [("for (int d = 0; d < kpad; d += 16 * kQkChain) {",
                          "for (int d = 0; d < (a.s < 0 ? kpad : 0); d += 16 * kQkChain) {")],
    "no copies": [("for (int e = threadIdx.x; e < rows * cpr; e += step) {",
                   "for (int e = threadIdx.x; e < (rows < 0 ? rows * cpr : 0); e += step) {")],
    "no stores": [("if (row < a.s) store2(", "if (row < 0) store2(")],
}
B6_CLOCK = [  # phases: 1 wait + barrier, 4 the next piece's copies, 2 the scores, 3 the PV
    # product (a piece of 64 keys: the second 32 keys' scores in 3)
    ("  for (int st = 0; st < steps; ++st) {\n",
     "  long long _t = clock64();\n  for (int st = 0; st < steps; ++st) {\n    PH(0);\n"),
    ("    if (st + 1 < steps) {\n", "    PH(1);\n    if (st + 1 < steps) {\n"),
    ("    if (!live) continue;\n", "    PH(4);\n    if (!live) continue;\n"),
    ("      // PV: four value tiles", "      PH(2);\n      // PV: four value tiles"),
    ("    if (j0 + KB >= s16) {  // the value tile's last piece: write it\n",
     "    PH(3);\n    if (j0 + KB >= s16) {\n"),
]
B4_PARTS = {
    "no copies": [("      cp_async16(smem_addr(slot",
                   "      if (a.k < 0) cp_async16(smem_addr(slot")],
    "no products": [("      for (int ks = 0; ks < KS; ++ks)\n#pragma unroll\n"
                     "        for (int j = 0;",
                     "      for (int ks = 0; ks < (a.k < 0 ? KS : 0); ++ks)\n#pragma unroll\n"
                     "        for (int j = 0;")],
    "no stores": [("      if (t < a.t_out && c0 + 8 * part < a.C)\n",
                   "      if (t < 0 && c0 + 8 * part < a.C)\n")],
    "no transposes": [("    for (int i4 = 4 * warp; i4 < W / 8 * kOct;",
                       "    for (int i4 = 4 * warp; a.k < 0 && i4 < W / 8 * kOct;")],
}
B4_CLOCK = [  # phases an item: 0 stores + loop, 1 barrier, 2 wait + barrier,
    # 3 transposes, 5 the next item's copies' issue + barrier, 4 products
    ("  for (int n = 0; n < n_items; ++n, it.next(a)) {\n    __syncthreads();  // item n-1",
     "  long long _t = clock64();\n  for (int n = 0; n < n_items; ++n, it.next(a)) {\n"
     "    PH(0);\n    __syncthreads();  // item n-1"),
    ("    cp_wait(a.depth);  // item n's rows have landed (this thread's copies)\n"
     "    __syncthreads();\n",
     "    PH(1);\n    cp_wait(a.depth);  // item n's rows have landed (this thread's copies)\n"
     "    __syncthreads();\n    PH(2);\n"),
    ("    // item n + depth - 1 into item n-1's slot, behind the transposes\n",
     "    PH(3);\n    // item n + depth - 1 into item n-1's slot, behind the transposes\n"),
    ("    __syncthreads();\n    // 3. the products", "    __syncthreads();\n    PH(5);\n"
     "    // 3. the products"),
    ("    __syncthreads();\n    // 4. write", "    __syncthreads();\n    PH(4);\n    // 4. write"),
]


def variant(src: str, edits: list, clock: bool = False) -> str:
    for old, new in edits:
        if old not in src:
            c.fail(f"bf16_kernel_probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    if clock:
        src = src.replace("namespace {\n", "namespace {\n" + CLOCK_HEAD, 1) + CLOCK_TAIL
    return src


def probe_b6(dev) -> None:
    from audiojax_torch.ops import _build
    from audiojax_torch.ops import attention_cuda as A

    src = (_build.CSRC / "quad_attention_bf16.cu").read_text()
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, edits in [("whole kernel", []), *B6_PARTS.items(), ("clock", B6_CLOCK)]:
        lib = _build.load_source("probe_b6_" + name.replace(" ", "_"),
                                 variant(src, edits, clock=name == "clock"))
        lib.ajt_quad_attention_bf16_f32.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i,
                                                    i, i, i, i, i, ctypes.c_longlong, p]
        libs[name] = lib
    for n, s, dv in ((964, 101, 128), (64, 256, 2048)):
        q, k = (torch.randn((n, s, 128), device=dev).to(torch.bfloat16) for _ in range(2))
        v = torch.randn((n, s, dv), device=dev).to(torch.bfloat16)
        out = torch.empty((n, s, dv), device=dev)
        g = A.quad_bf16_launch(n, s, 128, dv)

        def run(lib):
            return lib.ajt_quad_attention_bf16_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, s, 128, dv,
                1.0 / s, 0, g.warps, g.row_tiles, g.vsplit, g.kb, int(g.keep), g.smem,
                torch.cuda.current_stream().cuda_stream)

        times = {name: c.device_ms(lambda: run(lib)) * 1e3 for name, lib in libs.items()
                 if name != "clock"}
        print(f"B6 bf16 ({n}, {s}, K128, V{dv}) at {g}: us " + ", ".join(
            f"{name} {us:.1f}" for name, us in times.items()), flush=True)
        clock = libs["clock"]
        clock.probe_reset()
        run(clock)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        clock.probe_read(buf)
        tiles = -(-dv // A.QUAD_BF16_VT)
        pieces = g.blocks * (-(-(-(-s // 16) * 16) // g.kb)) * (-(-tiles // g.vsplit))
        print(f"B6 bf16 ({n}, {s}, K128, V{dv}) cycles a piece (block's thread 0): "
              f"wait + barrier {buf[1] / pieces:.0f}, scores {buf[2] / pieces:.0f}, next piece's "
              f"copies {buf[4] / pieces:.0f}, PV product {buf[3] / pieces:.0f}, store and loop "
              f"{buf[0] / pieces:.0f}", flush=True)


def probe_b4(dev) -> None:
    from audiojax_torch.ops import _build
    from audiojax_torch.ops import dwconv_cuda as D

    src = (_build.CSRC / "dwconv_bf16.cu").read_text()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, edits in [("whole kernel", []), *B4_PARTS.items(), ("clock", B4_CLOCK)]:
        lib = _build.load_source("probe_b4_" + name.replace(" ", "_"),
                                 variant(src, edits, clock=name == "clock"))
        lib.ajt_dwconv1d_mma_bf16.argtypes = [p, p, p] + [i] * 7 + [ll] * 2 + [i] * 6 + [ll, p]
        libs[name] = lib
    for (b, t, ch), k, pads in (((964, 98, 256), 31, (15, 15)), ((4, 3999, 2176), 17, (8, 8))):
        x = torch.randn((b, t, ch), device=dev).to(torch.bfloat16)
        w = (torch.randn((ch, 1, k), device=dev) / k ** 0.5).to(torch.bfloat16)[:, 0, :].t()
        y = torch.empty((b, t + sum(pads) - (k - 1), ch), device=dev, dtype=torch.bfloat16)
        g = D.dwconv_mma_launch(b, t, ch, k, *pads, 1)

        def run(lib):
            return lib.ajt_dwconv1d_mma_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, ch, k, *pads, 1, *w.stride(),
                g.ks, g.ipr, g.ipb, g.depth, *g.grid, g.smem,
                torch.cuda.current_stream().cuda_stream)

        times = {name: c.device_ms(lambda: run(lib)) * 1e3 for name, lib in libs.items()
                 if name != "clock"}
        print(f"B4 bf16 ({b}, {t}, {ch}) k{k} at {g}: us " + ", ".join(
            f"{name} {us:.1f}" for name, us in times.items()), flush=True)
        clock = libs["clock"]
        clock.probe_reset()
        run(clock)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        clock.probe_read(buf)
        items = g.items * g.grid[1]
        print(f"B4 bf16 ({b}, {t}, {ch}) k{k} cycles an item (block's thread 0): barrier "
              f"{buf[1] / items:.0f}, wait + barrier {buf[2] / items:.0f}, transposes "
              f"{buf[3] / items:.0f}, next item's copies + barrier {buf[5] / items:.0f}, "
              f"products {buf[4] / items:.0f}, stores and loop {buf[0] / items:.0f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_kernel_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    probe_b6(dev)
    probe_b4(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
