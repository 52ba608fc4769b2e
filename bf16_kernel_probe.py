#!/usr/bin/env python3
"""Where the bf16 tensor-core kernels' time goes (B6 ``quad_attention_bf16.cu``,
B4 and B5 ``dwconv_bf16.cu``, B3 ``relpos_scores_bf16.cu``), on one card.

    python3 bf16_kernel_probe.py [--parent DIR]

Two kinds of variants of each source, built by text edits through
``_build.load_source`` into ``audiojax_torch/_build/`` and launched through
the modules' own plans (``quad_bf16_launch``, ``dwconv_mma_launch``,
``relpos_bf16_launch``):

- a part switched off (its loop bound made zero by a condition the compiler
  cannot fold): B6 without its PV product, its score product, its copies or
  its stores; B4 and B5 without their copies, products, stores or
  transposes; B3 without its pe staging, its copies, its products, its
  softmax, its stores to the shared run or its stores to device memory.
  Each is timed at the served shapes (µs, CUDA events behind a spin kernel,
  median of 20; ``chip_smoke.device_ms``) beside the whole kernel.  The
  variants compute garbage: they are timed, not checked.
- clock64 marks at the phase boundaries of each block's loop (thread 0 of
  each block, summed by atomicAdd): B6's cycles a piece in the wait for its
  copies and the barrier, the issue of the next piece's copies, the scores
  and the PV product; B4's and B5's cycles a work item in the wait and
  barriers, the transposes, the next item's copies, the products and the
  stores; B3's cycles a batch row in the wait and barrier, the next row's
  copies, the products, the softmax, the stores to the shared run and the
  run's write, and a block's prologue (its pe rows).

With ``--parent DIR`` (an unpacked earlier tree of this repository whose
``csrc/relpos_scores.cu`` holds the FFMA kernel's bf16 instance,
``ajt_relpos_batched_bf16``), that kernel too, at ZipEnhancer's two largest
shapes, whole and without its products, its bias, its exponentials, its
stores or its pe staging.

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
    "no products": [("for (int ks = 0; ks < KS; ++ks)\n",
                     "for (int ks = 0; ks < (a.k < 0 ? KS : 0); ++ks)\n")],
    "no stores": [("if (t < a.t_out && ", "if (t < 0 && ")],
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
    ("    __syncthreads();\n    if constexpr (M == 1) {\n      // 4. write",
     "    __syncthreads();\n    PH(4);\n    if constexpr (M == 1) {\n      // 4. write"),
]
B3_PARTS = {
    "no pe staging": [("  for (int p = 0; p < a.P; ++p) {\n    const bf16* src = a.pe",
                       "  for (int p = 0; p < (a.N < 0 ? a.P : 0); ++p) {\n    const bf16* src = a.pe")],
    "no copies": [("    stage_rows(ks, KS,", "    if (a.N < 0) stage_rows(ks, KS,"),
                  ("    stage_rows(qs, KS,", "    if (a.N < 0) stage_rows(qs, KS,"),
                  ("    for (int r = tid; r < R; r += blockDim.x)\n      cp_async<8>",
                   "    for (int r = tid; r < (a.N < 0 ? R : 0); r += blockDim.x)\n      cp_async<8>")],
    "no products": [("for (int j2 = 0; j2 < kKT; j2 += 2) {",
                     "for (int j2 = 0; j2 < (a.N < 0 ? kKT : 0); j2 += 2) {")],
    "no softmax": [("      for (int j = 0; j < kKT; ++j) {\n        if (j >= nt) break;\n"
                    "        acc[j][0] = __expf(",
                    "      for (int j = 0; j < (a.N < 0 ? kKT : 0); ++j) {\n        if (j >= nt) "
                    "break;\n        acc[j][0] = __expf(")],
    "no run stores": [("        if (key < S) {", "        if (key < S && a.N < 0) {"),
                      ("        if (key + 1 < S) {", "        if (key + 1 < S && a.N < 0) {")],
    "no device stores": [("c < (end + 7) / 8; c += 32 * a.kw) {",
                          "c < (a.N < 0 ? (end + 7) / 8 : 0); c += 32 * a.kw) {")],
}
B3_CLOCK = [  # phases: 6 prologue, 1 wait + barrier, 2 the next row's copies, 3 products,
    # 4 softmax (and the exchanges), 5 the run's stores + the row group's barrier, 0 the
    # row group's piece of the run written, and the loop
    ("  const int g = lane >> 2, tq = lane & 3;\n",
     "  const int g = lane >> 2, tq = lane & 3;\n  long long _t = clock64();\n"),
    ("  for (int n = n_lo; n < n_hi; ++n) {\n    const int cur = (n - n_lo) & 1;\n",
     "  PH(6);\n  for (int n = n_lo; n < n_hi; ++n) {\n    const int cur = (n - n_lo) & 1;\n"
     "    PH(0);\n"),
    ("    __syncthreads();  // everyone's; the previous row's buffer and output run are free\n",
     "    __syncthreads();  // everyone's; the previous row's buffer and output run are free\n"
     "    PH(1);\n"),
    ("    cp_commit();\n\n    float acc[kKT][4];", "    cp_commit();\n    PH(2);\n\n    float acc[kKT][4];"),
    ("      // keys past S to -inf", "      PH(3);\n      // keys past S to -inf"),
    ("    // batch row n's run of out:", "    PH(4);\n    // batch row n's run of out:"),
    ("      bar_group(rg, a.kw);\n      const int beg",
     "      bar_group(rg, a.kw);\n      PH(5);\n      const int beg"),
]
# the parent's FFMA kernel (relpos_batched_kernel<NJ, bf16>)
OLD_B3_PARTS = {
    "no products": [("for (int d = 0; d < d4; d += 4) {", "for (int d = 0; d < (a.N < 0 ? d4 : 0); d += 4) {")],
    "no bias": [("      for (int p = 0; p < a.P; ++p) {\n#pragma unroll\n        for (int r = 0; r < 4; ++r) {\n"
                 "          const float w = widen(",
                 "      for (int p = 0; p < (a.N < 0 ? a.P : 0); ++p) {\n#pragma unroll\n        for (int r = 0; "
                 "r < 4; ++r) {\n          const float w = widen(")],
    "no expf": [("acc[r][t] = expf(acc[r][t] - m[r]);", "acc[r][t] = acc[r][t] - m[r];")],
    "no stores": [("if (t * 32 + lane < a.S) store_cs(", "if (t * 32 + lane < 0) store_cs(")],
    "no pe staging": [("  stage_pe<NJ>(a, a.pe", "  if (a.N < 0) stage_pe<NJ>(a, a.pe")],
}


def variant(src: str, edits: list, clock: bool = False) -> str:
    for old, new in edits:
        if old not in src:
            c.fail(f"bf16_kernel_probe: the source no longer holds {old!r}")
        src = src.replace(old, new)
    if clock:
        src = src.replace("namespace {\n", "namespace {\n" + CLOCK_HEAD, 1) + CLOCK_TAIL
    return src


def build_variants(prefix: str, src: str, parts: dict, clock_edits=None) -> dict:
    """The whole source, each part switched off and (with ``clock_edits``)
    the clock variant, built together (one nvcc each, all started at once)."""
    from concurrent.futures import ThreadPoolExecutor

    from audiojax_torch.ops import _build

    texts = {"whole kernel": src, **{name: variant(src, edits) for name, edits in parts.items()}}
    if clock_edits is not None:
        texts["clock"] = variant(src, clock_edits, clock=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: _build.load_source(prefix + kv[0].replace(" ", "_"), kv[1]),
            texts.items())))
    return libs


def probe_b6(dev) -> None:
    from audiojax_torch.ops import _build
    from audiojax_torch.ops import attention_cuda as A

    src = (_build.CSRC / "quad_attention_bf16.cu").read_text()
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = build_variants("probe_b6_", src, B6_PARTS, B6_CLOCK)
    for lib in libs.values():
        lib.ajt_quad_attention_bf16_f32.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i,
                                                    i, i, i, i, i, ctypes.c_longlong, p]
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


def _clock(lib, run, what: str, parts: str, count: int) -> None:
    """Thread 0's cycles of each phase of a clock variant's one run, a unit."""
    lib.probe_reset()
    run(lib)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.probe_read(buf)
    print(f"{what}: " + ", ".join(f"{name} {buf[i] / count:.0f}" for i, name in parts),
          flush=True)


def probe_b4(dev) -> None:
    """B4 at the GAN's and SS's shapes, and B5 (the same kernel, two lanes a
    group) at SS's, by the same variants."""
    from audiojax_torch.ops import _build
    from audiojax_torch.ops import dwconv_cuda as D

    src = (_build.CSRC / "dwconv_bf16.cu").read_text()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build_variants("probe_b4_", src, B4_PARTS, B4_CLOCK)
    for lib in libs.values():
        lib.ajt_dwconv1d_mma_bf16.argtypes = [p, p, p] + [i] * 7 + [ll] * 2 + [i] * 6 + [ll, p]
        lib.ajt_dwconv1d_grouped2_mma_bf16.argtypes = ([p, p, p] + [i] * 7 + [ll] * 3
                                                       + [i] * 6 + [ll, p])
    cases = (((964, 98, 256), 31, (15, 15), 1, 1), ((4, 3999, 2176), 17, (8, 8), 1, 1),
             ((4, 3999, 512), 39, (38, 38), 2, 2))
    for (b, t, ch), k, pads, dil, m in cases:
        x = torch.randn((b, t, ch), device=dev).to(torch.bfloat16)
        t_out = t + sum(pads) - dil * (k - 1)
        g = D.dwconv_mma_launch(b, t, ch, k, *pads, dil, m)
        if m == 1:
            w = (torch.randn((ch, 1, k), device=dev) / k ** 0.5).to(torch.bfloat16)[:, 0, :].t()
            y = torch.empty((b, t_out, ch), device=dev, dtype=torch.bfloat16)
        else:
            w = (torch.randn((ch // 2, 2, k), device=dev) / (2 * k) ** 0.5).to(torch.bfloat16)
            w = w.permute(2, 1, 0)
            y = torch.empty((b, t_out, ch // 2), device=dev, dtype=torch.bfloat16)

        def run(lib):
            fn = lib.ajt_dwconv1d_mma_bf16 if m == 1 else lib.ajt_dwconv1d_grouped2_mma_bf16
            return fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, t, ch, k, *pads, dil,
                      *w.stride(), g.ks, g.ipr, g.ipb, g.depth, *g.grid, g.smem,
                      torch.cuda.current_stream().cuda_stream)

        what = f"B{4 if m == 1 else 5} bf16 ({b}, {t}, {ch}) k{k} d{dil}"
        times = {name: c.device_ms(lambda: run(lib)) * 1e3 for name, lib in libs.items()
                 if name != "clock"}
        print(f"{what} at {g}: us " + ", ".join(f"{name} {us:.1f}" for name, us in times.items()),
              flush=True)
        _clock(libs["clock"], run, f"{what} cycles an item (block's thread 0)",
               ((1, "barrier"), (2, "wait + barrier"), (3, "transposes"),
                (5, "next item's copies + barrier"), (4, "products"), (0, "stores and loop")),
               g.items * g.grid[1])


def _b3_inputs(dev, n: int, s: int):
    """ZipEnhancer's B3 inputs in bf16: q, k, pp lane slices of one
    projection, H 4, D 32, P 4; an output of bf16 probabilities."""
    proj = (0.5 * torch.randn((n, s, 288), device=dev)).to(torch.bfloat16)
    pe = (0.5 * torch.randn((4, 4, s, s), device=dev)).to(torch.bfloat16)
    out = torch.empty((n, 4, s, s), device=dev, dtype=torch.bfloat16)
    return proj[..., :128], proj[..., 128:256], proj[..., 256:], pe, out


B3_SHAPES = ((964, 101), (404, 241))  # ZipEnhancer's two largest bf16 shapes


def probe_b3(dev) -> None:
    from audiojax_torch.ops import _build
    from audiojax_torch.ops import attention_cuda as A

    src = (_build.CSRC / "relpos_scores_bf16.cu").read_text()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build_variants("probe_b3_", src, B3_PARTS, B3_CLOCK)
    for lib in libs.values():
        lib.ajt_relpos_mma_bf16.argtypes = [p, p, p, p, p] + [i] * 6 + [ll] * 3 + [i] * 5 + [ll, p]
    for n, s in B3_SHAPES:
        q, k, pp, pe, out = _b3_inputs(dev, n, s)
        g = A.relpos_bf16_launch(n, s, 4, 32, 4)

        def run(lib):
            return lib.ajt_relpos_mma_bf16(
                q.data_ptr(), k.data_ptr(), pp.data_ptr(), pe.data_ptr(), out.data_ptr(), n, s, 4,
                32, 4, 8, q.stride(1), k.stride(1), pp.stride(1), g.wr, g.kw, g.row_tiles, g.nb,
                g.chunks, g.smem, torch.cuda.current_stream().cuda_stream)

        times = {name: c.device_ms(lambda: run(lib)) * 1e3 for name, lib in libs.items()
                 if name != "clock"}
        print(f"B3 bf16 ({n}, {s}) at {g}: us " + ", ".join(
            f"{name} {us:.1f}" for name, us in times.items()), flush=True)
        _clock(libs["clock"], run, f"B3 bf16 ({n}, {s}) cycles a batch row (block's thread 0)",
               ((1, "wait + barrier"), (2, "next row's copies"), (3, "products"),
                (4, "softmax"), (5, "run stores + barrier"), (0, "run write and loop")),
               g.blocks * g.nb)
        _clock(libs["clock"], run, f"B3 bf16 ({n}, {s}) cycles a block's prologue",
               ((6, "zeros, pe rows, first copies"),), g.blocks)


def _old_b3_plan(n: int, s: int, h: int, d: int, n_pos: int) -> tuple:
    """(nj, rows, nb, smem) of the FFMA kernel's bf16 instance as its tree
    planned it (``relpos_launch(…, esize=2)`` there, S ≤ 256)."""
    cd = lambda a, b: -(-a // b)  # noqa: E731
    nj = 1 << max(0, (cd(s, 32) - 1).bit_length())

    def smem_of(r: int) -> int:
        buf = cd(((32 * nj + r) * (cd(d, 8) * 8 + 4) + r * n_pos) * 2, 16) * 16
        return 4 * n_pos * r * 32 * nj + 2 * buf

    r = 16 if nj == 4 else cd(cd(s, cd(s, 32)), 4) * 4
    while r > 4 and smem_of(r) > 232448:
        r -= 4
    smem = smem_of(r)
    per_sm = max(1, min(233472 // (smem + 1024), 2048 // (8 * r)))
    nb = cd(n, max(1, min(n, 132 * per_sm // (h * cd(s, r)))))
    return nj, r, nb, smem


def probe_old_b3(dev, parent: str) -> None:
    from pathlib import Path

    src = (Path(parent) / "audiojax_torch" / "csrc" / "relpos_scores.cu").read_text()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build_variants("probe_old_b3_", src, OLD_B3_PARTS)
    for lib in libs.values():
        lib.ajt_relpos_batched_bf16.argtypes = ([p, p, p, p, p] + [i] * 6 + [ll] * 3 + [i] * 3
                                                + [ll, p])
    for n, s in B3_SHAPES:
        q, k, pp, pe, out = _b3_inputs(dev, n, s)
        nj, rows, nb, smem = _old_b3_plan(n, s, 4, 32, 4)

        def run(lib):
            return lib.ajt_relpos_batched_bf16(
                q.data_ptr(), k.data_ptr(), pp.data_ptr(), pe.data_ptr(), out.data_ptr(), n, s, 4,
                32, 4, 8, q.stride(1), k.stride(1), pp.stride(1), nj, rows, nb, smem,
                torch.cuda.current_stream().cuda_stream)

        if run(libs["whole kernel"]) != 0:
            c.fail(f"the parent's B3 bf16 did not launch at ({n}, {s})")
        times = {name: c.device_ms(lambda: run(lib)) * 1e3 for name, lib in libs.items()}
        print(f"parent's B3 bf16 (FFMA, {parent}) ({n}, {s}) nj {nj} rows {rows} nb {nb}: us "
              + ", ".join(f"{name} {us:.1f}" for name, us in times.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_kernel_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    if parent:
        probe_old_b3(dev, parent)
    probe_b3(dev)
    probe_b4(dev)
    probe_b6(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
