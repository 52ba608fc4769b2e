#!/usr/bin/env python3
"""Where B4's and B5's time goes, on one card: variants of ``csrc/dwconv.cu``.

    python3 dwconv_probe.py

Builds the kernel source as it is and with one part switched off by text
edits: no strip loads (the FMA loop and the stores run on whatever shared
memory holds), and no FMA loop (the loads and the stores only).  Each is
timed at a few serving shapes at the wrapper's plan (µs, CUDA events behind
a spin kernel, median of 20; ``chip_smoke.device_ms``), beside a device copy
of x of the same bytes.  The variants compute garbage: they are timed, not
checked.  Then a loop of FFMAs on registers alone is timed with each pair of
non-reused sources in the same register bank, and in opposite banks
(TFLOP/s).  Every build goes through ``_build.load_source`` into
``audiojax_torch/_build/``, and every launch through ``dwconv_cuda``'s own
binding of the library it launches on.  Without CUDA it exits 1.
"""
from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as c

EDITS = {  # variant: the (text in csrc/dwconv.cu, its replacement) pairs
    "no loads": [("const int count = (span - it.first) * kCopies;",
                  "const int count = a.k < 0 ? (span - it.first) * kCopies : 0;")],
    "no FMA loop": [("      if (row_stationary) {", "      if (row_stationary && a.k < 0) {"),
                    ("        int i0 = 0;\n        for (; i0 + R <= a.k;",
                     "        int i0 = a.k;\n        for (; i0 + R <= a.k;")],
}
SHAPES = [  # (label, M, (B, T, C), k, pads, dilation), from chip_smoke.py
    ("GAN intra uv", 1, (964, 98, 256), 31, (15, 15), 1),
    ("GAN inter uv", 1, (404, 238, 256), 31, (15, 15), 1),
    ("SS flash in_conv", 1, (4, 3999, 2176), 17, (8, 8), 1),
    ("SS mem_stack[0]", 1, (4, 3999, 256), 39, (19, 19), 1),
    ("SS mem_stack[1] (B5)", 2, (4, 3999, 512), 39, (38, 38), 2),
]
# acc[j] += x[j] * w on registers: the x and acc quads pair component for
# component (same bank) or rotated by one (opposite banks); w is reused
BANKS_CU = r"""
template <bool ROT>
__global__ void ffma_loop(const float4* in, float4* out, int iters, float4 w) {
  float4 x[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = in[(threadIdx.x + j) % 64];
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = ROT ? make_float4(x[j].y, x[j].z, x[j].w, x[j].x) : x[j];
      acc[j].x = fmaf(v.x, w.x, acc[j].x);
      acc[j].y = fmaf(v.y, w.y, acc[j].y);
      acc[j].z = fmaf(v.z, w.z, acc[j].z);
      acc[j].w = fmaf(v.w, w.w, acc[j].w);
    }
    w.x += 1e-7f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(blockIdx.x * blockDim.x + threadIdx.x) * 8 + j] = acc[j];
}
extern "C" int ffma_loop_run(int rot, const float* in, float* out, int blocks, int threads,
                             int iters, void* stream) {
  const float4 w = make_float4(0.5f, 0.25f, 0.125f, 0.0625f);
  if (rot) {
    ffma_loop<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float4*)in, (float4*)out, iters, w);
  } else {
    ffma_loop<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float4*)in, (float4*)out, iters, w);
  }
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("dwconv_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device
    from audiojax_torch.ops import _build as B
    from audiojax_torch.ops import dwconv_cuda as D

    dev = resolve_device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    src = (B.CSRC / "dwconv.cu").read_text()
    sources = {"as is": src}
    for name, edits in EDITS.items():
        sources[name] = src
        for old, new in edits:
            if old not in src:
                c.fail(f"{name}: an edit no longer matches csrc/dwconv.cu")
            sources[name] = sources[name].replace(old, new)
    with ThreadPoolExecutor(len(sources) + 1) as pool:  # one nvcc a source, all at once
        banks = pool.submit(B.load_source, "probe_ffma_banks",
                            "#include <cuda_runtime.h>\n" + BANKS_CU)
        libs = dict(zip(sources, pool.map(
            lambda i_text: D._bind(B.load_source(f"probe_dwconv_{i_text[0]}", i_text[1])),
            enumerate(sources.values()))))
        banks = banks.result()

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, m, (b, t, ch), k, pads, dil in SHAPES:
        g = ch // m
        x = torch.randn((b, t, ch), generator=gen, device=dev)
        wt = torch.randn((g, m, k), generator=gen, device=dev)
        w = wt[:, 0, :].t() if m == 1 else wt.permute(2, 1, 0)
        t_out = t + sum(pads) - dil * (k - 1)
        out = torch.empty((b, t_out, g), device=dev)
        plan = D.dwconv_launch(b, t, ch, k, *pads, dil, m)
        fn = "ajt_dwconv1d_f32" if m == 1 else "ajt_dwconv1d_grouped2_f32"
        row = []
        for name, lib in libs.items():
            us = c.device_ms(lambda: D._launch(lib, fn, x, w, out, pads, dil, plan)) * 1e3
            row.append(f"{name} {us:.2f}")
        copy = torch.empty_like(x)
        row.append(f"copy of x {c.device_ms(lambda: copy.copy_(x)) * 1e3:.2f}")
        bound_us = c.bound(2.0 * m * b * t_out * g * k,
                           4.0 * (b * t * ch + k * ch + b * t_out * g))[0] * 1e3
        print(f"{label} ({b}, {t}, {ch}) k{k} d{dil}, bound {bound_us:.2f} us, plan r{plan.r} "
              f"vc{plan.vc} ntt{plan.ntt} ipb{plan.ipb} depth{plan.depth}: us "
              + ", ".join(row), flush=True)
        del x, out, copy

    banks.ffma_loop_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    inp = torch.randn(256, device=dev)
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4000
    res = torch.empty(blocks * threads * 32, device=dev)
    for rot, what in ((0, "same bank"), (1, "opposite banks")):
        ms = c.device_ms(lambda: banks.ffma_loop_run(rot, inp.data_ptr(), res.data_ptr(), blocks,
                                                     threads, iters, None))
        print(f"FFMA loop on registers, non-reused sources in {what}: "
              f"{2.0 * 32 * iters * blocks * threads / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
