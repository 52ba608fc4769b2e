#!/usr/bin/env python3
"""Latency of one served model's 6 s request, and of its depthwise conv layers, on one card.

    python3 serve_latency.py [--model zipenhancer] [--mix] [--root DIR]

Imports ``audiojax_torch`` from ``--root`` (default: this checkout), so that
two trees can be compared in one call to the card: unpack the other tree
with ``git archive`` into a directory that ``.gitignore`` lists and run
them in turn, A, B, B, A.  The script's helpers come from this checkout's
``chip_smoke.py``.

1. Layers: at each depthwise (B4) and grouped (B5) conv shape of one 6 s
   forward of ``--model`` (``chip_smoke.py``'s case lists), the device time
   of ``nn.core.conv1d`` with the model's (C, M, k) weight, as the model
   calls it (µs, CUDA events behind a spin kernel, median of 20;
   ``chip_smoke.device_ms``), and its host time: µs a call over 200 calls
   issued back to back; then the kernel alone through its wrapper, with the
   weight copied beforehand into the contiguous (k, C) or (k, 2, G) layout
   that every tree's wrapper takes.
2. Serving: random parameters from seed 0, a warm-up, then the 6 s request
   (``chip_smoke.noisy_speech``, or ``speech_mix`` for MossFormer2-SS)
   20 times: elapsed ms (``Session.process``) median, quartiles,
   min and max.  With ``--mix`` each 6 s request follows a 30 s one, in the
   order ``chip_smoke.py``'s serving phases take them.

Without CUDA it exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as c

# (label, (B, T, C_in), k, (lo, hi), dilation, lanes a group) of one 6 s forward
LAYERS = {
    "zipenhancer": [(label, shape, k, pads, dil, 1) for label, shape, k, pads, dil in c.B4_CASES
                    if label in ("intra gau out_conv", "inter gau out_conv")
                    or label.startswith("zip ts")],
    "mossformergan_se": [(*case, 1) for case in c.B4_CASES[:8]],
    "mossformer2_ss": [(*case, 1) for case in c.B4_SS_CASES[:3]] + [(*c.B5_SS_CASES[0], 2)],
}
HOST_CALLS = 200
REPEATS = 20  # served 6 s requests a run


def layers(model: str, dev) -> None:
    from audiojax_torch.nn import core
    from audiojax_torch.ops import dwconv_cuda as D

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, (b, t, ch), k, pads, dil, m in LAYERS[model]:
        g = ch // m
        x = torch.randn((b, t, ch), generator=gen, device=dev)
        p = {"w": torch.randn((g, m, k), generator=gen, device=dev) / (m * k) ** 0.5}

        def call():
            return core.conv1d(p, x, padding=pads, dilation=dil, groups=g)

        dev_us = c.device_ms(call) * 1e3
        # the kernel alone, its weight already in the layout every tree's wrapper takes
        wk = p["w"][:, 0, :].t().contiguous() if m == 1 else p["w"].permute(2, 1, 0).contiguous()
        kernel = D.fast_dwconv1d if m == 1 else D.fast_dwconv1d_grouped
        ker_us = c.device_ms(lambda: kernel(x, wk, pads=pads, dilation=dil)) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        print(f"layer {label} ({b}, {t}, {ch}) k{k} d{dil}: conv1d device {dev_us:.2f} us, "
              f"host {host_us:.2f} us a call; kernel alone on a contiguous weight "
              f"{ker_us:.2f} us", flush=True)


def serve(model: str, mix: bool, card: str) -> None:
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.session import Session

    spec = registry.get(model)
    cfg = spec.make_config()
    session = Session(spec.make_module(spec.init_params(0, cfg, "cuda"), cfg),
                      spec.make_manifest(cfg), device="cuda")
    clip = c.speech_mix if model == "mossformer2_ss" else c.noisy_speech
    audio, before = clip(6 * c.SR, 21), clip(30 * c.SR, 22) if mix else None
    session.process(audio)  # warm-up: cuBLAS, cuDNN and allocator set-up
    ms = []
    for _ in range(REPEATS):
        if mix:
            session.process(before)
        ms.append(session.process(audio).elapsed_s * 1e3)
    ms = np.array(ms)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"serve {model} 6 s{' after 30 s' if mix else ''}: elapsed ms median {med:.3f} "
          f"(quartiles {q1:.3f} … {q3:.3f}, min {ms.min():.3f}, max {ms.max():.3f}, "
          f"n={REPEATS})  [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="zipenhancer", choices=sorted(LAYERS))
    ap.add_argument("--mix", action="store_true", help="a 30 s request before each 6 s one")
    ap.add_argument("--root", type=Path, default=None,
                    help="the tree to import audiojax_torch from (default: this checkout)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_latency: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import audiojax_torch
    from audiojax_torch.device import resolve_device

    card = c.card_line()
    print(f"serve_latency: audiojax_torch from {Path(audiojax_torch.__file__).parent}; "
          f"card {card}", flush=True)
    c.build_all()
    dev = resolve_device("cuda")
    layers(args.model, dev)
    serve(args.model, args.mix, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
