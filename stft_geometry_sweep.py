#!/usr/bin/env python3
"""Time the STFT/ISTFT kernels (B1, B2) at every launch geometry, on one card.

    python3 stft_geometry_sweep.py

For each serving shape of ``chip_smoke.py``'s phase 3 (and its odd, Mel-Band
and DFSMN geometries, DFSMN's 6 s synthesis and GTCRN's stream step) this prints ``torch.stft``'s device time and then
B1's device time at each count of frames a block and B2's at each count of
hop-rows a block and frames transformed at a time (µs, CUDA events behind a
spin kernel, median of 20; ``chip_smoke.device_ms``), launched through
``ops/stft_cuda.py``'s ``launch_stft`` and ``launch_istft``.  Every result
is held to the wrapper's own within 3e-6 × max|ref|.  ``ops/stft_cuda.py``'s
``B1_POINTS`` and ``B2_POINTS`` come from these tables.  Without CUDA it
exits 1.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke as c


def main() -> int:
    if not torch.cuda.is_available():
        print("stft_geometry_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.dsp import stft as D
    from audiojax_torch.ops import stft_cuda as K

    dev = torch.device("cuda")
    print(f"card: {c.card_line()}", flush=True)
    c.build_all()
    C = D.StftConfig
    shapes = [("gan", C(400, 100, window="hamming", pad_mode="reflect"), 32, 24000),
              ("gtcrn", C(512, 256, window="hann_sqrt", pad_mode="reflect"), 16, 32000),
              ("gtcrn 1.3 s", C(512, 256, window="hann_sqrt", pad_mode="reflect"), 1, 32000),
              ("zip", C(400, 100, window="hann", pad_mode="reflect"), 4, 24000),
              ("odd", C(319, 160, window="hamming", pad_mode="constant"), 4, 16000),
              ("mel", C(2048, 441, window="hann", pad_mode="reflect"), 2, 88200),
              ("dfsmn", C(1920, 960, window="hamming_periodic", center=False), 2, 19200),
              ("dfsmn 6 s", C(1920, 960, window="hamming_periodic", center=False), 4, 96000),
              ("gtcrn stream", C(512, 256, window="hann_sqrt", pad_mode="reflect", center=False),
               8, 1280)]

    for name, cfg, b, length in shapes:
        x = torch.randn(b, length, device=dev)
        g1 = K.stft_launch(cfg, b, length)
        g2 = K.istft_launch(cfg, b, g1.n_t)
        win = D.analysis_window(cfg, dev)
        out = torch.empty((b, g1.n_t, 2 * cfg.f_bins), device=dev)
        out2 = torch.empty((b, g2.end - g2.start), device=dev)
        ref = K.stft_packed_cuda(x, cfg)
        ref2 = K.istft_packed_cuda(ref, cfg)
        m, k_seg = D.fft_plan(cfg.n_fft).m, -(-cfg.n_fft // cfg.hop)
        lib_us = c.device_ms(lambda: torch.stft(x, cfg.n_fft, cfg.hop, window=win,
                                                center=cfg.center, pad_mode=cfg.pad_mode,
                                                return_complex=True)) * 1e3
        print(f"== {name} ({b}, {length}): wrapper B1 frames {g1.frames}, B2 rows/group "
              f"{g2.rows}/{g2.group}; torch.stft {lib_us:.1f} us; radices "
              f"{D.fft_plan(cfg.n_fft).radices}", flush=True)
        res = []
        for frames in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16):
            if frames > g1.n_t or K.smem_bytes(
                    m, frames, 8, 4 * ((frames - 1) * cfg.hop + cfg.n_fft)) > K.SMEM_MAX:
                continue
            us = c.device_ms(lambda: K.launch_stft(x, cfg, out, frames)) * 1e3
            if float((out - ref).abs().max()) > 3e-6 * float(ref.abs().max()):
                c.fail(f"B1 {name} frames {frames} disagrees with the wrapper")
            res.append(f"{frames}:{us:.1f}")
        print(f"B1 {name}: frames:us", " ".join(res), flush=True)
        res = []
        for rows in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12):
            full = rows + k_seg - 1
            for group in sorted({full, min(full, 2), min(full, 4), min(full, 7)}):
                if K.smem_bytes(m, group, 16, 8 * rows * cfg.hop) > K.SMEM_MAX:
                    continue
                us = c.device_ms(lambda: K.launch_istft(ref, cfg, out2, None, g2.start,
                                                        rows, group)) * 1e3
                if float((out2 - ref2).abs().max()) > 3e-6 * float(ref2.abs().max()):
                    c.fail(f"B2 {name} rows {rows} group {group} disagrees with the wrapper")
                res.append(f"{rows}/{group}:{us:.1f}")
        print(f"B2 {name}: rows/group:us", " ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
