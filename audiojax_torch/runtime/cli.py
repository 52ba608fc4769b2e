"""Command-line serving entry point of the port.

    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.wav --device cpu --seed 3
    python -m audiojax_torch.runtime.cli --model mossformergan_se --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model zipenhancer --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model mossformer2_ss --input mix.wav --output spk.wav
        (writes spk_0.wav and spk_1.wav)
    python -m audiojax_torch.runtime.cli --list

Parameters are drawn at random from ``--seed`` (no checkpoint importer has
been ported yet).  The model runs on the card unless ``--device cpu`` is
given; without CUDA and without ``--device cpu`` the command fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="audiojax_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", help="model name: gtcrn, mossformergan_se, zipenhancer or "
                    "mossformer2_ss (see --list)")
    ap.add_argument("--input", nargs="*", default=[], help="input wav path(s)")
    ap.add_argument("--output", help="output wav path (multi-source models append _0, _1, …)")
    ap.add_argument("--seed", type=int, default=0, help="random-parameter seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--list", action="store_true", help="list registered models")
    args = ap.parse_args(argv)

    from . import registry

    if args.list:
        for n in registry.names():
            print(n)
        return 0
    if not args.model:
        ap.error("--model is required (or use --list)")
    spec = registry.get(args.model)

    from ..device import resolve_device
    from .audio_io import read_wav, resample_np, to_mono, write_wav
    from .session import Session

    device = resolve_device(args.device)
    cfg = spec.make_config()
    manifest = spec.make_manifest(cfg)
    inputs = [Path(p) for p in args.input]
    if len(inputs) != manifest.num_audio_inputs:
        print(f"{spec.name} needs {manifest.num_audio_inputs} input wav(s), got {len(inputs)}",
              file=sys.stderr)
        return 2

    audios = []
    for p in inputs:
        data, rate = read_wav(p)
        if manifest.input_channels == 1:
            data = to_mono(data)[None]
        audios.append(resample_np(data, rate, manifest.in_sample_rate))

    print(f"note: using randomly initialised {spec.name} params (seed {args.seed})",
          file=sys.stderr)
    if device.type == "cuda":
        from ..ops import _build

        for src in sorted(_build.CSRC.glob("*.cu")):  # set-up, outside the timed call
            _build.load(src.stem)
    model = spec.make_module(spec.init_params(args.seed, cfg, device), cfg)
    result = Session(model, manifest, device=device).process(*audios)

    out_base = Path(args.output) if args.output else inputs[0].with_name(
        inputs[0].stem + f".{spec.name}.wav")
    if len(result.outputs) == 1:
        paths = [write_wav(out_base, result.outputs[0], manifest.out_sample_rate)]
    else:
        paths = [write_wav(out_base.with_name(f"{out_base.stem}_{i}{out_base.suffix}"), o,
                           manifest.out_sample_rate) for i, o in enumerate(result.outputs)]
    for p in paths:
        print(f"wrote {p}")
    print(f"RTF: {result.rtf:.6f}  ({result.elapsed_s * 1e3:.2f} ms for "
          f"{result.audio_duration_s:.2f} s audio on {device}; a first call, warm-up included)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
