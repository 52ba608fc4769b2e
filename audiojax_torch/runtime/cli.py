"""Command-line serving entry point of the port.

    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.wav --device cpu --seed 3
    python -m audiojax_torch.runtime.cli --model mossformergan_se --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model zipenhancer --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model mossformer2_ss --input mix.wav --output spk.wav
        (writes spk_0.wav and spk_1.wav)
    python -m audiojax_torch.runtime.cli --model dfsmn --input noisy48k.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model mossformer2_se --input noisy48k.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model ul_unas --input noisy.wav --output clean.wav
    python -m audiojax_torch.runtime.cli --model nkf_aec --input near.wav far.wav --output out.wav
    python -m audiojax_torch.runtime.cli --model sdaec|deep_echo|dfsmn_aec --input near.wav far.wav
    python -m audiojax_torch.runtime.cli --model gtcrn --artifact art/ --input noisy.wav
    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.flac --output clean.wav
    python -m audiojax_torch.runtime.cli --model melband_roformer --artifact q8art/ --input mix.wav
    python -m audiojax_torch.runtime.cli --model zipenhancer --input noisy.wav --compute-dtype bfloat16
    python -m audiojax_torch.runtime.cli --model gtcrn --input noisy.wav --stream [--block-hops 4]
    python -m audiojax_torch.runtime.cli --model nkf_aec --input near.wav far.wav --stream
    python -m audiojax_torch.runtime.cli --model dfsmn_aec --input near.wav far.wav --stream
    python -m audiojax_torch.runtime.cli --model gtcrn --artifact jax_art/ --input noisy.wav
        (an artifact the JAX package wrote: params.msgpack)
    python -m audiojax_torch.runtime.cli --model mossformergan_se --artifact art/ --aot \
        --input noisy.wav  (the graph that export --aot wrote)
    python -m audiojax_torch.runtime.cli --list

With ``--artifact`` the command serves the weights of an artifact that
``python -m audiojax_torch.runtime.export`` wrote from an upstream checkpoint,
with the config the artifact records; ``--model`` must name the artifact's
model; an artifact exported with ``--compute-dtype`` is served in the dtype
it records, and one optimized by ``runtime.optimize`` (or ``export --plan``)
as its manifest's ``optimize`` record says: q8f32 and weight-only bf16
weights mapped to float32 at every forward (stream: once, on the host), q8dyn
as it is.  The artifact may be the JAX package's (``params.msgpack``, read
without ``msgpack``).  With ``--aot`` the artifact's ``torch.export`` graph
(``graph.pt2``, written by ``export --aot`` on the same device type) serves
the windows instead of the model code; an artifact without a graph exits 2.
Without it, parameters are drawn at random from ``--seed``.
``--compute-dtype bfloat16`` serves the bf16 plan (bf16 network, float32 DSP
islands) of the families whose config has the knob (zipenhancer,
mossformergan_se, mossformer2_ss, mossformer2_se, melband_roformer,
melband_roformer_stereo, mossformer2_sr); another model exits 2.  Inputs are
read by ``audio_io.read_audio``: WAV, FLAC (the native bridge), or any
container an ffmpeg hook decodes.  A two-input model (the echo cancellers
``nkf_aec``, ``sdaec``, ``deep_echo`` and ``dfsmn_aec``) takes two
``--input`` files, the microphone (near end) first and the far-end
reference second; a wrong
count of inputs exits 2 with the model's count.  The model runs on the card
unless ``--device cpu`` is given; without CUDA and without ``--device cpu``
the command fails.

With ``--stream`` a model that has state-carry streaming (gtcrn, dfsmn,
ul_unas, nkf_aec, sdaec, deep_echo, dfsmn_aec) is served through
``StreamingSession`` instead of windows: the whole clip is pushed, the stream
flushed, and the command prints the streaming RTF and the algorithmic latency
(one block of ``--block-hops`` hops plus the model's delay: n_fft − hop, or
2·hop for ``dfsmn_aec``).
On the card the step is one captured CUDA graph; on the CPU it runs eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="audiojax_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", help="model name: gtcrn, mossformergan_se, zipenhancer, "
                    "mossformer2_ss, dfsmn, mossformer2_se, ul_unas, nkf_aec, sdaec, "
                    "deep_echo or dfsmn_aec (see --list)")
    ap.add_argument("--input", nargs="*", default=[],
                    help="input audio path(s), WAV or FLAC: near then far for the echo cancellers")
    ap.add_argument("--output", help="output wav path (multi-source models append _0, _1, …)")
    ap.add_argument("--artifact", help="artifact dir with params.pt (or the JAX package's "
                    "params.msgpack) + manifest.json")
    ap.add_argument("--seed", type=int, default=0, help="random-parameter seed when no artifact")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--stream", action="store_true",
                    help="serve with state-carry streaming (low latency) instead of windows")
    ap.add_argument("--block-hops", type=int, default=4, help="streaming block size in hops")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                    help="activation compute dtype (bfloat16: the bf16 plan, float32 DSP "
                         "islands, of zipenhancer, mossformergan_se, mossformer2_ss, "
                         "mossformer2_se, melband_roformer[_stereo] and mossformer2_sr); an "
                         "artifact's recorded dtype unless given")
    ap.add_argument("--aot", action="store_true",
                    help="serve from the artifact's torch.export graph (graph.pt2, written by "
                         "export --aot) instead of the model code")
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
    if args.stream and spec.make_stream is None:
        streaming = [n for n in registry.names() if registry.get(n).make_stream]
        print(f"{spec.name} does not support --stream (no state-carry streaming); "
              f"streaming models: {streaming}", file=sys.stderr)
        return 2

    if args.aot:
        from . import aot

        if args.stream or not args.artifact or not aot.has_graph(args.artifact):
            print("--aot needs an --artifact containing a serialized graph (export with "
                  "`python -m audiojax_torch.runtime.export … --aot`), and serves windows, "
                  "not --stream", file=sys.stderr)
            return 2

    from ..device import resolve_device
    from .audio_io import read_audio, resample_np, to_mono, write_wav
    from .checkpoint import load_artifact
    from .manifest import Manifest
    from .optimize import materialize_params, wrap_forward
    from .session import Session

    device = resolve_device(args.device)
    cfg = spec.make_config()
    if args.artifact:
        manifest = Manifest.load(Path(args.artifact) / "manifest.json")
        if manifest.model_name != spec.name:
            print(f"artifact was exported for model {manifest.model_name!r} but --model is "
                  f"{spec.name!r}; refusing to serve with mixed geometry", file=sys.stderr)
            return 2
        recorded = manifest.extra.get("activation_compute_dtype")
        try:
            cfg = registry.config_from_manifest(spec, manifest)  # the exported config exactly
            if recorded and not args.compute_dtype:  # the dtype the artifact was exported for
                if not registry.has_compute_dtype(cfg):
                    print(f"artifact records activation_compute_dtype={recorded!r} but "
                          f"{spec.name} has no compute_dtype knob; refusing to serve with a "
                          "different dtype than exported", file=sys.stderr)
                    return 2
                cfg = dataclasses.replace(cfg, compute_dtype=recorded)
        except ValueError as e:  # a compute dtype the config does not know
            print(f"artifact {args.artifact}: {e}", file=sys.stderr)
            return 2
    else:
        manifest = spec.make_manifest(cfg)
    if args.compute_dtype:
        if not registry.has_compute_dtype(cfg):
            print(f"{spec.name} has no compute_dtype knob; see --compute-dtype in --help",
                  file=sys.stderr)
            return 2
        try:
            cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        except ValueError as e:
            print(f"{spec.name}: {e}", file=sys.stderr)
            return 2
    inputs = [Path(p) for p in args.input]
    if len(inputs) != manifest.num_audio_inputs:
        print(f"{spec.name} needs {manifest.num_audio_inputs} input wav(s), got {len(inputs)}",
              file=sys.stderr)
        return 2

    audios = []
    for p in inputs:
        data, rate = read_audio(p)
        if manifest.input_channels == 1:
            data = to_mono(data)[None]
        audios.append(resample_np(data, rate, manifest.in_sample_rate))

    if device.type == "cuda":
        from ..ops import _build

        for src in sorted(_build.CSRC.glob("*.cu")):  # set-up, outside the timed call
            _build.load(src.stem)
    if args.artifact:
        params, _ = load_artifact(args.artifact, device)
    else:
        print(f"note: no --artifact given; using randomly initialised {spec.name} params "
              f"(seed {args.seed})", file=sys.stderr)
        params = spec.init_params(args.seed, cfg, device)
    if args.stream:
        # a stream builds its step from the spec: an optimized tree is mapped once
        return _stream(spec, materialize_params(params, manifest), cfg, manifest, audios, inputs,
                       args, device)
    if args.aot:  # the plan's view is inside the graph
        model = aot.load_compiled(args.artifact, aot.prepare_for_graph(params, args.artifact))
    else:
        model = wrap_forward(spec.make_module(params, cfg), manifest)
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
    dtype = getattr(cfg, "compute_dtype", "float32")
    print(f"RTF: {result.rtf:.6f}  ({result.elapsed_s * 1e3:.2f} ms for "
          f"{result.audio_duration_s:.2f} s audio on {device}, {dtype}; a first call, warm-up "
          "included)")
    return 0


def _stream(spec, params, cfg, manifest, audios, inputs, args, device) -> int:
    """Push each whole input through a StreamingSession, flush, write the wav."""
    import numpy as np

    from .audio_io import write_wav
    from .streaming import StreamingSession

    session = StreamingSession(spec, params, cfg, block_hops=args.block_hops,
                               jit=device.type == "cuda", device=device)
    monos = [a.reshape(-1) for a in audios]  # (1, n) each
    n = max(m.shape[-1] for m in monos)  # the longest input, as Session pads
    monos = [np.pad(m, (0, n - m.shape[-1])) for m in monos]
    start = time.perf_counter()
    out = np.concatenate([session.push(*monos), session.flush()])
    elapsed = time.perf_counter() - start
    path = Path(args.output) if args.output else inputs[0].with_name(
        inputs[0].stem + f".{spec.name}.stream.wav")
    print(f"wrote {write_wav(path, out, manifest.out_sample_rate)}")
    dur = out.shape[-1] / manifest.out_sample_rate
    latency = session.latency_samples
    print(f"streaming RTF: {elapsed / dur:.6f} on {device} (algorithmic latency {latency} "
          f"samples = {1000 * latency / manifest.model_sample_rate:.1f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
