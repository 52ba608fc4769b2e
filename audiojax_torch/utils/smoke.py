"""One-command completeness smoke: every registered model, end to end.

Counterpart of ``audiojax.utils.smoke``.

    python -m audiojax_torch.utils.smoke [--seconds 0.6] [--models gtcrn dfsmn] [--device cpu]

For each registered model: random parameters (seed 0) at the model's default
(full) config, one synthetic int16 request of ``--seconds`` through
``Session`` (output shape and finiteness), and one streamed chunk of two hops
where the model has state-carry streaming.  One status line a model; the
exit code is 1 if any model fails.  It runs on the card unless ``--device
cpu`` is given (on the CPU the larger models take minutes).
"""
from __future__ import annotations

import sys
import traceback


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.smoke", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=0.6, help="synthetic clip length")
    ap.add_argument("--models", nargs="*", help="subset of registry names")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..runtime import registry
    from ..runtime.optimize import wrap_forward
    from ..runtime.session import Session

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    failures = 0
    for name in args.models or registry.names():
        try:
            spec = registry.get(name)
            cfg = spec.make_config()
            params = spec.init_params(0, cfg, dev)
            manifest = spec.make_manifest(cfg)
            n = int(args.seconds * manifest.in_sample_rate)
            audios = [(rng.standard_normal((manifest.input_channels, n)) * 6000).astype(np.int16)
                      for _ in range(manifest.num_audio_inputs)]
            model = wrap_forward(spec.make_module(params, cfg), manifest)
            result = Session(model, manifest, device=dev).process(*audios)
            ok = all(np.isfinite(o.astype(np.float64)).all() for o in result.outputs)
            stream = "-"
            if spec.make_stream is not None:
                init_fn, step_fn, delay = spec.make_stream(cfg)
                chunks = [torch.from_numpy(a[:, :2 * cfg.hop]).to(dev) for a in audios]
                with torch.inference_mode():
                    _, out = step_fn(params, init_fn(1, dev), *chunks)
                out0 = out[0] if isinstance(out, (tuple, list)) else out
                finite = bool(torch.isfinite(out0.double()).all())
                stream = f"stream ok (delay {delay})" if finite else "stream NOT FINITE"
            outs = "+".join(str(o.shape[-1]) for o in result.outputs)
            print(f"{name:24s} {'ok' if ok else 'NOT FINITE':10s} out {outs:>12s} @ "
                  f"{manifest.out_sample_rate} Hz  {stream}", flush=True)
            failures += (not ok) or "NOT" in stream
        except Exception:  # noqa: BLE001 — reported and counted: the exit code says it
            failures += 1
            print(f"{name:24s} FAILED", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
