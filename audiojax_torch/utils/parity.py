"""Output-parity harness: SNR of the port's output against a reference wav.

Counterpart of ``audiojax.utils.parity``, with the same numbers: the
acceptance gate is ≥ 40 dB output SNR against a reference output (the
reference ONNX pipeline's, produced elsewhere, or the JAX package's).
``main`` serves ``--artifact`` (or random parameters from seed 0) through
the port's ``Session`` on ``--device`` (the card by default) and scores its
output against ``--reference``; the exit code is 1 below the threshold.

    python -m audiojax_torch.utils.parity --model gtcrn --artifact art/ \\
        --input noisy.wav --reference ref_denoised.wav [--device cpu]
"""
from __future__ import annotations

import numpy as np

__all__ = ["output_snr", "parity_report"]


def output_snr(reference: np.ndarray, test: np.ndarray) -> float:
    """SNR (dB) of ``test`` against ``reference`` over the common length."""
    n = min(reference.shape[-1], test.shape[-1])
    ref = reference[..., :n].astype(np.float64)
    err = ref - test[..., :n].astype(np.float64)
    sig = float(np.sum(ref * ref))
    noise = float(np.sum(err * err))
    if noise == 0.0:
        return float("inf")
    return 10.0 * np.log10(max(sig, 1e-12) / noise)


def parity_report(reference: np.ndarray, test: np.ndarray, *, threshold_db: float = 40.0) -> dict:
    snr = output_snr(reference, test)
    return {
        "snr_db": round(snr, 2) if np.isfinite(snr) else snr,
        "threshold_db": threshold_db,
        "passed": bool(snr >= threshold_db),
        "ref_samples": int(reference.shape[-1]),
        "test_samples": int(test.shape[-1]),
    }


def load_session(model_name: str, artifact=None, *, cfg=None, device=None):
    """The port's ``Session`` for ``model_name`` on ``device``: an artifact's
    parameters under the config it records (``cfg`` replaces it) and its
    optimize plan, or random parameters from seed 0 at the default config."""
    from ..device import resolve_device
    from ..runtime import registry
    from ..runtime.checkpoint import load_artifact
    from ..runtime.optimize import wrap_forward
    from ..runtime.session import Session

    dev = resolve_device(device)
    spec = registry.get(model_name)
    if artifact is not None:
        params, manifest = load_artifact(artifact, dev)
        if manifest.model_name != model_name:
            raise ValueError(f"artifact {artifact} holds {manifest.model_name!r}, "
                             f"not {model_name!r}")
        cfg = cfg if cfg is not None else registry.config_from_manifest(spec, manifest)
    else:
        cfg = cfg if cfg is not None else spec.make_config()
        params, manifest = spec.init_params(0, cfg, dev), spec.make_manifest(cfg)
    return Session(wrap_forward(spec.make_module(params, cfg), manifest), manifest, device=dev)


def read_inputs(paths, manifest) -> list:
    """Input wavs as ``Session.process`` takes them: mono where the model
    takes one channel, resampled to its input rate."""
    from ..runtime.audio_io import read_audio, resample_np, to_mono

    audios = []
    for p in paths:
        data, rate = read_audio(p)
        if manifest.input_channels == 1:
            data = to_mono(data)[None]
        audios.append(resample_np(data, rate, manifest.in_sample_rate))
    return audios


def main(argv=None):
    import argparse
    import json

    from ..runtime.audio_io import read_wav, to_mono

    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.parity", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--input", nargs="+", required=True)
    ap.add_argument("--reference", required=True, help="reference output wav")
    ap.add_argument("--artifact", help="artifact dir (random params otherwise)")
    ap.add_argument("--threshold", type=float, default=40.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    session = load_session(args.model, args.artifact, device=args.device)
    result = session.process(*read_inputs(args.input, session.manifest))
    ref, _ = read_wav(args.reference)
    report = parity_report(to_mono(ref), result.audio, threshold_db=args.threshold)
    print(json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
