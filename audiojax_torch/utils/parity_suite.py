"""Pretrained-weights parity gate of the port: one command against a parity kit.

Counterpart of ``audiojax.utils.parity_suite``, with the same kit layout,
messages and report: ≥ 40 dB output SNR against the reference's own
outputs on its examples, with *pretrained* weights.  The reference side runs
on a machine with onnxruntime and the published checkpoints; that machine
produces a **parity kit** directory, and this tool turns the kit into a
pass/fail report, serving on the card unless ``--device cpu`` is given::

    python -m audiojax_torch.utils.parity_suite KIT_DIR --out PARITY_PRETRAINED.json

Kit layout (one subdirectory per registry model name)::

    KIT/<model>/checkpoint.pt           # upstream torch checkpoint (or .npz)
    KIT/<model>/inputs/<case>.wav       # an example input
    KIT/<model>/inputs/<case>.0.wav     # multi-input models: numbered in the
    KIT/<model>/inputs/<case>.1.wav     #   manifest's Session.process order
    KIT/<model>/ref/<case>.wav          # the reference pipeline's output
    KIT/<model>/config.json             # optional {"threshold_db": …,
                                        #   "cfg": {dataclass overrides}}

Each model is exported through the port's artifact path
(``runtime.export.export_artifact``: the fail-closed importers the serving
CLI uses), served by its ``Session`` and compared case by case with
:func:`audiojax_torch.utils.parity.output_snr`.  A kit's refs may also be the
JAX package's outputs on the same checkpoint: the kit then holds the port
against the JAX package end to end.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["run_kit", "run_model_dir"]

_GATE_DB = 40.0
_SNR_CAP_DB = 999.0  # bit-exact refs give inf; capped so the report stays strict JSON


def _load_checkpoint(path: Path):
    if path.suffix == ".npz":
        return dict(np.load(path, allow_pickle=False))
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def _cases(inputs_dir: Path) -> dict[str, list[Path]]:
    """Group input wavs into cases: ``name.wav`` or ``name.<idx>.wav``."""
    cases: dict[str, dict[int, Path]] = {}
    for p in sorted(inputs_dir.glob("*.wav")):
        stem = p.stem
        head, _, idx = stem.rpartition(".")
        if head and idx.isdigit():
            cases.setdefault(head, {})[int(idx)] = p
        else:
            cases.setdefault(stem, {})[0] = p
    return {name: [by_idx[i] for i in sorted(by_idx)] for name, by_idx in cases.items()}


def run_model_dir(model: str, model_dir: Path, *, workdir: Path, device=None) -> dict:
    """Export ``model`` from the kit checkpoint and gate every case."""
    import dataclasses

    from ..runtime import registry
    from ..runtime.audio_io import read_audio, to_mono
    from ..runtime.export import export_artifact
    from .parity import load_session, output_snr, read_inputs

    knobs = {}
    cfg_path = model_dir / "config.json"
    if cfg_path.exists():
        knobs = json.loads(cfg_path.read_text())
    threshold = float(knobs.get("threshold_db", _GATE_DB))

    ckpts = [p for p in model_dir.iterdir()
             if p.stem == "checkpoint" and p.suffix in (".pt", ".tar", ".pth", ".npz")]
    if not ckpts:
        return {"model": model, "error": "no checkpoint.{pt,tar,pth,npz} in kit"}
    spec = registry.get(model)
    cfg = spec.make_config()
    if knobs.get("cfg"):
        cfg = dataclasses.replace(cfg, **knobs["cfg"])

    artifact = workdir / model
    export_artifact(model, _load_checkpoint(ckpts[0]), artifact, cfg=cfg, smoke=False)
    session = load_session(model, artifact, cfg=cfg, device=device)

    rows = []
    for case, paths in _cases(model_dir / "inputs").items():
        ref_path = model_dir / "ref" / f"{case}.wav"
        if not ref_path.exists():
            rows.append({"case": case, "error": f"missing {ref_path.name} under ref/"})
            continue
        result = session.process(*read_inputs(paths, session.manifest))
        ref, _ = read_audio(ref_path)
        snr = output_snr(to_mono(ref), result.audio)
        rows.append({"case": case, "snr_db": round(min(float(snr), _SNR_CAP_DB), 2),
                     "passed": bool(snr >= threshold)})
    return {
        "model": model,
        "threshold_db": threshold,
        "cases": rows,
        "min_snr_db": min((r["snr_db"] for r in rows if "snr_db" in r), default=None),
        "passed": bool(rows) and all(r.get("passed") for r in rows),
    }


def run_kit(kit_dir, *, models=None, workdir=None, device=None) -> dict:
    import tempfile

    from ..runtime import registry

    kit_dir = Path(kit_dir)
    found = sorted(d.name for d in kit_dir.iterdir() if d.is_dir())
    if models:
        missing = sorted(set(models) - set(found))
        if missing:
            raise SystemExit(f"models not in kit: {missing}; kit has: {found}")
        found = [m for m in found if m in models]
    unknown = [m for m in found if m not in registry.names()]
    if unknown:
        raise SystemExit(f"kit directories that are not registry models: {unknown}; "
                         f"valid names: {sorted(registry.names())}")
    if not found:
        raise SystemExit(f"no model directories in {kit_dir}")

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(workdir) if workdir else Path(tmp)
        results = [run_model_dir(m, kit_dir / m, workdir=work, device=device) for m in found]
    return {
        "kit": str(kit_dir),
        "models": results,
        "passed": all(r.get("passed") for r in results),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.parity_suite", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kit", help="parity kit directory (see module docstring)")
    ap.add_argument("--models", nargs="*", help="subset of kit models")
    ap.add_argument("--out", help="write the JSON report here as well")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    report = run_kit(args.kit, models=args.models, device=args.device)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
