"""Export entry point: upstream checkpoint → an artifact the port serves.

Counterpart of ``audiojax.runtime.export``: load the upstream torch
checkpoint, apply the importer's fusion recipes, write ``params.pt`` +
``manifest.json`` (with the full model config) + ``import_report.json``, and
finish with a short synthetic request through ``Session`` on what was written.

    python -m audiojax_torch.runtime.export --model gtcrn \
        --checkpoint ckpt.pt --out artifact_dir/ [--no-smoke] [--device cpu]
    python -m audiojax_torch.runtime.export --model zipenhancer \
        --checkpoint ckpt.pt --out artifact_dir/ --compute-dtype bfloat16
    python -m audiojax_torch.runtime.export --model melband_roformer \
        --checkpoint ckpt.pt --out artifact_dir/ --plan q8f32

The import is fail-closed (unread checkpoint keys abort).  The smoke request
runs on the card unless ``--device cpu`` is given; without CUDA and without
``--device cpu`` the export fails before it writes anything.  A checkpoint
given as a path is unpickled (``torch.load(weights_only=False)``, as upstream
checkpoints need): unpickling runs code, so export only files you trust.

``compute_dtype`` ("bfloat16") selects the model's activation compute dtype
and is recorded in the manifest (``activation_compute_dtype``, and in the
stored config), so that the CLI serves the artifact with it; the parameters
are stored float32 and cast once where they are served.  ``plan`` (a name in
``runtime.optimize.PLANS``: q8f32, q8dyn, bf16 …) optimizes the written
artifact in place before the smoke request, which then serves what the plan
wrote.

``aot`` (``--aot``) also exports the served forward as a ``torch.export``
graph into the artifact (``graph.pt2`` + ``graph.json``, ``runtime/aot.py``),
traced on the smoke request's device over the parameters as they are served
(the plan's tree, cast to the compute dtype); ``cli --aot`` then serves the
graph, and a host can serve it without the model code.  A graph holds its
device: export on the card for the card.

    python -m audiojax_torch.runtime.export --model mossformergan_se \
        --checkpoint ckpt.pt --out artifact_dir/ --aot
"""
from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path

__all__ = ["export_artifact"]


def export_artifact(model_name: str, ckpt, out_dir, *, cfg=None, smoke: bool = True,
                    import_kwargs=None, device=None, compute_dtype: str | None = None,
                    plan=None, aot: bool = False) -> dict:
    """checkpoint (path or state dict) → artifact directory; returns a report
    dict (``artifact``, ``model``, with ``aot`` the graph's ``aot``,
    ``aot_batch_mode`` and ``aot_admissible_batches``, and with ``smoke``
    the request's ``smoke`` summary).  ``compute_dtype`` replaces the
    config's and is recorded in the manifest; ``plan`` (a
    ``runtime.optimize.Plan``) optimizes the artifact in place."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..importers import _IMPORTERS, import_checkpoint
    from . import registry
    from .checkpoint import load_artifact, save_artifact
    from .optimize import optimize_artifact, wrap_forward
    from .session import Session

    spec = registry.get(model_name)
    dev = resolve_device(device) if smoke or aot else None
    cfg = cfg if cfg is not None else spec.make_config()
    if compute_dtype is not None:
        if not registry.has_compute_dtype(cfg):
            raise ValueError(f"{model_name} has no compute_dtype knob")
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)  # refused here if unported
    if isinstance(ckpt, (str, Path)):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=False)

    out_dir = Path(out_dir)
    kw = dict(import_kwargs or {})
    if "cfg" in inspect.signature(_IMPORTERS[model_name]).parameters:
        kw.setdefault("cfg", cfg)
    params = import_checkpoint(model_name, ckpt,
                               report_path=out_dir / "import_report.json", **kw)

    manifest = spec.make_manifest(cfg)
    # the full serving config: the CLI rebuilds it from here, so an artifact
    # exported with a non-default config does not serve with the defaults
    manifest = dataclasses.replace(
        manifest, extra={**manifest.extra, "config": dataclasses.asdict(cfg)})
    if compute_dtype is not None:
        manifest = dataclasses.replace(
            manifest, extra={**manifest.extra, "activation_compute_dtype": compute_dtype})
    save_artifact(out_dir, params, manifest)
    report = {"artifact": str(out_dir), "model": model_name}
    if plan is not None:
        optimize_artifact(out_dir, out_dir, plan)

    if smoke or aot:  # what is on disk, as it is served
        served, manifest = load_artifact(out_dir, dev)
        model = wrap_forward(spec.make_module(served, cfg), manifest)
    if aot:
        import json

        from . import aot as graph

        meta_path = graph.attach_graph(out_dir, model, manifest)
        meta = json.loads(meta_path.read_text())
        # the serving bound, visible at export time
        report.update(aot=str(meta_path), aot_batch_mode=meta["batch_mode"],
                      aot_admissible_batches=meta["admissible_batches"])
    if smoke:
        # synthetic int16 inputs through the Session
        rng = np.random.default_rng(0)
        length = min(manifest.input_audio_length, manifest.in_sample_rate)
        # (channels, n): a two-channel model (stereo Mel-Band, H-GTCRN) takes two
        audios = [(rng.standard_normal((manifest.input_channels, length)) * 6000)
                  .astype(np.int16) for _ in range(manifest.num_audio_inputs)]
        result = Session(model, manifest, device=dev).process(*audios)
        if not all(np.isfinite(o.astype(np.float64)).all() for o in result.outputs):
            raise RuntimeError("export smoke test produced non-finite output")
        report["smoke"] = {
            "device": str(dev),
            "compute_dtype": getattr(cfg, "compute_dtype", "float32"),
            "out_samples": int(result.outputs[0].shape[-1]),
            "outputs": len(result.outputs),
            "rtf": round(result.rtf, 4),
        }
    return report


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="audiojax_torch.runtime.export", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="torch checkpoint path (unpickled: only files you trust)")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--plan", help="optimization plan applied to the artifact (see "
                    "python -m audiojax_torch.runtime.optimize --list-plans)")
    ap.add_argument("--no-smoke", action="store_true", help="skip the inference smoke test")
    ap.add_argument("--device", default=None,
                    help="where the smoke test runs: cuda (default) or cpu")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                    help="activation compute dtype, recorded in the manifest (bfloat16: the "
                         "bf16 serving plan of the families with the knob)")
    ap.add_argument("--aot", action="store_true",
                    help="export the served forward as a torch.export graph into the artifact "
                         "(graph.pt2 + graph.json), on --device; cli --aot serves it")
    args = ap.parse_args(argv)
    from .optimize import PLANS

    if args.plan and args.plan not in PLANS:
        ap.error(f"unknown plan {args.plan!r}; available: {sorted(PLANS)}")
    report = export_artifact(args.model, args.checkpoint, args.out,
                             smoke=not args.no_smoke, device=args.device,
                             compute_dtype=args.compute_dtype, aot=args.aot,
                             plan=PLANS[args.plan] if args.plan else None)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
