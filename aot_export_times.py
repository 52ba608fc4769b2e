#!/usr/bin/env python3
"""Graph artifacts of whole models on one card: export and load seconds, size, latency.

    python3 aot_export_times.py [--models gtcrn ...] [--compute-dtype bfloat16]

For each model at its default (full) config, random parameters from seed 0
on the card: one 6 s request (``chip_smoke.noisy_speech``; ``speech_mix``
for a separation model, a (near, far) pair for an echo canceller) served
through ``Session`` by the eager module, 3 times after a warm-up; then
``runtime.aot.attach_graph`` into a temporary directory (the export, timed,
its eager warm-up forward included), the size of ``graph.pt2`` and its node
count, ``load_compiled`` (timed), and the same request served by the graph:
the medians and the largest difference (LSB).  One JSON line a model, after the card's
name and power limit.  ``graph_nodes`` counts the loaded graph's top-level
nodes; ``nodes_with_steps`` adds the nodes of the scan operators' traced
steps (``graph.json``'s ``nodes``).  The time loops trace as scan operators
(``runtime/aot.py``); before that they unrolled (GTCRN's GRUs over 126
frames a window: ~20k nodes).

Without CUDA it exits 1.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as c


def measure(name: str, compute_dtype: str | None) -> dict:
    from audiojax_torch.runtime import aot, registry
    from audiojax_torch.runtime.session import Session

    spec = registry.get(name)
    cfg = spec.make_config(compute_dtype=compute_dtype) if compute_dtype else spec.make_config()
    manifest = spec.make_manifest(cfg)
    model = spec.make_module(spec.init_params(0, cfg, "cuda"), cfg)
    sr = manifest.in_sample_rate
    clip = (c.echo_pair if manifest.task == "aec" else
            c.speech_mix if manifest.task == "separation" else c.noisy_speech)
    ins = c._inputs(clip(6 * sr, 97, sr=sr))
    runs = {}

    def serve(label, m):
        session = Session(m, manifest, device="cuda")
        session.process(*ins)  # warm-up
        runs[label] = [session.process(*ins) for _ in range(3)]

    serve("eager", model)  # first: the process's first forward sets up cuDNN and cuBLAS
    root = Path(tempfile.mkdtemp(prefix="aot_export_times_"))
    try:
        t0 = time.perf_counter()
        aot.attach_graph(root, model, manifest)
        export_s = time.perf_counter() - t0
        meta = json.loads((root / aot.GRAPH_META).read_text())
        nbytes = sum(p.stat().st_size for p in root.glob("graph*.pt2"))
        t0 = time.perf_counter()
        graph = aot.load_compiled(root, model.params)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nodes = sum(len(g.graph.nodes) for g in graph.graphs.values())
    serve("graph", graph)
    worst = max(int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))
                for r, e in zip(runs["graph"], runs["eager"])
                for a, b in zip(r.outputs, e.outputs))
    med = {k: float(np.median([r.elapsed_s * 1e3 for r in v])) for k, v in runs.items()}
    return {"model": name, "compute_dtype": compute_dtype or "float32",
            "batch_mode": meta["batch_mode"], "loops": meta.get("loops"),
            "nodes_with_steps": sum(meta.get("nodes", {}).values()), "export_s": round(export_s, 2),
            "load_s": round(load_s, 2), "graph_bytes": nbytes, "graph_nodes": nodes,
            "graph_ms": round(med["graph"], 3), "eager_ms": round(med["eager"], 3),
            "graph_vs_eager_max_lsb": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", nargs="*", default=["gtcrn"])
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("aot_export_times: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    resolve_device("cuda")
    c.build_all()
    print(c.card_line(), flush=True)
    for name in args.models:
        print(json.dumps(measure(name, args.compute_dtype)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
