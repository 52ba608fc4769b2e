"""Model inspector: parameters, the forward's operation count, serving geometry.

Counterpart of ``audiojax.utils.inspect_model``.

    python -m audiojax_torch.utils.inspect_model --model gtcrn [--device cpu]
    python -m audiojax_torch.utils.inspect_model --all
    python -m audiojax_torch.utils.inspect_model --model zipenhancer --compute-dtype bfloat16

Prints one JSON report a model with the JAX package's keys: the parameter
count and megabytes of the random (seed 0) float32 tree, the manifest's
serving geometry, and the cost of one forward over one window (batch 1, of
zeros), run on ``--device`` (the card by default).

The cost does not come from a compiler's analysis, as XLA's
``cost_analysis`` gives the JAX report's.  ``gflops_per_chunk`` is
``torch.utils.flop_counter.FlopCounterMode``'s count over the forward with
the kernels' routing points called as their registered operators
(``ops/_build.registered_ops``), each of which has its own formula
(``register_flop_formula`` in ``ops/*_cuda.py``: an FFT's 5/2·n·log2(n) a
frame, a multiply-add a tap of the convolutions, the score and PV products
of the attentions): matrix products, convolutions and the kernels count,
elementwise work does not.  ``bytes_accessed_mb`` is the sum of every
operator's input and output bytes (views apart): unfused, so it is not XLA's
figure for a fused program and runs well above it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _BytesMode(TorchDispatchMode):
    """Sums every operator's tensor input and output bytes; views move none."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def forward_cost(model, inputs) -> tuple[float, float]:
    """(operations, bytes accessed) of one forward ``model(*inputs)``: the
    ``FlopCounterMode`` count with the kernels' routing points called as
    their registered operators, and every operator's input and output bytes.
    A count that fails raises."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops._build import registered_ops

    counter, moved = FlopCounterMode(display=False), _BytesMode()
    with torch.inference_mode(), registered_ops(), counter, moved:
        model(*inputs)
    return float(counter.get_total_flops()), float(moved.total)


def inspect_model(name: str, compute_dtype: str | None = None, device=None) -> dict:
    from ..device import resolve_device
    from ..runtime import registry
    from ..runtime.aot import flat_params

    dev = resolve_device(device)
    spec = registry.get(name)
    cfg = spec.make_config()
    if compute_dtype is not None:
        if not registry.has_compute_dtype(cfg):
            raise ValueError(f"{name} has no compute_dtype knob")
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    man = spec.make_manifest(cfg)
    rc = man.runtime_config()
    w, ch, k = rc["INPUT_AUDIO_LENGTH"], rc["INPUT_CHANNELS"], rc["NUM_AUDIO_INPUTS"]
    shape = (1, w) if ch == 1 else (1, ch, w)

    params = spec.init_params(0, cfg, dev)
    leaves = flat_params(params).values()
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    model = spec.make_module(params, cfg).to(dev).eval()
    inputs = [torch.zeros(shape, dtype=torch.int16, device=dev) for _ in range(k)]
    flops, bytes_acc = forward_cost(model, inputs)
    chunk_s = w / rc["IN_SAMPLE_RATE"]

    report = {
        "model": name,
        "task": spec.task,
        "params": n_params,
        "param_mb": round(param_bytes / 2**20, 2),
        "chunk_seconds": round(chunk_s, 3),
        "input_shape": list(shape),
        "num_audio_inputs": k,
        "sample_rates": {"in": rc["IN_SAMPLE_RATE"], "model": rc["MODEL_SAMPLE_RATE"],
                         "out": rc["OUT_SAMPLE_RATE"]},
        "gflops_per_chunk": round(flops / 1e9, 3),
        "gflops_per_audio_second": round(flops / 1e9 / chunk_s, 3) if chunk_s else None,
        "bytes_accessed_mb": round(bytes_acc / 2**20, 2),
        "arithmetic_intensity": round(flops / bytes_acc, 2) if bytes_acc else None,
    }
    if compute_dtype:
        report["compute_dtype"] = compute_dtype
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.inspect_model", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", help="model name; omit with --all")
    ap.add_argument("--all", action="store_true", help="inspect every registered model")
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..runtime import registry

    names = registry.names() if args.all else [args.model]
    if names == [None]:
        ap.error("--model or --all is required")
    failed = 0
    for n in names:
        try:
            print(json.dumps(inspect_model(n, args.compute_dtype, args.device)), flush=True)
        except Exception as e:  # noqa: BLE001 — reported on the model's line; exit code 1
            failed += 1
            print(json.dumps({"model": n, "error": f"{type(e).__name__}: {e}"}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
