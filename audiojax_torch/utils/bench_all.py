"""Full model-zoo RTF benchmark of the port, on the card.

Counterpart of ``audiojax.utils.bench_all``: every registered model at its
manifest serving geometry (one ``INPUT_AUDIO_LENGTH`` window, batch 1),
plus the bf16-compute variants of the models with a ``compute_dtype`` knob
and, with ``--quant``, the quantized plans.  Prints one JSON line a row,
then a markdown table headed by the card's name and power limit.

    python -m audiojax_torch.utils.bench_all [--iters N] [--models a,b] [--quant q8f32,q8dyn]
        [--json-out rows.jsonl] [--device cpu]

Timing: one warm-up pass, 12 settle passes, then 3 loops of ``iters``
passes timed by CUDA events (the host clock on the CPU), the fastest loop
kept.  Every pass gets the same inputs (the super-resolution model's output
is three times its input and the echo cancellers take two inputs, so the
passes are not chained).  The operation count behind ``gflops`` is
``FlopCounterMode``'s over one forward (``utils.inspect_model.forward_cost``),
and ``mfu_pct`` divides the achieved rate by the card's peak for the row's
compute dtype (``device.peak_flops``: float32 outside the tensor cores for
the float32 and q8 rows, bf16 on them for the bf16 rows); a CPU row has no
``mfu_pct``.  A row that fails becomes an ``error`` row and the sweep goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time
import traceback

import numpy as np
import torch

# Reference RTF baselines: the reference's ORT-CPU rows (BASELINE.md; the
# first row of each model), the JAX package's numbers as they are.
BASELINES = {
    "zipenhancer": 0.32,
    "mossformergan_se": 1.085,
    "mossformer2_se": 0.09,
    "dfsmn": 0.0068,
    "gtcrn": 0.0036,
    "h_gtcrn": 0.03,
    "ul_unas": 0.0064,
    "sdaec": 0.105,
    "dfsmn_aec": 0.11,
    "nkf_aec": 0.018,
    "deep_echo": 0.024,
    "mossformer2_ss": 2.63,
    "melband_roformer": 1.40,
    "melband_roformer_stereo": 1.40,
    "mossformer2_sr": 1.49,
}

SETTLE = 12  # untimed passes after the warm-up
LOOPS = 3  # timed loops of ``iters`` passes; the fastest is kept


def _clip(shape, rate, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / rate
    wave = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    mono = (wave * 20000).astype(np.int16)
    return np.broadcast_to(mono, shape).copy()


def init_numpy(spec):
    """The numpy draw in the JAX package's layout behind ``spec.init_params``
    (``models.<family>.init_<name>_numpy`` beside ``init_<name>``): the tree
    an artifact holds, which the optimizer's plans take."""
    fn = spec.init_params
    return getattr(importlib.import_module(fn.__module__), f"{fn.__name__}_numpy")


def _first(out) -> torch.Tensor:
    return out[0] if isinstance(out, (tuple, list)) else out


def _time_passes(model, inputs, iters: int) -> float:
    """Seconds a pass: the fastest of ``LOOPS`` loops of ``iters`` passes,
    after a warm-up and ``SETTLE`` passes, every pass on the same inputs."""
    cuda = inputs[0].device.type == "cuda"
    with torch.inference_mode():
        model(*inputs)
        for _ in range(SETTLE):
            model(*inputs)
        best = float("inf")
        for _ in range(LOOPS):
            if cuda:
                torch.cuda.synchronize(inputs[0].device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    model(*inputs)
                end.record()
                end.synchronize()
                elapsed = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    model(*inputs)
                elapsed = time.perf_counter() - t0
            best = min(best, elapsed)
    return best / iters


def bench_model(name: str, *, iters: int, compute_dtype: str | None = None,
                quant: str | None = None, cfg_replace: dict | None = None,
                batch: int = 1, device=None) -> dict:
    """One row.  ``batch`` > 1 is THROUGHPUT mode: ``batch`` independent
    clips run in one call (concurrent requests batched on the leading axis)
    and the reported RTF is amortized per clip."""
    from ..device import peak_flops, resolve_device
    from ..params import params_from_numpy
    from ..runtime import registry
    from .inspect_model import forward_cost

    dev = resolve_device(device)
    spec = registry.get(name)
    cfg = spec.make_config()
    if compute_dtype is not None:
        if not registry.has_compute_dtype(cfg):
            raise ValueError(f"{name} has no compute_dtype knob")
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if cfg_replace:  # a smaller config; the same code path
        cfg = dataclasses.replace(cfg, **cfg_replace)
    man = spec.make_manifest(cfg)
    rc = man.runtime_config()
    w, ch, k = rc["INPUT_AUDIO_LENGTH"], rc["INPUT_CHANNELS"], rc["NUM_AUDIO_INPUTS"]
    shape = (batch, w) if ch == 1 else (batch, ch, w)
    inputs = [torch.from_numpy(_clip(shape, rc["IN_SAMPLE_RATE"], seed=i)).to(dev)
              for i in range(k)]

    snr_q8 = None
    if quant:  # the quantized-parameter plans, served as an optimized artifact is
        from ..runtime.optimize import PLANS, apply_plan, wrap_forward

        tree = init_numpy(spec)(0, cfg)
        with torch.inference_mode():
            ref0 = _first(spec.make_module(params_from_numpy(tree, dev), cfg)(*inputs))
            ref0 = ref0.cpu().numpy().astype(np.float64)
        qtree, _ = apply_plan(tree, PLANS[quant])
        man.extra["optimize"] = {"plan": quant, "quantize": quant, "compute_dtype": "f32"}
        model = wrap_forward(spec.make_module(params_from_numpy(qtree, dev), cfg), man)
        with torch.inference_mode():
            q0 = _first(model(*inputs)).cpu().numpy().astype(np.float64)
        err = np.sum((ref0 - q0) ** 2)
        snr_q8 = round(10.0 * np.log10(np.sum(ref0**2) / max(err, 1e-12)), 1)
    else:  # ParamModule casts the tree once for a bf16 config
        model = spec.make_module(spec.init_params(0, cfg, dev), cfg)
    model = model.to(dev).eval()

    flops, _ = forward_cost(model, inputs)
    elapsed = _time_passes(model, inputs, iters)

    duration = w / rc["IN_SAMPLE_RATE"]
    rtf = elapsed / (duration * batch)  # amortized per clip in throughput mode
    base = BASELINES.get(name)
    row = {
        "model": name + (f"+{compute_dtype}" if compute_dtype else "")
        + (f"+{quant}" if quant else "")
        + (f"@bs{batch}" if batch != 1 else ""),
        "rtf": round(rtf, 6),
        "latency_ms": round(elapsed * 1e3, 3),
        "chunk_s": round(duration, 3),
        "baseline_rtf": base,
        "vs_baseline": round(base / rtf, 2) if base else None,
    }
    if flops:
        achieved = flops / elapsed
        row["gflops"] = round(flops / 1e9, 2)
        row["tflops_per_s"] = round(achieved / 1e12, 3)
        if dev.type == "cuda":
            peak = peak_flops(dev, compute_dtype or "float32")
            row["mfu_pct"] = round(100.0 * achieved / peak, 2)
    if snr_q8 is not None:
        row["snr_vs_f32_db"] = snr_q8
    return row


def _error_row(model: str, e: Exception) -> dict:
    return {"model": model, "error": f"{type(e).__name__}: {e}"}


def table(rows: list[dict], card: str) -> str:
    """The markdown table of ``rows``, headed by the card line."""
    lines = [f"Card: {card}", "",
             "| Model | RTF | chunk | reference CPU RTF | speedup | TFLOP/s | MFU |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['model']} | ERROR: {r['error']} | | | | | |")
            continue
        base = r["baseline_rtf"]
        tf = f"{r['tflops_per_s']:.2f}" if "tflops_per_s" in r else "—"
        mfu = f"{r['mfu_pct']:.1f}%" if "mfu_pct" in r else "—"
        lines.append(f"| {r['model']} | {r['rtf']:.6f} | {r['chunk_s']:.1f} s | "
                     f"{base if base is not None else '—'} | "
                     f"{str(r['vs_baseline']) + '×' if r['vs_baseline'] else '—'} | "
                     f"{tf} | {mfu} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.bench_all", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--models", default=None, help="comma-separated subset")
    ap.add_argument("--batch", type=int, default=1,
                    help="clips per call (throughput mode; RTF amortized per clip)")
    ap.add_argument("--no-bf16", action="store_true", help="skip bf16-compute variants")
    ap.add_argument("--quant", default=None,
                    help="comma-separated quant plans (q8f32,q8dyn) benched for models "
                    "whose recommended plan quantizes (reference: Mel-Band only)")
    ap.add_argument("--json-out", default=None,
                    help="also write the card line and the rows as JSON lines "
                    "(input to utils.readme_tables)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import card_line, resolve_device
    from ..runtime import registry

    dev = resolve_device(args.device)
    card = card_line(dev)
    names = args.models.split(",") if args.models else registry.names()
    rows = []

    def add(label: str, **kw) -> dict:
        try:  # keep sweeping on any per-row failure (unknown names included)
            row = bench_model(kw.pop("name"), iters=args.iters, batch=args.batch, device=dev,
                              **kw)
        except Exception as e:  # noqa: BLE001 — the row carries it; the sweep goes on
            traceback.print_exc(file=sys.stderr)
            row = _error_row(label, e)
        print(json.dumps(row), flush=True)
        rows.append(row)
        return row

    for name in names:
        if "error" in add(name, name=name):
            continue
        cfg = registry.get(name).make_config()
        # --no-bf16 skips only the bf16 variants, NOT the --quant rows
        if not args.no_bf16 and registry.has_compute_dtype(cfg):
            add(f"{name}+bfloat16", name=name, compute_dtype="bfloat16")
        if args.quant:
            from ..runtime.optimize import plan_for

            # an explicit --models selection benches the requested quant rows
            # whatever the recommended plan; the default full sweep quantizes
            # only where the reference recommends it (Mel-Band)
            if args.models or plan_for(name).quantize != "none":
                for q in args.quant.split(","):
                    add(f"{name}+{q}", name=name, quant=q)

    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in [{"card": card}, *rows]))

    print("\n" + table(rows, card))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
