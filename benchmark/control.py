"""Readings that the output check's limit is set from, for one cell, many
seeds in one process.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] [--faults]

For each seed: the traffic and the weights as a run draws them; one round of
the mix (every clip once, in the seed's first order) served through the
port's ``Session`` in the configuration's float32 plan (the program) and in
the controls, each a precision below the one the configuration states
(float32 with TF32 off): the program with TF32 switched on (``tf32``), the
reference with TF32 on put in the program's place (``tf32_reference``), and
the port's own bfloat16 plan (``bf16``); and with ``--faults`` the float32
plan with each of ``benchmark.faults`` planted.  The requests a run would
check, drawn as a run draws them, are compared with the reference (float32,
TF32 off).  Prints one JSON line a seed and a last line with the largest
reading of the program (the lower reading) and the smallest of each
control (the upper one is the least of them).  The TF32 controls need the
card (the CPU has no TF32).  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys


CONTROLS = ("tf32", "tf32_reference", "bf16")


def readings(cell, seed: int, device, faults: bool) -> dict:
    import contextlib
    import gc

    import torch

    from . import check, generator, program, weights
    from .faults import FAULTS

    traffic = generator.generate(cell.mix, seed)
    order = [int(c) for c in traffic.order[: len(traffic.clips)]]
    picks = generator.check_sample(cell.mix, seed, order, traffic)
    cuda = torch.device(device).type == "cuda"
    params = weights.draw(cell.reference.param_table(cell.config["model"]), seed, device)
    plans = {"program": ("float32", None, False), "bf16": ("bfloat16", None, False)}
    if cuda:
        plans["tf32"] = ("float32", None, True)
    if faults:
        plans.update({name: ("float32", f, False) for name, f in FAULTS.items()})
    outputs = {}
    for name, (dtype, fault, tf32) in plans.items():
        prog = program.Program(cell.config, params, device, compute_dtype=dtype)
        if fault is not None:
            fault(prog)
        with check.precision(True) if tf32 else contextlib.nullcontext():
            outs = [prog.process(*traffic.clips[c])[0] for c in order]
        outputs[name] = [outs[i] for i in picks]
        del prog, outs
        gc.collect()
    del params
    if cuda:
        torch.cuda.empty_cache()
    checked = [traffic.clips[order[i]] for i in picks]
    refs = check.reference_outputs(cell, seed, checked, device)
    if cuda:
        outputs["tf32_reference"] = check.reference_outputs(cell, seed, checked, device, tf32=True)
    sources = cell.reference.output_sources(cell.config["model"])
    return {name: check.compare(outs, refs, sources) for name, outs in outputs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from . import cell as cells

    if not torch.cuda.is_available():
        print("benchmark.control: CUDA is not available", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    rows = []
    for seed in args.seeds:
        r = readings(cell, seed, "cuda", args.faults)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    least = {k: min(r[k] for r in rows) for k in rows[0] if k != "program"}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "lower": max(r["program"] for r in rows),
                      "upper": min(least[k] for k in CONTROLS if k in least),
                      "limit": cell.config["check"]["worst_rel_err"],
                      **{f"least_{k}": v for k, v in least.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
