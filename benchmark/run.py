"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (counted in ``setup_s``, from the process's start): the port's kernel
libraries are built or loaded side by side, the traffic and the weights are
drawn from the seed (the weights on the card, by the reference's table), the
port's session is built and every window bucket the traffic uses is served
twice.  The window: one closed-loop client sends requests back to back
through ``Session.process`` for ``--seconds``, and on to the end of the
round of clips then under way (every seed serves whole rounds of the same
clip lengths), so it ends when that round's last request returns.  The device's peak memory is read.  With
``--trace 1`` the same client then goes on through two slices of about two
seconds each, traced by ``torch.profiler`` (the profiler's own cost stays
out of the window).  Then the program is freed, and the reference checks a sample of the outputs
(``benchmark.check``).  The result line carries the cell's end-to-end
metrics (``--trace 0``) or its per-layer ones (``--trace 1``), each read by
its own file in ``benchmark/metrics``; its last key, ``checks``, holds each
number compared beside its limit, which also end standard error.

No CUDA, fewer cards than the cell asks for, or a module of JAX, of the JAX
package or of the project's smoke script in ``sys.modules`` once the window
has closed: a non-zero exit and no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

_IMPORTED = time.time()


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program lives at a fixed path inside
# the checkout
CACHE = ROOT / ".bench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "audiojax", "chip_smoke"}
SLICES = 2  # traced slices after the window; the first whose trace reads whole is kept
SLICE_S = 2.0


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that no run may hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _sync(torch, cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device: str, start: float) -> dict:
    """One run of ``cell``; returns the result dict (``checks`` last)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import bounds, check, generator, program, trace as tr
    from . import weights
    from .reference import session as ref_session

    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(2)
    config, serving = cell.config, cell.config["serving"]
    if cell.mix["sample_rate"] != serving["sample_rate"]:
        raise ValueError(f"the mix is at {cell.mix['sample_rate']} Hz, the model takes "
                         f"{serving['sample_rate']} Hz")
    phases = {"imports": time.time() - start}
    wait_builds = program.start_builds(config["kernels"]) if cuda else (lambda: None)
    traffic = generator.generate(cell.mix, seed)
    phases["traffic"] = time.time() - start
    params = weights.draw(cell.reference.param_table(config["model"]), seed, device)
    _sync(torch, cuda)
    phases["weights"] = time.time() - start
    wait_builds()
    if cuda:  # a first run's build products reach the disk here, not in the window
        os.sync()
    phases["kernel builds"] = time.time() - start
    prog = program.Program(config, params, device)
    del params
    _sync(torch, cuda)
    phases["session"] = time.time() - start

    def needed(n: int) -> int:
        return ref_session.windows_needed(n, serving)

    warm = {}
    for i, c in enumerate(traffic.clips):
        warm.setdefault(ref_session.windows_run(needed(generator.samples(c)), serving), i)
    for i in warm.values():
        for _ in range(2):
            prog.process(*traffic.clips[i])
    _sync(torch, cuda)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prog.batches.clear()
    gc.collect()
    setup_s = time.time() - start
    phases["warm-up"] = setup_s
    print("set-up, seconds from the process's start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    requests = []

    def serve(in_slice: bool) -> None:
        c = int(traffic.order[len(requests) % len(traffic.order)])
        clip = traffic.clips[c]
        n = generator.samples(clip)
        seen = len(prog.batches)
        t0 = time.perf_counter()
        try:
            with record_function(tr.SPAN) if in_slice else contextlib.nullcontext():
                outputs, elapsed = prog.process(*clip)
            error = None
        except Exception as e:  # a failed request is counted, and fails the run
            outputs, elapsed, error = None, None, f"{type(e).__name__}: {e}"
            print(f"request {len(requests)} (clip {c}) failed: {error}", file=sys.stderr)
        t1 = time.perf_counter()
        batches = prog.batches[seen:]
        requests.append({"clip": c, "n": n, "t1": t1, "wall_s": t1 - t0,
                         "elapsed_s": elapsed, "ok": error is None, "batches": batches,
                         "windows_run": int(sum(batches)), "windows_needed": needed(n),
                         "in_slice": in_slice, "outputs": outputs})

    # whole rounds: every seed serves the same work, in its own order
    t_win = time.perf_counter()
    while (not requests or time.perf_counter() - t_win < seconds
           or len(requests) % len(traffic.clips)):
        serve(False)
    window_s = requests[-1]["t1"] - t_win
    _sync(torch, cuda)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    card = torch.cuda.get_device_name() if cuda else "cpu"
    record = {"setup_s": setup_s, "window_s": window_s, "sample_rate": traffic.sample_rate,
              "requests": requests, "window_peak_bytes": window_peak, "slice": None}
    result_device = {"platform": "gpu" if cuda else "cpu", "kind": card,
                     "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    breakdown = None
    if trace:
        # traced slices: whole requests right after the window, in the same
        # order, until one reads whole (every listed per-layer metric found)
        peak = bounds.peaks(card) if cuda else None
        record["peak_flops"] = peak["float32"] if peak else None
        record["flops_per_window"] = check.work_at(cell, 1)[1]
        work = {}
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for _ in range(SLICES):
            first = len(requests)
            with profile(activities=activities) as prof:
                tr.spin_guard(torch)
                t0 = time.perf_counter()
                while len(requests) == first or time.perf_counter() - t0 < SLICE_S:
                    serve(True)
                tr.spin_guard(torch)
            stats = tr.parse(prof, torch)
            del prof
            stats["windows_run"], stats["calls"], stats["bound_s"] = 0, {}, {}
            for b in (b for r in requests[first:] for b in r["batches"]):
                if b not in work:
                    work[b] = check.work_at(cell, b)[0]
                stats["windows_run"] += b
                for kind, ops, nbytes in work[b]:
                    stats["calls"][kind] = stats["calls"].get(kind, 0) + 1
                    if peak:
                        stats["bound_s"][kind] = (stats["bound_s"].get(kind, 0.0)
                                                  + bounds.bound_s(ops, nbytes, peak))
            record["slice"] = stats
            if all(cell.metrics[m][1].read(record) is not None for m in cell.per_layer):
                break
        result_device["busy_s"] = stats["busy_s"]
        result_device["window_s"] = stats["wall_s"]
        breakdown = {"device_ops": tr.top({k: v[1] for k, v in stats["kernels"].items()}),
                     "idle_gaps": tr.top(stats["gaps"])}
        port = {}
        for name, (n, _) in stats["kernels"].items():
            key = tr.PORT.search(name)
            if key:
                port[key.group(1)] = port.get(key.group(1), 0) + n
        print(f"traced slice: {stats['windows_run']} windows, {stats['launches']} launches, "
              f"calls {stats['calls']}, port kernels {port}", file=sys.stderr)
        for in_slice in (False, True):  # the profiler's cost: wall seconds a window run
            rs = [r for r in requests if r["in_slice"] == in_slice and r["ok"]]
            print(f"{'traced' if in_slice else 'untraced'} requests: "
                  f"{sum(r['wall_s'] for r in rs) / max(1, sum(r['windows_run'] for r in rs))} "
                  f"s a window run, {len(rs)} requests", file=sys.stderr)

    # the program's state is freed before the reference runs
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: a sample of the window's outputs against the reference
    completed = [r["clip"] for r in requests]
    picks = generator.check_sample(cell.mix, seed, completed, traffic)
    t_ref = time.perf_counter()
    refs = check.reference_outputs(cell, seed, [traffic.clips[completed[i]] for i in picks],
                                   device)
    worst = check.compare([requests[i]["outputs"] for i in picks], refs,
                          cell.reference.output_sources(config["model"]))
    failed = sum(not r["ok"] for r in requests)
    limit = config["check"]["worst_rel_err"]
    correct = failed == 0 and bool(np.isfinite(worst)) and worst <= limit

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        entry, reader = cell.metrics[name]
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    result = {"correct": bool(correct), "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {"worst_rel_err": {"value": worst if np.isfinite(worst) else None,
                                          "limit": limit},
                        "failed_requests": {"value": failed, "limit": 0}}
    print(f"checked {len(picks)} of {len(requests)} requests in {time.perf_counter() - t_ref:.2f} s; "
          f"window {window_s} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)

    import torch

    from . import cell as cells

    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available; the benchmark measures the card",
              file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} asks for {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; nothing it runs may import JAX, the JAX "
              "package or the smoke script", file=sys.stderr)
        return 3
    from audiojax_torch.device import card_line

    result["device"]["card"] = card_line("cuda")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
