"""Device traces of steady slices of the window, and what is read from them.

A slice is a run of whole requests right after the measured window, traced
by ``torch.profiler`` (host and device).  Spin kernels fence it on both sides
and are left out: a trace has been seen to lose a few launches at its start.
Each request is a ``bench.request`` span.  From the raw events (not
``key_averages()``, whose Python tree of every host op costs seconds) a
slice gives: its wall time, from the first span's start to the last one's
end; the device's busy time, the union of every kernel, copy and fill
inside it; each kernel's launches and device seconds; the idle gaps, each
named by the innermost host op running at its middle; the model windows run
and the least time of the kernel-shaped calls they made
(``benchmark.bounds``), from the reference's record of those calls at the
same batches.
"""
from __future__ import annotations

import re

import numpy as np

SPAN = "bench.request"
SHORT_GAP_NS = 10_000
SPIN_CYCLES = 1000


def spin_guard(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(32):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()


def kernel_pattern(names) -> re.Pattern:
    """Matches a kernel symbol that names one of ``names`` as a whole word."""
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")


# the port's hand-written kernels (``audiojax_torch/csrc``), by symbol
PORT_KERNELS = ("stft_kernel", "istft_kernel", "dwconv_kernel", "dwconv_grouped_kernel",
                "dwconv_kernel_bf16_mma", "dwconv_grouped_kernel_bf16_mma",
                "quad_attention_kernel", "quad_attention_kernel_bf16", "relpos_batched_kernel",
                "relpos_tiled_kernel", "relpos_mma_kernel_bf16")
PORT = kernel_pattern(PORT_KERNELS)


def roofline_share(s: dict | None, kernels: tuple, calls: tuple) -> float | None:
    """100 × Σ least time of the reference's ``calls`` over Σ device time of
    the ``kernels`` in slice ``s``; None where there is nothing to read or
    the trace's launches are not one a call."""
    if not s or not s.get("bound_s"):
        return None
    pattern = kernel_pattern(kernels)
    rows = [v for name, v in s["kernels"].items() if pattern.search(name)]
    launches, seconds = sum(n for n, _ in rows), sum(sec for _, sec in rows)
    expected = sum(s["calls"].get(c, 0) for c in calls)
    if not expected or launches != expected or seconds <= 0:
        return None
    return 100.0 * sum(s["bound_s"].get(c, 0.0) for c in calls) / seconds


def _is_device(ev, torch) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset") or "spin_kernel" in name)


def parse(prof, torch) -> dict:
    """The slice's readings from a finished profile."""
    spans, host, device = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        if _is_device(ev, torch):
            if "spin_kernel" not in name and name != SPAN:  # the span's device-side mark
                device.append((start, start + dur, name))
        elif name == SPAN:
            spans.append((start, start + dur))
        elif dur > 0:
            host.append((start, start + dur, name))
    if not spans:
        return {"wall_s": 0.0, "busy_s": 0.0, "kernels": {}, "launches": 0, "gaps": {}}
    t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
    kernels: dict = {}
    intervals = []
    for s, e, name in device:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        intervals.append((s, e))
        if _is_kernel(name):
            row = kernels.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (e - s) * 1e-9
    busy_ns, gaps = _union_and_gaps(intervals, t0, t1)
    return {"wall_s": (t1 - t0) * 1e-9, "busy_s": busy_ns * 1e-9, "kernels": kernels,
            "launches": sum(n for n, _ in kernels.values()),
            "gaps": _label_gaps(gaps, host, spans)}


def _union_and_gaps(intervals, t0, t1):
    busy, gaps, cursor = 0, [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((cursor, t1))
    return busy, gaps


def _label_gaps(gaps, host, spans) -> dict:
    """Idle seconds by what the host was doing: the innermost host op at a
    gap's middle, else Python between ops inside a request (the session's
    and the model's own), else the benchmark's loop between requests; gaps
    under 10 µs together."""
    out: dict = {}
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:
            label = "gaps under 10 us"
        else:
            mid = (s + e) // 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                label = host[int(inside[np.argmax(starts[inside])])][2]
            elif any(a <= mid <= b for a, b in spans):
                label = "Session.process: host Python between torch ops"
            else:
                label = "benchmark loop between requests"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
