"""The idle split's readers (``session_idle_share``, ``model_host_idle_share``)
on synthetic slices: labels summed by prefix, nothing read from a program
without the port's spans, a true zero kept, and the split plus the
unattributed rest equal to ``idle_share``."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import trace
from benchmark.cell import ROOT, _module

READERS = {name: _module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"test_metric_{name}")
           for name in ("session_idle_share", "model_host_idle_share", "idle_share")}


def _read(name, record):
    return READERS[name].read(record)


def _record(gaps: dict, wall_s: float = 2.0, busy_s: float = 1.8) -> dict:
    return {"slice": {"wall_s": wall_s, "busy_s": busy_s, "kernels": {}, "launches": 0,
                      "gaps": gaps}}


def test_labels_are_summed_by_prefix():
    record = _record({"session.process": 0.001, "session.slice": 0.01, "session.to_host": 0.02,
                      "model.forward": 0.003, "model.ss.flash": 0.04, "model.ss.fsmn": 0.01,
                      "cudaLaunchKernel": 0.05, "aten::mm": 0.02, "gaps under 10 us": 0.02,
                      "benchmark loop between requests": 0.01})
    assert _read("session_idle_share", record) == pytest.approx(0.031 / 2.0, abs=1e-15)
    assert _read("model_host_idle_share", record) == pytest.approx(0.053 / 2.0, abs=1e-15)


@pytest.mark.parametrize("gaps", [
    {"Session.process: host Python between torch ops": 0.04, "model.forward": 0.01,
     "gaps under 10 us": 0.02},  # the parent's labels: no port span named a gap
    {},
], ids=["no_session_label", "no_gaps"])
def test_a_slice_without_session_spans_reads_nothing(gaps):
    record = _record(gaps)
    assert _read("session_idle_share", record) is None
    assert _read("model_host_idle_share", record) is None
    assert _read("session_idle_share", {"slice": None}) is None
    assert _read("model_host_idle_share", {"slice": None}) is None


def test_a_slice_with_session_spans_and_no_model_gap_reads_zero():
    record = _record({"session.to_host": 0.01, "cudaLaunchKernel": 0.02})
    assert _read("session_idle_share", record) == pytest.approx(0.005)
    value = _read("model_host_idle_share", record)
    assert value is not None and value == 0.0


def _requests(rng, t0: int, n: int):
    """Host events of ``n`` back-to-back requests from ``t0`` (ns): each a
    ``bench.request`` span around ``session.process``, its six phases, the
    model's stage spans inside ``model.forward``, and runtime ops inside
    those; returns (request spans, host events)."""
    spans, host, t = [], [], t0
    for _ in range(n):
        start = t
        t += int(rng.integers(2_000, 30_000))  # the benchmark loop
        process_start = t
        for phase in ("session.condition", "session.slice", "session.to_device"):
            end = t + int(rng.integers(5_000, 200_000))
            host.append((t, end, phase))
            host.append((t + 1_000, t + 3_000, "aten::empty"))
            t = end
        forward_start = t
        for stage in ("model.ss.encoder", *["model.ss.flash", "model.ss.fsmn"] * 3,
                      "model.ss.mask", "model.ss.decoder"):
            end = t + int(rng.integers(20_000, 400_000))
            host.append((t, end, stage))
            op = t + int(rng.integers(1_000, 10_000))
            host.append((op, op + int(rng.integers(2_000, 15_000)), "cudaLaunchKernel"))
            t = end
        t += 3_000
        host.append((forward_start, t, "model.forward"))
        for phase in ("session.to_host", "session.stitch"):
            end = t + int(rng.integers(5_000, 300_000))
            host.append((t, end, phase))
            t = end
        host.append((process_start, t, "session.process"))
        t += int(rng.integers(1_000, 20_000))
        spans.append((start, t))
    return spans, host


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_split_and_the_unattributed_rest_make_idle_share(seed):
    """A slice built as ``trace.parse`` builds it: the union of device
    intervals, its gaps named by the innermost host op at their middle."""
    rng = np.random.default_rng(seed)
    spans, host = _requests(rng, 1_000_000, 6)
    t0, t1 = spans[0][0], spans[-1][1]
    starts = np.sort(rng.integers(t0, t1, 400))
    intervals = [(int(s), int(s + rng.integers(500, 40_000))) for s in starts]
    intervals = [(s, min(e, t1)) for s, e in intervals if s < t1]
    busy_ns, gaps = trace._union_and_gaps(intervals, t0, t1)
    labelled = trace._label_gaps(gaps, host, spans)
    record = _record(labelled, wall_s=(t1 - t0) * 1e-9, busy_s=busy_ns * 1e-9)
    session = _read("session_idle_share", record)
    model = _read("model_host_idle_share", record)
    assert session > 0 and model > 0
    rest = sum(sec for k, sec in labelled.items()
               if not k.startswith(("session.", "model."))) / record["slice"]["wall_s"]
    assert abs(session + model + rest - _read("idle_share", record)) <= 1e-9
