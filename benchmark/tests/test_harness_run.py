"""A run of the harness on the CPU at tiny sizes, through the reference and
the port's plain path: the result's keys, the output check, and the faults
it has to catch."""
from __future__ import annotations

import json
import math
import time

import pytest
import torch
from harness_tiny import tiny_cell

from benchmark import faults, program, run

SEED = 2**31 + 2**30 + 17  # past 32 signed bits, as a check's seeds may be
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_is_correct_with_the_contract_keys(workload, trace):
    cell = tiny_cell(workload)
    result = run.run(cell, SEED, 3.0 if trace else 0.3, trace, "cpu", time.time())
    line = json.loads(json.dumps(result))
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    names = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= set(names)
    for name, m in line["metrics"].items():
        assert m["unit"] == cell.metrics[name][0]["unit"] and math.isfinite(m["value"])
    if not trace:  # the host-clock metrics are read on any device
        assert set(line["metrics"]) == set(names)
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"session_host_ms"} <= set(line["metrics"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    check = line["checks"]["worst_rel_err"]
    assert 0 <= check["value"] <= check["limit"]


@pytest.mark.parametrize("workload, seconds", [("gan-clips", 14.0), ("ss-clips", 4.5)])
def test_clip_rehearsal_counts_bucket_pads(workload, seconds):
    """A clip of three windows runs four: a quarter of them pads."""
    cell = tiny_cell(workload, strata=1, checked=1)
    cell.mix["lengths_s"] = {"law": "fixed", "value": seconds, "strata": 1}
    result = run.run(cell, SEED, 0.1, True, "cpu", time.time())
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["pad_window_share"]["value"] == 0.25


def _plant(monkeypatch, fault) -> None:
    """The run's program, built as a run builds it, with ``fault`` planted."""
    class Broken(program.Program):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            fault(self)

    monkeypatch.setattr(program, "Program", Broken)


@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    _plant(monkeypatch, faults.FAULTS[fault])
    result = run.run(tiny_cell(workload), SEED, 0.3, False, "cpu", time.time())
    assert result["correct"] is False
    check = result["checks"]["worst_rel_err"]
    assert check["value"] > check["limit"]


def test_a_failing_request_fails_the_run(monkeypatch):
    calls = []

    def raises(prog):  # the set-up's warm-up is served; every timed request raises
        forward = prog.module.forward

        def fails_after_warm_up(*audio):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError("planted")
            return forward(*audio)
        prog.module.forward = fails_after_warm_up

    _plant(monkeypatch, raises)
    result = run.run(tiny_cell("gan-6s"), SEED, 0.3, False, "cpu", time.time())
    assert result["correct"] is False and result["failed"] == result["attempted"] >= 1
