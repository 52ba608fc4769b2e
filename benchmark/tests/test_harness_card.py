"""On the card (marked ``card``; each skips without CUDA): a short run of
each cell is correct and reports its metrics, and the controls (TF32 and
bf16) at the cells' own size fail the limit.  The benchmark's runs and
``benchmark.control`` make the full readings; these hold that they still
work."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import cell as cells
from benchmark.cell import ROOT

WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(cells.load(workload).end_to_end)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
def test_controls_fail_on_the_card(card, workload):
    """The program passes the limit; TF32 in the program, TF32 in the
    reference and the port's bf16 plan each fail it."""
    from benchmark import control

    cell = cells.load(workload)
    r = control.readings(cell, 2**31 + 7, "cuda", faults=False)
    limit = cell.config["check"]["worst_rel_err"]
    assert r["program"] <= limit < min(r[k] for k in control.CONTROLS), r
