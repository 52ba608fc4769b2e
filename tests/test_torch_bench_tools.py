"""The port's ``utils/bench_all.py`` and ``utils/readme_tables.py`` against the
JAX package's, on the CPU.

``bench_model`` makes the JAX package's row (keys, ``model`` label with its
``+dtype`` / ``+plan`` / ``@bsN`` suffixes, ``baseline_rtf``, ``chunk_s``)
from the same registry entry at the same config; a CPU row has no
``mfu_pct`` (the port knows no CPU peak, where the JAX package assumes a
TPU's on any device).  The table functions are the JAX package's, text for
text on the same rows, and ``main`` writes only the port's regions of
README.md.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiojax.utils import bench_all as jbench
from audiojax.utils import readme_tables as jtables
from test_torch_ckpt_builders import TINY, one_thread  # noqa: F401
from torch_isolation import hide_module_stubs  # noqa: F401

from audiojax_torch import device as port_device
from audiojax_torch.utils import bench_all, readme_tables

REPO = Path(__file__).resolve().parents[1]
GTCRN_SMALL = {"channels": 8}  # GTCRN is small already: half its channels


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_row_keys_match_jax(batch):
    want = jbench.bench_model("gtcrn", iters=1, cfg_replace=GTCRN_SMALL, batch=batch)
    got = bench_all.bench_model("gtcrn", iters=1, cfg_replace=GTCRN_SMALL, batch=batch,
                                device="cpu")
    assert list(got) == [k for k in want if k != "mfu_pct"]
    assert got["model"] == want["model"] == ("gtcrn" if batch == 1 else "gtcrn@bs2")
    for k in ("baseline_rtf", "chunk_s"):
        assert got[k] == want[k], k
    assert got["rtf"] > 0 and got["gflops"] > 0 and got["latency_ms"] > 0
    assert got["vs_baseline"] == pytest.approx(got["baseline_rtf"] / got["rtf"], abs=0.006)


def test_bench_quant_row_matches_jax():
    """A q8f32 row of Mel-Band (tiny widths): the same label and keys, and an
    SNR against float32 near the JAX package's on its own forward."""
    cfg = TINY["melband_roformer"]
    want = jbench.bench_model("melband_roformer", iters=1, quant="q8f32", cfg_replace=cfg)
    got = bench_all.bench_model("melband_roformer", iters=1, quant="q8f32", cfg_replace=cfg,
                                device="cpu")
    assert list(got) == [k for k in want if k != "mfu_pct"]
    assert got["model"] == want["model"] == "melband_roformer+q8f32"
    assert got["snr_vs_f32_db"] == pytest.approx(want["snr_vs_f32_db"], abs=3.0)


def test_bench_all_main_keeps_sweeping(tmp_path, capsys):
    """An unknown name and a plan that quantizes nothing (GTCRN's weights are
    all under the q8 size floor) become ``error`` rows; the sweep goes on;
    ``--json-out`` leads with the card line."""
    out = tmp_path / "rows.jsonl"
    assert bench_all.main(["--models", "no_such_model,gtcrn", "--iters", "1", "--quant",
                           "q8f32", "--json-out", str(out), "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0] == {"card": "cpu"}
    rows = lines[1:]
    assert [r["model"] for r in rows] == ["no_such_model", "gtcrn", "gtcrn+q8f32"]
    assert "KeyError" in rows[0]["error"] and "ZERO leaves" in rows[2]["error"]
    assert "error" not in rows[1] and rows[1]["rtf"] > 0
    printed = capsys.readouterr().out
    assert "Card: cpu" in printed and "| no_such_model | ERROR: KeyError" in printed


def test_failed_flop_count_is_an_error(monkeypatch):
    """A count that fails raises into the row (no silent loss of the FLOP and
    MFU columns)."""
    def broken(model, inputs):
        raise RuntimeError("count failed")

    monkeypatch.setattr("audiojax_torch.utils.inspect_model.forward_cost", broken)
    with pytest.raises(RuntimeError, match="count failed"):
        bench_all.bench_model("gtcrn", iters=1, cfg_replace=GTCRN_SMALL, device="cpu")


def test_peak_flops_by_card(monkeypatch):
    """The H100's float32 and bf16 peaks by name; an unknown card raises."""
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: next(names))
    assert port_device.peak_flops("cuda", "float32") == 67e12
    assert port_device.peak_flops("cuda", "bfloat16") == 989e12
    with pytest.raises(ValueError, match="no peak FLOP/s known"):
        port_device.peak_flops("cuda", "float32")


def test_clip_and_baselines_match_jax():
    assert bench_all.BASELINES == jbench.BASELINES
    for shape, rate in (((1, 1000), 16000), ((2, 2, 300), 44100)):
        np.testing.assert_array_equal(bench_all._clip(shape, rate, seed=3),
                                      jbench._clip(shape, rate, seed=3))


# ── readme_tables ──────────────────────────────────────────────────────────

ROWS = [
    {"model": "gtcrn", "rtf": 0.004321, "latency_ms": 8.6, "chunk_s": 2.0,
     "baseline_rtf": 0.0036, "vs_baseline": 0.83, "gflops": 0.12, "tflops_per_s": 0.014,
     "mfu_pct": 0.02},
    {"model": "zipenhancer", "rtf": 0.0062, "latency_ms": 37.2, "chunk_s": 6.0,
     "baseline_rtf": 0.32, "vs_baseline": 51.61, "gflops": 380.1, "tflops_per_s": 10.2,
     "mfu_pct": 15.22},
    {"model": "zipenhancer+bfloat16", "rtf": 0.0047, "latency_ms": 28.2, "chunk_s": 6.0,
     "baseline_rtf": 0.32, "vs_baseline": 68.09, "gflops": 380.1, "tflops_per_s": 13.5,
     "mfu_pct": 1.37},
    {"model": "sdaec", "error": "RuntimeError: out of memory"},
    {"model": "melband_roformer", "rtf": 0.06, "latency_ms": 120.0, "chunk_s": 2.0,
     "baseline_rtf": 1.4, "vs_baseline": 23.33, "gflops": 704.3, "tflops_per_s": 5.9,
     "mfu_pct": 8.76},
    {"model": "melband_roformer+bfloat16", "rtf": 0.032, "latency_ms": 64.0, "chunk_s": 2.0,
     "baseline_rtf": 1.4, "vs_baseline": 43.75},
    {"model": "melband_roformer+q8f32", "rtf": 0.0615, "latency_ms": 123.0, "chunk_s": 2.0,
     "baseline_rtf": 1.4, "vs_baseline": 22.76, "snr_vs_f32_db": 39.7},
    {"model": "melband_roformer+q8dyn", "rtf": 0.071, "latency_ms": 142.0, "chunk_s": 2.0,
     "baseline_rtf": 1.4, "vs_baseline": 19.72, "snr_vs_f32_db": 35.2},
    {"model": "gtcrn@bs2", "rtf": 0.0021, "latency_ms": 8.4, "chunk_s": 2.0,
     "baseline_rtf": 0.0036, "vs_baseline": 1.71},
]
HEADLINE = {"value": 0.0075, "vs_baseline": 42.58, "zipenhancer_bf16_rtf": 0.0065,
            "zipenhancer_bf16_vs_baseline": 48.95, "gtcrn_rtf": 0.00006,
            "gtcrn_vs_baseline": 60.67, "gtcrn_stream_rtf_64ms_blocks": 0.0417}


def _region(text: str, tag: str) -> str:
    begin, end = f"<!-- {tag}:begin -->", f"<!-- {tag}:end -->"
    return text[text.index(begin): text.index(end) + len(end)]


def test_readme_tables_render_as_jax(tmp_path, capsys):
    for rows in (ROWS, [r for r in ROWS if "mfu_pct" not in r]):
        assert readme_tables.zoo_table(rows) == jtables.zoo_table(rows)
        assert readme_tables.quant_table(rows) == jtables.quant_table(rows)
    assert readme_tables.headline_table(HEADLINE) == jtables.headline_table(HEADLINE)
    text = "a\n<!-- t:begin -->\nold\n<!-- t:end -->\nb\n"
    assert (readme_tables.replace_region(text, "t", "new")
            == jtables.replace_region(text, "t", "new"))

    # main on a copy of README.md: the port's two regions filled, headed by the
    # card, and every other byte (the JAX section's regions too) unchanged
    readme = tmp_path / "README.md"
    original = (REPO / "README.md").read_text()
    readme.write_text(original)
    rows_file = tmp_path / "rows.jsonl"
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rows_file.write_text("".join(json.dumps(r) + "\n" for r in [{"card": card}, *ROWS]))
    assert readme_tables.main(["--readme", str(readme), "--zoo", str(rows_file)]) == 0
    updated = readme.read_text()
    for tag in ("zoo-table", "quant-table", "headline-table"):
        assert _region(updated, tag) == _region(original, tag), tag
    zoo = _region(updated, readme_tables.ZOO_TAG)
    assert f"Card: {card}\n\n{jtables.zoo_table(ROWS)}\n" in zoo
    assert f"Card: {card}\n\n{jtables.quant_table(ROWS)}\n" in _region(updated,
                                                                       readme_tables.QUANT_TAG)
    rest = updated.replace(zoo, "").replace(_region(updated, readme_tables.QUANT_TAG), "")
    assert rest == original.replace(_region(original, readme_tables.ZOO_TAG), "").replace(
        _region(original, readme_tables.QUANT_TAG), "")

    # the port has no headline benchmark yet: --headline names the missing region
    line = tmp_path / "line.json"
    line.write_text(json.dumps(HEADLINE))
    with pytest.raises(SystemExit, match="torch-headline-table"):
        readme_tables.main(["--readme", str(readme), "--headline", str(line)])
    assert readme.read_text() == updated
