"""A new configuration, reference, traffic mix and per-layer metric are new
files and new entries in ``BENCHMARK.json`` alone: in a copy of the
benchmark, with no file that is there edited, a cell built of them runs and
reports the new metrics, the new reference's kernel kind with the work that
its own file counts.  And a checkout that holds only the benchmark (no
program) gives no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark.cell import ROOT

NEW_CONFIG = {**json.loads((ROOT / "benchmark/configs/mossformergan_se-f32.json").read_text()),
              "name": "mossformergan_se-tiny", "reference": "gan_marked"}
NEW_CONFIG["model"] = {**NEW_CONFIG["model"], "emb_dim": 16, "emb_ks": 2, "uv_channels": 24,
                       "n_blocks": 1, "dense_depth": 2, "lorder": 4, "mf_hidden": 32,
                       "mf_vdim": 16, "mf_qk": 16, "mf_rot": 8, "dw_kernel": 7,
                       "attn_heads": 2, "attn_q_ch": 2, "attn_v_ch": 4}
# a stereo mix of two voices, one of them late: the model takes mono, so the
# session (and the reference's copy of it) averages the channels
NEW_MIX = {"sample_rate": 16000, "lengths_s": {"law": "fixed", "value": 3.0, "strata": 2},
           "voices": 2,
           "inputs": [[[{"voice": 0, "gain": 0.6}, {"voice": 1, "gain": 0.3, "delay_s": 0.05}],
                       [{"voice": 0, "gain": 0.3}, {"voice": 1, "gain": 0.6}]]],
           "check": {"requests": 1, "longest": False}}
NEW_METRIC = '''"""Requests completed in the window."""


def read(record):
    return float(len(record["requests"]))
'''
# a reference that stands in for one more kernel, and counts that kernel's work
NEW_REFERENCE = '''"""The GAN's reference, with one more kernel-shaped call a forward."""
from benchmark.reference import common, mossformergan_se as base

param_table, output_sources = base.param_table, base.output_sources


def forward(params, audio, cfg):
    common.record("marked_kernel", 2.0e9, 1.0e6)
    return base.forward(params, audio, cfg)
'''
NEW_KIND_METRIC = '''"""Calls of the marked kernel in the traced slice."""


def read(record):
    s = record["slice"]
    return float(s["calls"]["marked_kernel"]) if s and s["calls"].get("marked_kernel") else None
'''


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_config_traffic_and_metric_added_as_files(tmp_path):
    dst = _copy(tmp_path)
    os.symlink(ROOT / "audiojax_torch", dst / "audiojax_torch")
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*") if p.is_file()}
    (dst / "benchmark/configs/mossformergan_se-tiny.json").write_text(json.dumps(NEW_CONFIG))
    (dst / "benchmark/traffic/short-clips.json").write_text(json.dumps(NEW_MIX))
    (dst / "benchmark/metrics/requests_done.py").write_text(NEW_METRIC)
    (dst / "benchmark/metrics/marked_calls.py").write_text(NEW_KIND_METRIC)
    (dst / "benchmark/reference/gan_marked.py").write_text(NEW_REFERENCE)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mossformergan_se-tiny", "source": "https://example.org",
                             "file": "benchmark/configs/mossformergan_se-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-short", "config": "mossformergan_se-tiny",
                               "traffic": "short-clips", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "serving",
                               "moves": "audio_s_per_s", "workloads": ["tiny-short"]})
    bench["per_layer"].append({"name": "marked_calls", "unit": "calls", "better": "lower",
                               "source": "device_trace", "layer": "marked kernel",
                               "moves": "audio_s_per_s", "workloads": ["tiny-short"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing there was edited

    code = ("import json, time, torch; torch.set_num_threads(1); "
            "from benchmark import cell, check, run; "
            "c = cell.load('tiny-short'); "
            "print([k for k in check.work_at(c, 1)[0] if k[0] == 'marked_kernel']); "
            "print(json.dumps(run.run(c, 11, 0.2, True, 'cpu', time.time())))")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[('marked_kernel', 2000000000.0, 1000000.0)]"
    line = json.loads(lines[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["requests_done"]["value"] >= 1
    assert line["metrics"]["marked_calls"]["value"] >= 1


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    dst = _copy(tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gan-6s",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=dst,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert not out.stdout.strip()
