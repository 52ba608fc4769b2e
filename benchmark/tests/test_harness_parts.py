"""The harness's parts on the CPU: seeded traffic, the copied bound
arithmetic, the reference's tables against the port's key layout, the
reference against the port, the bf16 control, the no-JAX check and the
contract of ``BENCHMARK.json``."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from harness_tiny import TINY, tiny_cell

from benchmark import bounds, cell as cells, check, control, generator, run
from benchmark.cell import ROOT
from benchmark.reference import common
from benchmark.reference import session as ref_session

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traffic_repeats_for_a_seed_and_keeps_its_sizes_across_seeds(workload):
    mix = cells.load(workload).mix
    a, b = generator.generate(mix, 2**33 + 5), generator.generate(mix, 2**33 + 5)
    c = generator.generate(mix, 6)
    assert all(np.array_equal(x, y) for p, q in zip(a.clips, b.clips) for x, y in zip(p, q))
    assert np.array_equal(a.order, b.order)
    assert sorted(map(generator.samples, a.clips)) == sorted(map(generator.samples, c.clips))
    assert not np.array_equal(a.clips[0][0], c.clips[0][0])
    assert all(x.dtype == np.int16 and np.abs(x.astype(np.int32)).max() < 32767
               for clip in a.clips for x in clip)
    # each round serves every clip once
    n = len(a.clips)
    assert all(sorted(a.order[i: i + n]) == list(range(n)) for i in range(0, len(a.order), n))


def test_check_sample_draws_distinct_clips_with_the_longest():
    mix = cells.load("gan-clips").mix
    t = generator.generate(mix, 3)
    completed = [int(c) for c in t.order[:40]]
    picks = generator.check_sample(mix, 3, completed, t)
    clips = [completed[i] for i in picks]
    assert len(set(clips)) == len(clips) == mix["check"]["requests"]
    assert max(generator.samples(t.clips[c]) for c in clips) == max(map(generator.samples, t.clips))
    assert picks == generator.check_sample(mix, 3, completed, t)


def _meta(*shape):
    return torch.empty(shape, device="meta")


CALLS = {
    "stft": lambda: common.stft(_meta(32, 24000), 400, 100, "hamming", "reflect"),
    "istft": lambda: common.istft(_meta(32, 241, 402), 400, 100, "hamming"),
    "dwconv": lambda: common.conv1d({"w": _meta(256, 1, 31)}, _meta(964, 98, 256),
                                    padding=15, groups=256),
    "dwconv_grouped": lambda: common.conv1d({"w": _meta(256, 2, 39)}, _meta(4, 3999, 512),
                                            padding=38, dilation=2, groups=256),
    "quad_attention": lambda: common.quad_attention(_meta(964, 101, 128), _meta(964, 101, 128),
                                                    _meta(964, 101, 128), scale=1.0),
}


@pytest.mark.parametrize("kind, ms", [("stft", 0.004619), ("istft", 0.004619),
                                      ("dwconv", 0.0578), ("dwconv_grouped", 0.0147),
                                      ("quad_attention", 0.0751)])
def test_bounds_reproduce_the_kernel_table(kind, ms):
    """The work that each reference function records for its kernel, at the
    kernel table's shapes, gives the table's Bound ms."""
    with common.record_calls() as calls:
        CALLS[kind]()
    assert [c[0] for c in calls] == [kind]
    got = bounds.bound_s(*calls[0][1:], bounds.peaks("NVIDIA H100 80GB HBM3")) * 1e3
    assert abs(got - ms) <= 0.5 * 10 ** -(len(str(ms).split(".")[1])), got


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tuple(tree.shape)


@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
@pytest.mark.parametrize("size", ["tiny", "published"])
def test_reference_table_is_the_port_key_layout(workload, size):
    from audiojax_torch.params import params_from_numpy
    from audiojax_torch.runtime import registry

    cell = cells.load(workload)
    model = dict(cell.config["model"])
    if size == "tiny":
        model.update(TINY[cell.config["program"]["registry"]])
    spec = registry.get(cell.config["program"]["registry"])
    init = {"mossformergan_se": "init_mossformergan_numpy",
            "mossformer2_ss": "init_mossformer2_ss_numpy"}[spec.name]
    mod = sys.modules[spec.make_module.__module__]
    port = dict(_flat(params_from_numpy(getattr(mod, init)(0, spec.make_config(**model)), "cpu")))
    ours = {p: s for p, s, _, _ in cell.reference.param_table(model)}
    assert port == ours


@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
def test_kernel_calls_at_a_window_are_the_port_launches(workload):
    """The reference records as many kernel-shaped calls a forward as the
    port launches (GAN: 1 B1, 1 B2, 48 B4, 24 B6; SS: 96 B4, 24 B5, 24 B6)."""
    cell = cells.load(workload)
    calls, flops = check.work_at(cell, 2)
    kinds = {}
    for k, *_ in calls:
        kinds[k] = kinds.get(k, 0) + 1
    expect = ({"stft": 1, "istft": 1, "dwconv": 48, "quad_attention": 24}
              if workload.startswith("gan") else
              {"dwconv": 96, "dwconv_grouped": 24, "quad_attention": 24})
    assert kinds == expect
    assert flops == pytest.approx(2 * check.work_at(cell, 1)[1], rel=1e-9)


@pytest.mark.parametrize("workload", ["gan-6s", "ss-6s"])
def test_the_bf16_control_fails_the_limit(workload):
    """The control (the port's own bfloat16 plan) at test size reads above
    the limit that the program's float32 plan stays under (the TF32 controls
    need the card: ``test_harness_card``)."""
    torch.set_num_threads(1)
    cell = tiny_cell(workload)
    r = control.readings(cell, 5, "cpu", faults=False)
    limit = cell.config["check"]["worst_rel_err"]
    assert r["program"] < limit < r["bf16"], r


def test_reference_precision_is_set_and_put_back():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = True  # as a program might leave them
        with check.precision(False):
            assert not matmul.allow_tf32 and not cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert matmul.allow_tf32 and cudnn.allow_tf32
        with check.precision(True):
            assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class _Toy(torch.nn.Module):
    """Per window: each output source a fixed function of the inputs, with
    ``scale`` output samples an input sample."""

    def __init__(self, scale: int, sources: int):
        super().__init__()
        self.scale, self.sources = scale, sources

    def forward(self, *audio):
        return _toy(audio, self.scale, self.sources)


def _toy(audio, scale, sources):
    x = sum(a.to(torch.float32) * (i + 1) for i, a in enumerate(audio)) / (len(audio) + 1)
    x = x.repeat_interleave(scale, dim=-1)
    return tuple(torch.round(x * (0.9 - 0.2 * s)).to(torch.int16) for s in range(sources))


@pytest.mark.parametrize("geometry", [
    dict(window=800, pad_head=0, overlap=0, scale=1, inputs=1, channels=1, sources=1, n=3000),
    dict(window=800, pad_head=200, overlap=0, scale=1, inputs=1, channels=1, sources=2, n=2500),
    dict(window=1000, pad_head=0, overlap=300, scale=3, inputs=1, channels=1, sources=1, n=4321),
    dict(window=1000, pad_head=100, overlap=600, scale=1, inputs=2, channels=1, sources=1, n=3333),
    dict(window=900, pad_head=0, overlap=200, scale=1, inputs=1, channels=2, sources=2, n=2900),
    dict(window=900, pad_head=0, overlap=0, scale=1, inputs=1, channels=1, sources=1, n=2900,
         stereo_in=True, normalize_rms=3000.0),
])
def test_reference_session_serves_as_the_port_session(geometry):
    """The reference's plain copy of the session (windows, heads, overlap-add
    stitch, output scale, several inputs, channels, mono downmix, RMS) gives
    the port's ``Session`` output sample for sample, on a toy model."""
    from audiojax_torch.runtime.manifest import Manifest
    from audiojax_torch.runtime.session import Session

    g = dict(geometry)
    scale, sources, n = g.pop("scale"), g.pop("sources"), g.pop("n")
    stereo_in, rms = g.pop("stereo_in", False), g.pop("normalize_rms", None)
    manifest = Manifest(model_name="toy", task="denoise", model_family="toy",
                        model_sample_rate=16000, in_sample_rate=16000,
                        out_sample_rate=16000 * scale,
                        input_audio_length=g["window"], pad_head=g["pad_head"],
                        overlap_length=g["overlap"], num_audio_inputs=g["inputs"],
                        input_channels=g["channels"], normalize_audio_default=rms is not None,
                        normalize_target_rms=rms or 4096.0)
    serving = {**program_geometry(manifest), "bucket": "pow2"}
    rng = np.random.default_rng(0)
    ch = 2 if stereo_in or g["channels"] == 2 else 1
    clip = tuple(rng.integers(-9000, 9000, size=(ch, n) if ch > 1 else n).astype(np.int16)
                 for _ in range(g["inputs"]))
    port = Session(_Toy(scale, sources), manifest, device="cpu").process(*clip).outputs
    ours = ref_session.serve(lambda p, *a: _toy(a[:-1], scale, sources), None, clip, None,
                             serving, "cpu", 3)
    assert len(port) == len(ours) == sources
    for a, b in zip(port, ours):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


def program_geometry(manifest) -> dict:
    from benchmark import program

    return program.geometry_of(manifest.runtime_config())


def test_no_jax_check_compares_top_level_names_whole(monkeypatch):
    for name in ("jax.numpy", "audiojax.models", "flax", "chip_smoke"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in run.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    assert "audiojax" not in run.forbidden_modules() or "audiojax" in sys.modules


def test_a_cell_run_loads_nothing_of_jax():
    code = ("import sys, time; sys.path.insert(0, 'benchmark/tests'); "
            "from harness_tiny import tiny_cell; from benchmark import run; "
            "run.run(tiny_cell('gan-6s', strata=1, checked=1), 3, 0.1, True, 'cpu', time.time()); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_json_meets_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells_seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in cells_seen
        cells_seen.add((w["config"], w["traffic"]))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reporting = {w["name"] for w in BENCH["workloads"]
                     if "workloads" not in e2e[m["moves"]] or w["name"] in e2e[m["moves"]]["workloads"]}
        assert set(m["workloads"]) <= reporting
    for w in WORKLOADS:  # every cell reports setup_s, another end-to-end metric and a layer's
        cell = cells.load(w)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
