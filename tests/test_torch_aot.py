"""Graph artifacts of the port (``runtime/aot.py``), case for case with
``tests/test_aot.py``.

A ``torch.export`` graph of the served forward, written into the artifact,
serves through ``Session`` with the artifact's own parameters as its inputs,
equal to the eager module at any window batch, and refuses what the JAX
package's graphs refuse (a parameter structure it was not traced for,
another device type, another format: the JAX package's StableHLO graph), a
batch above its bound and a batch without a static graph.  GTCRN serves at
its full width on 0.25 s windows (its GRU loops unroll in the trace); the
two-input case is NKF-AEC on 0.16 s windows: SDAEC's frequency LSTMs
unroll over 81 bins at every frame, and even a few frames make a graph that
takes minutes to export and load on the CPU; the mechanics (static
dispatch, stale files) run on a stub model of a few operators.  A host
that loads and serves a graph never imports ``audiojax_torch.models``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import wave
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiojax.runtime import aot as jaot
from audiojax.runtime import registry as jregistry
from audiojax.runtime.checkpoint import save_artifact as jsave
from test_torch_ckpt_builders import BUILDERS, one_thread  # noqa: F401
from torch_isolation import hide_module_stubs  # noqa: F401

from audiojax_torch.dsp.stft import StftConfig
from audiojax_torch.models.base import ParamModule
from audiojax_torch.models.nkf_aec import init_nkf_numpy
from audiojax_torch.ops.stft_cuda import fast_istft_packed, fast_stft_packed
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import aot, cli, registry
from audiojax_torch.runtime.checkpoint import load_artifact, save_artifact
from audiojax_torch.runtime.export import export_artifact
from audiojax_torch.runtime.session import Session

REPO = Path(__file__).resolve().parents[1]
GTCRN_WINDOW = 4000  # 0.25 s: 16 frames
NKF_WINDOW = 2560


def _windows(manifest, batch, seed=0):
    w = manifest.input_audio_length
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((batch, w)) * 3000).astype(np.int16))


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _snr(ref, out):
    ref, out = ref.astype(np.float64), out.astype(np.float64)
    err = np.sum((ref - out) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


@pytest.fixture(scope="module")
def gtcrn_artifact(tmp_path_factory):
    """GTCRN at full width on 0.25 s windows, weights from the JAX package's
    init (seed 0), saved and exported; with the loaded graph."""
    jspec = jregistry.get("gtcrn")
    jparams = jspec.init_params(jax.random.PRNGKey(0), jspec.make_config())
    spec = registry.get("gtcrn")
    cfg = spec.make_config()
    manifest = dataclasses.replace(spec.make_manifest(cfg), input_audio_length=GTCRN_WINDOW)
    tree = jax.tree.map(np.asarray, jparams)
    path = tmp_path_factory.mktemp("gtcrn_aot")
    save_artifact(path, tree, manifest)
    params = params_from_numpy(tree, "cpu")
    model = spec.make_module(params, cfg).eval()
    aot.attach_graph(path, model, manifest)
    return path, model, params, manifest, aot.load_compiled(path, params), jparams


def test_poly_graph_serves_any_batch(gtcrn_artifact):
    """One graph, exported from a batch of 2, equals the eager module bit for
    bit at batches 1 and 8."""
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    meta = json.loads((path / aot.GRAPH_META).read_text())
    assert meta["batch_mode"] == "poly", meta["symbolic_fallback_error"]
    assert meta["format"] == aot.FORMAT and meta["device"] == "cpu"
    assert meta["admissible_batches"] == "1..64"
    with torch.inference_mode():
        for batch in (1, 8):
            audio = _windows(manifest, batch, seed=batch)
            np.testing.assert_array_equal(compiled(audio).numpy(), model(audio).numpy())


def test_graph_stores_no_weight(gtcrn_artifact, tmp_path):
    """The parameters are graph inputs: the graph file holds no weight and no
    example inputs, and other weights of the same structure serve through it."""
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    with zipfile.ZipFile(path / aot.GRAPH_FILE) as z:
        sizes = {i.filename.split("/", 1)[1]: i.file_size for i in z.infolist()}
    assert not [f for f in sizes if "/weights/" in f and not f.endswith(".json")]
    assert sum(n for f, n in sizes.items() if "sample_inputs" in f) < 1024
    spec = registry.get("gtcrn")
    other = spec.init_params(7, spec.make_config(), "cpu")
    audio = _windows(manifest, 2, seed=5)
    with torch.inference_mode():
        want = spec.make_module(other, spec.make_config())(audio)
        got = aot.CompiledGraph(aot.flat_params(other), compiled.graphs, compiled.max_batch)(audio)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_session_serves_from_graph(gtcrn_artifact):
    """Session(<loaded graph>) == Session(<module>) on a clip of several windows."""
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    clip = _windows(manifest, 3, seed=7).numpy().reshape(-1)[:10000]
    out_py = Session(model, manifest, device="cpu").process(clip)
    out_aot = Session(compiled, manifest, device="cpu").process(clip)
    np.testing.assert_array_equal(out_aot.audio, out_py.audio)


def test_graph_matches_jax_module(gtcrn_artifact):
    """The graph against the JAX package's forward on the same weights."""
    path, model, params, manifest, compiled, jparams = gtcrn_artifact
    jspec = jregistry.get("gtcrn")
    audio = _windows(manifest, 2, seed=9)
    want = np.asarray(jax.jit(jspec.make_forward(jspec.make_config()))(jparams, audio.numpy()))
    with torch.inference_mode():
        got = compiled(audio).numpy()
    assert got.shape == want.shape
    assert _snr(want, got) >= 40.0


def test_params_fingerprint_fail_closed(gtcrn_artifact):
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    bad = dict(params)
    bad["extra"] = torch.zeros(3)
    with pytest.raises(ValueError, match="mismatch"):
        aot.load_compiled(path, bad)


def test_device_scope_fail_closed(gtcrn_artifact, tmp_path):
    """A graph holds the device it was traced on: one exported on the card
    refuses parameters on the CPU (the JAX package's platform scope)."""
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    clone = _copy(path, tmp_path / "art")
    meta = json.loads((clone / aot.GRAPH_META).read_text())
    meta["device"] = "cuda"
    (clone / aot.GRAPH_META).write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="device type 'cuda'"):
        aot.load_compiled(clone, params)


def test_jax_graph_refused(tmp_path):
    """A graph artifact of the JAX package (graph.stablehlo + its graph.json)
    is refused by name, by the library and by the CLI."""
    spec = jregistry.get("gtcrn")
    manifest = spec.make_manifest(spec.make_config())
    jparams = {"gain": jax.numpy.ones((3,))}
    jsave(tmp_path, jparams, manifest)
    jaot.attach_graph(tmp_path, lambda p, a: a, jparams, manifest, static_batches=(1,))
    assert (tmp_path / "graph.stablehlo").is_file() and aot.has_graph(tmp_path)
    with pytest.raises(ValueError, match="jax.export/stablehlo"):
        aot.load_compiled(tmp_path, {"gain": torch.ones(3)})
    with pytest.raises(ValueError, match="jax.export/stablehlo"):
        aot.prepare_for_graph({"gain": torch.ones(3)}, tmp_path)


# ── the mechanics, on a stub model ─────────────────────────────────────────

STUB_STFT = StftConfig(64, 16, window="hann")


class _Stub(ParamModule):
    """STFT → a gain a packed bin → ISTFT, through the kernels' routing points;
    ``stubborn`` reads the batch size as an int, which specialises it."""

    stubborn = False

    def forward(self, audio):
        if self.stubborn:
            int(audio.shape[0])
        spec = fast_stft_packed(audio.float() / 32768.0, STUB_STFT) * self.params["gain"]
        y = fast_istft_packed(spec, STUB_STFT, audio.shape[-1])
        return torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(torch.int16)


def _stub(stubborn=False, seed=0):
    rng = np.random.default_rng(seed)
    gain = (1.0 + 0.1 * rng.standard_normal(2 * STUB_STFT.f_bins)).astype(np.float32)
    model = _Stub({"gain": torch.from_numpy(gain)}, None).eval()
    model.stubborn = stubborn
    spec = registry.get("gtcrn")
    manifest = dataclasses.replace(spec.make_manifest(spec.make_config()), input_audio_length=512)
    return model, manifest


def test_static_fallback_dispatch(tmp_path):
    """A forward that rejects a symbolic batch falls back to static graphs;
    dispatch keys on the window batch and an unknown one fails clearly."""
    model, manifest = _stub(stubborn=True, seed=1)
    aot.attach_graph(tmp_path, model, manifest, static_batches=(1, 2))
    meta = json.loads((tmp_path / aot.GRAPH_META).read_text())
    assert meta["batch_mode"] == "static" and meta["admissible_batches"] == [1, 2]
    assert meta["symbolic_fallback_error"]
    compiled = aot.load_compiled(tmp_path, model.params)
    with torch.inference_mode():
        for batch in (1, 2):
            audio = _windows(manifest, batch, seed=11)
            np.testing.assert_array_equal(compiled(audio).numpy(), model(audio).numpy())
        with pytest.raises(ValueError, match="batch-3"):
            compiled(_windows(manifest, 3))


def test_batch_above_bound_refused(tmp_path):
    """A symbolic graph serves batches up to its max_batch and refuses more."""
    model, manifest = _stub()
    aot.attach_graph(tmp_path, model, manifest, max_batch=4)
    compiled = aot.load_compiled(tmp_path, model.params)
    with torch.inference_mode():
        audio = _windows(manifest, 4, seed=2)
        np.testing.assert_array_equal(compiled(audio).numpy(), model(audio).numpy())
        with pytest.raises(ValueError, match="window batches <= 4"):
            compiled(_windows(manifest, 5))


def test_reexport_drops_stale_blobs(tmp_path):
    """A re-export in the other batch mode leaves no graph file of the earlier one."""
    model, manifest = _stub()
    aot.attach_graph(tmp_path, model, manifest)
    assert (tmp_path / aot.GRAPH_FILE).is_file()
    model.stubborn = True
    aot.attach_graph(tmp_path, model, manifest, static_batches=(1,))
    assert not (tmp_path / aot.GRAPH_FILE).exists()
    assert (tmp_path / "graph.b1.pt2").is_file()
    model.stubborn = False
    aot.attach_graph(tmp_path, model, manifest)
    assert (tmp_path / aot.GRAPH_FILE).is_file()
    assert sorted(p.name for p in tmp_path.glob("graph*.pt2")) == [aot.GRAPH_FILE]


def test_empty_static_batches_is_an_error(tmp_path):
    model, manifest = _stub(stubborn=True)
    with pytest.raises(ValueError, match="static_batches is empty"):
        aot.attach_graph(tmp_path, model, manifest, static_batches=())
    assert not (tmp_path / aot.GRAPH_META).exists()


def test_prepare_for_graph_reproduces_compute_dtype(gtcrn_artifact, tmp_path):
    """graph.json records the served tree's compute dtype; prepare_for_graph
    gives the tree that registry.prepare_compute_params gives, q8 trees
    untouched; MossFormer2-SR's own preparation (its generator float32) is
    not a uniform cast, and its graph refuses the generic one."""
    path, model, params, manifest, compiled, _ = gtcrn_artifact
    clone = _copy(path, tmp_path / "art")
    meta = json.loads((clone / aot.GRAPH_META).read_text())
    assert meta["params_compute_dtype"] is None
    assert aot.prepare_for_graph(params, clone) is params

    meta["params_compute_dtype"] = "bfloat16"
    (clone / aot.GRAPH_META).write_text(json.dumps(meta))
    prepared = aot.prepare_for_graph(params, clone)
    assert {t.dtype for t in aot.flat_params(prepared).values()} == {torch.bfloat16}
    q8 = {"w": {"q8": torch.zeros(4, dtype=torch.int8), "scale": torch.ones(1)}, "b": torch.ones(2)}
    assert aot.prepare_for_graph(q8, clone) is q8

    for name in ("zipenhancer", "mossformer2_sr"):
        spec = registry.get(name)
        cfg = spec.make_config(compute_dtype="bfloat16")
        tree = spec.init_params(0, cfg, "cpu")
        served = registry.prepare_compute_params(tree, cfg, spec)
        meta["params_fingerprint"] = aot._params_fingerprint(aot.flat_params(served))
        (clone / aot.GRAPH_META).write_text(json.dumps(meta))
        generic = aot.prepare_for_graph(tree, clone)
        if name == "zipenhancer":
            for a, b in zip(aot.flat_params(generic).values(), aot.flat_params(served).values()):
                assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            with pytest.raises(ValueError, match="mismatch"):
                aot.load_compiled(clone, generic)


@pytest.fixture(scope="module")
def nkf_artifact(tmp_path_factory):
    spec = registry.get("nkf_aec")
    cfg = spec.make_config()
    manifest = dataclasses.replace(spec.make_manifest(cfg), input_audio_length=NKF_WINDOW)
    tree = init_nkf_numpy(2, cfg)
    params = params_from_numpy(tree, "cpu")
    path = tmp_path_factory.mktemp("nkf_aot")
    save_artifact(path, tree, manifest)
    model = spec.make_module(params, cfg).eval()
    aot.attach_graph(path, model, manifest, static_batches=(1,))
    return path, model, params, manifest


def test_two_input_model_graph(nkf_artifact):
    """An echo canceller (two audio inputs) exports and serves through the same path."""
    path, model, params, manifest = nkf_artifact
    compiled = aot.load_compiled(path, params)
    near, far = _windows(manifest, 2, seed=3), _windows(manifest, 2, seed=4)
    with torch.inference_mode():
        np.testing.assert_array_equal(compiled(near, far).numpy(), model(near, far).numpy())


def test_graph_host_never_imports_models(nkf_artifact, tmp_path):
    """Loading and serving a graph artifact imports runtime and ops, never
    audiojax_torch.models; the answer equals the eager module's."""
    path, model, params, manifest = nkf_artifact
    rng = np.random.default_rng(5)
    near, far = ((rng.standard_normal(5000) * 3000).astype(np.int16) for _ in range(2))
    want = Session(model, manifest, device="cpu").process(near, far).audio
    np.save(tmp_path / "near.npy", near)
    np.save(tmp_path / "far.npy", far)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)  # as this process: the same sums' order\n"
        "from audiojax_torch.runtime import aot\n"
        "from audiojax_torch.runtime.checkpoint import load_artifact\n"
        "from audiojax_torch.runtime.session import Session\n"
        "art, d = sys.argv[1], sys.argv[2]\n"
        "params, manifest = load_artifact(art, 'cpu')\n"
        "model = aot.load_compiled(art, aot.prepare_for_graph(params, art))\n"
        "out = Session(model, manifest, device='cpu').process(np.load(d + '/near.npy'),\n"
        "                                                     np.load(d + '/far.npy'))\n"
        "np.save(d + '/out.npy', out.audio)\n"
        "print(sorted(m for m in sys.modules if m.startswith('audiojax')))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, str(path), str(tmp_path)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "audiojax_torch.runtime.aot" in proc.stdout
    assert "audiojax_torch.models" not in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def _write_wav(path, audio, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.astype("<i2").tobytes())


def _read_wav(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def test_export_aot_and_cli_aot(tmp_path, capsys):
    """``export --aot`` (DFSMN at its defaults, a synthetic checkpoint) writes
    graph.pt2 and graph.json and reports them; ``cli --aot`` serves the graph,
    equal to the CLI without it; without a graph ``--aot`` exits 2."""
    spec = registry.get("dfsmn")
    ckpt = tmp_path / "dfsmn.pt"
    torch.save(BUILDERS["dfsmn"](spec.make_config(), seed=0), ckpt)
    art = tmp_path / "art"
    from audiojax_torch.runtime import export as texport

    assert texport.main(["--model", "dfsmn", "--checkpoint", str(ckpt), "--out", str(art),
                         "--device", "cpu", "--aot", "--no-smoke"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["aot"] == str(art / aot.GRAPH_META)
    assert report["aot_batch_mode"] == "poly" and report["aot_admissible_batches"] == "1..64"
    assert (art / aot.GRAPH_FILE).is_file()

    rng = np.random.default_rng(0)
    clip = (rng.standard_normal(100000) * 3000).astype(np.int16)
    wav = tmp_path / "in.wav"
    _write_wav(wav, clip, 48000)
    outs = {}
    for flag in ([], ["--aot"]):
        out = tmp_path / f"out{len(flag)}.wav"
        assert cli.main(["--model", "dfsmn", "--artifact", str(art), "--input", str(wav),
                         "--output", str(out), "--device", "cpu", *flag]) == 0
        outs[len(flag)] = _read_wav(out)
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[0].shape == clip.shape

    bare = tmp_path / "bare"
    export_artifact("dfsmn", str(ckpt), bare, smoke=False)
    assert cli.main(["--model", "dfsmn", "--artifact", str(bare), "--input", str(wav),
                     "--device", "cpu", "--aot"]) == 2
    assert "--aot needs an --artifact containing a serialized graph" in capsys.readouterr().err
    params, _ = load_artifact(art, "cpu")
    assert aot.load_compiled(art, params).max_batch == 64
