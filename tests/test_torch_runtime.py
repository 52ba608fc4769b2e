"""The port's package boundary and serving runtime on the CPU.

Isolation (the port never imports JAX or the JAX package), entry points that
default to the card and refuse to fall back, the kernel build's failure path,
the CLI, the manifest and the stitch.
"""
import ast
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from audiojax.runtime.manifest import Manifest as JManifest
from audiojax.runtime.session import Session as JSession

from audiojax_torch.models.base import ParamModule
from audiojax_torch.models.gtcrn import GTCRN, GtcrnConfig, init_gtcrn, init_gtcrn_numpy
from audiojax_torch.models.mossformergan_se import (MossFormerGAN, MossFormerGanConfig,
                                                    init_mossformergan)
from audiojax_torch.models.mossformer2_ss import MossFormer2SsConfig, init_mossformer2_ss
from audiojax_torch.models.zipenhancer import ZipEnhancerConfig, init_zipenhancer
from audiojax_torch.ops import _build
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli, registry
from audiojax_torch.runtime.manifest import Manifest
from audiojax_torch.runtime.session import Session

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audiojax_torch"


def test_import_pulls_in_no_jax():
    """Every module of the port imports in a fresh interpreter without putting
    jax or audiojax (or any of their submodules), flax or msgpack into
    sys.modules, and without building a kernel."""
    code = (
        "import importlib, pkgutil, sys, audiojax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(audiojax_torch.__path__, 'audiojax_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert {'audiojax_torch.nn.zipformer', 'audiojax_torch.models.zipenhancer',\n"
        "        'audiojax_torch.models.mossformer2_ss', 'audiojax_torch.importers.common',\n"
        "        'audiojax_torch.importers.gtcrn', 'audiojax_torch.importers.mossformergan_se',\n"
        "        'audiojax_torch.importers.zipenhancer', 'audiojax_torch.importers.mossformer2_ss',\n"
        "        'audiojax_torch.runtime.checkpoint', 'audiojax_torch.runtime.export',\n"
        "        'audiojax_torch.runtime.streaming', 'audiojax_torch.models.dfsmn',\n"
        "        'audiojax_torch.frontend.kaldi', 'audiojax_torch.importers.dfsmn',\n"
        "        'audiojax_torch.models.mossformer2_se', 'audiojax_torch.models.ul_unas',\n"
        "        'audiojax_torch.models.nkf_aec', 'audiojax_torch.importers.ul_unas',\n"
        "        'audiojax_torch.importers.nkf', 'audiojax_torch.nn.cfb',\n"
        "        'audiojax_torch.models.sdaec', 'audiojax_torch.models.deep_echo',\n"
        "        'audiojax_torch.models.dfsmn_aec', 'audiojax_torch.importers.sdaec',\n"
        "        'audiojax_torch.importers.deep_echo', 'audiojax_torch.importers.dfsmn_aec',\n"
        "        'audiojax_torch.runtime.vad', 'audiojax_torch.utils.profiling',\n"
        "        'audiojax_torch.utils.bench_all', 'audiojax_torch.utils.readme_tables',\n"
        "        'audiojax_torch.utils.ablation', 'audiojax_torch.utils.zip_profile',\n"
        "        'audiojax_torch.utils.gan_profile', 'audiojax_torch.utils.ss_profile',\n"
        "        'audiojax_torch.utils.parity', 'audiojax_torch.utils.parity_suite'} <= set(mods)\n"
        "assert len(mods) > 15, mods\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'audiojax', 'flax', 'msgpack'))\n"
        "assert not bad, bad\n"
        "from audiojax_torch.ops import _build\n"
        "assert _build.load.cache_info().currsize == 0\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    """A scan of every import statement in the port, chip_smoke.py, the
    three geometry sweeps, the dwconv probe and the checkpoint builders
    chip_smoke.py imports."""
    files = [p for p in PORT.rglob("*.py") if "_build" not in p.parts] + [
        REPO / "chip_smoke.py", REPO / "stft_geometry_sweep.py",
        REPO / "attention_geometry_sweep.py", REPO / "dwconv_geometry_sweep.py",
        REPO / "dwconv_probe.py", REPO / "tests" / "test_torch_ckpt_builders.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "audiojax", "flax", "msgpack"}, (path, roots)


# ── the card by default, no quiet fallback ─────────────────────────────────


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _gtcrn_module():
    return GTCRN(init_gtcrn(0, device="cpu"))


def test_entry_points_default_to_the_card(no_cuda):
    cfg = GtcrnConfig()
    manifest = registry.get("gtcrn").make_manifest(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session(_gtcrn_module(), manifest)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_gtcrn(0, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        params_from_numpy(init_gtcrn_numpy(0, cfg))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session(_gtcrn_module(), manifest, device="cuda")
    Session(_gtcrn_module(), manifest, device="cpu")  # asked for: fine

    gan_cfg = MossFormerGanConfig(n_blocks=1)
    gan_manifest = registry.get("mossformergan_se").make_manifest(gan_cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_mossformergan(0, gan_cfg)
    gan = MossFormerGAN(init_mossformergan(0, gan_cfg, device="cpu"), gan_cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session(gan, gan_manifest)
    Session(gan, gan_manifest, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_zipenhancer(0, ZipEnhancerConfig())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_mossformer2_ss(0, MossFormer2SsConfig(depth=1))


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A failed nvcc raises; nothing falls back to the plain versions."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("stft")
    with pytest.raises(RuntimeError, match="nvcc failed"):  # a failure is not cached
        _build.load("stft")
    assert not list(tmp_path.iterdir())  # no half-written library left behind


def test_kernel_source_build_failure_raises(monkeypatch, tmp_path):
    """A source text (a kernel variant for a probe) that nvcc refuses raises,
    and leaves neither the text nor a library behind."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc failed for probe"):
        _build.load_source("probe", "__global__ void k() {}\n")
    assert not list(tmp_path.iterdir())


def test_params_refuse_unknown_layouts():
    for shape in ((3,), (1, 2, 3, 4, 5)):
        with pytest.raises(ValueError, match=f"{len(shape)}-D weight"):
            params_from_numpy({"conv": {"w": np.zeros(shape, np.float32)}}, device="cpu")
    # a 3-D conv1d kernel: WIO (k, in/groups, out) → torch's (out, in/groups, k)
    w = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    out = params_from_numpy({"conv1d": {"w": w}}, device="cpu")["conv1d"]["w"]
    assert out.shape == (5, 4, 3) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), w.transpose(2, 1, 0))
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy({"w": np.zeros((3, 4), np.float64)}, device="cpu")


def test_params_carry_lists():
    """A ``mem_stack``-shaped list of dicts (MossFormer2-SS) and a list of
    arrays stay lists in order, their items converted under the list's key; an
    object leaf is refused with its key path named."""
    rng = np.random.default_rng(0)
    stack = [{"conv": {"w": rng.standard_normal((39, j + 1, 4)).astype(np.float32)},
              "norm": {"g": np.full((4,), j, np.float32)}} for j in range(2)]
    taps = [np.full((3, 2, 5), i, np.float32) for i in range(3)]
    out = params_from_numpy({"fsmn0": {"mem_stack": stack, "w": taps}}, device="cpu")["fsmn0"]
    assert isinstance(out["mem_stack"], list) and len(out["mem_stack"]) == 2
    for j, item in enumerate(out["mem_stack"]):
        np.testing.assert_array_equal(item["conv"]["w"].numpy(),
                                      stack[j]["conv"]["w"].transpose(2, 1, 0))
        assert float(item["norm"]["g"][0]) == j
    assert [tuple(t.shape) for t in out["w"]] == [(5, 2, 3)] * 3  # conv1d layout, in order
    assert [float(t[0, 0, 0]) for t in out["w"]] == [0.0, 1.0, 2.0]
    bad = np.empty(2, dtype=object)
    with pytest.raises(TypeError, match="'fsmn0/mem_stack/1/norm/g' is object"):
        params_from_numpy({"fsmn0": {"mem_stack": [stack[0], {"norm": {"g": bad}}]}},
                          device="cpu")


def test_param_module_keeps_the_tree_shape():
    """A module's ``params`` gives back the tree it was made from: a list stays
    a list in order, and a dict whose keys are indices stays a dict."""
    tree = {"mem_stack": [{"g": torch.full((2,), 0.0)}, {"g": torch.full((2,), 1.0)}],
            "bands": {"0": torch.zeros(3), "1": torch.ones(3)}}
    back = ParamModule(tree, cfg=None).params
    assert isinstance(back["mem_stack"], list) and isinstance(back["bands"], dict)
    assert [float(item["g"][0]) for item in back["mem_stack"]] == [0.0, 1.0]
    assert sorted(back["bands"]) == ["0", "1"] and float(back["bands"]["1"][0]) == 1.0


# ── CLI ────────────────────────────────────────────────────────────────────


def _write_wav(path, audio, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.astype("<i2").tobytes())


def test_cli_denoises_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(0)
    audio = np.round(rng.standard_normal(24000) * 2000).astype(np.int16)
    src, dst = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    _write_wav(src, audio)
    rc = cli.main(["--model", "gtcrn", "--input", str(src), "--output", str(dst),
                   "--device", "cpu", "--seed", "3"])
    assert rc == 0
    with wave.open(str(dst), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 16000)
        out = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert out.shape == audio.shape and np.any(out)
    assert "RTF" in capsys.readouterr().out


@pytest.mark.parametrize("name,rate", [("gtcrn", 16000), ("dfsmn", 48000), ("ul_unas", 16000)])
def test_cli_streams_on_cpu(name, rate, tmp_path, capsys):
    """``--stream`` pushes the whole clip through a StreamingSession, flushes,
    and writes as many samples as it read; the printed latency is one block
    plus n_fft − hop."""
    audio = np.round(np.random.default_rng(1).standard_normal(rate // 2 + 123) * 2000)
    src, dst = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    _write_wav(src, audio.astype(np.int16), rate)
    rc = cli.main(["--model", name, "--input", str(src), "--output", str(dst), "--device", "cpu",
                   "--stream", "--block-hops", "2"])
    assert rc == 0
    with wave.open(str(dst), "rb") as w:
        assert w.getframerate() == rate and w.getnframes() == audio.size
        assert np.any(np.frombuffer(w.readframes(w.getnframes()), "<i2"))
    cfg = registry.get(name).make_config()
    latency = 2 * cfg.hop + cfg.n_fft - cfg.hop
    out = capsys.readouterr().out
    assert "streaming RTF" in out and f"algorithmic latency {latency} samples" in out


def test_cli_stream_refuses_a_model_without_streaming(tmp_path, capsys):
    src = tmp_path / "in.wav"
    _write_wav(src, np.zeros(16000, np.int16))
    assert cli.main(["--model", "zipenhancer", "--input", str(src), "--device", "cpu",
                     "--stream"]) == 2
    assert ("streaming models: ['deep_echo', 'dfsmn', 'dfsmn_aec', 'gtcrn', 'nkf_aec', "
            "'sdaec', 'ul_unas']" in capsys.readouterr().err)


def test_cli_list_and_default_device(no_cuda, tmp_path, capsys):
    assert cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == ["deep_echo", "dfsmn", "dfsmn_aec", "gtcrn",
                                               "h_gtcrn", "melband_roformer",
                                               "melband_roformer_stereo", "mossformer2_se",
                                               "mossformer2_sr", "mossformer2_ss",
                                               "mossformergan_se", "nkf_aec", "sdaec",
                                               "ul_unas", "zipenhancer"]
    src = tmp_path / "in.wav"
    _write_wav(src, np.zeros(16000, np.int16))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["--model", "gtcrn", "--input", str(src)])


# ── manifest and stitch against the JAX package ────────────────────────────


def test_manifest_contract():
    data = {k: v for k, v in vars(JManifest("m", "denoise", "f", 16000, 16000, 16000, 32000)).items()}
    assert Manifest.from_dict(dict(data)).runtime_config() == JManifest.from_dict(dict(data)).runtime_config()
    del data["model_family"]
    with pytest.raises(KeyError, match="model_family"):
        Manifest.from_dict(data)
    with pytest.raises(ValueError, match="unknown task"):
        Manifest("m", "karaoke", "f", 16000, 16000, 16000, 32000)


@pytest.mark.parametrize("overlap", [0, 4000])
def test_stitch_matches_jax(overlap):
    """Butt-join, and the Hann-taper overlap-add used by overlapped manifests."""
    kw = dict(model_name="m", task="denoise", model_family="f", in_sample_rate=16000,
              out_sample_rate=16000, model_sample_rate=16000, input_audio_length=16000,
              overlap_length=overlap)
    windows = np.random.default_rng(1).standard_normal((5, 16000)).astype(np.float32)
    stride = 16000 - overlap
    ref = JSession(lambda p, a: a, None, JManifest(**kw), jit=False)._stitch(windows, stride, 1.0)
    port = Session(torch.nn.Identity(), Manifest(**kw), device="cpu")
    out = port._stitch(windows, stride, 1.0)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_session_window_geometry_and_pad_head():
    """Power-of-two bucketing, PAD_HEAD prefix and trim, through an identity model."""
    kw = dict(model_name="m", task="denoise", model_family="f", in_sample_rate=16000,
              out_sample_rate=16000, model_sample_rate=16000, input_audio_length=1000)
    seen = []

    class Echo(torch.nn.Module):
        def forward(self, a):
            seen.append(tuple(a.shape))
            return a

    audio = np.arange(4500, dtype=np.int16)
    for pad_head in (0, 300):
        r = Session(Echo(), Manifest(**kw, pad_head=pad_head), device="cpu").process(audio)
        np.testing.assert_array_equal(r.audio, audio)
    assert seen == [(8, 1000), (8, 1000)]  # 5 windows → 8
