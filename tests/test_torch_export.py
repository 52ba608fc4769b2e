"""The port's artifact path against audiojax.runtime.export / checkpoint.

The JAX package's ``export_artifact(…, smoke=False)`` and the port's run on
the same synthetic upstream dict (``test_torch_ckpt_builders``; GTCRN at its
defaults, the others at the port's tiny test widths).  Their manifests are
equal as JSON, and the port's ``params.pt`` holds the arrays the JAX
package's ``load_artifact`` returns, bit for bit.  ``load_artifact`` serves
exactly what ``params_from_numpy`` of the import tree serves; the export's
smoke request runs on the CPU when asked; the CLI serves an artifact
(MossFormer2-SE's bf16 one too, refused until ROADMAP A.10's rest), and
refuses a mismatched model, a bf16 artifact of a family without the
compute-dtype knob, and (like the export) to run without CUDA unless given
``--device cpu``.
"""
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from audiojax.runtime.checkpoint import load_artifact as jload
from audiojax.runtime.export import export_artifact as jexport
from test_torch_ckpt_builders import BUILDERS, TINY, one_thread, tiny_config  # noqa: F401
from test_torch_importers import JCONFIGS, assert_trees_equal

from audiojax_torch.importers import import_checkpoint
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli, registry
from audiojax_torch.runtime import export as texport_mod
from audiojax_torch.runtime.checkpoint import load_artifact, load_tree
from audiojax_torch.runtime.export import export_artifact
from audiojax_torch.runtime.session import Session

REPO = Path(__file__).resolve().parents[1]
FAMILIES = sorted(BUILDERS)


def _export_port(name, tmp_path, seed=5, **kw):
    cfg = tiny_config(name)
    sd = BUILDERS[name](cfg, seed=seed)
    out = tmp_path / f"{name}_port"
    report = export_artifact(name, sd, out, cfg=cfg, **kw)
    return cfg, sd, out, report


@pytest.mark.parametrize("name", FAMILIES)
def test_artifact_equals_jax_export(name, tmp_path):
    cfg, sd, out, report = _export_port(name, tmp_path, smoke=False)
    assert report == {"artifact": str(out), "model": name}
    jout = tmp_path / f"{name}_jax"
    jexport(name, sd, jout, cfg=JCONFIGS[name](**TINY[name]), smoke=False)
    assert sorted(p.name for p in out.iterdir()) == [
        "import_report.json", "manifest.json", "params.pt"]
    for f in ("manifest.json", "import_report.json"):
        assert json.loads((out / f).read_text()) == json.loads((jout / f).read_text()), f
    jparams, _ = jload(jout)
    assert_trees_equal(jparams, load_tree(out))


def _served(model_name, params, cfg, clip):
    spec = registry.get(model_name)
    return Session(spec.make_module(params, cfg), spec.make_manifest(cfg),
                   device="cpu").process(clip).outputs


def test_load_artifact_serves_the_import_tree(tmp_path):
    name = "mossformer2_ss"
    cfg, sd, out, _ = _export_port(name, tmp_path, smoke=False)
    params, manifest = load_artifact(out, device="cpu")
    direct = params_from_numpy(import_checkpoint(name, sd, cfg=cfg), device="cpu")
    assert_trees_equal(params, direct)
    assert manifest.extra["config"]["dim"] == cfg.dim
    clip = (np.random.default_rng(6).standard_normal(12000) * 3000).astype(np.int16)
    for a, b in zip(_served(name, params, cfg, clip), _served(name, direct, cfg, clip)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_export_smoke_on_cpu(name, tmp_path):
    _, _, out, report = _export_port(name, tmp_path, device="cpu")
    smoke = report["smoke"]
    manifest = registry.get(name).make_manifest(tiny_config(name))
    assert smoke["device"] == "cpu" and smoke["outputs"] == manifest.output_sources
    assert smoke["out_samples"] == int(min(manifest.input_audio_length, manifest.in_sample_rate)
                                       * manifest.input_to_output_scale)
    assert np.isfinite(smoke["rtf"]) and smoke["rtf"] > 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_fallback_without_cuda(no_cuda, tmp_path):
    """Export's smoke step and load_artifact go to the card unless asked for
    the CPU: without CUDA they raise, and export writes nothing first."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _export_port("gtcrn", tmp_path)
    assert not (tmp_path / "gtcrn_port").exists()
    _, _, out, _ = _export_port("gtcrn", tmp_path, smoke=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_artifact(out)
    load_artifact(out, device="cpu")


# ── the two entry points ───────────────────────────────────────────────────


def _write_wav(path, audio, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.astype("<i2").tobytes())


def _read_wav(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def _noisy(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    x[:201] = 0.0
    return np.round(x * 32767).astype(np.int16)


def test_export_and_cli_commands_on_cpu(tmp_path):
    """``python -m …export`` on a checkpoint file, then ``python -m …cli
    --artifact``: the wav it writes equals the library's answer."""
    ckpt, art = tmp_path / "gtcrn.pt", tmp_path / "art"
    sd = BUILDERS["gtcrn"](seed=8)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    audio = _noisy(24000, 9)
    src, dst = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    _write_wav(src, audio)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.run([sys.executable, "-m", *args], cwd=tmp_path, env=env,
                            capture_output=True, text=True, timeout=300)
             for args in (["audiojax_torch.runtime.export", "--model", "gtcrn", "--checkpoint",
                           str(ckpt), "--out", str(art), "--device", "cpu"],
                          ["audiojax_torch.runtime.cli", "--model", "gtcrn", "--artifact",
                           str(art), "--input", str(src), "--output", str(dst), "--device",
                           "cpu"])]
    assert [p.returncode for p in procs] == [0, 0], [p.stderr for p in procs]
    report = json.loads(procs[0].stdout)
    assert report["model"] == "gtcrn" and report["smoke"]["device"] == "cpu"
    assert "randomly initialised" not in procs[1].stderr
    params, manifest = load_artifact(art, device="cpu")
    want = _served("gtcrn", params, tiny_config("gtcrn"), audio)[0]
    np.testing.assert_array_equal(_read_wav(dst), want)


def test_cli_rebuilds_the_exported_config(tmp_path, capsys):
    """A ZipEnhancer artifact at the tiny config (its ``encoder_downsample`` a
    tuple of pairs, a list of lists in JSON) serves what the library does."""
    cfg, _, art, _ = _export_port("zipenhancer", tmp_path, smoke=False)
    audio = _noisy(20000, 10)
    src, dst = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    _write_wav(src, audio)
    assert cli.main(["--model", "zipenhancer", "--artifact", str(art), "--input", str(src),
                     "--output", str(dst), "--device", "cpu"]) == 0
    params, _ = load_artifact(art, device="cpu")
    np.testing.assert_array_equal(_read_wav(dst), _served("zipenhancer", params, cfg, audio)[0])


@pytest.mark.parametrize("name,channels,rate", [("h_gtcrn", 2, 16000),
                                                ("melband_roformer_stereo", 2, 44100),
                                                ("mossformer2_sr", 1, 16000)])
def test_cli_serves_the_new_families_artifacts(name, channels, rate, tmp_path):
    """A two-microphone H-GTCRN wav in, mono out; stereo Mel-Band in and out;
    SR at 16 kHz in and 48 kHz out: the CLI's wav equals the library's answer."""
    cfg, _, art, _ = _export_port(name, tmp_path, smoke=False)
    audio = np.stack([_noisy(6000, 13 + c) for c in range(channels)])
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    with wave.open(str(src), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.T.astype("<i2").tobytes())
    assert cli.main(["--model", name, "--artifact", str(art), "--input", str(src),
                     "--output", str(dst), "--device", "cpu"]) == 0
    params, manifest = load_artifact(art, device="cpu")
    want = _served(name, params, cfg, audio if channels > 1 else audio[0])[0]
    with wave.open(str(dst), "rb") as w:
        assert (w.getnchannels(), w.getframerate()) == (manifest.output_channels,
                                                        manifest.out_sample_rate)
        got = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    got = got.reshape(-1, manifest.output_channels).T
    np.testing.assert_array_equal(got[0] if manifest.output_channels == 1 else got, want)


def test_cli_refuses_mismatched_or_bf16_artifacts(tmp_path, capsys):
    _, _, art, _ = _export_port("gtcrn", tmp_path, smoke=False)
    src = tmp_path / "noisy.wav"
    _write_wav(src, _noisy(8000, 11))
    base = ["--artifact", str(art), "--input", str(src), "--device", "cpu"]
    assert cli.main(["--model", "zipenhancer", *base]) == 2
    assert "exported for model 'gtcrn'" in capsys.readouterr().err

    # a bf16 artifact of MossFormer2-SE, whose plan was refused until ROADMAP
    # A.10's rest, serves; one of a family without the knob (GTCRN) is refused
    _, _, se_art, _ = _export_port("mossformer2_se", tmp_path, smoke=False)
    for path, bf16 in ((se_art, True), (art, False)):
        manifest_path = path / "manifest.json"
        data = json.loads(manifest_path.read_text())
        data["extra"]["activation_compute_dtype"] = "bfloat16"
        if bf16:
            data["extra"]["config"]["compute_dtype"] = "bfloat16"
        manifest_path.write_text(json.dumps(data))
    assert cli.main(["--model", "mossformer2_se", *base[:1], str(se_art), *base[2:],
                     "--output", str(tmp_path / "se.wav")]) == 0
    assert "bfloat16" in capsys.readouterr().out
    assert cli.main(["--model", "gtcrn", *base]) == 2
    assert "no compute_dtype knob" in capsys.readouterr().err


def test_commands_need_cuda_or_cpu(no_cuda, tmp_path):
    ckpt = tmp_path / "gtcrn.pt"
    torch.save(BUILDERS["gtcrn"](seed=8), ckpt)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        texport_mod.main(["--model", "gtcrn", "--checkpoint", str(ckpt),
                          "--out", str(tmp_path / "art")])
    assert not (tmp_path / "art").exists()
    assert texport_mod.main(["--model", "gtcrn", "--checkpoint", str(ckpt),
                             "--out", str(tmp_path / "art"), "--no-smoke"]) == 0
    src = tmp_path / "noisy.wav"
    _write_wav(src, _noisy(8000, 12))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["--model", "gtcrn", "--artifact", str(tmp_path / "art"), "--input", str(src)])
