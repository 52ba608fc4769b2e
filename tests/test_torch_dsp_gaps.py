"""The rest of the JAX package's public ``dsp.stft`` and ``runtime.manifest``
in the port: ``stft``, ``stft_real``, ``istft``, ``istft_polar`` and
``istft_length`` against ``audiojax.dsp.stft`` on seeded numpy input (within
1e-5 × max|ref|), and the manifest inspector against the JAX one (the same
stdout and exit code, on a good and on a broken manifest).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiojax.dsp as jdsp
from audiojax.runtime import manifest as jmanifest

import audiojax_torch.dsp as tdsp
from audiojax_torch.runtime import manifest as tmanifest
from audiojax_torch.runtime import registry

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5

CONFIGS = {
    "512_256_hann_sqrt_reflect": dict(n_fft=512, hop=256, window="hann_sqrt", pad_mode="reflect"),
    "319_160_hamming": dict(n_fft=319, hop=160, window="hamming"),
    "400_100_win320_uncentred": dict(n_fft=400, hop=100, win_length=320, window="hann",
                                     center=False),
}


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.max(np.abs(want)))


def _pair(name):
    kw = CONFIGS[name]
    return jdsp.StftConfig(**kw), tdsp.StftConfig(**kw)


def test_public_names_match_jax():
    """The JAX package's names; ``dsp.stft`` is also still the module, as
    the port's callers import it through the package, callable as the
    function."""
    assert sorted(tdsp.__all__) == sorted(jdsp.__all__)
    from audiojax_torch.dsp import stft as module

    assert callable(module) and module.stft_packed is tdsp.stft_packed


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stft_views_match_jax(name):
    """stft's (real, imag) and stft_real over two leading axes."""
    jcfg, tcfg = _pair(name)
    x = np.random.default_rng(0).standard_normal((2, 3, 4000)).astype(np.float32)
    jre, jim = jdsp.stft(jnp.asarray(x), jcfg)
    tre, tim = tdsp.stft(torch.from_numpy(x), tcfg)
    _close(tre, jre)
    _close(tim, jim)
    _close(tdsp.stft_real(torch.from_numpy(x), tcfg), jdsp.stft_real(jnp.asarray(x), jcfg))


@pytest.mark.parametrize("out_length", [None, 2000])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_istft_views_match_jax(name, out_length):
    """istft (rectangular) and istft_polar, and istft_length for the frame count."""
    jcfg, tcfg = _pair(name)
    rng = np.random.default_rng(1)
    n_t = 24
    re, im = (rng.standard_normal((2, n_t, tcfg.f_bins)).astype(np.float32) for _ in range(2))
    mag, pha = np.abs(re), rng.uniform(-np.pi, np.pi, re.shape).astype(np.float32)
    _close(tdsp.istft(torch.from_numpy(re), torch.from_numpy(im), tcfg, out_length),
           jdsp.istft(jnp.asarray(re), jnp.asarray(im), jcfg, out_length))
    polar = tdsp.istft_polar(torch.from_numpy(mag), torch.from_numpy(pha), tcfg, out_length)
    _close(polar, jdsp.istft_polar(jnp.asarray(mag), jnp.asarray(pha), jcfg, out_length))
    assert tdsp.istft_length(tcfg, n_t) == jdsp.istft_length(jcfg, n_t)
    if out_length is None:
        assert polar.shape[-1] == tdsp.istft_length(tcfg, n_t)


# ── the manifest inspector ─────────────────────────────────────────────────


@pytest.fixture
def manifests(tmp_path):
    spec = registry.get("gtcrn")
    good = tmp_path / "good"
    spec.make_manifest(spec.make_config()).save(good / "manifest.json")
    data = json.loads((good / "manifest.json").read_text())
    del data["model_family"]
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(data))
    return good, broken


@pytest.mark.parametrize("which", ["good", "broken"])
def test_manifest_main_matches_jax(manifests, capsys, which):
    """Every key printed, then OK (exit 0) or the missing key on stderr
    (exit 1): the JAX inspector's stdout and exit code on the same file."""
    good, broken = manifests
    path = str(good if which == "good" else broken)
    rc = tmanifest.main([path])
    got = capsys.readouterr()
    jrc = jmanifest.main([path])
    want = capsys.readouterr()
    assert rc == jrc == (0 if which == "good" else 1)
    assert got.out == want.out
    if which == "broken":
        assert "model_family" in got.err and "model_family" in want.err


def test_manifest_module_entry(manifests):
    """``python -m audiojax_torch.runtime.manifest`` is the inspector."""
    good, broken = manifests
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for path, rc in ((good, 0), (broken, 1)):
        proc = subprocess.run([sys.executable, "-m", "audiojax_torch.runtime.manifest", str(path)],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == rc, proc.stderr
        assert "model_name = 'gtcrn'" in proc.stdout
