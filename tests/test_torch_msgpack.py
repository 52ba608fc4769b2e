"""The port's reader of the JAX package's artifacts (``runtime/msgpack_io.py``).

Trees that ``flax.serialization.to_bytes`` wrote (through the JAX package's
``save_artifact`` and ``optimize_artifact``) come out of the port's
``load_tree`` equal, bit for bit, to what ``audiojax.runtime.checkpoint.
load_artifact`` returns: float32 and per-layer lists (MossFormer2-SS's
FSMN ``mem_stack``), the q8f32 and q8dyn trees' int8 and float32 leaves, the
weight-only bf16 tree's bfloat16 leaves and flax's chunked arrays.  Each
refusal names its byte offset.  The reader loads where ``msgpack``, ``flax``
and ``jax`` cannot be imported, and a JAX artifact served by the port's
``Session`` and CLI agrees with the JAX ``Session`` on it.
"""
import dataclasses
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from audiojax.runtime import registry as jregistry
from audiojax.runtime.checkpoint import load_artifact as jload
from audiojax.runtime.checkpoint import save_artifact as jsave
from audiojax.runtime.optimize import PLANS as JPLANS
from audiojax.runtime.optimize import optimize_artifact as joptimize
from audiojax.runtime.optimize import wrap_forward as jwrap
from audiojax.runtime.session import Session as JSession
from jax_artifacts import GTCRN_ARTIFACT, write_jax_gtcrn_artifact
from test_torch_ckpt_builders import TINY, one_thread  # noqa: F401

from audiojax_torch.runtime import cli, msgpack_io, registry
from audiojax_torch.runtime.checkpoint import load_artifact, load_tree, save_artifact
from audiojax_torch.runtime.optimize import wrap_forward
from audiojax_torch.runtime.session import Session

REPO = Path(__file__).resolve().parents[1]


def _jax_tree(tree):
    """The JAX loader's tree with numpy leaves (lists kept)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree(v) for v in tree]
    return np.asarray(tree)


def _assert_bitwise(jtree, ttree, path=""):
    """Same structure (dicts, lists), shapes and dtypes; bits equal.  A
    bfloat16 leaf is a numpy array (ml_dtypes) on the JAX side, a CPU torch
    tensor on the port's."""
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and list(ttree) == list(jtree), path
        for k in jtree:
            _assert_bitwise(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, list):
        assert isinstance(ttree, list) and len(ttree) == len(jtree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _assert_bitwise(a, b, f"{path}/{i}")
    elif jtree.dtype == jnp.bfloat16:
        assert isinstance(ttree, torch.Tensor) and ttree.dtype == torch.bfloat16, path
        assert tuple(ttree.shape) == jtree.shape, path
        np.testing.assert_array_equal(ttree.reshape(-1).view(torch.int16).numpy(),
                                      jtree.reshape(-1).view(np.int16), err_msg=path)
    else:
        assert isinstance(ttree, np.ndarray) and ttree.dtype == jtree.dtype, path
        assert ttree.shape == jtree.shape, path
        np.testing.assert_array_equal(ttree.reshape(-1).view(np.uint8),
                                      jtree.reshape(-1).view(np.uint8), err_msg=path)


def _lists(tree) -> int:
    if isinstance(tree, dict):
        return sum(_lists(v) for v in tree.values())
    if isinstance(tree, list):
        return 1 + sum(_lists(v) for v in tree)
    return 0


@pytest.fixture(scope="module")
def ss_artifacts(tmp_path_factory):
    """MossFormer2-SS at the tiny test widths (per-layer lists; dense leaves
    above q8's 4096-element floor) written by the JAX package, float32 and
    through its q8f32, q8dyn and weight-only bf16 plans."""
    spec = jregistry.get("mossformer2_ss")
    cfg = spec.make_config(**TINY["mossformer2_ss"])
    root = tmp_path_factory.mktemp("jax_ss")
    jsave(root / "float32", spec.init_params(jax.random.PRNGKey(3), cfg), spec.make_manifest(cfg))
    for plan in ("q8f32", "q8dyn", "bf16"):
        joptimize(root / "float32", root / plan, JPLANS[plan])
    return root


@pytest.mark.parametrize("kind", ["float32", "q8f32", "q8dyn", "bf16"])
def test_tree_equals_jax_loader(ss_artifacts, kind):
    art = ss_artifacts / kind
    jtree = _jax_tree(jload(art)[0])
    ttree = load_tree(art)
    _assert_bitwise(jtree, ttree)
    assert _lists(ttree) > 0  # the FSMN memories' per-layer lists, restored
    leaves = jax.tree.leaves(jtree)
    dtypes = {str(leaf.dtype) for leaf in leaves}
    assert dtypes == {"float32": {"float32"}, "q8f32": {"float32", "int8"},
                      "q8dyn": {"float32", "int8"}, "bf16": {"float32", "bfloat16"}}[kind]


def test_chunked_arrays(tmp_path, monkeypatch):
    """flax splits a leaf above MAX_CHUNK_SIZE bytes into chunks; the reader
    joins them (a float32, an int8 and a bfloat16 leaf, in dicts and a list)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 11)).astype(np.float32),
            "b": [{"q8": rng.integers(-127, 127, (300,)).astype(np.int8),
                   "scale": np.float32(rng.standard_normal((1, 3)))},
                  {"w": jnp.asarray(rng.standard_normal((5, 9)), jnp.bfloat16)}],
            "small": np.ones((3,), np.float32)}
    raw = serialization.to_bytes(tree)
    assert msgpack_io.unpackb(raw)["a"].keys() >= {msgpack_io.CHUNKED, "shape", "chunks"}
    spec = jregistry.get("gtcrn")
    jsave(tmp_path, tree, spec.make_manifest(spec.make_config()))
    assert (tmp_path / "params.msgpack").read_bytes() == raw
    _assert_bitwise(_jax_tree(jload(tmp_path)[0]), load_tree(tmp_path))


def test_scalars_and_complex():
    """Every msgpack width the format defines, the numpy-scalar and complex exts."""
    tree = {"i": [0, 127, -1, -32, -33, 255, 256, 65536, 2**32, -2**40, 2**63 - 1],
            "f": [0.5, -1e300], "s": "é" * 40, "b": b"\x00" * 300, "n": None, "t": [True, False],
            "np": np.float32(2.5), "c": complex(1.5, -2.0), "big": {str(i): i for i in range(20)},
            "long": list(range(70000))}
    got = msgpack_io.unpackb(serialization.msgpack_serialize(tree))
    ref = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    assert got.keys() == ref.keys()
    for k in tree:
        assert got[k] == ref[k], k
    assert type(got["np"]) is np.float32


def _refused(raw: bytes, match: str):
    with pytest.raises(ValueError, match=match) as e:
        msgpack_io.restore(raw)
    assert "byte offset" in str(e.value)


def test_refusals(tmp_path):
    raw = serialization.to_bytes({"w": np.arange(6, dtype=np.float32)})
    _refused(raw[:-5], "truncated input")
    _refused(raw + b"\xc0", "trailing bytes")
    _refused(b"\x81\xa1w\xc1", "unknown msgpack type byte 0xc1")
    _refused(b"\x81\xa1w\xd4\x07\x00", "unknown ext code 7")
    _refused(serialization.to_bytes({"w": np.arange(6, dtype=np.float64)}), "dtype 'float64'")
    # an ndarray whose bytes do not fill its shape
    body = b"\x93\x91\x04\xa7float32\xc4\x0c" + b"\x00" * 12  # ((4,), "float32", 12 bytes)
    _refused(b"\x81\xa1w\xc7" + bytes([len(body), 1]) + body, "12 bytes for a float32 array")
    # both files in one artifact
    (tmp_path / "params.msgpack").write_bytes(raw)
    torch.save({"w": torch.zeros(6)}, tmp_path / "params.pt")
    with pytest.raises(ValueError, match="both params.pt and params.msgpack"):
        load_tree(tmp_path)
    # and the port writes no params.pt beside a JAX artifact's params.msgpack
    (tmp_path / "params.pt").unlink()
    with pytest.raises(ValueError, match="params.msgpack"):
        save_artifact(tmp_path, {"w": np.zeros(6, np.float32)}, None)


def test_reader_needs_no_msgpack():
    """In a process where msgpack, flax and jax cannot be imported, the
    committed JAX artifact loads, equal to the tree loaded here."""
    code = (
        "import sys, hashlib, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('msgpack', 'flax', 'jax', 'audiojax'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from audiojax_torch.runtime.checkpoint import load_artifact\n"
        "params, manifest = load_artifact(sys.argv[1], 'cpu')\n"
        "h = hashlib.sha256()\n"
        "def walk(t):\n"
        "    if isinstance(t, dict):\n"
        "        [walk(t[k]) for k in sorted(t)]\n"
        "    elif isinstance(t, list):\n"
        "        [walk(v) for v in t]\n"
        "    else:\n"
        "        h.update(t.numpy().tobytes())\n"
        "walk(params)\n"
        "print(manifest.model_name, h.hexdigest())\n"
        "assert not any(m.split('.')[0] in ('msgpack', 'flax', 'jax') for m in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code, str(GTCRN_ARTIFACT)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import hashlib

    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            [walk(t[k]) for k in sorted(t)]
        elif isinstance(t, list):
            [walk(v) for v in t]
        else:
            h.update(t.numpy().tobytes())

    walk(load_artifact(GTCRN_ARTIFACT, "cpu")[0])
    assert out.stdout.split() == ["gtcrn", h.hexdigest()]


def test_committed_artifact_is_the_jax_packages(tmp_path):
    """``tests/data/jax_gtcrn_artifact`` is what the JAX package writes from
    its stated seed, byte for byte."""
    write_jax_gtcrn_artifact(tmp_path)
    for f in ("params.msgpack", "manifest.json"):
        assert (tmp_path / f).read_bytes() == (GTCRN_ARTIFACT / f).read_bytes(), f


def _clip(n, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) \
        + 0.05 * rng.standard_normal(n)
    return np.round(x * 12000).astype(np.int16)


def _snr(ref, out):
    ref, out = ref.astype(np.float64), out.astype(np.float64)
    err = np.sum((ref - out) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


@pytest.mark.parametrize("plan", ["float32", "q8f32"])
def test_jax_artifact_served_by_the_port(plan, tmp_path):
    """The committed GTCRN artifact (and its JAX q8f32 optimization, GRU and
    conv leaves of 256 elements up quantized) served by the port's Session
    and CLI on the CPU against the JAX Session on the same artifact."""
    art = GTCRN_ARTIFACT
    if plan != "float32":
        art = joptimize(GTCRN_ARTIFACT, tmp_path / plan,
                        dataclasses.replace(JPLANS[plan], q8_min_size=256))
        assert json.loads((art / "manifest.json").read_text())["extra"]["optimize"]["quantize"]
    clip = _clip(40000)
    jparams, jmanifest = jload(art)
    jspec = jregistry.get("gtcrn")
    want = JSession(jwrap(jspec.make_forward(jspec.make_config()), jmanifest), jparams,
                    jmanifest).process(clip).audio

    params, manifest = load_artifact(art, "cpu")
    spec = registry.get("gtcrn")
    got = Session(wrap_forward(spec.make_module(params, spec.make_config()), manifest), manifest,
                  device="cpu").process(clip).audio
    assert got.shape == want.shape == clip.shape
    assert _snr(want, got) >= 40.0

    wav_in, wav_out = tmp_path / "in.wav", tmp_path / "out.wav"
    with wave.open(str(wav_in), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(clip.astype("<i2").tobytes())
    assert cli.main(["--model", "gtcrn", "--artifact", str(art), "--input", str(wav_in),
                     "--output", str(wav_out), "--device", "cpu"]) == 0
    with wave.open(str(wav_out), "rb") as w:
        served = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    np.testing.assert_array_equal(served, got)
