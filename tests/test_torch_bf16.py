"""The bf16 serving plan: the plain versions of B3, B4, B5 and B6 in bfloat16
against the JAX package's functions in bfloat16, and the plan through the
registry, ``Session``, export and the CLI.

Inputs are drawn in float32 from a seed with numpy and rounded to bf16 once;
both packages get the same bf16 values.  The JAX side runs its jnp reference
paths and its Pallas kernels in interpret mode.  Tolerance: one bf16 ulp,
|Δ| ≤ 2⁻⁷·|ref| plus 1e-6 near zero: both sides round the same f32 sums
once, and part only where the two sums (in another order) straddle a
rounding boundary.  Each case prints how many elements differ.

The families' bf16 forwards are held against the JAX package in their own
test files (``test_torch_zipenhancer.py``, ``test_torch_mossformergan.py``,
``test_torch_mossformer2_ss.py``).
"""
import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.nn import core as jcore
from audiojax.ops.attention_pallas import (quad_attention_jnp, relpos_scores_jnp,
                                           relpos_scores_pallas)
from audiojax.ops.dwconv_pallas import dwconv1d_jnp, dwconv1d_pallas_tiled
from test_torch_ckpt_builders import BUILDERS, one_thread, tiny_config  # noqa: F401

from audiojax_torch.nn import core as tcore
from audiojax_torch.ops import attention_cuda, dwconv_cuda
from audiojax_torch.runtime import cli, registry
from audiojax_torch.runtime.checkpoint import load_artifact
from audiojax_torch.runtime.export import export_artifact
from audiojax_torch.runtime.session import Session

ULP = 2.0 ** -7


def _bf16(rng, *shape, scale=1.0):
    """(torch bf16, the same values as a JAX bf16 array)."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _within_ulp(out: torch.Tensor, ref, what: str) -> None:
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} elements differ "
          f"(max {diff.max():.3g})")
    assert np.all(diff <= ULP * np.abs(ref) + 1e-6), what


# ── B4 / B5 ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("pads", [(3, 3), (5, 1)])
def test_dwconv1d_plain_bf16_matches_jnp(pads):
    rng = np.random.default_rng(31)
    (x, jx), (w, jw) = _bf16(rng, 3, 40, 128), _bf16(rng, 7, 128, scale=0.4)
    out = dwconv_cuda.dwconv1d_plain(x, w, pads=pads)
    _within_ulp(out, dwconv1d_jnp(jx, jw, pads=pads), f"B4 pads {pads} vs dwconv1d_jnp")


def test_dwconv1d_plain_bf16_dilated_matches_pallas_tiled():
    """Dilation 2 in bf16: the only dtype the TPU's time-tiled kernel is
    called with (``audiojax/nn/core.py:219-252``)."""
    rng = np.random.default_rng(32)
    (x, jx), (w, jw) = _bf16(rng, 2, 300, 128), _bf16(rng, 9, 128, scale=0.3)
    out = dwconv_cuda.dwconv1d_plain(x, w, pads=(8, 8), dilation=2)
    ref = dwconv1d_pallas_tiled(jx, jw, pads=(8, 8), tile=128, dilation=2, interpret=True)
    _within_ulp(out, ref, "B4 dilation 2 vs dwconv1d_pallas_tiled")


def test_dwconv1d_grouped_plain_bf16_matches_jax():
    """The grouped 2-in/1-out conv in bf16 against ``nn.core.conv1d`` with
    groups=G (its f32 shift-and-add, one rounding), and the TPU's route, the
    stride-2 deinterleave into two tiled calls each rounded to bf16 and then
    added in bf16, against the same deinterleave of the port's B4 plain."""
    rng = np.random.default_rng(33)
    g, k = 128, 9
    (x, jx), (w, jw) = _bf16(rng, 2, 300, 2 * g), _bf16(rng, k, 2, g, scale=0.3)
    out = dwconv_cuda.dwconv1d_grouped_plain(x, w, pads=(16, 16), dilation=2)
    _within_ulp(out, jcore.conv1d({"w": jw}, jx, padding=(16, 16), dilation=2, groups=g),
                "B5 vs conv1d groups=G")
    lanes = sum(dwconv_cuda.dwconv1d_plain(x[..., r::2], w[:, r, :], pads=(16, 16), dilation=2)
                for r in range(2))
    ref = sum(dwconv1d_pallas_tiled(jx[..., r::2], jw[:, r, :], pads=(16, 16), dilation=2,
                                    tile=128, interpret=True) for r in range(2))
    _within_ulp(lanes, ref, "B5 deinterleaved vs two dwconv1d_pallas_tiled")


def test_dwconv_bf16_dtype_mismatch_raises():
    x, w = torch.zeros(1, 20, 8, dtype=torch.bfloat16), torch.zeros(3, 8)
    with pytest.raises(TypeError, match="dtype mismatch"):
        dwconv_cuda.dwconv1d_plain(x, w)
    with pytest.raises(TypeError, match="dtype mismatch"):
        dwconv_cuda.dwconv1d_grouped_plain(torch.zeros(1, 20, 8), torch.zeros(3, 2, 4,
                                                                            dtype=torch.bfloat16))


# ── B6 / B3 ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("mask", [False, True])
def test_quad_attention_plain_bf16_matches_jnp(mask):
    """bf16 out against ``quad_attention_jnp`` (the Pallas kernel's contract),
    and float32 out, as the bf16 layers take it, against the JAX models' own
    expression (``nn/mossformer.py:195-201``: both einsums with
    ``preferred_element_type=float32``), to the f32 sums' order."""
    rng = np.random.default_rng(34)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, 4, 48, 32) for _ in range(3))
    out = attention_cuda.quad_attention_plain(q, k, v, scale=1 / 48, mask_diag=mask)
    _within_ulp(out, quad_attention_jnp(jq, jk, jv, scale=1 / 48, mask_diag=mask),
                f"B6 mask {mask} vs quad_attention_jnp")
    out32 = attention_cuda.quad_attention_plain(q, k, v, scale=1 / 48, mask_diag=mask,
                                                out_dtype=torch.float32)
    attn = jnp.square(jnp.maximum(jnp.einsum("nik,njk->nij", jq, jk,
                                             preferred_element_type=jnp.float32) / 48, 0.0))
    if mask:
        attn = jnp.where(jnp.eye(48, dtype=bool), 0.0, attn)
    ref32 = jnp.einsum("nij,njv->niv", attn, jv, preferred_element_type=jnp.float32)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), np.asarray(ref32), rtol=1e-5, atol=1e-6)
    assert torch.equal(out32.bfloat16(), out)  # one rounding of the same sums


def test_relpos_scores_plain_bf16_matches_jnp_and_pallas():
    """bf16 q, k, pp and pe, bf16 probabilities: against ``relpos_scores_jnp``
    (the function ZipEnhancer runs) and ``relpos_scores_pallas`` with
    ``out_dtype=bfloat16`` in interpret mode (its pe is bf16)."""
    rng = np.random.default_rng(35)
    n, s, h, d, n_pos = 3, 21, 2, 8, 4
    stride = attention_cuda.pos_stride(n_pos)
    (q, jq), (k, jk) = _bf16(rng, n, s, h * d), _bf16(rng, n, s, h * d)
    (pp, jpp), (pe, jpe) = _bf16(rng, n, s, h * stride), _bf16(rng, h, n_pos, s, s, scale=0.5)
    out = attention_cuda.relpos_scores_plain(q, k, pp, pe, num_heads=h)
    _within_ulp(out, relpos_scores_jnp(jq, jk, jpp, jpe, num_heads=h), "B3 vs relpos_scores_jnp")
    _within_ulp(out, relpos_scores_pallas(jq, jk, jpp, jpe, out_dtype=jnp.bfloat16,
                                          interpret=True), "B3 vs relpos_scores_pallas")


# ── the registry, Session, export and CLI ──────────────────────────────────


def test_prepare_compute_params_casts_once():
    """float32 leaves to bf16, once, on the host; a float32 config and a
    config without the knob pass through; a bf16 network refuses a tree that
    was not cast (it casts nothing per forward)."""
    tree = {"w": torch.ones(2, 2), "n": torch.zeros(2, dtype=torch.int64), "l": [torch.ones(1)]}
    cfg = registry.get("zipenhancer").make_config(compute_dtype="bfloat16")
    cast = registry.prepare_compute_params(tree, cfg)
    assert (cast["w"].dtype, cast["n"].dtype, cast["l"][0].dtype) == (
        torch.bfloat16, torch.int64, torch.bfloat16)
    assert tcore.cast_f32_tree(cast, torch.bfloat16)["w"] is cast["w"]  # idempotent
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert registry.prepare_compute_params(tree, f32) is tree
    assert registry.prepare_compute_params(tree, registry.get("gtcrn").make_config()) is tree
    tiny = dataclasses.replace(tiny_config("mossformer2_ss"), compute_dtype="bfloat16")
    params = registry.get("mossformer2_ss").init_params(0, tiny, "cpu")
    from audiojax_torch.models.mossformer2_ss import mossformer2_ss_forward

    with pytest.raises(TypeError, match="prepare_compute_params"):
        mossformer2_ss_forward(params, torch.zeros(1, 4000, dtype=torch.int16), tiny)


def test_param_module_takes_its_spec_hook(monkeypatch):
    """``ParamModule`` casts through the ``prepare_params`` hook of the spec
    that builds its class, and a class that no spec builds takes the
    whole-tree cast."""
    from audiojax_torch.models.base import ParamModule

    class Toy(ParamModule):
        def forward(self, x):
            return x

    cfg = registry.get("zipenhancer").make_config(compute_dtype="bfloat16")
    tree = {"keep": {"w": torch.ones(2)}, "net": {"w": torch.ones(2)}}
    held = Toy(tree, cfg).params
    assert (held["keep"]["w"].dtype, held["net"]["w"].dtype) == (torch.bfloat16, torch.bfloat16)
    seen = []

    def hook(params, c):
        seen.append(c)
        return {"keep": params["keep"], "net": tcore.cast_f32_tree(params["net"], torch.bfloat16)}

    spec = dataclasses.replace(registry.get("zipenhancer"), name="toy", make_module=Toy,
                               prepare_params=hook)
    monkeypatch.setitem(registry._REGISTRY, "toy", spec)
    assert registry.spec_for_module(Toy) is spec
    held = Toy(tree, cfg).params
    assert seen == [cfg]
    assert (held["keep"]["w"].dtype, held["net"]["w"].dtype) == (torch.float32, torch.bfloat16)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert Toy(tree, f32).params["net"]["w"].dtype == torch.float32 and seen == [cfg]


@pytest.mark.parametrize("name", ["mossformer2_se", "melband_roformer", "mossformer2_sr"])
def test_unported_bf16_plans_refused_by_name(name):
    """The three families that refused the bf16 plan until ROADMAP A.10's
    rest serve it: the config takes it and the module holds the cast tree
    (SR's generator float32); a compute dtype the port has no plan for is
    refused by name."""
    spec = registry.get(name)
    cfg = dataclasses.replace(tiny_config(name), compute_dtype="bfloat16")
    assert registry.has_compute_dtype(cfg)
    params = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg).params
    gen = params.pop("gen", None)
    assert {t.dtype for t in _leaves(params)} == {torch.bfloat16}
    assert gen is None or {t.dtype for t in _leaves(gen)} == {torch.float32}
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        spec.make_config(compute_dtype="float16")


def test_module_casts_its_tree_once():
    """A bf16 config's module holds the cast tree (float32 params in, bf16
    buffers), and serves int16 from its float32 islands."""
    spec = registry.get("zipenhancer")
    cfg = dataclasses.replace(tiny_config("zipenhancer"), compute_dtype="bfloat16")
    params = spec.init_params(0, cfg, "cpu")
    assert {t.dtype for t in _leaves(params)} == {torch.float32}
    model = spec.make_module(params, cfg)
    assert {b.dtype for b in model.buffers()} == {torch.bfloat16}
    out = model(torch.from_numpy(_noisy(4000, 3)[None]))
    assert out.dtype == torch.int16 and out.shape == (1, 4000) and bool(out.abs().max() > 0)


def _noisy(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    return np.round(x * 32767).astype(np.int16)


def _write_wav(path, audio, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(audio.astype("<i2").tobytes())


def _read_wav(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


@pytest.fixture(scope="module")
def ss_bf16_artifact(tmp_path_factory):
    """A MossFormer2-SS artifact at the tiny test config, exported with
    ``compute_dtype="bfloat16"`` (smoke request on the CPU)."""
    out = tmp_path_factory.mktemp("art") / "ss_bf16"
    cfg = tiny_config("mossformer2_ss")
    report = export_artifact("mossformer2_ss", BUILDERS["mossformer2_ss"](cfg, seed=5), out,
                             cfg=cfg, device="cpu", compute_dtype="bfloat16")
    return cfg, out, report


def test_bf16_artifact_round_trips(ss_bf16_artifact):
    """The manifest records the dtype (and the config holds it), the weights
    stay float32 on disk, the smoke request served bf16, and ``Session`` on
    the loaded artifact gives what the bf16 module of the stored tree gives."""
    cfg, out, report = ss_bf16_artifact
    assert report["smoke"]["compute_dtype"] == "bfloat16" and report["smoke"]["outputs"] == 2
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["extra"]["activation_compute_dtype"] == "bfloat16"
    assert manifest["extra"]["config"]["compute_dtype"] == "bfloat16"
    params, man = load_artifact(out, device="cpu")
    assert all(t.dtype == torch.float32 for t in _leaves(params))
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    spec = registry.get("mossformer2_ss")
    served = registry.prepare_compute_params(params, bcfg)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(served))
    clip = _noisy(20000, 4)
    a = Session(spec.make_module(served, bcfg), man, device="cpu").process(clip)
    b = Session(spec.make_module(params, bcfg), man, device="cpu").process(clip)
    for x, y in zip(a.outputs, b.outputs):
        assert x.dtype == np.int16 and np.any(x)
        np.testing.assert_array_equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_cli_serves_the_recorded_dtype(ss_bf16_artifact, tmp_path):
    """``--artifact`` of a bf16 export serves bf16 (its two sources equal the
    library's bf16 answer); ``--compute-dtype float32`` overrides it."""
    cfg, art, _ = ss_bf16_artifact
    clip = _noisy(20000, 6)
    src = tmp_path / "mix.wav"
    _write_wav(src, clip)
    params, manifest = load_artifact(art, device="cpu")
    spec = registry.get("mossformer2_ss")
    for dtype, flag in (("bfloat16", []), ("float32", ["--compute-dtype", "float32"])):
        dst = tmp_path / f"{dtype}.wav"
        assert cli.main(["--model", "mossformer2_ss", "--artifact", str(art), "--input",
                         str(src), "--output", str(dst), "--device", "cpu", *flag]) == 0
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        want = Session(spec.make_module(params, c), manifest, device="cpu").process(clip)
        for i, o in enumerate(want.outputs):
            np.testing.assert_array_equal(_read_wav(tmp_path / f"{dtype}_{i}.wav"), o)


def test_cli_compute_dtype_flag(tmp_path, capsys):
    """``--compute-dtype bfloat16`` serves a float32 artifact of a bf16-plan
    family in bf16 (the library's bf16 answer; MossFormer2-SS, and
    MossFormer2-SE whose plan this flag refused until ROADMAP A.10's rest); a
    family without the knob exits 2."""
    src = tmp_path / "mix.wav"
    _write_wav(src, _noisy(16000, 7))
    dst = tmp_path / "out.wav"
    assert cli.main(["--model", "gtcrn", "--input", str(src), "--output", str(dst),
                     "--device", "cpu", "--compute-dtype", "bfloat16"]) == 2
    assert "no compute_dtype knob" in capsys.readouterr().err
    se_art, se_cfg = tmp_path / "se", tiny_config("mossformer2_se")
    export_artifact("mossformer2_se", BUILDERS["mossformer2_se"](se_cfg, seed=3), se_art,
                    cfg=se_cfg, smoke=False)
    se_dst = tmp_path / "se.wav"
    assert cli.main(["--model", "mossformer2_se", "--artifact", str(se_art), "--input",
                     str(src), "--output", str(se_dst), "--device", "cpu", "--compute-dtype",
                     "bfloat16"]) == 0
    assert "bfloat16" in capsys.readouterr().out
    params, manifest = load_artifact(se_art, device="cpu")
    se_spec = registry.get("mossformer2_se")
    from audiojax_torch.runtime.audio_io import resample_np

    want = Session(se_spec.make_module(params, dataclasses.replace(se_cfg,
                                                                  compute_dtype="bfloat16")),
                   manifest, device="cpu").process(resample_np(_read_wav(src), 16000, 48000))
    np.testing.assert_array_equal(_read_wav(se_dst), want.audio)
    art = tmp_path / "ss"
    cfg = tiny_config("mossformer2_ss")
    export_artifact("mossformer2_ss", BUILDERS["mossformer2_ss"](cfg, seed=2), art, cfg=cfg,
                    smoke=False)
    assert cli.main(["--model", "mossformer2_ss", "--artifact", str(art), "--input", str(src),
                     "--output", str(dst), "--device", "cpu", "--compute-dtype",
                     "bfloat16"]) == 0
    assert "bfloat16" in capsys.readouterr().out
    params, manifest = load_artifact(art, device="cpu")
    spec = registry.get("mossformer2_ss")
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    want = Session(spec.make_module(params, bcfg), manifest, device="cpu").process(
        _read_wav(src))
    for i, o in enumerate(want.outputs):
        np.testing.assert_array_equal(_read_wav(tmp_path / f"out_{i}.wav"), o)
