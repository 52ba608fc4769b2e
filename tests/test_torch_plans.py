"""The q8f32, q8dyn and weight-only bf16 plans of the port against the JAX
package, on the CPU: quantization, the layout of quantized weights, the
dynamic int8 product, the optimizer's checks and audit, and the artifacts
through export ``--plan``, the optimizer's command and the CLI (offline and
``--stream``).

Mel-Band Roformer (the JAX package's ``plan_for`` gives it q8f32) runs at the
port's tiny test widths, GTCRN at its defaults, with ``min_size=256`` where a
plan must reach its GRU leaves (as ``tests/test_utils.py`` quantizes them).
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import melband_roformer as JM
from audiojax.nn import core as jcore
from audiojax.runtime import optimize as joptimize
from audiojax.utils import quantize as jquantize
from reference_loader import snr_db
from test_torch_ckpt_builders import BUILDERS, TINY, one_thread, tiny_config  # noqa: F401

from audiojax_torch.models import melband_roformer as TM
from audiojax_torch.nn import core
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli, optimize, registry
from audiojax_torch.runtime import export as texport
from audiojax_torch.runtime.checkpoint import load_artifact, load_tree
from audiojax_torch.runtime.export import export_artifact
from audiojax_torch.runtime.session import Session
from audiojax_torch.runtime.streaming import StreamingSession
from audiojax_torch.utils.quantize import dequantize_tree, quantize_tree, quantized_bytes

# Mel-Band under q8f32 and q8dyn, the port against the JAX package on the same
# quantized tree, int16 SNR: the port's float32 gate
Q8_GATE_DB = 40.0


@pytest.fixture(scope="module")
def melband():
    """(JAX config, port config, the JAX tree as numpy arrays)."""
    jcfg, tcfg = JM.MelBandConfig(**TINY["melband_roformer"]), tiny_config("melband_roformer")
    pj = jax.jit(JM.init_melband, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jax.tree.map(np.asarray, pj)


@pytest.fixture(scope="module")
def gtcrn_tree():
    spec = registry.get("gtcrn")
    from audiojax.runtime import registry as jregistry

    jspec = jregistry.get("gtcrn")
    pj = jax.jit(jspec.init_params, static_argnums=1)(jax.random.PRNGKey(1), jspec.make_config())
    return spec, jax.tree.map(np.asarray, pj)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


# ── quantization ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("which,min_size", [("melband", 4096), ("melband", 256),
                                            ("gtcrn", 256)])
def test_quantize_tree_equals_jax(which, min_size, melband, gtcrn_tree):
    """int8 values and scales bit for bit, the same nodes, the same byte counts."""
    tree = melband[2] if which == "melband" else gtcrn_tree[1]
    ours, ref = quantize_tree(tree, min_size), jquantize.quantize_tree(tree, min_size)
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    n_q = 0
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        n_q += a.dtype == np.int8
    assert n_q > 0
    assert quantized_bytes(ours) == jquantize.quantized_bytes(ref)


def test_q8_leaves_land_in_the_port_layout(melband, gtcrn_tree):
    """A q8 node takes its weight's layout change, values and scales both:
    dequantized in the port's layout it equals the port's conversion of the
    dequantized JAX-layout tree, bit for bit — conv2d (GTCRN), stacked dense
    ``me_hidden`` (Mel-Band), GRU (GTCRN) and dense leaves."""
    for tree in (melband[2], gtcrn_tree[1]):
        q = quantize_tree(tree, 256)
        ported = params_from_numpy(q, device="cpu")
        want = params_from_numpy(jax.tree.map(np.asarray, jquantize.dequantize_tree(q)),
                                 device="cpu")
        got = dequantize_tree(ported)
        for a, b in zip(_leaves(got), _leaves(want)):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    gt = params_from_numpy(quantize_tree(gtcrn_tree[1], 256), device="cpu")
    conv = gt["enc0"]["conv"]["w"]  # HWIO (1, 5, 9, 16) → (16, 9, 1, 5), scale (16, 1, 1, 5)
    assert tuple(conv["q8"].shape) == (16, 9, 1, 5) and tuple(conv["scale"].shape) == (16, 1, 1, 5)
    assert conv["q8"].dtype == torch.int8 and conv["scale"].dtype == torch.float32
    gru = gt["enc_gt0"]["tra"]["gru"]["w_i"]  # kept (8, 48), scale (1, 48)
    assert tuple(gru["q8"].shape) == (8, 48) and tuple(gru["scale"].shape) == (1, 48)
    mb = params_from_numpy(quantize_tree(melband[2], 256), device="cpu")
    hid = mb["me_hidden"][0]["w"]  # stacked (bands, in, out) kept, scale (bands, 1, out)
    assert tuple(hid["q8"].shape) == (8, 32, 64) and tuple(hid["scale"].shape) == (8, 1, 64)
    # a conv1d weight (k, in, out) → (out, in, k), its scale (k, 1, out) → (out, 1, k)
    w = np.random.default_rng(0).standard_normal((17, 32, 64)).astype(np.float32)
    c1 = params_from_numpy(quantize_tree({"conv": {"w": w}}), device="cpu")["conv"]["w"]
    assert tuple(c1["q8"].shape) == (64, 32, 17) and tuple(c1["scale"].shape) == (64, 1, 17)
    with pytest.raises(TypeError, match="q8"):
        params_from_numpy({"d": {"w": {"q8": w, "scale": w}}}, device="cpu")


def test_cast_and_prepare_leave_q8_alone(melband):
    """``cast_f32_tree`` leaves q8 nodes as they are, and
    ``prepare_compute_params`` passes a quantized tree through."""
    _, tcfg, tree = melband
    q = params_from_numpy(quantize_tree(tree, 256), device="cpu")
    cast = core.cast_f32_tree(q, torch.bfloat16)
    assert cast["me_hidden"][0]["w"]["scale"].dtype == torch.float32
    assert cast["me_hidden"][0]["b"].dtype == torch.bfloat16
    bf = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    assert registry.prepare_compute_params(q, bf) is q


# ── the dynamic int8 product ──────────────────────────────────────────────


@pytest.mark.parametrize("rows", [1, 11, 40])
def test_dense_q8dyn_matches_jax(rows):
    """``core.dense`` on a q8 weight against the JAX package's at 1, 11 and 40
    rows (1e-6 × max|ref|), and against the manual pipeline: per-row int8
    activations, an int32 product, the two rescales."""
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((96, 160)).astype(np.float32)
    b = rng.standard_normal(160).astype(np.float32)
    x = rng.standard_normal((2, rows, 96)).astype(np.float32)
    q = quantize_tree({"d": {"w": w}}, min_size=1)["d"]["w"]
    ref = np.asarray(jax.jit(jcore.dense)({"w": jax.tree.map(jnp.asarray, q), "b": b},
                                          jnp.asarray(x)))
    p = {"w": {k: torch.from_numpy(v) for k, v in q.items()}, "b": torch.from_numpy(b)}
    out = core.dense(p, torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())

    xs = np.maximum(np.abs(x).max(axis=-1, keepdims=True), np.finfo(np.float32).tiny) / 127.0
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
    manual = (xq.astype(np.int64) @ q["q8"].astype(np.int64)) * xs * q["scale"] + b
    np.testing.assert_allclose(out, manual, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(3, 2048, 24), (5, 13, 11), (40, 96, 160)])
def test_int_mm_is_exact(m, k, n):
    """The int8 product sums in int32 exactly at K = 2048 with every entry
    ±127 (127²·K passes 2²⁴, where float32 sums stop being exact), and the
    zero padding to the card's shape contract (M > 16, K and N multiples of
    8), taken on every device, gives the same product at odd shapes."""
    rng = np.random.default_rng(7)
    a = rng.choice([-127, 127], (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = core.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


# ── Mel-Band under q8f32 and q8dyn ────────────────────────────────────────


@pytest.mark.parametrize("quantize,min_size", [("q8f32", 4096), ("q8dyn", 4096),
                                               ("q8dyn", 256)])
def test_melband_q8_matches_jax(quantize, min_size, melband):
    """The same quantized tree in both packages: the JAX package's q8f32
    forward on its dequantized tree and its q8dyn forward on the tree itself,
    against the port's module served through ``wrap_forward`` (q8f32: its
    buffers int8, dequantized at every forward; q8dyn: as it is).  At the
    tiny widths only the stacked mask MLP reaches 4,096 elements; at 256 the
    attention and feed-forward products take the dynamic int8 route too."""
    jcfg, tcfg, tree = melband
    q = quantize_tree(tree, min_size)
    audio = (np.random.default_rng(3).standard_normal((2, 8820)) * 6000).astype(np.int16)
    jq = jax.tree.map(jnp.asarray, q)
    jp = jquantize.dequantize_tree(jq) if quantize == "q8f32" else jq
    ref = np.asarray(jax.jit(lambda p, a: JM.melband_forward(p, a, jcfg))(jp, jnp.asarray(audio)))
    spec = registry.get("melband_roformer")
    manifest = spec.make_manifest(tcfg)
    manifest.extra["optimize"] = {"plan": quantize, "quantize": quantize, "compute_dtype": "f32"}
    model = optimize.wrap_forward(spec.make_module(params_from_numpy(q, device="cpu"), tcfg),
                                  manifest)
    assert {t.dtype for t in model.buffers()} == {torch.float32, torch.int8}
    with torch.inference_mode():
        out = model(torch.from_numpy(audio)).numpy()
    f32 = np.asarray(jax.jit(lambda p, a: JM.melband_forward(p, a, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(audio)))
    s = snr_db(ref, out)
    print(f"\nmelband {quantize}: port vs JAX {s:.2f} dB; JAX {quantize} vs JAX float32 "
          f"{snr_db(f32, ref):.2f} dB, port vs JAX float32 {snr_db(f32, out):.2f} dB")
    assert out.dtype == np.int16 and out.shape == ref.shape and np.any(out)
    assert s >= Q8_GATE_DB


@pytest.mark.parametrize("name", registry.names())
def test_every_family_serves_the_q8_plans(name):
    """Every registered model at the tiny test widths, its tree quantized
    with ``min_size`` 256 (GRU, LSTM, dense, conv and stacked weights int8):
    served through ``wrap_forward`` under q8f32 it equals the forward of the
    dequantized tree bit for bit, and under q8dyn it runs on the tree as it
    is (the dynamic int8 route) to an int16 answer of the input's shape."""
    from test_torch_ckpt_builders import INIT_NUMPY

    spec, cfg = registry.get(name), tiny_config(name)
    manifest = spec.make_manifest(cfg)
    q = quantize_tree(INIT_NUMPY[name](0, cfg), 256)
    n = min(manifest.input_audio_length, manifest.in_sample_rate // 4)
    shape = (1, manifest.input_channels, n) if manifest.input_channels > 1 else (1, n)
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy((rng.standard_normal(shape) * 3000).astype(np.int16))
          for _ in range(manifest.num_audio_inputs)]
    outs = {}
    for plan in ("q8f32", "q8dyn"):
        manifest.extra["optimize"] = {"plan": plan, "quantize": plan, "compute_dtype": "f32"}
        model = optimize.wrap_forward(spec.make_module(params_from_numpy(q, device="cpu"), cfg),
                                      manifest)
        assert torch.int8 in {t.dtype for t in model.buffers()}
        with torch.inference_mode():
            out = model(*xs)
        outs[plan] = out if isinstance(out, tuple) else (out,)
    with torch.inference_mode():
        ref = spec.make_module(dequantize_tree(params_from_numpy(q, device="cpu")), cfg)(*xs)
    for a, b, c in zip(outs["q8f32"], ref if isinstance(ref, tuple) else (ref,), outs["q8dyn"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert c.dtype == a.dtype and c.shape == a.shape and bool(c.any())


# ── the optimizer ──────────────────────────────────────────────────────────


def test_optimize_plans_fail_closed():
    """Contract drift aborts: invalid plan combinations, dead block patterns,
    a pass that quantizes or casts nothing."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        optimize.Plan("bad", quantize="q8f32", compute_dtype="bf16")
    with pytest.raises(ValueError, match="unknown quantize"):
        optimize.Plan("bad", quantize="int4")
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        optimize.Plan("bad", compute_dtype="fp16")
    params = {"lin": {"w": np.ones((128, 128), np.float32), "b": np.ones((128,), np.float32)}}
    with pytest.raises(ValueError, match="matched nothing"):
        optimize.apply_plan(params, optimize.Plan("bad", compute_dtype="bf16",
                                                  fp32_block=("no_such_layer",)))
    with pytest.raises(ValueError, match="ZERO leaves"):
        optimize.apply_plan(params, optimize.Plan("bad", quantize="q8f32", q8_min_size=1 << 20))
    with pytest.raises(ValueError, match="bf16 cast ZERO leaves"):
        optimize.apply_plan({"b": np.ones((128,), np.float32)}, optimize.PLANS["bf16"])
    assert optimize.plan_for("melband_roformer").quantize == "q8f32"
    assert optimize.plan_for("gtcrn") is optimize.PLANS["f32"]
    assert sorted(optimize.PLANS) == sorted(joptimize.PLANS)


def test_q8dyn_warns_experimental(melband):
    with pytest.warns(UserWarning, match="EXPERIMENTAL"):
        _, audit = optimize.apply_plan(melband[2], optimize.PLANS["q8dyn"])
    assert audit["experimental"] is True


@pytest.mark.parametrize("plan", [
    "f32", "q8f32", "q8dyn", "bf16", "melband_roformer", "blocked",
])
def test_apply_plan_audit_and_tree_equal_jax(plan, melband):
    """The audit dict (its keys, and its values but the plan's notes, which
    speak of the port) and the optimized tree equal the JAX package's on the
    same tree; ``blocked`` is a bf16 plan whose ``fp32_block`` keeps the band
    split float32."""
    tree = melband[2]
    if plan == "blocked":
        mine = optimize.Plan("blocked", compute_dtype="bf16", fp32_block=(r"^band_split/",))
        theirs = joptimize.Plan("blocked", compute_dtype="bf16", fp32_block=(r"^band_split/",))
    else:
        mine, theirs = optimize.PLANS[plan], joptimize.PLANS[plan]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, audit = optimize.apply_plan(tree, mine)
        jout, jaudit = joptimize.apply_plan(tree, theirs)
    assert set(audit) == set(jaudit) and set(audit["plan"]) == set(jaudit["plan"])
    for a in (audit, jaudit):
        a["plan"].pop("notes")
    assert audit == jaudit
    assert jax.tree.structure(out) == jax.tree.structure(jout)
    for a, b in zip(_leaves(out), jax.tree.leaves(jout)):
        if isinstance(a, torch.Tensor):  # a bf16 leaf
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def _wav(path, audio, rate):
    from audiojax_torch.runtime.audio_io import write_wav

    return write_wav(path, audio, rate)


def _read(path):
    from audiojax_torch.runtime.audio_io import read_audio

    return read_audio(path)[0]


@pytest.mark.parametrize("plan", ["q8f32", "q8dyn", "bf16"])
def test_export_plan_round_trip(plan, tmp_path):
    """Export ``plan=`` optimizes the artifact in place before its smoke
    request; ``params.pt`` keeps the int8 or bfloat16 leaves; the manifest
    and the report carry the plan; the CLI serves the artifact as the
    library's ``wrap_forward`` does (q8f32 and bf16 from buffers in their
    stored dtype)."""
    name = "melband_roformer"
    cfg = tiny_config(name)
    art = tmp_path / "art"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = export_artifact(name, BUILDERS[name](cfg, seed=3), art, cfg=cfg, device="cpu",
                                 plan=optimize.PLANS[plan])
    assert report["smoke"]["device"] == "cpu"
    audit = json.loads((art / "optimize_report.json").read_text())
    assert audit["plan"]["name"] == plan
    params, manifest = load_artifact(art, device="cpu")
    assert manifest.extra["optimize"] == {"plan": plan, "quantize": optimize.PLANS[plan].quantize,
                                          "compute_dtype": optimize.PLANS[plan].compute_dtype}
    stored = {t.dtype for t in _leaves(params)}
    assert stored == ({torch.float32, torch.bfloat16} if plan == "bf16"
                      else {torch.float32, torch.int8})
    if plan != "bf16":
        assert audit["compression"] > 1.0 and audit["leaves_quantized"] > 0
    spec = registry.get(name)
    model = optimize.wrap_forward(spec.make_module(params, cfg), manifest)
    assert {t.dtype for t in model.buffers()} == stored
    clip = (np.random.default_rng(4).standard_normal(30000) * 5000).astype(np.int16)
    want = Session(model, manifest, device="cpu").process(clip).audio
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    _wav(src, clip, manifest.in_sample_rate)
    assert cli.main(["--model", name, "--artifact", str(art), "--input", str(src),
                     "--output", str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(_read(dst)[0], want)
    # q8f32 and bf16 serve their float32 weights: the answer of the materialized tree
    if plan != "q8dyn":
        f32 = optimize.materialize_params(params, manifest)
        assert {t.dtype for t in _leaves(f32)} == {torch.float32}
        ref = Session(spec.make_module(f32, cfg), manifest, device="cpu").process(clip).audio
        np.testing.assert_array_equal(ref, want)


def test_optimize_and_export_commands(tmp_path, capsys):
    """``python -m audiojax_torch.runtime.optimize src dst --plan …`` (and
    ``--list-plans``), and export's ``--plan`` flag, write what the library
    writes."""
    assert optimize.main(["--list-plans"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in optimize.PLANS)
    name = "melband_roformer"
    cfg = tiny_config(name)
    src = tmp_path / "src"
    export_artifact(name, BUILDERS[name](cfg, seed=6), src, cfg=cfg, smoke=False)
    assert optimize.main([str(src), str(tmp_path / "dst"), "--plan", "q8f32"]) == 0
    assert "wrote optimized artifact" in capsys.readouterr().out
    ref = quantize_tree(load_tree(src))
    for a, b in zip(jax.tree.leaves(load_tree(tmp_path / "dst")), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        optimize.main([str(src), str(tmp_path / "x"), "--plan", "int4"])
    capsys.readouterr()

    ckpt = tmp_path / "gtcrn.pt"
    torch.save(BUILDERS["gtcrn"](seed=8), ckpt)
    assert texport.main(["--model", "gtcrn", "--checkpoint", str(ckpt), "--out",
                         str(tmp_path / "g"), "--device", "cpu", "--plan", "bf16"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["smoke"]["outputs"] == 1
    manifest = json.loads((tmp_path / "g" / "manifest.json").read_text())
    assert manifest["extra"]["optimize"]["plan"] == "bf16"


@pytest.mark.parametrize("plan", [
    optimize.Plan("q8dyn256", quantize="q8dyn", q8_min_size=256),
    optimize.Plan("q8f32_256", quantize="q8f32", q8_min_size=256),
    optimize.PLANS["bf16"],
], ids=lambda p: p.name)
def test_cli_streams_an_optimized_artifact(plan, gtcrn_tree, tmp_path, capsys):
    """``--stream`` on an optimized GTCRN artifact serves the tree
    ``materialize_params`` gives (q8dyn: the int8 GRU and dense weights as
    they are; q8f32 and bf16: float32), as a ``StreamingSession`` does."""
    spec, _ = gtcrn_tree
    cfg = spec.make_config()
    src = tmp_path / "src"
    export_artifact("gtcrn", BUILDERS["gtcrn"](seed=9), src, smoke=False)
    art = optimize.optimize_artifact(src, tmp_path / "art", plan)
    params, manifest = load_artifact(art, device="cpu")
    served = optimize.materialize_params(params, manifest)
    dtypes = {t.dtype for t in _leaves(served)}
    assert dtypes == ({torch.float32, torch.int8} if plan.quantize == "q8dyn"
                      else {torch.float32})
    clip = (np.random.default_rng(10).standard_normal(9000) * 4000).astype(np.int16)
    session = StreamingSession(spec, served, cfg, block_hops=4, jit=False, device="cpu")
    want = np.concatenate([session.push(clip), session.flush()])
    inp, out = tmp_path / "in.wav", tmp_path / "out.wav"
    _wav(inp, clip, 16000)
    assert cli.main(["--model", "gtcrn", "--artifact", str(art), "--input", str(inp),
                     "--output", str(out), "--device", "cpu", "--stream"]) == 0
    assert "streaming RTF" in capsys.readouterr().out
    np.testing.assert_array_equal(_read(out)[0], want)
    assert want.shape == clip.shape and np.any(want)
