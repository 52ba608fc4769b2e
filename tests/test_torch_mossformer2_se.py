"""MossFormer2-SE in the port against audiojax.models.mossformer2_se, on the CPU.

The blocks and the network run at the tiny widths of
``tests/test_mossformer.py:79`` (dim 64, depth 2, group 16) on parameters JAX
draws, carried to the port as numpy by ``params_from_numpy``; the same seeded
numpy inputs go through both packages.  The int16 forward runs once more at
full widths with one layer on the port's own numpy draw, given to both.  The
JAX side runs its jnp paths on the CPU; the port takes its kernels' plain
versions.

Gates: blocks, GroupNorm(1), the deltas and the network within
1e-5 × max|ref|; the int16 forwards and ``Session.process`` within 1 LSB
(float32 sums reassociate between XLA:CPU and ATen and move a rounding by
one step at most; the full-width layer holds 1 LSB too, so no 40 dB gate is
needed in its place).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import mossformer2_se as J
from audiojax.nn import mossformer as JM
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession

from test_torch_ckpt_builders import hold_bf16, one_thread  # noqa: F401

from audiojax_torch.models import mossformer2_se as T
from audiojax_torch.nn import mossformer as TM
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
# the bf16 plan: the port's bf16 output against the JAX package's bf16 one on
# the CPU, int16 SNR, just below what was measured (ROADMAP §C); against its
# float32 one: test_torch_ckpt_builders.hold_bf16
BF16_GATE_DB = 40.0
TINY = dict(dim=64, depth=2, group_size=16, qk_dim=32, vu_dim=96, fsmn_inner=32, dw_kernel=5,
            rot_dim=8, lorder=5)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = J.MossFormer2SeConfig(**TINY), T.MossFormer2SeConfig(**TINY)
    pj = J.init_mossformer2_se(jax.random.PRNGKey(2), jcfg)
    # non-trivial norms, so that the per-channel affines are held too
    rng = np.random.default_rng(9)
    for key in ("in_norm", "mm_norm", "intra_norm"):
        pj[key] = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.standard_normal(v.shape)
                                  .astype(np.float32)) for k, v in pj[key].items()}
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _speech(n, seed, sr=48000):
    """A harmonic voice under a syllable envelope plus noise, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    voiced = sum(np.sin(2 * np.pi * 150 * k * t) / k for k in range(1, 8))
    x = 0.2 * voiced * np.sin(2 * np.pi * 3 * t) ** 2 + 0.05 * rng.standard_normal(n)
    return np.round(x * 32767).astype(np.int16)


def test_config_and_init_keys_and_shapes(tiny):
    _, tcfg, pj, _ = tiny
    assert (dataclasses.asdict(T.MossFormer2SeConfig())
            == dataclasses.asdict(J.MossFormer2SeConfig()))
    assert _keys_shapes(T.init_mossformer2_se_numpy(0, tcfg)) == _keys_shapes(pj)
    full = jax.eval_shape(lambda k: J.init_mossformer2_se(k, J.MossFormer2SeConfig()),
                          jax.random.PRNGKey(0))
    assert _keys_shapes(T.init_mossformer2_se_numpy(0)) == _keys_shapes(full)
    ported = T.init_mossformer2_se(0, tcfg, device="cpu")
    assert ported["pos_scale"].shape == () and ported["tail_act"]["alpha"].shape == ()
    assert tuple(ported["fsmn0"]["mem_conv"]["w"].shape) == (32, 1, 9)  # (C, 1, 2·lorder − 1)
    assert T.MossFormer2SeConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        T.MossFormer2SeConfig(compute_dtype="float16")


def test_bf16_plan_matches_jax(tiny):
    """The bf16 plan: a 0.5 s two-row request (tiny widths) against the JAX
    package's bf16 and float32 forwards, on the same parameters cast by each
    package's ``prepare_compute_params``; the fbank stays a float32 island."""
    jcfg, tcfg, pj, pt = tiny
    jb, tb = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, tcfg))
    audio = np.stack([_speech(24000, 5), _speech(24000, 6)])
    ref32 = jax.jit(lambda p, a: J.mossformer2_se_forward(p, a, jcfg))(pj, jnp.asarray(audio))
    ref16 = jax.jit(lambda p, a: J.mossformer2_se_forward(p, a, jb))(
        jregistry.prepare_compute_params(pj, jb), jnp.asarray(audio))
    model = tregistry.get("mossformer2_se").make_module(pt, tb)
    assert {t.dtype for t in model.buffers()} == {torch.bfloat16}
    with torch.inference_mode():
        out = model(torch.from_numpy(audio))
    hold_bf16(np.asarray(ref32), np.asarray(ref16), out.numpy(), BF16_GATE_DB, "mossformer2_se")


def test_gated_fsmn_block_matches_jax(tiny):
    _, _, pj, pt = tiny
    x = np.random.default_rng(1).standard_normal((2, 37, 64)).astype(np.float32)
    ref = jax.jit(lambda p, x: JM.gated_fsmn_block(p, x, lorder=5))(pj["fsmn1"], jnp.asarray(x))
    _close(TM.gated_fsmn_block(pt["fsmn1"], torch.from_numpy(x), lorder=5), ref)


def test_group_norm_all_is_per_window():
    """GroupNorm(1) normalises each window over (T, C) on its own: two windows
    at very different levels batched together give what each gives alone."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 12)).astype(np.float32) * np.array([[[1.0]], [[300.0]]],
                                                                        np.float32)
    p = {"g": rng.standard_normal(12).astype(np.float32), "b": rng.standard_normal(12)
         .astype(np.float32)}
    ref = J.group_norm_all(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = T.group_norm_all(pt, torch.from_numpy(x))
    _close(got, ref)
    for i in range(2):
        _close(T.group_norm_all(pt, torch.from_numpy(x[i:i + 1])), np.asarray(ref)[i:i + 1])


def test_deltas_match_jax():
    """Window 5 with a replicate pad of 2 frames at each end, taken twice."""
    x = np.random.default_rng(3).standard_normal((2, 9, 60)).astype(np.float32)
    d1 = J.deltas(jnp.asarray(x))
    _close(T.deltas(torch.from_numpy(x)), d1)
    _close(T.deltas(T.deltas(torch.from_numpy(x))), J.deltas(d1))
    one = np.repeat(x[:, :1], 3, axis=1)  # a constant signal has no deltas
    assert float(T.deltas(torch.from_numpy(one)).abs().max()) == 0.0


def test_net_matches_jax(tiny):
    """A ReLU mask of 961 bins, within 1e-5 (``tests/test_mossformer.py:79``)."""
    jcfg, tcfg, pj, pt = tiny
    fb = np.random.default_rng(3).standard_normal((2, 20, 3 * jcfg.n_mels)).astype(np.float32)
    ref = jax.jit(lambda p, f: J.mossformer2_se_net(p, f, jcfg))(pj, jnp.asarray(fb))
    got = T.mossformer2_se_net(pt, torch.from_numpy(fb), tcfg)
    assert tuple(got.shape) == (2, 20, jcfg.stft_bins) and float(got.min()) >= 0.0
    _close(got, ref)


@pytest.mark.parametrize("length", [48000, 50000, 1920])
def test_forward_matches_jax(tiny, length):
    """One second (125 frames), a length off the hop grid (padded), and a
    single frame: int16 within 1 LSB."""
    jcfg, tcfg, pj, pt = tiny
    audio = np.stack([_speech(length, 4), _speech(length, 5)])
    ref = jax.jit(lambda p, a: J.mossformer2_se_forward(p, a, jcfg))(pj, jnp.asarray(audio))
    got = T.mossformer2_se_forward(pt, torch.from_numpy(audio), tcfg)
    assert got.dtype == torch.int16 and tuple(got.shape) == audio.shape and bool(got.any())
    assert _lsb(ref, got) <= 1


def test_forward_full_width_one_layer_matches_jax():
    """Full widths (dim 512, 961 bins, FLASH group 256, lorder 20), one layer,
    0.5 s at 48 kHz (59 frames, one zero-padded group): within 1 LSB."""
    kw = dict(depth=1)
    jcfg, tcfg = J.MossFormer2SeConfig(**kw), T.MossFormer2SeConfig(**kw)
    pn = T.init_mossformer2_se_numpy(3, tcfg)
    audio = _speech(24000, 6)[None]
    ref = jax.jit(lambda p, a: J.mossformer2_se_forward(p, a, jcfg))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(audio))
    pt = params_from_numpy(pn, device="cpu")
    got = T.mossformer2_se_forward(pt, torch.from_numpy(audio), tcfg)
    assert bool(got.any()) and _lsb(ref, got) <= 1
    np.testing.assert_array_equal(T.MossFormer2SE(pt, tcfg)(torch.from_numpy(audio)).numpy(),
                                  got.numpy())


def test_session_matches_jax(tiny):
    """A 5 s 48 kHz clip at the manifest's geometry: 2 s windows, 3 of them
    bucketed to 4 (one all-zero pad window), butt-joined; within 1 LSB."""
    jcfg, tcfg, pj, pt = tiny
    clip = _speech(5 * 48000, 7)
    jspec, tspec = jregistry.get("mossformer2_se"), tregistry.get("mossformer2_se")
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    seen = []
    model = tspec.make_module(pt, tcfg)
    model.register_forward_hook(lambda m, a, o: seen.append(tuple(a[0].shape)))
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(model, manifest, device="cpu").process(clip)
    assert seen == [(4, 96000)]
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert _lsb(ref.audio, out.audio) <= 1 and out.audio_duration_s == ref.audio_duration_s


def test_kernel_routes_per_forward(tiny, monkeypatch):
    """Each layer sends four depthwise convs to B4's route and the FLASH group
    attention to B6's; the synthesis goes to B2's and nothing to B1, B3 or B5
    (``chip_smoke.py``'s 1 B2, 96 B4 and 24 B6 a forward at depth 24)."""
    from audiojax_torch.models import mossformer2_se as model_mod
    from audiojax_torch.nn import core as tcore
    from audiojax_torch.ops import stft_cuda

    calls = {"b1": 0, "b2": 0, "b4": 0, "b5": 0, "b6": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stft_cuda, "plain_stft_packed", counting("b1", stft_cuda.plain_stft_packed))
    monkeypatch.setattr(model_mod, "fast_istft_packed", counting("b2", model_mod.fast_istft_packed))
    monkeypatch.setattr(tcore, "fast_dwconv1d", counting("b4", tcore.fast_dwconv1d))
    monkeypatch.setattr(tcore, "fast_dwconv1d_grouped",
                        counting("b5", tcore.fast_dwconv1d_grouped))
    monkeypatch.setattr(TM, "fast_quad_attention", counting("b6", TM.fast_quad_attention))
    _, tcfg, _, pt = tiny
    T.mossformer2_se_forward(pt, torch.from_numpy(_speech(9600, 8)[None]), tcfg)
    assert calls == {"b1": 0, "b2": 1, "b4": 4 * tcfg.depth, "b5": 0, "b6": tcfg.depth}


def test_silence_maps_to_silence(tiny):
    _, tcfg, _, pt = tiny
    out = T.mossformer2_se_forward(pt, torch.zeros((1, 9600), dtype=torch.int16), tcfg)
    assert out.dtype == torch.int16 and int(out.abs().max()) == 0
