"""MossFormer2-SS in the port against audiojax.models.mossformer2_ss.

The blocks and the network run at the tiny widths of
``tests/test_mossformer2_ss.py`` on parameters JAX draws
(``init_mossformer2_ss(PRNGKey(0))``), which reach the port as numpy through
``params_from_numpy`` (``mem_stack`` is a list).  The int16 forward runs at
full widths with one layer on the port's own numpy draw, given to both
packages, on 499 frames: two FLASH groups of 256, the second zero-padded.  The
JAX side runs on the CPU (its depthwise convs and the grouped memory conv take
the lax/shift-and-add paths there); the port takes its kernels' plain versions.

Tolerances: blocks and network agree to 1e-5 × max|ref|; the port sums the
linear attention over the unpadded frames and the relu² attention apart from
it, in another order.  The int16 outputs must reach 40 dB SNR per source, the
port's float32 gate.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import mossformer2_ss as J
from audiojax.nn import mossformer as JM
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_torch_ckpt_builders import hold_bf16, one_thread  # noqa: F401

from audiojax_torch.models import mossformer2_ss as T
from audiojax_torch.nn import mossformer as TM
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
MIN_SNR_DB = 40.0
# the bf16 plan: the port's bf16 output against the JAX package's bf16 one on
# the CPU, int16 SNR, just below what was measured (39.63 and 38.49 dB by source; ROADMAP §C);
# against its float32 one: test_torch_ckpt_builders.hold_bf16
BF16_GATE_DB = 37.0

TINY = dict(dim=64, depth=2, group_size=16, qk_dim=32, vu_dim=96, fsmn_inner=32, dw_kernel=5,
            rot_dim=8, lorder=5)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = J.MossFormer2SsConfig(**TINY), T.MossFormer2SsConfig(**TINY)
    pj = jax.jit(J.init_mossformer2_ss, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _mix(n, seed):
    """Two synthetic voices (different pitch and syllable rate) plus noise, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    a = np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t) ** 2
    b = np.sin(2 * np.pi * 310 * t + 1.0) * np.cos(2 * np.pi * 2 * t) ** 2
    x = 0.25 * a + 0.2 * b + 0.03 * rng.standard_normal(n)
    return np.round(x * 32767).astype(np.int16)


def test_config_and_init_keys_and_shapes(tiny):
    _, tcfg, pj, pt = tiny
    assert dataclasses.asdict(T.MossFormer2SsConfig()) == dataclasses.asdict(J.MossFormer2SsConfig())
    assert _keys_shapes(T.init_mossformer2_ss_numpy(0, tcfg)) == _keys_shapes(pj)
    full = jax.eval_shape(lambda k: J.init_mossformer2_ss(k, J.MossFormer2SsConfig()),
                          jax.random.PRNGKey(0))
    assert _keys_shapes(T.init_mossformer2_ss_numpy(0)) == _keys_shapes(full)
    assert isinstance(pt["fsmn0"]["mem_stack"], list) and len(pt["fsmn0"]["mem_stack"]) == 2
    assert tuple(pt["fsmn0"]["mem_stack"][1]["conv"]["w"].shape) == (32, 2, 9)  # (G, 2, k)
    ported = T.init_mossformer2_ss(0, tcfg, device="cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in jax.tree_util.tree_leaves(ported))
    # the module holds the list as buffers and gives it back as a list
    back = T.MossFormer2SS(ported, tcfg).params
    assert _keys_shapes(back) == _keys_shapes(ported)


def test_bf16_plan_refused(tiny):
    """The bf16 plan, refused until ROADMAP A.10's first part, served: each
    source of a 0.25 s two-row mix (tiny widths) against the JAX package's
    bf16 and float32 forwards, on the parameters carried across by
    ``params_from_numpy`` and cast by each package's
    ``prepare_compute_params``.  Any other compute dtype is refused."""
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        T.MossFormer2SsConfig(compute_dtype="float16")
    jcfg, tcfg, pj, pt = tiny
    jb, tb = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, tcfg))
    audio = np.stack([_mix(4000, 8), _mix(4000, 9)])
    refs32 = jax.jit(lambda p, a: J.mossformer2_ss_forward(p, a, jcfg))(pj, jnp.asarray(audio))
    refs16 = jax.jit(lambda p, a: J.mossformer2_ss_forward(p, a, jb))(
        jregistry.prepare_compute_params(pj, jb), jnp.asarray(audio))
    outs = T.mossformer2_ss_forward(tregistry.prepare_compute_params(pt, tb),
                                    torch.from_numpy(audio), tb)
    for i, (r32, r16, out) in enumerate(zip(refs32, refs16, outs)):
        hold_bf16(np.asarray(r32), np.asarray(r16), out.numpy(), BF16_GATE_DB,
                  f"mossformer2_ss source {i}")


def test_flash_layer_matches_jax(tiny):
    """T = 40 with group 16: three groups, the last zero-padded after RoPE."""
    jcfg, tcfg, pj, pt = tiny
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(np.float32)
    kw = dict(group_size=16, qk_dim=32, rot_dim=8)
    ref = jax.jit(lambda p, x: JM.flash_layer(p, x, **kw))(pj["flash0"], jnp.asarray(x))
    _close(TM.flash_layer(pt["flash0"], torch.from_numpy(x), **kw), ref)


def test_gated_fsmn_block_dilated_matches_jax(tiny):
    _, _, pj, pt = tiny
    x = np.random.default_rng(2).standard_normal((2, 37, 64)).astype(np.float32)
    ref = jax.jit(lambda p, x: JM.gated_fsmn_block_dilated(p, x, lorder=5))(pj["fsmn1"],
                                                                             jnp.asarray(x))
    _close(TM.gated_fsmn_block_dilated(pt["fsmn1"], torch.from_numpy(x), lorder=5), ref)


def test_net_matches_jax(tiny):
    jcfg, tcfg, pj, pt = tiny
    audio = (np.random.default_rng(3).standard_normal((2, 800)) * 0.05).astype(np.float32)
    ref = jax.jit(lambda p, a: J.mossformer2_ss_net(p, a, jcfg))(pj, jnp.asarray(audio))
    _close(T.mossformer2_ss_net(pt, torch.from_numpy(audio), tcfg), ref)


def test_forward_full_width_matches_jax():
    """Full widths, one layer, a 4,000-sample two-row clip: 499 frames, two
    groups of 256, the second zero-padded."""
    kw = dict(depth=1)
    jcfg, tcfg = J.MossFormer2SsConfig(**kw), T.MossFormer2SsConfig(**kw)
    pn = T.init_mossformer2_ss_numpy(3, tcfg)
    audio = np.stack([_mix(4000, 5), _mix(4000, 6)])
    refs = jax.jit(lambda p, a: J.mossformer2_ss_forward(p, a, jcfg))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(audio))
    pt = params_from_numpy(pn, device="cpu")
    outs = T.mossformer2_ss_forward(pt, torch.from_numpy(audio), tcfg)
    assert len(outs) == 2
    for ref, out in zip(refs, outs):
        out = out.numpy()
        assert out.dtype == np.int16 and out.shape == audio.shape and np.any(out)
        assert snr_db(np.asarray(ref), out) >= MIN_SNR_DB
    for a, b in zip(T.MossFormer2SS(pt, tcfg)(torch.from_numpy(audio)), outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_session_matches_jax(tiny):
    """A 5 s clip at the manifest's geometry: the 8,000-sample head makes 88,000
    samples, 3 windows of 2 s, bucketed to 4 (one all-zero pad window)."""
    jcfg, tcfg, pj, pt = tiny
    clip = _mix(5 * 16000, 4)
    jspec, tspec = jregistry.get("mossformer2_ss"), tregistry.get("mossformer2_ss")
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    seen = []
    model = tspec.make_module(pt, tcfg)
    model.register_forward_hook(lambda m, a, o: seen.append(tuple(a[0].shape)))
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(model, manifest, device="cpu").process(clip)
    assert seen == [(4, 32000)]
    assert len(out.outputs) == len(ref.outputs) == 2
    for r, o in zip(ref.outputs, out.outputs):
        assert o.dtype == np.int16 and o.shape == r.shape == clip.shape and np.any(o)
        assert snr_db(r, o) >= MIN_SNR_DB
    assert out.audio_duration_s == ref.audio_duration_s == 5.0


def test_kernel_routes_per_layer(tiny, monkeypatch):
    """Each layer sends four depthwise convs to B4's route, the grouped memory
    conv to B5's and the FLASH group attention to B6's; nothing else reaches
    them (``chip_smoke.py``'s 96/24/24 a forward at depth 24)."""
    from audiojax_torch.nn import core as tcore

    calls = {"b4": 0, "b5": 0, "b6": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tcore, "fast_dwconv1d", counting("b4", tcore.fast_dwconv1d))
    monkeypatch.setattr(tcore, "fast_dwconv1d_grouped",
                        counting("b5", tcore.fast_dwconv1d_grouped))
    monkeypatch.setattr(TM, "fast_quad_attention", counting("b6", TM.fast_quad_attention))
    _, tcfg, _, pt = tiny
    T.mossformer2_ss_forward(pt, torch.from_numpy(_mix(1600, 7)[None]), tcfg)
    assert calls == {"b4": 4 * tcfg.depth, "b5": tcfg.depth, "b6": tcfg.depth}


def test_silence_maps_to_silence(tiny):
    _, tcfg, _, pt = tiny
    outs = T.mossformer2_ss_forward(pt, torch.zeros((1, 8000), dtype=torch.int16), tcfg)
    for o in outs:
        assert o.dtype == torch.int16 and int(o.abs().max()) == 0  # zero rms_in, zero gain
