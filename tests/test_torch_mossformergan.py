"""MossFormerGAN-SE in the port against audiojax.models.mossformergan_se.

The blocks and the network run at the tiny widths of
``tests/test_mossformergan.py`` on parameters JAX draws
(``init_mossformergan(PRNGKey(0))``), which reach the port as numpy through
``params_from_numpy``.  The int16 forward runs at full widths with one
SyncANet block on the port's own numpy draw, given to both packages.  The JAX
side runs on the CPU (its STFT/ISTFT and depthwise convs take the jnp/lax
paths there); the port takes its kernels' plain versions.

Tolerances: blocks and network agree to 1e-5 × max|ref|; the port computes
the GAU's local relu² attention and its linear attention as two products
where the JAX package shares one value product, and sums in another order.
The int16 outputs must reach 40 dB SNR, the port's float32 gate.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import mossformergan_se as J
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_torch_ckpt_builders import hold_bf16, one_thread  # noqa: F401

from audiojax_torch.models import mossformergan_se as T
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
MIN_SNR_DB = 40.0
# the bf16 plan: the port's bf16 output against the JAX package's bf16 one on
# the CPU, int16 SNR, just below what was measured (27.66 dB; ROADMAP §C);
# against its float32 one: test_torch_ckpt_builders.hold_bf16
BF16_GATE_DB = 27.0

TINY = dict(emb_dim=16, emb_ks=2, uv_channels=24, n_blocks=1, dense_depth=2, lorder=4,
            mf_hidden=32, mf_vdim=16, mf_qk=16, mf_rot=8, dw_kernel=7,
            attn_heads=2, attn_q_ch=2, attn_v_ch=4, fold_window=0)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = J.MossFormerGanConfig(**TINY), T.MossFormerGanConfig(**TINY)
    pj = jax.jit(J.init_mossformergan, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _noisy(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 3 * t) + 0.05 * rng.standard_normal(n)
    return np.round(x * 32767).astype(np.int16)


def test_config_and_init_keys_and_shapes(tiny):
    _, tcfg, pj, pt = tiny
    assert dataclasses.asdict(T.MossFormerGanConfig()) == dataclasses.asdict(J.MossFormerGanConfig())
    assert _keys_shapes(T.init_mossformergan_numpy(0, tcfg)) == _keys_shapes(pj)
    # the default (full) configuration, shapes only
    full = jax.eval_shape(lambda k: J.init_mossformergan(k, J.MossFormerGanConfig()),
                          jax.random.PRNGKey(0))
    assert _keys_shapes(T.init_mossformergan_numpy(0)) == _keys_shapes(full)
    ported = T.init_mossformergan(0, tcfg, device="cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in jax.tree_util.tree_leaves(ported))
    # the bf16 plan is served; any other compute dtype is refused by name
    assert T.MossFormerGanConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        T.MossFormerGanConfig(compute_dtype="float16")


def test_gau_matches_jax(tiny):
    jcfg, tcfg, pj, pt = tiny
    b, bt, q_len = 2, 5, 9
    x = np.random.default_rng(1).standard_normal((b * bt, q_len, 16)).astype(np.float32)
    ref = jax.jit(lambda p, x: J.mossformer_gau(p, x, jcfg, b))(pj["block0"]["intra"]["mf"],
                                                                 jnp.asarray(x))
    _close(T.mossformer_gau(pt["block0"]["intra"]["mf"], torch.from_numpy(x), tcfg, b), ref)


def test_triple_attention_matches_jax(tiny):
    jcfg, tcfg, pj, pt = tiny
    x = np.random.default_rng(2).standard_normal((2, 6, 101, 16)).astype(np.float32)
    ref = jax.jit(lambda p, x: J.triple_attention(p, x, jcfg))(pj["block0"]["attn"], jnp.asarray(x))
    _close(T.triple_attention(pt["block0"]["attn"], torch.from_numpy(x), tcfg), ref)


def test_net_matches_jax(tiny):
    jcfg, tcfg, pj, pt = tiny
    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((1, 8, 201))).astype(np.float32)
    spec = rng.standard_normal((1, 8, 201, 2)).astype(np.float32)
    ref = jax.jit(lambda p, m, s: J.mossformergan_net(p, m, s, jcfg))(
        pj, jnp.asarray(mag), jnp.asarray(spec))
    _close(T.mossformergan_net(pt, torch.from_numpy(mag), torch.from_numpy(spec), tcfg), ref)


def test_forward_full_width_matches_jax():
    """Full widths, one SyncANet block, a 0.2 s clip (no batch-fold)."""
    kw = dict(n_blocks=1, fold_window=0)
    jcfg, tcfg = J.MossFormerGanConfig(**kw), T.MossFormerGanConfig(**kw)
    pn = T.init_mossformergan_numpy(3, tcfg)
    audio = np.stack([_noisy(3200, 5), _noisy(3200, 6)])
    ref = np.asarray(jax.jit(lambda p, a: J.mossformergan_forward(p, a, jcfg))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(audio)))
    pt = params_from_numpy(pn, device="cpu")
    out = T.mossformergan_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    assert out.dtype == np.int16 and out.shape == audio.shape
    assert snr_db(ref, out) >= MIN_SNR_DB
    np.testing.assert_array_equal(T.MossFormerGAN(pt, tcfg)(torch.from_numpy(audio)).numpy(), out)


def test_bf16_forward_matches_jax(tiny):
    """The bf16 plan (tiny widths, three 0.25 s clips, no fold) against the JAX
    package's bf16 and float32 forwards, on the parameters carried across by
    ``params_from_numpy`` and cast by each package's
    ``prepare_compute_params``."""
    jcfg, tcfg, pj, pt = tiny
    jb, tb = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, tcfg))
    audio = np.stack([_noisy(4000, seed) for seed in (8, 9, 10)])
    ref32 = np.asarray(jax.jit(lambda p, a: J.mossformergan_forward(p, a, jcfg))(
        pj, jnp.asarray(audio)))
    ref16 = np.asarray(jax.jit(lambda p, a: J.mossformergan_forward(p, a, jb))(
        jregistry.prepare_compute_params(pj, jb), jnp.asarray(audio)))
    out = T.mossformergan_forward(tregistry.prepare_compute_params(pt, tb),
                                  torch.from_numpy(audio), tb).numpy()
    hold_bf16(ref32, ref16, out, BF16_GATE_DB, "mossformergan_se")


def test_session_matches_jax(tiny):
    """A 7 s clip at the manifest's geometry: 2 windows of 6 s, each folded into
    four 1.5 s fold windows (tiny widths, ``fold_window=24000`` kept)."""
    _, _, pj, pt = tiny
    kw = {**TINY, "fold_window": 24000}
    jcfg, tcfg = J.MossFormerGanConfig(**kw), T.MossFormerGanConfig(**kw)
    clip = _noisy(7 * 16000, 4)
    jspec, tspec = jregistry.get("mossformergan_se"), tregistry.get("mossformergan_se")
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(clip)
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert snr_db(ref.audio, out.audio) >= MIN_SNR_DB
    assert out.audio_duration_s == ref.audio_duration_s == 7.0
