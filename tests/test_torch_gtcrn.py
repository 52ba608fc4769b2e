"""GTCRN in the port against audiojax.models.gtcrn on the same parameters.

JAX draws the parameters (``init_gtcrn(PRNGKey(0))``); they reach the port
as numpy through ``params_from_numpy``.  The JAX side runs on the CPU, where
its STFT/ISTFT is the jnp path, and each JAX function is compiled once.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import gtcrn as J
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_torch_ckpt_builders import one_thread  # noqa: F401

from audiojax_torch.models import gtcrn as T
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

MIN_SNR_DB = 40.0  # the port's f32 gate against the JAX package


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same as a numpy tree, the port's CPU tensors)."""
    pj = jax.jit(J.init_gtcrn, static_argnums=1)(jax.random.PRNGKey(0), J.GtcrnConfig())
    pn = jax.tree.map(np.asarray, pj)
    return pj, pn, params_from_numpy(pn, device="cpu")


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def _noisy(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 3 * t) + 0.05 * rng.standard_normal(n)
    return np.round(x * 32767).astype(np.int16)


def test_init_keys_and_shapes(params):
    _, pn, pt = params
    assert _keys_shapes(T.init_gtcrn_numpy(0)) == _keys_shapes(pn)
    ported = T.init_gtcrn(0, device="cpu")
    assert _keys_shapes(ported) == _keys_shapes(pt)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in jax.tree_util.tree_leaves(ported))


def test_net_matches_jax(params):
    pj, _, pt = params
    cfg = J.GtcrnConfig()
    spec = np.random.default_rng(1).standard_normal((2, 17, 514)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, s: J.gtcrn_net(p, s, cfg))(pj, jnp.asarray(spec)))
    out = T.gtcrn_net(pt, torch.from_numpy(spec), T.GtcrnConfig()).numpy()
    assert out.shape == ref.shape
    # float32 through ~30 layers and 10 GRUs: 1e-5 of the largest magnitude
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_forward_matches_jax(params):
    pj, _, pt = params
    audio = np.stack([_noisy(12000, 2), _noisy(12000, 3)])
    ref = np.asarray(jax.jit(lambda p, a: J.gtcrn_forward(p, a, J.GtcrnConfig()))(
        pj, jnp.asarray(audio)))
    out = T.gtcrn_forward(pt, torch.from_numpy(audio)).numpy()
    assert out.dtype == np.int16 and out.shape == audio.shape
    assert snr_db(ref, out) >= MIN_SNR_DB
    # the module wraps the same forward
    module_out = T.GTCRN(pt).eval()(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(module_out, out)


def test_session_matches_jax(params):
    """A 5 s clip: 3 windows of 2 s, bucketed to 4, butt-joined."""
    pj, _, pt = params
    clip = _noisy(5 * 16000, 4)
    jspec = jregistry.get("gtcrn")
    jcfg = jspec.make_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    tspec = tregistry.get("gtcrn")
    tcfg = tspec.make_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(clip)
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert snr_db(ref.audio, out.audio) >= MIN_SNR_DB
    assert out.audio_duration_s == ref.audio_duration_s == 5.0
