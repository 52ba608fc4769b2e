"""Deep-Echo in the port against audiojax.models.deep_echo, on the CPU.

Deep-Echo runs at its defaults (20 channels, order-10 echo path) on the
port's numpy draw (``init_deep_echo_numpy``), given to JAX as arrays and to
the port by ``params_from_numpy``; every JAX reference is jitted.  Its CFB
and LSTM blocks are SDAEC's (``tests/test_torch_sdaec.py``); here its own
parts: the delay bank ``apply_echo_path`` (offline and with a carried
history) and the net's channel order, within 1e-5 × max|ref|; the int16
forward, ``Session.process(near, far)`` and the stream step within 1 LSB,
the stream states within STATE_RTOL (1e-4) × max|ref| (each step from
the same incoming state, as for SDAEC); ``StreamingServer`` (``jit=False``) against
the JAX server within 1 LSB; then the JAX package's stream contract and the
kernel routes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import deep_echo as J
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from audiojax.runtime.streaming import StreamingServer as JServer
from test_torch_ckpt_builders import one_thread  # noqa: F401  (autouse)
from test_torch_sdaec import (close, drive, echo_pair, lsb, pairs, speech, states_close,
                              stream_chunks, t, zero_mean)

from audiojax_torch.models import deep_echo as T
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession
from audiojax_torch.runtime.streaming import StreamingServer


@pytest.fixture(scope="module")
def params():
    pn = T.init_deep_echo_numpy(0)
    return pn, jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_and_init_keys_and_shapes(params):
    pn, _, _ = params
    assert dataclasses.asdict(T.DeepEchoConfig()) == dataclasses.asdict(J.DeepEchoConfig())
    full = jax.eval_shape(lambda k: J.init_deep_echo(k, J.DeepEchoConfig()),
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    assert {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(pn)[0]} == want


@pytest.mark.parametrize("with_history", [False, True])
def test_apply_echo_path_matches_jax(with_history):
    """Σ_l path_l · far delayed by (order − 1 − l) frames, from the zero left
    pad or from a carried (order − 1)-frame history."""
    far, path = _rand((2, 6, 160, 2), 1), _rand((2, 6, 160, 2, 10), 2)
    hist = _rand((2, 9, 160, 2), 3) if with_history else None
    ref = J.apply_echo_path(jnp.asarray(far), jnp.asarray(path), 10,
                            None if hist is None else jnp.asarray(hist))
    close(T.apply_echo_path(t(far), t(path), 10, None if hist is None else t(hist)), ref)


def test_net_matches_jax(params):
    """The whole net on given spectra (mix and far complex-last), offline."""
    _, pj, pt = params
    mix, far = _rand((1, 5, 160, 2), 4), _rand((1, 5, 160, 2), 5)
    ref = jax.jit(lambda p, a, b: J.deep_echo_net(p, a, b, J.DeepEchoConfig()))(
        pj, jnp.asarray(mix), jnp.asarray(far))
    close(T.deep_echo_net(pt, t(mix), t(far), T.DeepEchoConfig()), ref)


def test_forward_matches_jax(params):
    """Two 0.5 s (near, far) rows with an echo path: within 1 LSB."""
    _, pj, pt = params
    near, far = pairs(2, 8000, 10)
    ref = jax.jit(lambda p, a, b: J.deep_echo_forward(p, a, b, J.DeepEchoConfig()))(
        pj, jnp.asarray(near), jnp.asarray(far))
    got = T.deep_echo_forward(pt, t(near), t(far), T.DeepEchoConfig())
    assert got.dtype == torch.int16 and tuple(got.shape) == near.shape
    assert lsb(ref, got) <= 1


def test_session_matches_jax(params):
    """``Session.process(near, far)`` on a 1 s pair (one 10 s window)."""
    _, pj, pt = params
    near, far = speech(16000, 12), speech(16000, 13, pitch=210.0)
    jspec, tspec = jregistry.get("deep_echo"), tregistry.get("deep_echo")
    jcfg, tcfg = jspec.make_config(), tspec.make_config()
    manifest = tspec.make_manifest(tcfg)
    assert manifest.num_audio_inputs == 2 and manifest.input_audio_length == 160000
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(near, far)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(near, far)
    assert out.audio.dtype == np.int16 and out.audio.shape == near.shape
    assert lsb(ref.audio, out.audio) <= 1


def test_stream_step_matches_jax(params):
    """Four chunks of 4 hops, two lanes: int16 within 1 LSB, the new states
    (the far delay-bank history among them) within STATE_RTOL (1e-4) × max|ref|."""
    _, pj, pt = params
    jcfg, tcfg = J.DeepEchoConfig(), T.DeepEchoConfig()
    jstep = jax.jit(lambda s, n, f: J.deep_echo_stream_step(pj, s, n, f, jcfg))
    near, far = pairs(2, 16 * 160, 14)
    states_close(J.deep_echo_stream_init(jcfg, batch=2),
                 T.deep_echo_stream_init(tcfg, batch=2, device="cpu"), 0.0)
    stream_chunks(jstep, lambda s, n, f: T.deep_echo_stream_step(pt, s, n, f, tcfg),
                  J.deep_echo_stream_init(jcfg, batch=2), near, far, 640)


def test_stream_matches_offline_at_its_delay(params):
    """Port of ``tests/test_sdaec_deep_echo.py:145``: on zero-mean inputs the
    stream is the default offline path delayed by n_fft − hop, within 1 LSB."""
    _, _, pt = params
    cfg = T.DeepEchoConfig()
    rng = np.random.default_rng(2)
    total = 16 * cfg.hop
    near, far = zero_mean(rng, total), zero_mean(rng, total)
    offline = T.deep_echo_forward(pt, t(near[None]), t(far[None]), cfg).numpy()[0]
    state, outs = T.deep_echo_stream_init(cfg, device="cpu"), []
    for s in range(0, total, 4 * cfg.hop):
        state, out = T.deep_echo_stream_step(pt, state, t(near[None, s:s + 4 * cfg.hop]),
                                             t(far[None, s:s + 4 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    streamed = np.concatenate(outs)
    delay = cfg.n_fft - cfg.hop
    lo, hi = cfg.n_fft, total - cfg.n_fft - delay
    assert lsb(offline[lo:hi], streamed[lo + delay:hi + delay]) <= 1


def test_server_matches_jax_server(params):
    """Three lanes of (near, far), irregular pushes, block_hops 2: within
    1 LSB of the JAX server; the lane-axis inference holds."""
    _, pj, pt = params
    jspec, tspec = jregistry.get("deep_echo"), tregistry.get("deep_echo")
    n = 9 * 160 + 77
    clips = [echo_pair(n, 20 + 2 * i) for i in range(3)]
    cuts = [0, 300, 1000, 1000 + 2 * 160 + 5, n]
    ref = drive(JServer(jspec, pj, jspec.make_config(), max_streams=3, block_hops=2,
                        jit=True), clips, cuts)
    srv = StreamingServer(tspec, pt, tspec.make_config(), max_streams=3, block_hops=2,
                          jit=False, device="cpu")
    got = drive(srv, clips, cuts)
    for r, g in zip(ref, got):
        assert g.dtype == np.int16 and g.shape == r.shape == (n,)
        assert lsb(r, g) <= 1
    srv.verify_lane_isolation()


def test_kernel_routes(params, monkeypatch):
    """Offline: B1 once over near‖far and B2 once with the exact out_length;
    the stream step: B1 once over near‖far of its lanes, uncentred."""
    calls = {"b1": [], "b2": []}

    def b1(x, cfg):
        calls["b1"].append((tuple(x.shape), cfg.center))
        return stft(x, cfg)

    def b2(spec, cfg, out_length=None):
        calls["b2"].append(out_length)
        return istft(spec, cfg, out_length)

    stft, istft = T.fast_stft_packed, T.fast_istft_packed
    monkeypatch.setattr(T, "fast_stft_packed", b1)
    monkeypatch.setattr(T, "fast_istft_packed", b2)
    # the stream's framing lives in the SDAEC module
    from audiojax_torch.models import sdaec
    monkeypatch.setattr(sdaec, "fast_stft_packed", b1)
    _, _, pt = params
    near, far = pairs(1, 1000, 16)
    T.deep_echo_forward(pt, t(near), t(far))
    assert calls == {"b1": [((2, 1120), True)], "b2": [1120]}
    T.deep_echo_stream_step(pt, T.deep_echo_stream_init(batch=2, device="cpu"),
                            t(np.zeros((2, 640), np.int16)), t(np.zeros((2, 640), np.int16)))
    assert calls == {"b1": [((2, 1120), True), ((4, 799), False)], "b2": [1120]}
