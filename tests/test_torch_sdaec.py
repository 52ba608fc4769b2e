"""SDAEC and its ICCRN blocks in the port against audiojax, on the CPU.

SDAEC runs at its defaults (full width: 20 channels, 160 bins) on the port's
numpy draw (``init_sdaec_numpy``, the keys and shapes of JAX's
``init_sdaec``), given to JAX as arrays and to the port by
``params_from_numpy``.  Every JAX reference is jitted (an eager SDAEC
forward takes seconds a call) and computed once.

Gates: the blocks (``lstm`` in both directions and with a carried state,
``iccrn_layer_norm``, ``ch_lstm_f``, ``ch_lstm_t`` with state, ``ceps_unit``,
``cfb``, ``alpha_align`` with its cache) within 1e-5 × max|ref|; the int16
forward, ``Session.process(near, far)`` (at 16 kHz, and at 48 kHz in and out
through the in-graph resampler) and the stream step chunk for chunk within
1 LSB, the stream states within ``STATE_RTOL`` (1e-4) × max|ref| (each step
from the same incoming state; one full-width step carries ~1e-5 of float32
error in either package, see ``STATE_RTOL``); ``StreamingServer`` (``jit=False``)
against the JAX package's server within 1 LSB.  Then the JAX package's
stream contract (the stream is the offline path at an n_fft − hop delay),
the kernel routes and the CLI's two inputs.
"""
import dataclasses
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import sdaec as J
from audiojax.nn import cfb as JC
from audiojax.nn import rnn as JR
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from audiojax.runtime.streaming import StreamingServer as JServer
from test_torch_ckpt_builders import flat_tree, one_thread  # noqa: F401  (autouse)

from audiojax_torch.models import sdaec as T
from audiojax_torch.nn import cfb as TC
from audiojax_torch.nn import core as tcore
from audiojax_torch.nn import rnn as TR
from audiojax_torch.ops import dwconv_cuda
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession
from audiojax_torch.runtime.streaming import StreamingServer

RTOL = 1e-5
# × max|ref|, for a stream step's new state.  One full-width SDAEC step
# carries ~1e-5 × max|ref| of float32 error in its out-LSTM state whichever
# package computes it (the JAX package 1.48e-5 and the port 1.40e-5 against
# the port run in float64, on the same 4-frame step): its decoders' outputs
# reach ~10 and feed the LSTM's input products, and the recurrence grows the
# error over a step's frames.  Two float32 implementations part by up to
# 1.56e-5 there, and by 5.2e-5 in the cascade's 8-frame backend step; the
# echo-cancelled float waveform it carries (temp) parts by 1.3e-5 × max|ref|,
# half an int16 LSB.  A state-carry fault parts by O(1).
STATE_RTOL = 1e-4
SR = 16000


# ── shared by the three AEC test files ──────────────────────────────────────


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rtol * max(np.abs(ref).max(), 1e-30), rtol=0)


def states_close(jstate, tstate, rtol=RTOL):
    """Same key paths (tuples as lists) and dtypes; each leaf within rtol × max|ref|."""
    jf, tf = flat_tree(jax.tree.map(np.asarray, jstate)), flat_tree(tstate)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype, k
        close(tf[k], jf[k], rtol)


def to_port(tree):
    """A JAX state tree as the port's: tensors, tuples as lists."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_port(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def speech(n, seed, pitch=150.0, sr=SR):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    x = (0.25 * np.sin(2 * np.pi * pitch * tt) * np.sin(2 * np.pi * 3 * tt) ** 2
         + 0.05 * rng.standard_normal(n))
    return np.round(x * 32767).astype(np.int16)


def echo_pair(n, seed, sr=SR):
    """(near, far): near is local speech plus a delayed, filtered far end."""
    far = speech(n, seed, pitch=210.0, sr=sr)
    echo = np.convolve(far.astype(np.float64), np.r_[np.zeros(40), 0.5, 0.3, -0.2])[:n]
    near = np.clip(0.5 * speech(n, seed + 1, sr=sr) + echo, -32768, 32767).astype(np.int16)
    return near, far


def pairs(rows, n, seed):
    """(near, far) batches of ``rows`` echo pairs, each (rows, n)."""
    ps = [echo_pair(n, seed + 2 * i) for i in range(rows)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def drive(server, clips, cuts):
    """Open a lane per (near, far) clip, push every clip's [a, b) slices in
    turn through ``push_many``, flush each lane; the lanes' outputs."""
    sids = [server.open() for _ in clips]
    outs = {sid: [] for sid in sids}
    for a, b in zip(cuts[:-1], cuts[1:]):
        for sid, out in server.push_many({sid: tuple(x[a:b] for x in c)
                                          for sid, c in zip(sids, clips)}).items():
            outs[sid].append(out)
    for sid in sids:
        outs[sid].append(server.flush(sid))
    return [np.concatenate(outs[sid]) for sid in sids]


def stream_chunks(jstep, tstep, jstate, near, far, chunk):
    """Both stream steps chunk for chunk, each from the JAX package's incoming
    state (so that float32 differences do not compound through the carried
    recurrences): int16 within 1 LSB, the new states within STATE_RTOL."""
    for s in range(0, near.shape[1], chunk):
        tstate, tout = tstep(to_port(jstate), t(near[:, s:s + chunk]), t(far[:, s:s + chunk]))
        jstate, jout = jstep(jstate, jnp.asarray(near[:, s:s + chunk]),
                             jnp.asarray(far[:, s:s + chunk]))
        assert tout.dtype == torch.int16 and lsb(jout, tout) <= 1
        states_close(jstate, tstate, STATE_RTOL)
    return tstate


def write_wav(path, audio, sr=SR):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(audio.astype("<i2").tobytes())


def read_wav(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


# ── fixtures ──────────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def params():
    """(numpy tree, JAX params, the port's CPU tensors), from one draw."""
    pn = T.init_sdaec_numpy(0)
    return pn, jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ── config, init and blocks ────────────────────────────────────────────────


def test_config_and_init_keys_and_shapes(params):
    pn, _, _ = params
    assert dataclasses.asdict(T.SdaecConfig()) == dataclasses.asdict(J.SdaecConfig())
    full = jax.eval_shape(lambda k: J.init_sdaec(k, J.SdaecConfig()), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    assert {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(pn)[0]} == want


@pytest.mark.parametrize("reverse,with_state", [(False, False), (True, False), (False, True)])
def test_lstm_matches_jax(params, reverse, with_state):
    """The mid bottleneck's first layer (20 → 40): output and final (h, c)."""
    pn, pj, pt = params
    lp_j, lp_t = pj["mid_lstm"]["layers"][0], pt["mid_lstm"]["layers"][0]
    x = _rand((3, 7, 20), 1)
    state = (_rand((3, 40), 2), _rand((3, 40), 3)) if with_state else None
    fn = jax.jit(lambda p, v, s: JR.lstm(p, v, s, reverse=reverse, return_state=True))
    ry, (rh, rc) = fn(lp_j, jnp.asarray(x), None if state is None else tuple(map(jnp.asarray,
                                                                                  state)))
    gy, (gh, gc) = TR.lstm(lp_t, t(x), None if state is None else tuple(map(t, state)),
                           reverse=reverse, return_state=True)
    close(gy, ry)
    close(gh, rh)
    close(gc, rc)


def test_iccrn_layer_norm_matches_jax():
    """The unbiased variance over the (F, C) plane, with affine w and b."""
    x = _rand((2, 3, 160, 20), 4, 3.0)
    p = {"w": _rand((160, 20), 5), "b": _rand((160, 20), 6)}
    for eps in (T.LN_EPS, 1e-8):
        close(TC.iccrn_layer_norm({k: t(v) for k, v in p.items()}, t(x), eps),
              jax.jit(lambda q, v: JC.iccrn_layer_norm(q, v, eps))(
                  jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


@pytest.mark.parametrize("with_linear", [True, False])
def test_ch_lstm_f_matches_jax(params, with_linear):
    """The input frequency LSTM (bidirectional over 160 bins, one stacked loop)."""
    _, pj, pt = params
    x = _rand((1, 3, 160, 4), 7)
    ref = jax.jit(lambda p, v: JC.ch_lstm_f(p, v, with_linear=with_linear))(pj["in_lstm"],
                                                                             jnp.asarray(x))
    close(TC.ch_lstm_f(pt["in_lstm"], t(x), with_linear=with_linear), ref)


def test_ch_lstm_t_with_state_matches_jax(params):
    """The two-layer time bottleneck from a carried state: output and both
    layers' new (h, c)."""
    _, pj, pt = params
    x = _rand((2, 5, 160, 20), 8)
    state = [(_rand((320, 40), 9 + 2 * i), _rand((320, 40), 10 + 2 * i)) for i in range(2)]
    ry, rs = jax.jit(lambda p, v, s: JC.ch_lstm_t(p, v, state=s, return_state=True))(
        pj["mid_lstm"], jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    gy, gs = TC.ch_lstm_t(pt["mid_lstm"], t(x), state=[tuple(map(t, s)) for s in state],
                          return_state=True)
    close(gy, ry)
    states_close(rs, gs)


def test_ceps_bases_are_the_jax_packages():
    for a, b in zip(TC._ceps_bases(160), JC._ceps_bases(160)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_ceps_unit_matches_jax(params):
    _, pj, pt = params
    x = _rand((1, 3, 160, 20), 14)
    ref = jax.jit(lambda p, v: JC.ceps_unit(p, v, T.LN_EPS))(pj["enc0"]["ceps"], jnp.asarray(x))
    close(TC.ceps_unit(pt["enc0"]["ceps"], t(x), T.LN_EPS), ref)


def test_cfb_matches_jax(params):
    """A decoder CFB (2C in, C out): the gate, the (1, 3) frequency conv and
    the cepstral unit."""
    _, pj, pt = params
    x = _rand((1, 3, 160, 40), 15)
    ref = jax.jit(lambda p, v: JC.cfb(p, v, T.LN_EPS))(pj["dec1"], jnp.asarray(x))
    close(TC.cfb(pt["dec1"], t(x), T.LN_EPS), ref)


def test_alpha_align_with_cache_matches_jax(params, monkeypatch):
    """|alpha| and the new cache, from zeros and from a carried cache; the
    conv has one group, so it reaches neither B4's nor B5's route."""
    _, pj, pt = params

    def refuse(*a, **kw):
        raise AssertionError("a one-group conv reached a depthwise kernel's route")

    monkeypatch.setattr(tcore, "fast_dwconv1d", refuse)
    monkeypatch.setattr(tcore, "fast_dwconv1d_grouped", refuse)
    dwconv_cuda.reset_launches()  # earlier tests in this worker may have counted
    mix, far = np.abs(_rand((2, 6), 16, 50.0)), np.abs(_rand((2, 6), 17, 50.0))
    for cache in (None, np.abs(_rand((2, 9, 2), 18, 50.0))):
        ra, rc = J.alpha_align(pj["alpha"], jnp.asarray(mix), jnp.asarray(far), 10,
                               None if cache is None else jnp.asarray(cache),
                               return_cache=True)
        ga, gc = T.alpha_align(pt["alpha"], t(mix), t(far), 10,
                               None if cache is None else t(cache), return_cache=True)
        close(ga, ra)
        close(gc, rc)
    assert not any(dwconv_cuda.launches.values())


# ── forward, Session ───────────────────────────────────────────────────────


def test_forward_matches_jax(params):
    """Two 0.5 s (near, far) rows with an echo path: within 1 LSB."""
    _, pj, pt = params
    near, far = pairs(2, 8000, 30)
    ref = jax.jit(lambda p, a, b: J.sdaec_forward(p, a, b, J.SdaecConfig()))(
        pj, jnp.asarray(near), jnp.asarray(far))
    got = T.sdaec_forward(pt, t(near), t(far), T.SdaecConfig())
    assert got.dtype == torch.int16 and tuple(got.shape) == near.shape
    assert lsb(ref, got) <= 1


@pytest.mark.parametrize("rate", [16000, 48000])
def test_session_matches_jax(params, rate):
    """``Session.process(near, far)`` on a 1 s pair (one 10 s window) against
    the JAX Session, within 1 LSB; at 48 kHz in and out the forward resamples
    in the graph (``resample_linear``) on both sides of the 16 kHz model."""
    _, pj, pt = params
    near, far = (speech(rate, 31, sr=rate), speech(rate, 32, pitch=210.0, sr=rate))
    jspec, tspec = jregistry.get("sdaec"), tregistry.get("sdaec")
    kw = dict(in_sample_rate=rate, out_sample_rate=rate)
    jcfg, tcfg = jspec.make_config(**kw), tspec.make_config(**kw)
    manifest = tspec.make_manifest(tcfg)
    assert manifest.num_audio_inputs == 2 and manifest.task == "aec"
    assert manifest.input_audio_length == 160000 * rate // 16000
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(near, far)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(near, far)
    assert out.audio.dtype == np.int16 and out.audio.shape == near.shape
    assert lsb(ref.audio, out.audio) <= 1


# ── streaming ──────────────────────────────────────────────────────────────


def test_stream_step_matches_jax(params):
    """Four chunks of 4 hops, two lanes of (near, far), each step from the
    same incoming state: int16 within 1 LSB, every new state leaf within
    STATE_RTOL × max|ref| (the fresh states equal)."""
    _, pj, pt = params
    jcfg, tcfg = J.SdaecConfig(), T.SdaecConfig()
    jstep = jax.jit(lambda s, n, f: J.sdaec_stream_step(pj, s, n, f, jcfg))
    near, far = pairs(2, 16 * 160, 34)
    states_close(J.sdaec_stream_init(jcfg, batch=2),
                 T.sdaec_stream_init(tcfg, batch=2, device="cpu"), 0.0)
    tstate = stream_chunks(jstep, lambda s, n, f: T.sdaec_stream_step(pt, s, n, f, tcfg),
                           J.sdaec_stream_init(jcfg, batch=2), near, far, 640)
    with pytest.raises(ValueError, match="multiple of hop"):
        T.sdaec_stream_step(pt, tstate, torch.zeros((2, 100), dtype=torch.int16),
                            torch.zeros((2, 100), dtype=torch.int16), tcfg)
    with pytest.raises(ValueError, match="model rate only"):
        T.sdaec_stream_init(T.SdaecConfig(in_sample_rate=48000), device="cpu")


def zero_mean(rng, n, scale=6000):
    x = rng.standard_normal(n) * scale
    x = np.round(x - x.mean()).astype(np.int16)
    x[0] -= np.int16(x.sum())
    return x


def test_stream_matches_offline_at_its_delay(params):
    """Port of ``tests/test_sdaec_deep_echo.py:114``: the constant centre pad
    is the stream's zero prefix, so on zero-mean inputs the stream is the
    default offline path delayed by n_fft − hop, within 1 LSB."""
    _, _, pt = params
    cfg = T.SdaecConfig()
    rng = np.random.default_rng(1)
    total = 16 * cfg.hop
    near, far = zero_mean(rng, total), zero_mean(rng, total)
    offline = T.sdaec_forward(pt, t(near[None]), t(far[None]), cfg).numpy()[0]
    state, outs = T.sdaec_stream_init(cfg, device="cpu"), []
    for s in range(0, total, 4 * cfg.hop):
        state, out = T.sdaec_stream_step(pt, state, t(near[None, s:s + 4 * cfg.hop]),
                                         t(far[None, s:s + 4 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    streamed = np.concatenate(outs)
    delay = cfg.n_fft - cfg.hop
    lo, hi = cfg.n_fft, total - cfg.n_fft - delay
    assert lsb(offline[lo:hi], streamed[lo + delay:hi + delay]) <= 1


def test_server_matches_jax_server(params):
    """Three lanes of (near, far), irregular pushes through ``push_many``,
    block_hops 2: the port's server (jit=False) and the JAX package's
    (jit=True) within 1 LSB; the lane-axis inference holds."""
    _, pj, pt = params
    jspec, tspec = jregistry.get("sdaec"), tregistry.get("sdaec")
    jcfg, tcfg = jspec.make_config(), tspec.make_config()
    n = 9 * 160 + 77
    clips = [echo_pair(n, 40 + 2 * i) for i in range(3)]
    cuts = [0, 300, 1000, 1000 + 2 * 160 + 5, n]
    ref = drive(JServer(jspec, pj, jcfg, max_streams=3, block_hops=2, jit=True), clips, cuts)
    srv = StreamingServer(tspec, pt, tcfg, max_streams=3, block_hops=2, jit=False,
                          device="cpu")
    got = drive(srv, clips, cuts)
    for r, g in zip(ref, got):
        assert g.dtype == np.int16 and g.shape == r.shape == (n,)
        assert lsb(r, g) <= 1
    assert srv.latency_samples == 2 * 160 + 159
    srv.verify_lane_isolation()


# ── kernel routes and the CLI ──────────────────────────────────────────────


def test_kernel_routes(params, monkeypatch):
    """The offline forward reaches B1 once (near‖far stacked) and B2 once
    with the exact out_length; the stream step B1 once over near‖far of its
    lanes, uncentred, and no B2 (its synthesis is ``stream_istft``)."""
    calls = {"b1": [], "b2": []}

    def b1(x, cfg):
        calls["b1"].append((tuple(x.shape), cfg.center))
        return stft(x, cfg)

    def b2(spec, cfg, out_length=None):
        calls["b2"].append((tuple(spec.shape), out_length))
        return istft(spec, cfg, out_length)

    stft, istft = T.fast_stft_packed, T.fast_istft_packed
    monkeypatch.setattr(T, "fast_stft_packed", b1)
    monkeypatch.setattr(T, "fast_istft_packed", b2)
    _, _, pt = params
    near, far = pairs(2, 1000, 44)
    T.sdaec_forward(pt, t(near), t(far))
    assert calls == {"b1": [((4, 1120), True)], "b2": [((2, 7, 320), 1120)]}
    T.sdaec_stream_step(pt, T.sdaec_stream_init(batch=3, device="cpu"),
                        t(np.zeros((3, 640), np.int16)), t(np.zeros((3, 640), np.int16)))
    assert calls["b1"][1:] == [((6, 799), False)] and len(calls["b2"]) == 1


def test_cli_two_inputs_offline_and_stream(tmp_path, capsys):
    """``--input near.wav far.wav``: the offline answer is the library's
    Session on the same seed's parameters; ``--stream`` writes as many
    samples as it read; one input is refused with the model's count."""
    near, far = echo_pair(SR // 2, 46)
    paths = [tmp_path / "near.wav", tmp_path / "far.wav"]
    for p, a in zip(paths, (near, far)):
        write_wav(p, a)
    dst, sdst = tmp_path / "out.wav", tmp_path / "stream.wav"
    base = ["--model", "sdaec", "--device", "cpu", "--seed", "2"]
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(dst)]) == 0
    spec = tregistry.get("sdaec")
    cfg = spec.make_config()
    want = TSession(spec.make_module(spec.init_params(2, cfg, "cpu"), cfg),
                    spec.make_manifest(cfg), device="cpu").process(near, far).audio
    np.testing.assert_array_equal(read_wav(dst), want)
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(sdst), "--stream",
                     "--block-hops", "2"]) == 0
    assert read_wav(sdst).shape == near.shape and np.any(read_wav(sdst))
    assert "algorithmic latency 479 samples" in capsys.readouterr().out
    assert cli.main([*base, "--input", str(paths[0])]) == 2
    assert "sdaec needs 2 input wav(s), got 1" in capsys.readouterr().err
