"""NKF-AEC in the port against audiojax.models.nkf_aec, on the CPU.

NKF is small, so it runs at its defaults (1024/256 hann, L = 4, fc/rnn 18) on
the port's numpy draw (``init_nkf_numpy``, the keys and shapes of JAX's
``init_nkf``), given to JAX as arrays and to the port by
``params_from_numpy``.  That draw scales the last KGNet layer by
``RANDOM_GAIN_SCALE``: with JAX's unscaled draw the Kalman gain is expansive,
the echo estimate overflows float32 within tens of frames, and two float32
implementations part (8e-6 × max|ref| at 8 frames, 0.03 at 32, NaN at 126,
measured on unit-level spectra), so no gate could hold.  The long-T check
uses the JAX tests' tiny geometry (64/16) and their damping (0.05) against an
unrolled float64 numpy scan.

Gates: ``gru_cell``, ``kg_net`` and ``nkf_scan`` (echo and carried state, at
≤ 32 frames; 300 frames at 64/16) within 1e-5 × max|ref|; the int16 forward,
``Session.process(near, far)`` and the stream step chunk for chunk within
1 LSB, the stream states within 1e-5 × max|ref|.  Then the JAX package's
contracts (``tests/test_nkf_aec.py``): a zero far end passes the microphone
through, the folded forward, and the stream equal to the one-hop-prefixed
offline path; and the CLI's two inputs.
"""
import dataclasses
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import nkf_aec as J
from audiojax.nn import rnn as JR
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from test_torch_ckpt_builders import flat_tree, one_thread  # noqa: F401  (autouse)

from audiojax_torch.models import nkf_aec as T
from audiojax_torch.nn import rnn as TR
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

RTOL = 1e-5
SR = 16000


@pytest.fixture(scope="module")
def params():
    """(numpy tree, JAX params, the port's CPU tensors), from one draw."""
    pn = T.init_nkf_numpy(0)
    return pn, jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rtol * max(np.abs(ref).max(), 1e-30), rtol=0)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _t(x):
    return torch.from_numpy(x)


def _speech(n, seed, pitch=150.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.25 * np.sin(2 * np.pi * pitch * t) * np.sin(2 * np.pi * 3 * t) ** 2
         + 0.05 * rng.standard_normal(n))
    return np.round(x * 32767).astype(np.int16)


def _pair(n, seed):
    """(near, far): near is local speech plus a delayed, filtered far end."""
    far = _speech(n, seed, pitch=210.0)
    echo = np.convolve(far.astype(np.float64), np.r_[np.zeros(40), 0.5, 0.3, -0.2])[:n]
    near = np.clip(0.5 * _speech(n, seed + 1) + echo, -32768, 32767).astype(np.int16)
    return near, far


def _spectra(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_and_init_keys_and_shapes(params):
    pn, _, pt = params
    assert dataclasses.asdict(T.NkfConfig()) == dataclasses.asdict(J.NkfConfig())
    full = jax.eval_shape(lambda k: J.init_nkf(k, J.NkfConfig()), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    assert {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(pn)[0]} == want
    assert pt["fc_in_slope"].shape == () and pt["fc_mid_slope"].shape == ()  # 0-d leaves
    lim = np.sqrt(6.0 / (18 + 4)) * T.RANDOM_GAIN_SCALE
    assert np.abs(pn["fc_out"]["r"]["w"]).max() <= lim


def test_gru_cell_matches_jax(params):
    _, pj, pt = params
    x, h = _spectra((7, 18), 1), _spectra((7, 18), 2)
    _close(TR.gru_cell(pt["gru_r"], _t(x), _t(h)),
           JR.gru_cell(pj["gru_r"], jnp.asarray(x), jnp.asarray(h)))


def test_kg_net_matches_jax(params):
    """One KGNet step on 5 bins from non-zero GRU states: the gain and all four states."""
    _, pj, pt = params
    x = _spectra((5, 9, 2), 3)
    grus = [_spectra((5, 18), 4 + i) for i in range(4)]
    rk, rg = J.kg_net(pj, jnp.asarray(x), tuple(jnp.asarray(g) for g in grus))
    gk, gg = T.kg_net(pt, _t(x), tuple(_t(g) for g in grus))
    _close(gk, rk)
    for g, r in zip(gg, rg):
        _close(g, r)


@pytest.mark.parametrize("frames", [1, 32])
def test_scan_matches_jax(params, frames):
    """The echo, and with a carried state the new state, at ≤ 32 frames."""
    _, pj, pt = params
    cfg = J.NkfConfig()
    ref, mic = (_spectra((2, frames, cfg.f_bins, 2), s) for s in (8, 9))
    want = J.nkf_scan(pj, jnp.asarray(ref), jnp.asarray(mic), cfg)
    _close(T.nkf_scan(pt, _t(ref), _t(mic), T.NkfConfig()), want)

    jstate = J.nkf_stream_init(cfg, batch=2)
    tstate = T.nkf_stream_init(T.NkfConfig(), batch=2, device="cpu")
    jecho, jk = J.nkf_scan(pj, jnp.asarray(ref), jnp.asarray(mic), cfg, state=jstate["kalman"])
    techo, tk = T.nkf_scan(pt, _t(ref), _t(mic), T.NkfConfig(), state=tstate["kalman"])
    _close(techo, jecho)
    jf, tf = flat_tree(jax.tree.map(np.asarray, jk)), flat_tree(tk)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        _close(tf[k], jf[k])


def _f64_scan(p, ref, mic, order):
    """The Kalman recurrence unrolled in float64 numpy (``tests/test_nkf_aec.py:19``'s
    loop, on numpy arrays): an independent reference for long T."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)

    def dense(q, x):
        return x @ q["w"] + q["b"]

    def cdense(q, x):
        return np.stack([dense(q["r"], x[..., 0]), dense(q["i"], x[..., 1])], axis=-1)

    def cell(q, x, h):
        xt, gh = x @ q["w_i"] + q["b_i"], h @ q["w_h"] + q["b_h"]
        n_h = h.shape[-1]
        sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
        r = sig(xt[:, :n_h] + gh[:, :n_h])
        z = sig(xt[:, n_h:2 * n_h] + gh[:, n_h:2 * n_h])
        return (1.0 - z) * np.tanh(xt[:, 2 * n_h:] + r * gh[:, 2 * n_h:]) + z * h

    def cdot(a, b):
        return np.stack([np.sum(a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1], -1),
                         np.sum(a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0], -1)], -1)

    def cmul(a, b):
        return np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                         a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)

    leaky = lambda x, s: np.where(x >= 0, x, s * x)  # noqa: E731
    b, n_t, f, _ = ref.shape
    n = b * f
    padded = np.pad(ref.astype(np.float64), [(0, 0), (order - 1, 0), (0, 0), (0, 0)])
    h_prior = h_post = np.zeros((b, f, order, 2))
    g = [np.zeros((n, p["gru_r"]["w_h"].shape[0])) for _ in range(4)]
    echoes = []
    for t in range(n_t):
        xt = np.stack([padded[:, t + k] for k in range(order)], axis=-2)
        dh = h_post - h_prior
        h_prior, h_post = h_post, h_prior
        e = mic[:, t] - cdot(xt, h_prior)
        x = leaky(cdense(p["fc_in"], np.concatenate([xt, e[..., None, :], dh], -2)
                         .reshape(n, 2 * order + 1, 2)), p["fc_in_slope"])
        both = np.concatenate([x[..., 0], x[..., 1]])
        o_r = cell(p["gru_r"], both, np.concatenate([g[0], g[1]]))
        o_i = cell(p["gru_i"], both, np.concatenate([g[2], g[3]]))
        g = [o_r[:n], o_r[n:], o_i[:n], o_i[n:]]
        y = leaky(cdense(p["fc_mid"], np.stack([g[0] - g[3], g[2] + g[1]], -1)),
                  p["fc_mid_slope"])
        h_post = h_prior + cmul(cdense(p["fc_out"], y).reshape(b, f, order, 2), e[..., None, :])
        echoes.append(cdot(xt, h_post))
    return np.stack(echoes, axis=1)


def test_scan_long_t_matches_jax_and_float64():
    """300 frames at the JAX tests' 64/16 geometry with their 0.05 damping: the
    port and the JAX package each within 1e-5 × max|ref| of the float64
    unroll, and of each other; the gap does not widen with T."""
    jcfg, tcfg = J.NkfConfig(n_fft=64, hop=16), T.NkfConfig(n_fft=64, hop=16)
    pj = J.init_nkf(jax.random.PRNGKey(0), jcfg)
    pj["fc_out"] = jax.tree.map(lambda a: a * 0.05, pj["fc_out"])
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    ref, mic = (_spectra((1, 300, jcfg.f_bins, 2), s) for s in (10, 11))
    want64 = _f64_scan(pj, ref, mic, jcfg.filter_order)
    got = T.nkf_scan(pt, _t(ref), _t(mic), tcfg)
    jax_out = jax.jit(lambda p, a, b: J.nkf_scan(p, a, b, jcfg))(pj, jnp.asarray(ref),
                                                               jnp.asarray(mic))
    _close(got, want64)
    _close(np.asarray(jax_out), want64)
    _close(got, jax_out)


def test_forward_matches_jax(params):
    """A 2 s (near, far) pair with an echo path, two rows: within 1 LSB."""
    _, pj, pt = params
    pairs = [_pair(32000, 12), _pair(32000, 14)]
    near, far = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    ref = jax.jit(lambda p, f, n: J.nkf_forward(p, f, n, J.NkfConfig()))(
        pj, jnp.asarray(far), jnp.asarray(near))
    got = T.nkf_forward(pt, _t(far), _t(near), T.NkfConfig())
    assert got.dtype == torch.int16 and tuple(got.shape) == near.shape
    assert _lsb(ref, got) <= 1


def test_forward_fold_matches_jax(params):
    """Port of ``tests/test_nkf_aec.py:75``: fold windows of 4096, each demeaned
    after the fold, a 10,000-sample pair; within 1 LSB of JAX."""
    _, pj, pt = params
    rng = np.random.default_rng(2)
    far, near = ((rng.standard_normal(10000) * 5000).astype(np.int16)[None] for _ in range(2))
    ref = jax.jit(lambda p, f, n: J.nkf_forward(p, f, n, J.NkfConfig(fold_window=4096)))(
        pj, jnp.asarray(far), jnp.asarray(near))
    got = T.nkf_forward(pt, _t(far), _t(near), T.NkfConfig(fold_window=4096))
    assert tuple(got.shape) == (1, 10000) and got.dtype == torch.int16
    assert _lsb(ref, got) <= 1


def test_zero_far_end_passes_mic_through():
    """Port of ``tests/test_nkf_aec.py:59``: x_t = 0 ⇒ echo = 0 ⇒ the output is
    ISTFT(STFT(near)), > 40 dB against the (demeaned) near end, whatever the
    weights (here the JAX package's unscaled draw)."""
    pt = params_from_numpy(jax.tree.map(np.asarray, J.init_nkf(jax.random.PRNGKey(1))),
                           device="cpu")
    rng = np.random.default_rng(1)
    near = (rng.standard_normal(8192) * 8000).astype(np.int16)
    near = near - np.int16(round(near.astype(np.float64).mean()))
    out = T.nkf_forward(pt, torch.zeros((1, 8192), dtype=torch.int16), _t(near[None]),
                        T.NkfConfig()).numpy()[0]
    s, e = 1024, 8192 - 1024
    ref = near[s:e].astype(np.float64)
    err = out[s:e].astype(np.float64) - ref
    assert 10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-9)) > 40


def test_session_matches_jax_near_then_far(params):
    """``Session.process(near, far)`` (a 3 s pair, 2 windows), the module
    taking (near, far) and ``nkf_forward`` (far, near): within 1 LSB of the
    JAX Session; swapping the inputs changes the answer."""
    _, pj, pt = params
    near, far = _pair(3 * SR, 16)
    jspec, tspec = jregistry.get("nkf_aec"), tregistry.get("nkf_aec")
    cfg = tspec.make_config()
    manifest = tspec.make_manifest(cfg)
    assert manifest.num_audio_inputs == 2 and manifest.task == "aec"
    assert manifest.runtime_config() == jspec.make_manifest(jspec.make_config()).runtime_config()
    ref = JSession(jspec.make_forward(jspec.make_config()), pj,
                   jspec.make_manifest(jspec.make_config())).process(near, far)
    session = TSession(tspec.make_module(pt, cfg), manifest, device="cpu")
    out = session.process(near, far)
    assert out.audio.dtype == np.int16 and out.audio.shape == near.shape
    assert _lsb(ref.audio, out.audio) <= 1
    assert _lsb(session.process(far, near).audio, out.audio) > 100
    with pytest.raises(ValueError, match="expects 2 audio inputs"):
        session.process(near)


def test_stream_step_matches_jax(params):
    """4 chunks of 4 hops, two lanes of (near, far): int16 within 1 LSB and
    every state leaf within 1e-5 × max|ref|, chunk for chunk."""
    _, pj, pt = params
    jcfg, tcfg = J.NkfConfig(), T.NkfConfig()
    step = jax.jit(lambda p, s, n, f: J.nkf_stream_step(p, s, n, f, jcfg))
    pairs = [_pair(16 * 256, 18), _pair(16 * 256, 20)]
    near, far = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    jstate = J.nkf_stream_init(jcfg, batch=2)
    tstate = T.nkf_stream_init(tcfg, batch=2, device="cpu")
    for s in range(0, near.shape[1], 1024):
        jstate, jout = step(pj, jstate, jnp.asarray(near[:, s:s + 1024]),
                            jnp.asarray(far[:, s:s + 1024]))
        tstate, tout = T.nkf_stream_step(pt, tstate, _t(near[:, s:s + 1024]),
                                         _t(far[:, s:s + 1024]), tcfg)
        assert tout.dtype == torch.int16 and _lsb(jout, tout) <= 1
        jf, tf = flat_tree(jax.tree.map(np.asarray, jstate)), flat_tree(tstate)
        assert sorted(jf) == sorted(tf)
        for k in jf:
            _close(tf[k], jf[k])
    with pytest.raises(ValueError, match="multiple of hop"):
        T.nkf_stream_step(pt, tstate, torch.zeros((2, 100), dtype=torch.int16),
                          torch.zeros((2, 100), dtype=torch.int16), tcfg)


def test_stream_matches_prefixed_offline(params):
    """Port of ``tests/test_nkf_aec.py:86``: against the offline path on a
    one-hop-zero-prefixed pair the stream matches with a two-hop delay, within
    1 LSB (zero-mean inputs, so the offline demeaning is the identity)."""
    _, _, pt = params
    cfg = T.NkfConfig()
    rng = np.random.default_rng(5)
    total = 16 * cfg.hop

    def zmean(x):
        x = np.round(x - x.mean()).astype(np.int16)
        x[0] -= np.int16(x.sum())
        return x

    near, far = zmean(rng.standard_normal(total) * 6000), zmean(rng.standard_normal(total) * 6000)
    zp = np.zeros(cfg.hop, np.int16)
    prefixed = T.nkf_forward(pt, _t(np.concatenate([zp, far])[None]),
                             _t(np.concatenate([zp, near])[None]), cfg).numpy()[0]
    state, outs = T.nkf_stream_init(cfg, device="cpu"), []
    for s in range(0, total, 4 * cfg.hop):
        state, out = T.nkf_stream_step(pt, state, _t(near[None, s:s + 4 * cfg.hop]),
                                       _t(far[None, s:s + 4 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    streamed = np.concatenate(outs)
    delay = 2 * cfg.hop
    lo, hi = cfg.n_fft, total - cfg.n_fft - delay
    assert _lsb(prefixed[lo:hi], streamed[lo + delay:hi + delay]) <= 1


def test_kernel_routes(params, monkeypatch):
    """The offline forward reaches B1 once (far‖near stacked) and B2 once; the
    stream step B1 once (near‖far over the stacked 2·lanes rows)."""
    from audiojax_torch.models import nkf_aec as model_mod

    calls = {"b1": [], "b2": 0}

    def b1(x, cfg):
        calls["b1"].append(tuple(x.shape))
        return stft(x, cfg)

    def b2(*a, **kw):
        calls["b2"] += 1
        return istft(*a, **kw)

    stft, istft = model_mod.fast_stft_packed, model_mod.fast_istft_packed
    monkeypatch.setattr(model_mod, "fast_stft_packed", b1)
    monkeypatch.setattr(model_mod, "fast_istft_packed", b2)
    _, _, pt = params
    near, far = _pair(4096, 22)
    T.nkf_forward(pt, _t(np.stack([far, far])), _t(np.stack([near, near])), T.NkfConfig())
    assert calls == {"b1": [(4, 4096)], "b2": 1}
    T.nkf_stream_step(pt, T.nkf_stream_init(batch=3, device="cpu"),
                      _t(np.zeros((3, 1024), np.int16)), _t(np.zeros((3, 1024), np.int16)))
    assert calls == {"b1": [(4, 4096), (6, 1792)], "b2": 1}


def _write_wav(path, audio):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(audio.astype("<i2").tobytes())


def _read_wav(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def test_cli_two_inputs_offline_and_stream(tmp_path, capsys):
    """``--input near.wav far.wav``: the offline answer is the library's
    Session on the same seed's parameters; ``--stream`` writes as many samples
    as it read; one input is refused with the model's count."""
    near, far = _pair(SR, 24)
    paths = [tmp_path / "near.wav", tmp_path / "far.wav"]
    for p, a in zip(paths, (near, far)):
        _write_wav(p, a)
    dst, sdst = tmp_path / "out.wav", tmp_path / "stream.wav"
    base = ["--model", "nkf_aec", "--device", "cpu", "--seed", "2"]
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(dst)]) == 0
    spec = tregistry.get("nkf_aec")
    cfg = spec.make_config()
    want = TSession(spec.make_module(spec.init_params(2, cfg, "cpu"), cfg),
                    spec.make_manifest(cfg), device="cpu").process(near, far).audio
    np.testing.assert_array_equal(_read_wav(dst), want)
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(sdst), "--stream",
                     "--block-hops", "2"]) == 0
    assert _read_wav(sdst).shape == near.shape and np.any(_read_wav(sdst))
    assert "algorithmic latency 1280 samples" in capsys.readouterr().out
    assert cli.main([*base, "--input", str(paths[0])]) == 2
    assert "nkf_aec needs 2 input wav(s), got 1" in capsys.readouterr().err
