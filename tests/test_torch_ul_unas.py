"""UL-UNAS in the port against audiojax.models.ul_unas, on the CPU.

UL-UNAS has a fixed NAS plan, so it runs at its default (full) size, on the
port's numpy draw (``init_ul_unas_numpy(0)``, the keys and shapes of JAX's
``init_ul_unas``), given to JAX as arrays and to the port by
``params_from_numpy``, with clips of at most 0.5 s.  The same seeded
numpy inputs go through both packages; the port takes its kernels' plain
versions (B1/B2 on the card).

Gates: ``gru_bidir``, ``freq_attention``, ``ctfa``, the three block types
(encoder and decoder, offline and cached), ``dpgrnn``, the ERB bank given as
``weight`` and the network within 1e-5 × max|ref|; the int16 forward,
``Session.process`` and the stream step chunk for chunk within 1 LSB, the
carried states within 1e-5 × max|ref|.  Then the JAX package's contracts
(``tests/test_ul_unas.py``): the channel shuffle, temporal causality, and the
stream equal to the zero-prefixed offline path.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import ul_unas as J
from audiojax.nn import erb as JE
from audiojax.nn import rnn as JR
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from test_torch_ckpt_builders import flat_tree, one_thread  # noqa: F401

from audiojax_torch.models import gtcrn as TG
from audiojax_torch.models import ul_unas as T
from audiojax_torch.nn import erb as TE
from audiojax_torch.nn import rnn as TR
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

RTOL = 1e-5
HOP = 256


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's CPU tensors), from one numpy draw."""
    pn = T.init_ul_unas_numpy(0)
    return jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rtol * max(np.abs(ref).max(), 1e-30), rtol=0)


def _states_close(jstate, tstate):
    jf, tf = flat_tree(jstate), flat_tree(tstate)
    assert sorted(jf) == sorted(tf)
    for k, a in jf.items():
        assert tf[k].shape == a.shape, k
        if a.size:
            _close(tf[k], a)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _audio(shape, seed, scale=6000.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.int16)


def _feature_map(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(x)


def test_config_and_init_keys_and_shapes():
    assert dataclasses.asdict(T.UlUnasConfig()) == dataclasses.asdict(J.UlUnasConfig())
    assert T._SPECS == tuple(zip(J._TYPES, J._CHANNELS, J._WIDTHS, J._KERNELS, J._STRIDES,
                                 J._GROUPS))
    full = jax.eval_shape(lambda k: J.init_ul_unas(k, J.UlUnasConfig()), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
    got = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
           jax.tree_util.tree_flatten_with_path(T.init_ul_unas_numpy(0))[0]}
    assert got == want
    assert "erb" not in T.init_ul_unas(0, device="cpu")  # the analytic bank serves


def test_shuffle_interleaves():
    """Port of ``tests/test_ul_unas.py:16``."""
    y = T.shuffle_channels(torch.arange(8, dtype=torch.float32)[None, None, None, :])
    np.testing.assert_array_equal(y[0, 0, 0].numpy(), [0, 4, 1, 5, 2, 6, 3, 7])


def test_gru_bidir_matches_jax(params):
    """[fwd ‖ bwd] and the states (fwd after the last step, bwd after the first)."""
    pj, pt = params
    fa_j, fa_t = pj["enc0"]["ctfa"]["fa"], pt["enc0"]["ctfa"]["fa"]
    x = _feature_map((6, 17, 4), 1)
    ref, (rf, rb) = JR.gru_bidir(fa_j["fwd"], fa_j["bwd"], jnp.asarray(x), return_state=True)
    got, (gf, gb) = TR.gru_bidir(fa_t["fwd"], fa_t["bwd"], _t(x), return_state=True)
    for g, r in ((got, ref), (gf, rf), (gb, rb)):
        _close(g, r)
    _close(TR.gru_bidir(fa_t["fwd"], fa_t["bwd"], _t(x)), ref)


def test_freq_attention_and_ctfa_match_jax(params):
    """Widths 65 (a padded last super-band) and 129; cTFA with a carried state."""
    pj, pt = params
    for block, width, ch in (("enc0", 65, 12), ("dec4", 129, 1)):
        x = _feature_map((2, 5, width, ch), 2)
        p_j, p_t = pj[block]["ctfa"], pt[block]["ctfa"]
        _close(T.freq_attention(p_t["fa"], _t(x * x), 4), J.freq_attention(p_j["fa"],
                                                                          jnp.asarray(x * x), 4))
        h = _feature_map((2, 2 * ch), 3)
        ry, rh = J.ctfa(p_j, jnp.asarray(x), 4, jnp.asarray(h), return_state=True)
        gy, gh = T.ctfa(p_t, _t(x), 4, _t(h), return_state=True)
        _close(gy, ry)
        _close(gh, rh)


# (block, spec index, input shape (B, T, W, C), decoder)
BLOCKS = [("enc0", 0, (2, 6, 129, 1), False), ("enc1", 1, (2, 6, 65, 12), False),
          ("enc2", 2, (2, 6, 33, 24), False), ("enc3", 3, (2, 6, 33, 24), False),
          ("dec1", 3, (2, 6, 33, 32), True), ("dec2", 2, (2, 6, 33, 24), True),
          ("dec3", 1, (2, 6, 33, 24), True), ("dec4", 0, (2, 6, 65, 12), True)]


@pytest.mark.parametrize("name,i,shape,deconv", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_blocks_match_jax(params, name, i, shape, deconv):
    """Each of the three block types, offline and with a cache (kt − 1 frames;
    zero for the kt = 1 blocks), encoder and decoder."""
    pj, pt = params
    spec = T._SPECS[i]
    jfn, tfn = J._BLOCK_FNS[spec[0]], T._BLOCK_FNS[spec[0]]
    kw = {"deconv": deconv, "last": name == "dec4"}
    x = _feature_map(shape, 4)
    jcfg, tcfg = J.UlUnasConfig(), T.UlUnasConfig()
    ref = jax.jit(lambda p, x: jfn(p, x, spec, jcfg, **kw))(pj[name], jnp.asarray(x))
    _close(tfn(pt[name], _t(x), spec, tcfg, **kw), ref)

    enc_plan, dec_plan = T._stream_plan(tcfg)
    kt, width, cache_ch, out_ch = (dec_plan[int(name[3:])] if deconv
                                   else enc_plan[int(name[3:])])
    state = {"cache": _feature_map((2, kt - 1, width, cache_ch), 5),
             "ta": _feature_map((2, 2 * out_ch), 6)}
    ry, rs = jax.jit(lambda p, x, st: jfn(p, x, spec, jcfg, state=st, **kw))(
        pj[name], jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    gy, gs = tfn(pt[name], _t(x), spec, tcfg, state={k: _t(v) for k, v in state.items()}, **kw)
    _close(gy, ry)
    _states_close(jax.tree.map(np.asarray, rs), gs)


def test_dpgrnn_matches_jax(params):
    """UL-UNAS's dual-path block (the port runs GTCRN's ``dpgrnn``) with a
    carried inter-GRU state (2, B·33, 8)."""
    pj, pt = params
    x = _feature_map((2, 5, 33, 16), 7)
    h = _feature_map((2, 2 * 33, 8), 8)
    ry, rh = J.dpgrnn(pj["dp1"], jnp.asarray(x), 16, jnp.asarray(h), return_state=True)
    gy, gh = TG.dpgrnn(pt["dp1"], _t(x), width=33, hidden=16, state=_t(h), return_state=True)
    _close(gy, ry)
    _close(gh, rh)
    _close(TG.dpgrnn(pt["dp2"], _t(x), width=33, hidden=16),
           J.dpgrnn(pj["dp2"], jnp.asarray(x), 16))


def test_erb_weight_matches_jax():
    """An imported bank given as ``weight`` (fc (F_high, n_erb), ifc (n_erb,
    F_high)) in place of the analytic one."""
    rng = np.random.default_rng(9)
    fc, ifc = (rng.random((192, 64)).astype(np.float32), rng.random((64, 192)).astype(np.float32))
    x = _feature_map((2, 3, 257, 1), 10)
    ref = JE.erb_compress(jnp.asarray(x), 65, 64, 512, weight=jnp.asarray(fc))
    got = TE.erb_compress(_t(x), 65, 64, 512, weight=_t(fc))
    _close(got, ref)
    _close(TE.erb_expand(got, 65, 64, 512, weight=_t(ifc)),
           JE.erb_expand(ref, 65, 64, 512, weight=jnp.asarray(ifc)))


def test_net_matches_jax(params):
    pj, pt = params
    spec = _feature_map((1, 13, 514), 11)
    ref = jax.jit(lambda p, s: J.ul_unas_net(p, s, J.UlUnasConfig()))(pj, jnp.asarray(spec))
    _close(T.ul_unas_net(pt, _t(spec), T.UlUnasConfig()), ref)


def test_net_with_imported_erb_bank_matches_jax(params):
    pj, pt = params
    rng = np.random.default_rng(12)
    erb = {"fc": rng.random((192, 64)).astype(np.float32) * 0.1,
           "ifc": rng.random((64, 192)).astype(np.float32)}
    spec = _feature_map((1, 7, 514), 13)
    ref = jax.jit(lambda p, s: J.ul_unas_net(p, s, J.UlUnasConfig()))(
        {**pj, "erb": jax.tree.map(jnp.asarray, erb)}, jnp.asarray(spec))
    got = T.ul_unas_net({**pt, "erb": {k: _t(v) for k, v in erb.items()}}, _t(spec),
                        T.UlUnasConfig())
    _close(got, ref)


@pytest.mark.parametrize("length", [8000, 7777])
def test_forward_matches_jax(params, length):
    """0.5 s and a length off the hop grid, two rows: int16 within 1 LSB."""
    pj, pt = params
    audio = _audio((2, length), 14)
    ref = jax.jit(lambda p, a: J.ul_unas_forward(p, a, J.UlUnasConfig()))(pj, jnp.asarray(audio))
    got = T.ul_unas_forward(pt, _t(audio), T.UlUnasConfig())
    assert got.dtype == torch.int16 and tuple(got.shape) == audio.shape and bool(got.any())
    assert _lsb(ref, got) <= 1


def test_session_matches_jax(params):
    """0.5 s through the manifest's 2 s window (one window, zero tail)."""
    pj, pt = params
    clip = _audio(8000, 15)
    jspec, tspec = jregistry.get("ul_unas"), tregistry.get("ul_unas")
    cfg = tspec.make_config()
    manifest = tspec.make_manifest(cfg)
    assert manifest.runtime_config() == jspec.make_manifest(jspec.make_config()).runtime_config()
    ref = JSession(jspec.make_forward(jspec.make_config()), pj,
                   jspec.make_manifest(jspec.make_config())).process(clip)
    out = TSession(tspec.make_module(pt, cfg), manifest, device="cpu").process(clip)
    assert out.audio.shape == ref.audio.shape == clip.shape and _lsb(ref.audio, out.audio) <= 1


def test_temporal_causality_of_network(params):
    """Port of ``tests/test_ul_unas.py:44``: late frames leave early mask frames alone."""
    _, pt = params
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((1, 20, 514)).astype(np.float32)
    spec2 = spec.copy()
    spec2[:, 15:] += rng.standard_normal((1, 5, 514)).astype(np.float32)
    a = T.ul_unas_net(pt, _t(spec), T.UlUnasConfig()).numpy()
    b = T.ul_unas_net(pt, _t(spec2), T.UlUnasConfig()).numpy()
    np.testing.assert_allclose(a[:, :15], b[:, :15], atol=1e-5)
    assert np.abs(a[:, 15:] - b[:, 15:]).max() > 1e-4


def test_stream_init_matches_jax():
    jstate = J.ul_unas_stream_init(J.UlUnasConfig(), batch=3)
    tstate = T.ul_unas_stream_init(T.UlUnasConfig(), batch=3, device="cpu")
    jf, tf = flat_tree(jax.tree.map(np.asarray, jstate)), flat_tree(tstate)
    assert {k: v.shape for k, v in jf.items()} == {k: v.shape for k, v in tf.items()}
    assert tf["/net/enc/3/cache"].shape == (3, 0, 33, 32)  # kt = 1: no history
    with pytest.raises(ValueError, match="model rate"):
        T.ul_unas_stream_init(T.UlUnasConfig(in_sample_rate=48000), device="cpu")


def test_stream_step_matches_jax(params):
    """4 chunks of 4 hops, two lanes: int16 within 1 LSB and every state leaf
    within 1e-5 × max|ref|, chunk for chunk."""
    pj, pt = params
    jcfg, tcfg = J.UlUnasConfig(), T.UlUnasConfig()
    step = jax.jit(lambda p, s, c: J.ul_unas_stream_step(p, s, c, jcfg))
    audio = _audio((2, 16 * HOP), 16)
    jstate = J.ul_unas_stream_init(jcfg, batch=2)
    tstate = T.ul_unas_stream_init(tcfg, batch=2, device="cpu")
    for s in range(0, audio.shape[1], 4 * HOP):
        chunk = audio[:, s:s + 4 * HOP]
        jstate, jout = step(pj, jstate, jnp.asarray(chunk))
        tstate, tout = T.ul_unas_stream_step(pt, tstate, _t(chunk), tcfg)
        assert tout.dtype == torch.int16 and tuple(tout.shape) == chunk.shape
        assert _lsb(jout, tout) <= 1
        _states_close(jax.tree.map(np.asarray, jstate), tstate)
    with pytest.raises(ValueError, match="multiple of hop"):
        T.ul_unas_stream_step(pt, tstate, torch.zeros((2, 100), dtype=torch.int16), tcfg)


def test_stream_matches_zero_prefixed_offline(params):
    """Port of ``tests/test_ul_unas.py:58``: from sample ``hop`` on the stream
    equals the offline center=False path on the zero-prefixed signal (1 LSB),
    and the default offline path at an n_fft − hop delay in the interior
    (2 LSB, as there)."""
    _, pt = params
    cfg = T.UlUnasConfig(center=False)
    total = 16 * cfg.hop
    audio = _audio(total, 1)
    carry = cfg.n_fft - cfg.hop
    padded = np.concatenate([np.zeros(carry, np.int16), audio])
    offline = T.ul_unas_forward(pt, _t(padded[None]), cfg).numpy()[0]
    state, outs = T.ul_unas_stream_init(cfg, device="cpu"), []
    for s in range(0, total, 4 * cfg.hop):
        state, out = T.ul_unas_stream_step(pt, state, _t(audio[None, s:s + 4 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    streamed = np.concatenate(outs)
    assert _lsb(streamed[cfg.hop:total], offline[cfg.hop:total]) <= 1
    default = T.ul_unas_forward(pt, _t(audio[None]), T.UlUnasConfig()).numpy()[0]
    lo, hi = 6 * cfg.n_fft, total - cfg.n_fft - carry
    assert _lsb(default[lo:hi], streamed[lo + carry:hi + carry]) <= 2


def test_kernel_routes(params, monkeypatch):
    """The offline forward reaches B1 once and B2 once; the stream step B1
    once; nothing reaches B3–B6."""
    from audiojax_torch.models import ul_unas as model_mod
    from audiojax_torch.nn import core as tcore

    calls = {"b1": 0, "b2": 0, "b4": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(model_mod, "fast_stft_packed", counting("b1", model_mod.fast_stft_packed))
    monkeypatch.setattr(model_mod, "fast_istft_packed",
                        counting("b2", model_mod.fast_istft_packed))
    monkeypatch.setattr(tcore, "fast_dwconv1d", counting("b4", tcore.fast_dwconv1d))
    _, pt = params
    T.ul_unas_forward(pt, _t(_audio((2, 4000), 17)), T.UlUnasConfig())
    assert calls == {"b1": 1, "b2": 1, "b4": 0}
    T.ul_unas_stream_step(pt, T.ul_unas_stream_init(batch=2, device="cpu"),
                          _t(_audio((2, 4 * HOP), 18)))
    assert calls == {"b1": 2, "b2": 1, "b4": 0}
