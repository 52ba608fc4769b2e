"""DFSMN and the Kaldi front end in the port against audiojax, on the CPU.

The same seeded numpy inputs go through both packages, parameters carried by
``params_from_numpy``, at depth 2, hidden 32, lorder 6 and the default
1920/960 geometry.  Gates: the Kaldi tables bit for bit (both are the same
float64 numpy); ``log_mel_fbank`` within 1e-5 × max|ref|; the mask net and
its carried memories within 1e-5 × max|ref|; ``dfsmn_forward`` and the stream
step's int16 within 1 LSB (the offline forward is held to the 1 LSB gate, not
the 40 dB one: float32 sums reassociate between XLA:CPU and ATen, which moves
a rounding by one step at most).  Then the JAX package's DFSMN stream
contracts (``tests/test_dfsmn.py:132,165``), ported, and the importer against
a torch replica of the upstream UniDeepFsmn stack.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.frontend import kaldi as JK
from audiojax.models import dfsmn as J
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from test_torch_ckpt_builders import build_dfsmn_state_dict, flat_tree, one_thread  # noqa: F401

from audiojax_torch.dsp.stft import frame_signal
from audiojax_torch.frontend import kaldi as TK
from audiojax_torch.importers import import_checkpoint
from audiojax_torch.models import dfsmn as T
from audiojax_torch.nn import core as tcore
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TINY = dict(depth=2, hidden=32, lorder=6)
RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rtol * np.abs(ref).max(), rtol=0)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _audio(shape, seed, scale=5000.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.int16)


@pytest.fixture(scope="module")
def params():
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = J.DfsmnConfig(**TINY), T.DfsmnConfig(**TINY)
    pj = J.init_dfsmn(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


# ── the Kaldi front end ─────────────────────────────────────────────────────


@pytest.mark.parametrize("n_mels,nfft,fs", [(120, 2048, 48000.0), (80, 512, 16000.0)])
def test_kaldi_tables_bit_for_bit(n_mels, nfft, fs):
    np.testing.assert_array_equal(TK.kaldi_mel_banks(n_mels, nfft, fs),
                                  JK.kaldi_mel_banks(n_mels, nfft, fs))
    frame_len = nfft * 15 // 16
    np.testing.assert_array_equal(TK.kaldi_analysis_basis(frame_len, nfft),
                                  JK.kaldi_analysis_basis(frame_len, nfft))
    assert TK.KALDI_LOG_EPS == JK.KALDI_LOG_EPS


def test_log_mel_fbank_matches_jax():
    x = _audio((2, 48000), 0).astype(np.float32)
    kw = dict(frame_len=1920, hop=960, nfft=2048, n_mels=120, fs=48000.0)
    ref = JK.log_mel_fbank(jnp.asarray(x), **kw)
    _close(TK.log_mel_fbank(torch.from_numpy(x), **kw), ref)
    # shared frames, and the power scale the model passes
    cfg = T.DfsmnConfig()
    frames = frame_signal(torch.from_numpy(x), cfg.frame_cfg)
    _close(TK.log_mel_fbank(torch.from_numpy(x), frames=frames, power_scale=4.0, **kw),
           JK.log_mel_fbank(jnp.asarray(x), power_scale=4.0, **kw))


# ── the model ───────────────────────────────────────────────────────────────


def test_init_keys_and_shapes(params):
    _, tcfg, pj, pt = params
    jshapes = {k: v.shape for k, v in flat_tree(pj).items()}
    assert {k: v.shape for k, v in flat_tree(T.init_dfsmn_numpy(0, tcfg)).items()} == jshapes
    assert sorted(flat_tree(pt)) == sorted(jshapes)
    assert isinstance(pt["layers"], list) and len(pt["layers"]) == tcfg.depth
    # the memory taps reach the port in torch's (C, 1, lorder) conv layout
    assert tuple(pt["layers"][0]["mem"]["w"].shape) == (tcfg.hidden, 1, tcfg.lorder)


def test_mask_net_state_carry_matches_jax(params):
    """Port of tests/test_dfsmn.py:108: three chunks with the memories carried
    equal one pass, in the port, against JAX's one pass."""
    jcfg, _, pj, pt = params
    fb = np.random.default_rng(1).standard_normal((2, 30, jcfg.n_mels)).astype(np.float32)
    ref, jstate = J.dfsmn_mask_net(pj, jnp.asarray(fb))
    masks, state = [], None
    for a, b in ((0, 11), (11, 23), (23, 30)):
        m, state = T.dfsmn_mask_net(pt, torch.from_numpy(fb[:, a:b]), state)
        masks.append(m)
    _close(torch.cat(masks, dim=1), ref)
    assert len(state) == len(jstate) == jcfg.depth
    for got, want in zip(state, jstate):
        _close(got, want)


def test_mask_net_lorder_one_keeps_no_history():
    """lorder 1: the memory is the current frame alone, and the carried state
    is empty (a slice by start: -(lorder - 1) would keep the whole buffer)."""
    cfg = J.DfsmnConfig(depth=2, hidden=16, lorder=1)
    pj = J.init_dfsmn(jax.random.PRNGKey(2), cfg)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    fb = np.random.default_rng(2).standard_normal((1, 7, cfg.n_mels)).astype(np.float32)
    ref, _ = J.dfsmn_mask_net(pj, jnp.asarray(fb))
    got, state = T.dfsmn_mask_net(pt, torch.from_numpy(fb))
    _close(got, ref)
    assert all(tuple(s.shape) == (1, 0, 16) for s in state)


def test_fsmn_memory_routes_to_b4(params, monkeypatch):
    """Each layer's memory is a true depthwise conv: ``nn.core.conv1d`` routes
    it to B4's wrapper (its plain version on the CPU), no pads, taps (k, C)."""
    _, tcfg, _, pt = params
    calls = []
    real = tcore.fast_dwconv1d

    def spy(x, w, *, pads, dilation):
        calls.append((tuple(x.shape), tuple(w.shape), pads, dilation))
        return real(x, w, pads=pads, dilation=dilation)

    monkeypatch.setattr(tcore, "fast_dwconv1d", spy)
    T.dfsmn_mask_net(pt, torch.zeros((2, 5, tcfg.n_mels)))
    assert calls == [((2, 5 + tcfg.lorder - 1, tcfg.hidden), (tcfg.lorder, tcfg.hidden),
                      (0, 0), 1)] * tcfg.depth


@pytest.mark.parametrize("length", [50000, 1920, 96000])
def test_forward_matches_jax(params, length):
    """Two clips; int16 within 1 LSB of JAX (the gate this file holds)."""
    jcfg, tcfg, pj, pt = params
    audio = _audio((2, length), 3)
    ref = np.asarray(jax.jit(lambda p, a: J.dfsmn_forward(p, a, jcfg))(pj, jnp.asarray(audio)))
    out = T.dfsmn_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    assert out.dtype == np.int16 and out.shape == audio.shape == ref.shape
    assert _lsb(ref, out) <= 1
    np.testing.assert_array_equal(T.DFSMN(pt, tcfg).eval()(torch.from_numpy(audio)).numpy(), out)


def test_forward_fold_window(params):
    """Batch-folded windows equal JAX's fold, and a misaligned fold is refused."""
    _, _, pj, pt = params
    jcfg, tcfg = J.DfsmnConfig(**TINY, fold_window=3840), T.DfsmnConfig(**TINY, fold_window=3840)
    audio = _audio((1, 10000), 4)
    ref = np.asarray(J.dfsmn_forward(pj, jnp.asarray(audio), jcfg))
    out = T.dfsmn_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    assert _lsb(ref, out) <= 1
    with pytest.raises(ValueError, match="fold_window"):
        T.dfsmn_forward(pt, torch.from_numpy(audio), T.DfsmnConfig(**TINY, fold_window=1000))


def test_session_matches_jax(params):
    """A 2.5 s clip at 48 kHz through both Sessions: 2 windows of 2 s, the
    manifests' runtime configs equal."""
    jcfg, tcfg, pj, pt = params
    clip = _audio(120000, 5, scale=3000.0)
    jspec, tspec = jregistry.get("dfsmn"), tregistry.get("dfsmn")
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    assert (manifest.in_sample_rate, manifest.center_pad, manifest.pad_mode) == (48000, False,
                                                                                "constant")
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(clip)
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert _lsb(ref.audio, out.audio) <= 1


# ── streaming ───────────────────────────────────────────────────────────────


def test_stream_step_matches_jax(params):
    """Six chunks of 4 hops, two lanes: int16 within 1 LSB and every state
    leaf within 1e-5 × max|ref|, chunk for chunk."""
    jcfg, tcfg, pj, pt = params
    step = jax.jit(lambda p, s, c: J.dfsmn_stream_step(p, s, c, jcfg))
    audio = _audio((2, 6 * 4 * jcfg.hop), 6)
    jstate, tstate = J.dfsmn_stream_init(jcfg, 2), T.dfsmn_stream_init(tcfg, 2, device="cpu")
    block = 4 * jcfg.hop
    for s in range(0, audio.shape[1], block):
        chunk = audio[:, s:s + block]
        jstate, jout = step(pj, jstate, jnp.asarray(chunk))
        tstate, tout = T.dfsmn_stream_step(pt, tstate, torch.from_numpy(chunk), tcfg)
        assert tout.dtype == torch.int16 and _lsb(jout, tout) <= 1
        jf, tf = flat_tree(jstate), flat_tree(tstate)
        assert sorted(jf) == sorted(tf)
        for k, a in jf.items():
            _close(tf[k], a)
    with pytest.raises(ValueError, match="multiple of hop"):
        T.dfsmn_stream_step(pt, tstate, torch.zeros((2, 1000), dtype=torch.int16), tcfg)
    with pytest.raises(ValueError, match="model rate"):
        T.dfsmn_stream_init(T.DfsmnConfig(in_sample_rate=16000), device="cpu")


def _stream(pt, cfg, audio):
    state, outs = T.dfsmn_stream_init(cfg, device="cpu"), []
    for s in range(0, audio.size, 4 * cfg.hop):
        state, out = T.dfsmn_stream_step(pt, state, torch.from_numpy(
            audio[None, s:s + 4 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    return np.concatenate(outs)


def test_stream_matches_zero_padded_offline():
    """Port of tests/test_dfsmn.py:132: from sample ``hop`` on, the stream
    equals the offline path on the zero-prepended signal to 1 LSB."""
    cfg = T.DfsmnConfig(depth=2, hidden=32)
    pt = T.init_dfsmn(5, cfg, device="cpu")
    total = 16 * cfg.hop
    audio = _audio(total, 7, scale=6000.0)
    padded = np.concatenate([np.zeros(cfg.n_fft - cfg.hop, np.int16), audio])
    offline = T.dfsmn_forward(pt, torch.from_numpy(padded[None]), cfg).numpy()[0]
    assert _lsb(_stream(pt, cfg, audio)[cfg.hop:total], offline[cfg.hop:total]) <= 1


def test_stream_matches_offline_interior():
    """Port of tests/test_dfsmn.py:165: past the FSMN receptive field the
    stream equals the plain offline path delayed by n_fft − hop, to 1 LSB."""
    cfg = T.DfsmnConfig(depth=2, hidden=32, lorder=4)
    pt = T.init_dfsmn(5, cfg, device="cpu")
    total = 32 * cfg.hop
    audio = _audio(total, 7, scale=6000.0)
    offline = T.dfsmn_forward(pt, torch.from_numpy(audio[None]), cfg).numpy()[0]
    streamed = _stream(pt, cfg, audio)
    delay = cfg.n_fft - cfg.hop
    lo = (1 + cfg.depth * (cfg.lorder - 1) + 3) * cfg.hop
    hi = total - cfg.n_fft - delay
    assert _lsb(offline[lo:hi], streamed[lo + delay:hi + delay]) <= 1


# ── the importer ────────────────────────────────────────────────────────────


def test_builder_keys_are_the_jax_tests():
    """The builder's keys and shapes are those of the JAX tests' inline
    DFSMN builder (tests/test_importers.py, c 32, 12 mels, 17 bins, lorder 5,
    depth 3)."""
    cfg = T.DfsmnConfig(n_mels=12, hidden=32, depth=3, lorder=5, n_fft=32, hop=16)
    theirs = {"linear1.linear.weight": (32, 12), "linear1.linear.bias": (32,),
              "linear2.linear.weight": (17, 32), "linear2.linear.bias": (17,)}
    for i in range(3):
        theirs.update({f"deepfsmn.{i}.linear.weight": (32, 32),
                       f"deepfsmn.{i}.linear.bias": (32,),
                       f"deepfsmn.{i}.project.weight": (32, 32),
                       f"deepfsmn.{i}.conv1.weight": (32, 1, 5, 1)})
    assert {k: tuple(v.shape) for k, v in build_dfsmn_state_dict(cfg, seed=0).items()} == theirs


def test_import_matches_torch_semantics():
    """The port's importer and mask net reproduce the upstream UniDeepFsmn
    stack, h += p1 + causal_conv(p1) (a torch replica)."""
    cfg = T.DfsmnConfig(n_mels=12, hidden=32, depth=3, lorder=5, n_fft=32, hop=16)
    sd = build_dfsmn_state_dict(cfg, seed=4)
    pt = params_from_numpy(import_checkpoint("dfsmn", sd), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 20, 12)).astype(np.float32))
    f = torch.nn.functional
    with torch.no_grad():
        h = torch.relu(f.linear(x, sd["linear1.linear.weight"], sd["linear1.linear.bias"]))
        for i in range(cfg.depth):
            f1 = torch.relu(f.linear(h, sd[f"deepfsmn.{i}.linear.weight"],
                                     sd[f"deepfsmn.{i}.linear.bias"]))
            p1 = f.linear(f1, sd[f"deepfsmn.{i}.project.weight"])
            mem = f.conv1d(f.pad(p1.transpose(1, 2), (cfg.lorder - 1, 0)),
                           sd[f"deepfsmn.{i}.conv1.weight"][..., 0], groups=cfg.hidden)
            h = h + p1 + mem.transpose(1, 2)
        ref = torch.sigmoid(f.linear(h, sd["linear2.linear.weight"], sd["linear2.linear.bias"]))
    mask, _ = T.dfsmn_mask_net(pt, x)
    _close(mask, ref.numpy())
