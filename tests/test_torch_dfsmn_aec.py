"""The DFSMN-AEC cascade and the VAD post-processing in the port against
audiojax, on the CPU.

The cascade runs at its defaults (mask net hidden 256, depth 9, lorder 20,
3 × 80 mels, 640/320) over each backend at its defaults, on the port's numpy
draw (``init_dfsmn_aec_numpy``: the backend's own draw, NKF's with its damped
gain, and DFSMN's), given to JAX as arrays; every JAX reference is jitted.

Gates: the DFSMN trunk (``return_trunk``) within 1e-5 × max|ref|; the int16
forward with each backend within 1 LSB, and the VAD probabilities within
1e-5; ``Session.process(near, far)`` and the stream step (SDAEC and
Deep-Echo backends) within 1 LSB, the stream states within STATE_RTOL (1e-4) × max|ref|
(each step from the same incoming state, as for SDAEC);
``StreamingServer`` (``jit=False``) against the JAX server within 1 LSB;
``runtime.vad`` equal to ``audiojax.runtime.vad`` on seeded probability
tracks.  Then the JAX package's contracts (the streamed cascade against the
offline interior, the refusals), the kernel routes and the CLI.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import dfsmn as JDF
from audiojax.models import dfsmn_aec as J
from audiojax.runtime import registry as jregistry
from audiojax.runtime import vad as JV
from audiojax.runtime.session import Session as JSession
from audiojax.runtime.streaming import StreamingServer as JServer
from test_torch_ckpt_builders import one_thread  # noqa: F401  (autouse)
from test_torch_sdaec import (close, drive, echo_pair, lsb, pairs, read_wav, states_close,
                              stream_chunks, t, write_wav, zero_mean)

from audiojax_torch.models import dfsmn as TDF
from audiojax_torch.models import dfsmn_aec as T
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import cli
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime import vad as TV
from audiojax_torch.runtime.session import Session as TSession
from audiojax_torch.runtime.streaming import StreamingServer

SR = 16000


def _params(cfg_kw, seed=0):
    pn = T.init_dfsmn_aec_numpy(seed, T.DfsmnAecConfig(**cfg_kw))
    return pn, jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


@pytest.fixture(scope="module")
def params():
    """The default cascade (SDAEC backend)."""
    return _params({})


def test_config_and_init_keys_and_shapes():
    assert dataclasses.asdict(T.DfsmnAecConfig()) == dataclasses.asdict(J.DfsmnAecConfig())
    for kw in ({}, {"backend": "deep_echo", "output_vad": True}, {"backend": "nkf"}):
        full = jax.eval_shape(lambda k: J.init_dfsmn_aec(k, J.DfsmnAecConfig(**kw)),
                              jax.random.PRNGKey(0))
        want = {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(full)[0]}
        pn = T.init_dfsmn_aec_numpy(0, T.DfsmnAecConfig(**kw))
        assert {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(pn)[0]} == want
    with pytest.raises(ValueError, match="unknown backend"):
        T.init_dfsmn_aec_numpy(0, T.DfsmnAecConfig(backend="nope"))


def test_dfsmn_mask_net_trunk_matches_jax():
    """``return_trunk``: the FSMN trunk before the mask head, and the mask and
    memories beside it, from zeros and from a carried state."""
    cfg = TDF.DfsmnConfig(n_mels=24, hidden=32, depth=2, lorder=6, n_fft=64, hop=32)
    pn = TDF.init_dfsmn_numpy(3, cfg)
    pj, pt = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")
    fb = np.random.default_rng(4).standard_normal((2, 7, 24)).astype(np.float32)
    mem = [np.random.default_rng(5 + i).standard_normal((2, 5, 32)).astype(np.float32)
           for i in range(2)]
    for state in (None, mem):
        rm, rs, rx = JDF.dfsmn_mask_net(pj, jnp.asarray(fb),
                                        None if state is None else [jnp.asarray(m) for m in state],
                                        return_trunk=True)
        gm, gs, gx = TDF.dfsmn_mask_net(pt, t(fb), None if state is None else [t(m) for m in state],
                                        return_trunk=True)
        close(gx, rx)
        close(gm, rm)
        for g, r in zip(gs, rs):
            close(g, r)
    assert len(TDF.dfsmn_mask_net(pt, t(fb))) == 2  # without it, (mask, state) as before


@pytest.mark.parametrize("backend", ["sdaec", "deep_echo", "nkf"])
def test_forward_matches_jax(backend):
    """The cascade over each backend on a 0.4 s (near, far) pair, two rows:
    within 1 LSB."""
    _, pj, pt = _params({"backend": backend})
    near, far = pairs(2, 6400, 50)
    jcfg, tcfg = J.DfsmnAecConfig(backend=backend), T.DfsmnAecConfig(backend=backend)
    ref = jax.jit(lambda p, a, b: J.dfsmn_aec_forward(p, a, b, jcfg))(
        pj, jnp.asarray(near), jnp.asarray(far))
    got = T.dfsmn_aec_forward(pt, t(near), t(far), tcfg)
    assert got.dtype == torch.int16 and tuple(got.shape) == near.shape
    assert lsb(ref, got) <= 1


def test_forward_with_vad_matches_jax():
    """``output_vad`` (Deep-Echo backend): the int16 output within 1 LSB and
    each frame's speech probability within 1e-5."""
    kw = {"backend": "deep_echo", "output_vad": True}
    _, pj, pt = _params(kw, seed=1)
    near, far = pairs(1, 9600, 52)
    jcfg, tcfg = J.DfsmnAecConfig(**kw), T.DfsmnAecConfig(**kw)
    rout, rvad = jax.jit(lambda p, a, b: J.dfsmn_aec_forward(p, a, b, jcfg))(
        pj, jnp.asarray(near), jnp.asarray(far))
    gout, gvad = T.dfsmn_aec_forward(pt, t(near), t(far), tcfg)
    assert lsb(rout, gout) <= 1
    assert tuple(gvad.shape) == (1, 29)
    np.testing.assert_allclose(gvad.numpy(), np.asarray(rvad), atol=1e-5, rtol=0)


def test_session_matches_jax(params):
    """``Session.process(near, far)`` on a 3 s pair (two 2 s windows)."""
    _, pj, pt = params
    near, far = echo_pair(3 * SR, 54)
    jspec, tspec = jregistry.get("dfsmn_aec"), tregistry.get("dfsmn_aec")
    jcfg, tcfg = jspec.make_config(), tspec.make_config()
    manifest = tspec.make_manifest(tcfg)
    assert manifest.num_audio_inputs == 2 and manifest.feature_kind == "kaldi_fbank_stft"
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(near, far)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(near, far)
    assert out.audio.dtype == np.int16 and out.audio.shape == near.shape
    assert lsb(ref.audio, out.audio) <= 1


@pytest.mark.parametrize("backend", ["sdaec", "deep_echo"])
def test_stream_step_matches_jax(backend):
    """Three chunks of 4 stage-2 hops (8 backend hops), two lanes: int16
    within 1 LSB, the new states (the backend's, the int16 and float FIFOs,
    the FSMN memories) within STATE_RTOL (1e-4) × max|ref|."""
    _, pj, pt = _params({"backend": backend})
    jcfg, tcfg = J.DfsmnAecConfig(backend=backend), T.DfsmnAecConfig(backend=backend)
    jstep = jax.jit(lambda s, n, f: J.dfsmn_aec_stream_step(pj, s, n, f, jcfg))
    near, far = pairs(2, 12 * 320, 56)
    states_close(J.dfsmn_aec_stream_init(jcfg, batch=2),
                 T.dfsmn_aec_stream_init(tcfg, batch=2, device="cpu"), 0.0)
    stream_chunks(jstep, lambda s, n, f: T.dfsmn_aec_stream_step(pt, s, n, f, tcfg),
                  J.dfsmn_aec_stream_init(jcfg, batch=2), near, far, 1280)


def test_stream_refusals(params):
    """No NKF stream (its forward has no state carry here) and no VAD output
    through the serving registry, as in the JAX package."""
    with pytest.raises(ValueError, match="no streaming path"):
        T.dfsmn_aec_stream_init(T.DfsmnAecConfig(backend="nkf"), device="cpu")
    spec = tregistry.get("dfsmn_aec")
    for cfg in (T.DfsmnAecConfig(backend="nkf"), T.DfsmnAecConfig(output_vad=True)):
        with pytest.raises(ValueError, match="streamable backend"):
            spec.make_stream(cfg)
    with pytest.raises(ValueError, match="multiple of hop"):
        T.dfsmn_aec_stream_step(params[2], T.dfsmn_aec_stream_init(device="cpu"),
                                torch.zeros((1, 100), dtype=torch.int16),
                                torch.zeros((1, 100), dtype=torch.int16))


def test_stream_with_vad_step():
    """Port of ``tests/test_dfsmn_aec.py:128``: the model's step itself
    emits one probability a frame with ``output_vad``."""
    cfg = T.DfsmnAecConfig(depth=2, hidden=32, lorder=4, output_vad=True)
    pt = T.init_dfsmn_aec(1, cfg, device="cpu")
    near, far = pairs(1, 4 * cfg.hop, 58)
    _, (out, vad) = T.dfsmn_aec_stream_step(pt, T.dfsmn_aec_stream_init(cfg, device="cpu"),
                                            t(near), t(far), cfg)
    assert tuple(out.shape) == (1, 4 * cfg.hop) and tuple(vad.shape) == (1, 4)
    assert bool(torch.isfinite(vad).all())


def test_stream_matches_offline_interior():
    """Port of ``tests/test_dfsmn_aec.py:88``: a 2·hop delay, and within 1 LSB
    of the offline cascade past the stage-2 FSMN's receptive field."""
    cfg = T.DfsmnAecConfig(depth=2, hidden=32, lorder=4)
    pt = T.init_dfsmn_aec(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    total = 32 * cfg.hop
    near, far = zero_mean(rng, total), zero_mean(rng, total)
    offline = T.dfsmn_aec_forward(pt, t(near[None]), t(far[None]), cfg).numpy()[0]
    state, outs = T.dfsmn_aec_stream_init(cfg, device="cpu"), []
    for s in range(0, total, 2 * cfg.hop):
        state, out = T.dfsmn_aec_stream_step(pt, state, t(near[None, s:s + 2 * cfg.hop]),
                                             t(far[None, s:s + 2 * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    streamed = np.concatenate(outs)
    delay = 2 * cfg.hop
    rf = 1 + cfg.depth * (cfg.lorder - 1)
    lo, hi = (rf + 4) * cfg.hop + cfg.frame_len, total - cfg.frame_len - delay
    assert lsb(offline[lo:hi], streamed[lo + delay:hi + delay]) <= 1


def test_server_matches_jax_server(params):
    """Three lanes of (near, far), irregular pushes, block_hops 2: within
    1 LSB of the JAX server; latency 2 hops of block plus 2·hop; the lane
    axes (the int16 near FIFO among them) hold."""
    _, pj, pt = params
    jspec, tspec = jregistry.get("dfsmn_aec"), tregistry.get("dfsmn_aec")
    n = 9 * 320 + 77
    clips = [echo_pair(n, 60 + 2 * i) for i in range(3)]
    cuts = [0, 700, 2000, 2000 + 2 * 320 + 5, n]
    ref = drive(JServer(jspec, pj, jspec.make_config(), max_streams=3, block_hops=2,
                        jit=True), clips, cuts)
    srv = StreamingServer(tspec, pt, tspec.make_config(), max_streams=3, block_hops=2,
                          jit=False, device="cpu")
    got = drive(srv, clips, cuts)
    for r, g in zip(ref, got):
        assert g.dtype == np.int16 and g.shape == r.shape == (n,)
        assert lsb(r, g) <= 1
    assert srv.latency_samples == 4 * 320
    srv.verify_lane_isolation()


# ── the VAD post-processing ────────────────────────────────────────────────


@pytest.mark.parametrize("trial", range(4))
def test_vad_matches_jax(trial):
    """Seeded probability tracks with runs of speech: the silence states, the
    fused segments and the timestamps equal the JAX package's."""
    rng = np.random.default_rng(trial)
    probs = np.clip(np.repeat(rng.random(40), rng.integers(1, 12, 40))
                    + 0.2 * rng.standard_normal(1) , 0.0, 1.0)
    look = int(rng.integers(1, 30))
    speak, sil = float(rng.uniform(0.3, 0.7)), float(rng.uniform(0.3, 0.7))
    kw = dict(speaking_score=speak, silence_score=sil, look_ahead_frames=look)
    np.testing.assert_array_equal(TV.probabilities_to_silence(probs, **kw),
                                  JV.probabilities_to_silence(probs, **kw))
    segs = [(float(a), float(a + b)) for a, b in zip(np.cumsum(rng.uniform(0, 0.6, 12)),
                                                     rng.uniform(0, 0.5, 12))]
    fkw = dict(fusion_threshold_s=0.3, min_speech_s=0.2)
    assert TV.fuse_timestamps(segs, **fkw) == JV.fuse_timestamps(segs, **fkw)
    vkw = dict(hop=320, sample_rate=SR, threshold=speak, silence_score=sil,
               look_ahead_s=float(rng.uniform(0.02, 0.5)))
    assert TV.vad_timestamps(probs, **vkw) == JV.vad_timestamps(probs, **vkw)


def test_vad_timestamps_bridging():
    """Port of ``tests/test_dfsmn_aec.py:33``: a 3-frame dip is bridged, a
    2-frame blip never confirmed; a segment ends one frame past its first
    silent frame."""
    probs = np.zeros(100)
    probs[10:30] = 0.9
    probs[33:50] = 0.9
    probs[80:82] = 0.9
    assert TV.vad_timestamps(probs, hop=320, sample_rate=SR, look_ahead_s=0.3) == [(0.2, 1.02)]


# ── kernel routes and the CLI ──────────────────────────────────────────────


def test_kernel_routes(params, monkeypatch):
    """A forward launches B1 once (the SDAEC backend's near‖far), B2 twice
    (the backend's synthesis and the mask synthesis, 640/320 symmetric
    Hamming, uncentred) and B4 nine times (C 256, k 20, no pads); on the CPU
    every wrapper takes its plain version and counts nothing."""
    from audiojax_torch.models import sdaec as S
    from audiojax_torch.nn import core
    from audiojax_torch.ops import dwconv_cuda, stft_cuda

    calls = {"b1": [], "b2": [], "b4": []}
    b1, b2, b4 = S.fast_stft_packed, stft_cuda.fast_istft_packed, core.fast_dwconv1d
    monkeypatch.setattr(S, "fast_stft_packed",
                        lambda x, c: calls["b1"].append(tuple(x.shape)) or b1(x, c))

    def istft(spec, cfg, out_length=None):
        calls["b2"].append((cfg.n_fft, cfg.window, cfg.center))
        return b2(spec, cfg, out_length)

    monkeypatch.setattr(S, "fast_istft_packed", istft)
    monkeypatch.setattr(T, "fast_istft_packed", istft)
    monkeypatch.setattr(core, "fast_dwconv1d",
                        lambda x, w, **kw: calls["b4"].append((tuple(x.shape), kw["pads"]))
                        or b4(x, w, **kw))
    stft_cuda.reset_launches()
    dwconv_cuda.reset_launches()
    near, far = pairs(2, 3200, 62)
    T.dfsmn_aec_forward(params[2], t(near), t(far))
    assert calls["b1"] == [(4, 3200)]
    assert calls["b2"] == [(319, "hamming", True), (640, "hamming_symmetric", False)]
    assert calls["b4"] == [((2, 9 + 19, 256), (0, 0))] * 9
    assert not any(stft_cuda.launches.values()) and not any(dwconv_cuda.launches.values())


def test_cli_two_inputs_offline_and_stream(tmp_path, capsys):
    """``--model dfsmn_aec --input near.wav far.wav``: the offline answer is
    the library's Session on the same seed's parameters; ``--stream`` writes
    as many samples as it read, at a latency of one block plus 2·hop."""
    near, far = echo_pair(SR // 2, 64)
    paths = [tmp_path / "near.wav", tmp_path / "far.wav"]
    for p, a in zip(paths, (near, far)):
        write_wav(p, a)
    dst, sdst = tmp_path / "out.wav", tmp_path / "stream.wav"
    base = ["--model", "dfsmn_aec", "--device", "cpu", "--seed", "3"]
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(dst)]) == 0
    spec = tregistry.get("dfsmn_aec")
    cfg = spec.make_config()
    want = TSession(spec.make_module(spec.init_params(3, cfg, "cpu"), cfg),
                    spec.make_manifest(cfg), device="cpu").process(near, far).audio
    np.testing.assert_array_equal(read_wav(dst), want)
    assert cli.main([*base, "--input", *map(str, paths), "--output", str(sdst), "--stream",
                     "--block-hops", "2"]) == 0
    assert read_wav(sdst).shape == near.shape and np.any(read_wav(sdst))
    assert "algorithmic latency 1280 samples" in capsys.readouterr().out
