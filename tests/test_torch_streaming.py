"""State-carry streaming in the port against audiojax, on the CPU.

The same numpy inputs (seeded) go through both packages, with parameters
carried by ``params_from_numpy``: ``stream_istft`` / ``steady_cola_np``, the
grouped GRU's carried state, GTCRN's stream step chunk for chunk, and the
``StreamingServer`` (``jit=False``: the CPU has no CUDA graph) against the
JAX package's server on the same clips and pushes, for every streaming model
(NKF-AEC's lanes push (near, far) pairs).  Then the JAX package's
own server, session and stream-contract tests, ported (``tests/
test_streaming_server.py``, ``tests/test_runtime.py``, ``tests/
test_gtcrn.py``).

Tolerances: int16 outputs within 1 LSB (float32 sums reassociate between
XLA:CPU and ATen, and between batched and single-lane products); float
states within 1e-5 × max|ref| (through GTCRN's ~30 layers and 10 GRUs);
``stream_istft`` within 1e-6 × max|ref| (one product and an overlap-add).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.dsp.stft import StftConfig as JStftConfig
from audiojax.dsp.stft import steady_cola_np as jax_steady_cola_np
from audiojax.dsp.stft import stream_istft as jax_stream_istft
from audiojax.models import dfsmn as JDF
from audiojax.models import gtcrn as JG
from audiojax.models import nkf_aec as JNKF
from audiojax.models import ul_unas as JUL
from audiojax.nn import rnn as JR
from audiojax.runtime import registry as jregistry
from audiojax.runtime.streaming import StreamingServer as JServer
from test_torch_ckpt_builders import flat_tree, one_thread  # noqa: F401

from audiojax_torch.dsp import stft as TD
from audiojax_torch.models import dfsmn as TDF
from audiojax_torch.models import gtcrn as TG
from audiojax_torch.models.nkf_aec import RANDOM_GAIN_SCALE
from audiojax_torch.nn import rnn as TR
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry
from audiojax_torch.runtime.streaming import StreamingServer, StreamingSession

STATE_RTOL = 1e-5
ISTFT_RTOL = 1e-6
DFSMN_TINY = dict(depth=2, hidden=32, lorder=6)


def _assert_states_close(jstate, tstate):
    """Same key paths and shapes; each leaf within STATE_RTOL × max|ref|."""
    jf, tf = flat_tree(jstate), flat_tree(tstate)
    assert sorted(jf) == sorted(tf)
    for k, a in jf.items():
        assert tf[k].shape == a.shape, k
        np.testing.assert_allclose(tf[k], a, atol=STATE_RTOL * max(np.abs(a).max(), 1e-30),
                                   rtol=0, err_msg=k)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _clips(n, length, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(length) * 6000).astype(np.int16) for _ in range(n)]


@pytest.fixture(scope="module")
def gtcrn_params():
    """(JAX params, the port's CPU tensors), drawn by JAX from PRNGKey(0)."""
    pj = jax.jit(JG.init_gtcrn, static_argnums=1)(jax.random.PRNGKey(0), JG.GtcrnConfig())
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def dfsmn_params():
    cfg = JDF.DfsmnConfig(**DFSMN_TINY)
    pj = JDF.init_dfsmn(jax.random.PRNGKey(3), cfg)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def ul_unas_params():
    pj = JUL.init_ul_unas(jax.random.PRNGKey(4), JUL.UlUnasConfig())
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.fixture(scope="module")
def nkf_aec_params():
    """JAX's draw with ``fc_out`` damped as the port's random init damps it."""
    pj = JNKF.init_nkf(jax.random.PRNGKey(5), JNKF.NkfConfig())
    pj["fc_out"] = jax.tree.map(lambda a: a * RANDOM_GAIN_SCALE, pj["fc_out"])
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _port(name):
    """The port's spec and tiny-or-default config for ``name``."""
    spec = registry.get(name)
    return spec, spec.make_config(**(DFSMN_TINY if name == "dfsmn" else {}))


# ── dsp: the streaming ISTFT ───────────────────────────────────────────────

CONFIGS = {
    "gtcrn": dataclasses.replace(JG.GtcrnConfig().stft, center=False),
    "dfsmn": JDF.DfsmnConfig().istft_cfg,
    "odd": JStftConfig(319, 160, window="hamming", center=False),
}


def _tcfg(jcfg):
    return TD.StftConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steady_cola_matches_jax(name):
    ref = jax_steady_cola_np(CONFIGS[name])
    got = TD.steady_cola_np(_tcfg(CONFIGS[name]))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ISTFT_RTOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_istft_matches_jax(name):
    jcfg = CONFIGS[name]
    rng = np.random.default_rng(1)
    frames = 3
    packed = rng.standard_normal((2, frames, 2 * jcfg.f_bins)).astype(np.float32)
    tail = rng.standard_normal((2, jcfg.n_fft - jcfg.hop)).astype(np.float32)
    emit = frames * jcfg.hop
    jout, jtail = jax_stream_istft(jnp.asarray(packed), jcfg, jnp.asarray(tail), emit)
    tout, ttail = TD.stream_istft(torch.from_numpy(packed), _tcfg(jcfg), torch.from_numpy(tail),
                                  emit)
    for ref, got in ((jout, tout), (jtail, ttail)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=ISTFT_RTOL * np.abs(ref).max(), rtol=0)


def test_grouped_gru_carried_state_matches_jax():
    """The state the port's grouped GRU returns is JAX's ``(G, B·W, H)``, and
    carrying it through two calls equals one call over both halves."""
    rng = np.random.default_rng(2)
    g, b, t, c, h = 2, 6, 5, 8, 4
    pn = {"w_i": rng.standard_normal((g, c // g, 3 * h)).astype(np.float32) * 0.5,
          "w_h": rng.standard_normal((g, h, 3 * h)).astype(np.float32) * 0.5,
          "b_i": rng.standard_normal((g, 3 * h)).astype(np.float32) * 0.1,
          "b_h": rng.standard_normal((g, 3 * h)).astype(np.float32) * 0.1}
    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    h0 = rng.standard_normal((g, b, h)).astype(np.float32)
    jy, jh = JR.grouped_gru(jax.tree.map(jnp.asarray, pn), jnp.asarray(x), groups=g,
                            h0=jnp.asarray(h0), return_state=True)
    ty, th = TR.grouped_gru(pt, torch.from_numpy(x), groups=g, h0=torch.from_numpy(h0),
                            return_state=True)
    assert tuple(th.shape) == np.asarray(jh).shape == (g, b, h)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    y1, h1 = TR.grouped_gru(pt, torch.from_numpy(x[:, :2]), groups=g, h0=torch.from_numpy(h0),
                            return_state=True)
    y2, h2 = TR.grouped_gru(pt, torch.from_numpy(x[:, 2:]), groups=g, h0=h1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), ty.numpy(), atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), th.numpy(), atol=1e-6)


# ── GTCRN's stream step ────────────────────────────────────────────────────


def test_gtcrn_stream_init_matches_jax():
    jstate = JG.gtcrn_stream_init(JG.GtcrnConfig(), batch=3)
    tstate = TG.gtcrn_stream_init(TG.GtcrnConfig(), batch=3, device="cpu")
    jf, tf = flat_tree(jstate), flat_tree(tstate)
    assert {k: v.shape for k, v in jf.items()} == {k: v.shape for k, v in tf.items()}
    assert not any(v.any() for v in tf.values())
    with pytest.raises(ValueError, match="model rate"):
        TG.gtcrn_stream_init(TG.GtcrnConfig(in_sample_rate=48000), device="cpu")


def test_gtcrn_stream_step_matches_jax(gtcrn_params):
    """8 chunks of 4 hops, two lanes: int16 within 1 LSB and every state leaf
    within 1e-5 × max|ref|, chunk for chunk."""
    pj, pt = gtcrn_params
    jcfg, tcfg = JG.GtcrnConfig(), TG.GtcrnConfig()
    step = jax.jit(lambda p, s, c: JG.gtcrn_stream_step(p, s, c, jcfg))
    audio = np.stack(_clips(2, 8 * 4 * jcfg.hop, seed=3))
    jstate = JG.gtcrn_stream_init(jcfg, batch=2)
    tstate = TG.gtcrn_stream_init(tcfg, batch=2, device="cpu")
    block = 4 * jcfg.hop
    for s in range(0, audio.shape[1], block):
        chunk = audio[:, s:s + block]
        jstate, jout = step(pj, jstate, jnp.asarray(chunk))
        tstate, tout = TG.gtcrn_stream_step(pt, tstate, torch.from_numpy(chunk))
        assert tout.dtype == torch.int16 and tuple(tout.shape) == chunk.shape
        assert _lsb(jout, tout) <= 1
        _assert_states_close(jstate, tstate)
    with pytest.raises(ValueError, match="multiple of hop"):
        TG.gtcrn_stream_step(pt, tstate, torch.zeros((2, 100), dtype=torch.int16))


def _zero_mean(audio):
    audio = np.round(audio - audio.mean()).astype(np.int16)
    audio[0] -= np.int16(audio.sum())  # exact zero mean: remove_dc is the identity
    return audio


def _stream(params, cfg, audio, block_hops=4):
    state = TG.gtcrn_stream_init(cfg, device="cpu")
    outs = []
    for s in range(0, audio.size, block_hops * cfg.hop):
        state, out = TG.gtcrn_stream_step(params, state, torch.from_numpy(
            audio[None, s:s + block_hops * cfg.hop]), cfg)
        outs.append(out.numpy()[0])
    return np.concatenate(outs)


def test_gtcrn_stream_matches_zero_padded_offline():
    """Port of tests/test_gtcrn.py:82: from sample ``hop`` on, the stream
    equals the offline center=False path on the zero-prepended signal, to
    1 LSB: every temporal dependency is carried exactly."""
    cfg = TG.GtcrnConfig(center=False)
    params = TG.init_gtcrn(0, cfg, device="cpu")
    total = 16 * cfg.hop
    audio = _zero_mean(np.random.default_rng(1).standard_normal(total) * 6000)
    padded = np.concatenate([np.zeros(cfg.n_fft - cfg.hop, np.int16), audio])
    offline = TG.gtcrn_forward(params, torch.from_numpy(padded[None]), cfg).numpy()[0]
    streamed = _stream(params, cfg, audio)
    assert _lsb(streamed[cfg.hop:total], offline[cfg.hop:total]) <= 1


def test_gtcrn_stream_tracks_default_offline_interior():
    """Port of tests/test_gtcrn.py:115: against the default (centred,
    DC-removed) offline path the stream is delayed by n_fft − hop and agrees
    > 35 dB in the interior, once the GRU transients decay."""
    cfg = TG.GtcrnConfig()
    params = TG.init_gtcrn(0, cfg, device="cpu")
    total = 32 * cfg.hop
    audio = _zero_mean(np.random.default_rng(1).standard_normal(total) * 6000)
    offline = TG.gtcrn_forward(params, torch.from_numpy(audio[None]), cfg).numpy()[0]
    streamed = _stream(params, cfg, audio)
    delay = cfg.n_fft - cfg.hop
    lo, hi = 8 * cfg.n_fft, total - cfg.n_fft - delay
    a = offline[lo:hi].astype(np.float64)
    err = a - streamed[lo + delay:hi + delay]
    assert 10 * np.log10(np.sum(a * a) / max(np.sum(err * err), 1e-9)) > 35


# ── StreamingServer against the JAX package's ──────────────────────────────


def _drive(server, clips, cuts):
    """Open a lane per clip (an array, or a tuple of one array per model
    input), push every clip's [a, b) slices in turn through ``push_many``,
    flush each lane; the lanes' outputs."""
    sids = [server.open() for _ in clips]
    outs = {sid: [] for sid in sids}

    def part(c, a, b):
        return tuple(x[a:b] for x in c) if isinstance(c, tuple) else c[a:b]

    for a, b in zip(cuts[:-1], cuts[1:]):
        for sid, out in server.push_many({sid: part(c, a, b)
                                          for sid, c in zip(sids, clips)}).items():
            outs[sid].append(out)
    for sid in sids:
        outs[sid].append(server.flush(sid))
    return [np.concatenate(outs[sid]) for sid in sids]


@pytest.mark.parametrize("name", ["gtcrn", "dfsmn", "ul_unas", "nkf_aec"])
def test_server_matches_jax_server(name, request):
    """Three lanes, irregular pushes through ``push_many``, block_hops 2: the
    port's server (jit=False) and the JAX package's (jit=True), within 1 LSB.
    NKF-AEC is the real two-input case: each lane pushes a (near, far) pair,
    the near end holding a delayed, scaled copy of its far end."""
    pj, pt = request.getfixturevalue(f"{name}_params")
    jspec = jregistry.get(name)
    jcfg = jspec.make_config(**(DFSMN_TINY if name == "dfsmn" else {}))
    spec, cfg = _port(name)
    n = 9 * cfg.hop + 77
    clips = _clips(3, n, seed=4)
    if name == "nkf_aec":
        fars = _clips(3, n, seed=5)
        clips = [((c // 2 + np.roll(f, 37) // 2).astype(np.int16), f)
                 for c, f in zip(clips, fars)]
    cuts = [0, 300, 1000, 1000 + 2 * cfg.hop + 5, n]
    ref = _drive(JServer(jspec, pj, jcfg, max_streams=4, block_hops=2, jit=True), clips, cuts)
    got = _drive(StreamingServer(spec, pt, cfg, max_streams=4, block_hops=2, jit=False,
                                 device="cpu"), clips, cuts)
    for r, g in zip(ref, got):
        assert g.dtype == np.int16 and g.shape == r.shape == (n,)
        assert _lsb(r, g) <= 1


# ── the JAX package's server tests, ported (tests/test_streaming_server.py) ─


def _server(name="gtcrn", seed=0, **kw):
    spec, cfg = _port(name)
    return spec, cfg, StreamingServer(spec, spec.init_params(seed, cfg, "cpu"), cfg,
                                      jit=False, device="cpu", **kw)


def test_server_matches_independent_sessions_gtcrn():
    """Two concurrent streams with interleaved, irregular pushes equal two
    independent StreamingSessions (batched and single-lane products
    reassociate float32 sums: 1 LSB)."""
    spec, cfg, srv = _server(max_streams=4, block_hops=2)
    clips = _clips(2, 3 * 1024, seed=0)
    refs = []
    for c in clips:
        s = StreamingSession(spec, srv.params, cfg, block_hops=2, jit=False, device="cpu")
        refs.append(np.concatenate([s.push(c), s.flush()]))
    s0, s1 = srv.open(), srv.open()
    outs = {s0: [], s1: []}
    cuts = [0, 700, 1100, 2048, 3 * 1024]
    for a, b in zip(cuts[:-1], cuts[1:]):
        outs[s0].append(srv.push(s0, clips[0][a:b]))
        outs[s1].append(srv.push(s1, clips[1][a:b]))
    outs[s0].append(srv.flush(s0))
    outs[s1].append(srv.flush(s1))
    for sid, ref in zip((s0, s1), refs):
        got = np.concatenate(outs[sid])
        assert got.shape == ref.shape
        assert _lsb(got, ref) <= 1


def test_server_lane_reuse_resets_state():
    _, _, srv = _server(seed=2, max_streams=1, block_hops=2)
    clip = _clips(1, 2 * 1024, seed=2)[0]
    sid = srv.open()
    first = np.concatenate([srv.push(sid, clip), srv.flush(sid)])
    srv.close(sid)
    with pytest.raises(RuntimeError, match="busy"):
        srv.open(), srv.open()  # only one lane
    srv.close(0)
    sid2 = srv.open()  # a reused lane behaves like a fresh stream
    second = np.concatenate([srv.push(sid2, clip), srv.flush(sid2)])
    np.testing.assert_array_equal(first, second)


def test_server_errors():
    _, _, srv = _server(seed=3, max_streams=1)
    with pytest.raises(KeyError, match="not open"):
        srv.push(0, np.zeros(10, np.int16))
    sid = srv.open()
    with pytest.raises(ValueError, match="chunk"):
        srv.push(sid, np.zeros(4, np.int16), np.zeros(4, np.int16))
    ns = registry.get("zipenhancer")
    with pytest.raises(ValueError, match="streaming"):
        StreamingServer(ns, {}, ns.make_config(), jit=False, device="cpu")


def test_push_many_single_step_per_block_round():
    """push_many advances all ready lanes in one step a block round, and
    matches independent sessions."""
    spec, cfg, srv = _server(seed=4, max_streams=4, block_hops=2)
    clips = _clips(3, 512, seed=4)  # exactly one block at block_hops=2
    refs = []
    for c in clips:
        s = StreamingSession(spec, srv.params, cfg, block_hops=2, jit=False, device="cpu")
        refs.append(np.concatenate([s.push(c), s.flush()]))
    sids = [srv.open() for _ in range(3)]
    steps = {"n": 0}
    inner = srv._masked_step

    def counting_step(*a, **k):
        steps["n"] += 1
        return inner(*a, **k)

    srv._masked_step = counting_step
    outs = srv.push_many({sid: c for sid, c in zip(sids, clips)})
    assert steps["n"] == 1  # 3 streams, 1 block each: one batched step
    for sid, ref in zip(sids, refs):
        got = np.concatenate([outs.get(sid, np.zeros(0, np.int16)), srv.flush(sid)])
        assert _lsb(got, ref) <= 1


@pytest.mark.parametrize("name", ["gtcrn", "dfsmn", "ul_unas", "nkf_aec"])
def test_lane_isolation_all_streaming_models(name):
    """verify_lane_isolation holds the lane-axis inference (batch-major state
    folds) for each streaming model: GTCRN's nested dict with the inter-GRU
    states folded (2, B·33, 8), DFSMN's list of FSMN memories (B, 19, 32),
    UL-UNAS's conv caches (the kt = 1 blocks' zero-length ones among them)
    and inter-GRU states (2, B·33, 8), NKF's nested tuples with the GRU
    states folded (B·513, 18)."""
    _, _, srv = _server(name, seed=1, max_streams=3, block_hops=1)
    if name == "ul_unas":
        assert any(t.numel() == 0 for t in srv._state)
    srv.verify_lane_isolation()


def test_lane_isolation_catches_a_batch_minor_fold():
    """A state folded batch-minor passes the shape inference but interleaves
    lanes: verify_lane_isolation must refuse it."""
    sub = 3

    def init(batch, device):
        return {"h": torch.zeros((sub * batch,), device=device)}

    def step(params, state, chunk):
        lane_sum = chunk.to(torch.float32).sum(-1)  # (B,)
        new = (lane_sum[None, :] + torch.arange(sub)[:, None]).reshape(-1)  # (sub, B): minor
        return {"h": state["h"] + new}, chunk

    spec = dataclasses.replace(registry.get("gtcrn"), make_stream=lambda cfg: (init, step, 0))
    srv = StreamingServer(spec, {}, TG.GtcrnConfig(), max_streams=4, block_hops=1, jit=False,
                          device="cpu")
    with pytest.raises(AssertionError, match="not batch-major"):
        srv.verify_lane_isolation()


def test_server_two_inputs():
    """A two-input (AEC-shaped) model takes one chunk per input in ``push``
    and a (near, far) pair per lane in ``push_many``; irregular pushes equal
    one push, lanes stay apart, and a lone or unequal chunk is refused.  No
    two-input streaming model is ported yet: a stand-in carries a running
    sum of (near − far) per lane."""
    hop = TG.GtcrnConfig().hop

    def init(batch, device):
        return {"acc": torch.zeros((batch, 1), device=device)}

    def step(params, state, near, far):
        d = near.to(torch.float32) - far.to(torch.float32)
        acc = state["acc"] + d.sum(-1, keepdim=True)
        return {"acc": acc}, (d + acc / d.shape[-1]).clamp(-32768, 32767).to(torch.int16)

    base = registry.get("gtcrn")
    spec = dataclasses.replace(
        base, make_stream=lambda cfg: (init, step, 0),
        make_manifest=lambda cfg: dataclasses.replace(base.make_manifest(cfg), num_audio_inputs=2))
    near, far = _clips(2, 5 * hop + 33, seed=5)
    one = StreamingSession(spec, {}, TG.GtcrnConfig(), block_hops=2, jit=False, device="cpu")
    ref = np.concatenate([one.push(near, far), one.flush()])
    srv = StreamingServer(spec, {}, TG.GtcrnConfig(), max_streams=2, block_hops=2, jit=False,
                          device="cpu")
    a, b = srv.open(), srv.open()
    outs = {a: [], b: []}
    for lo, hi in ((0, 100), (100, 700), (700, near.size)):
        got = srv.push_many({a: (near[lo:hi], far[lo:hi]), b: (far[lo:hi], near[lo:hi])})
        for sid, out in got.items():
            outs[sid].append(out)
    for sid in (a, b):
        outs[sid].append(srv.flush(sid))
    np.testing.assert_array_equal(np.concatenate(outs[a]), ref)
    assert np.concatenate(outs[a]).size == np.concatenate(outs[b]).size == near.size
    assert not np.array_equal(np.concatenate(outs[a]), np.concatenate(outs[b]))
    srv.verify_lane_isolation()
    srv.close(a)
    sid = srv.open()
    with pytest.raises(ValueError, match="expects 2 chunk"):
        srv.push(sid, near[:10])
    with pytest.raises(ValueError, match="equal length"):
        srv.push(sid, near[:10], far[:9])


def test_push_after_flush_rejected():
    """flush() consumes zero padding into the lane's state; a later push would
    emit time-shifted audio and must raise."""
    _, cfg, srv = _server(max_streams=2, block_hops=1)
    sid = srv.open()
    srv.push(sid, np.zeros(cfg.hop * 4, np.int16))
    srv.flush(sid)
    with pytest.raises(ValueError, match="flushed"):
        srv.push(sid, np.zeros(cfg.hop, np.int16))
    srv.close(sid)
    sid2 = srv.open()  # the lane is reusable after close
    assert srv.push(sid2, np.zeros(cfg.hop * 4, np.int16)).dtype == np.int16


def test_push_many_validates_before_buffering():
    """A bad entry in push_many must not leave earlier lanes buffered (a retry
    would buffer their audio twice)."""
    _, cfg, srv = _server(max_streams=2, block_hops=1)
    a, b = srv.open(), srv.open()
    chunk = np.zeros(cfg.hop, np.int16)
    with pytest.raises(ValueError, match="expects 1 chunk"):
        srv.push_many({a: chunk, b: (chunk, chunk)})
    assert srv._lanes[a].residuals[0].shape[0] == 0, "lane a was buffered"


# ── StreamingSession (tests/test_runtime.py:342-403, ported) ───────────────


def test_streaming_session_arbitrary_chunks_match_oneshot():
    """Irregular mic-style pushes give exactly the stream of one big push;
    total output length == total input length."""
    spec, cfg = _port("gtcrn")
    params = spec.init_params(0, cfg, "cpu")
    total = 20 * cfg.hop
    audio = (np.random.default_rng(0).standard_normal(total) * 6000).astype(np.int16)
    s1 = StreamingSession(spec, params, cfg, jit=False, device="cpu")
    parts, pos = [], 0
    for size in (300, 777, 1024, 5, 2048, 931):
        parts.append(s1.push(audio[pos:pos + size]))
        pos += size
    parts.append(s1.push(audio[pos:]))
    parts.append(s1.flush())
    chunked = np.concatenate(parts)
    s2 = StreamingSession(spec, params, cfg, jit=False, device="cpu")
    oneshot = np.concatenate([s2.push(audio), s2.flush()])
    assert chunked.shape == (total,)
    np.testing.assert_array_equal(chunked, oneshot)


@pytest.mark.parametrize("name", ["gtcrn", "dfsmn"])
def test_streaming_session_aligns_with_raw_stream(name):
    """The session's output is the raw model stream with the warm-up delay
    dropped; its latency is one block plus n_fft − hop."""
    spec, cfg = _port(name)
    params = spec.init_params(1, cfg, "cpu")
    init, step, delay = spec.make_stream(cfg)
    total = 16 * cfg.hop
    audio = (np.random.default_rng(1).standard_normal(total) * 6000).astype(np.int16)
    sess = StreamingSession(spec, params, cfg, block_hops=4, jit=False, device="cpu")
    assert delay == cfg.n_fft - cfg.hop and sess.latency_samples == 4 * cfg.hop + delay
    out = np.concatenate([sess.push(audio), sess.flush()])
    state, raws = init(1, "cpu"), []
    block = 4 * cfg.hop
    padded = np.concatenate([audio, np.zeros(delay + block, np.int16)])
    for i in range(-(-(total + delay) // block)):
        state, o = step(params, state, torch.from_numpy(padded[None, i * block:(i + 1) * block]))
        raws.append(o.numpy()[0])
    raw = np.concatenate(raws)
    np.testing.assert_array_equal(out, raw[delay:delay + total])


def test_streaming_session_unsupported_model():
    spec = registry.get("zipenhancer")
    with pytest.raises(ValueError, match="does not support streaming"):
        StreamingSession(spec, {}, None)


# ── the card by default, and no CUDA graph on the CPU ──────────────────────


def test_jit_needs_the_card():
    spec, cfg = _port("dfsmn")
    params = spec.init_params(0, cfg, "cpu")
    with pytest.raises(ValueError, match="jit=False"):
        StreamingServer(spec, params, cfg, device="cpu")
    with pytest.raises(ValueError, match="jit=False"):
        StreamingSession(spec, params, cfg, device="cpu")


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, cfg = _port("dfsmn")
    params = spec.init_params(0, cfg, "cpu")
    for jit in (True, False):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StreamingServer(spec, params, cfg, jit=jit)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TDF.dfsmn_stream_init(cfg)
