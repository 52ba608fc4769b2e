"""Mel-Band Roformer (mono and stereo) in the port against
audiojax.models.melband_roformer, on the CPU.

The network runs at the tiny widths of ``tests/test_melband.py:15 _tiny``
(n_fft 256, 8 bands, dim 32, one axial layer) on the port's numpy draw with
perturbed RMSNorm gains, given to both packages; the same seeded numpy
inputs go through both.  One int16 forward runs at the default widths and
band layout (dim 384, 60 bands, 2048/441) with one axial layer.  The JAX
side takes its plain STFT on the CPU; the port takes its kernels' plain
versions.

Gates: the filterbank and the band layout exactly; ``rms_norm`` and the
network within 1e-5 × max|ref|; int16 forwards and ``Session`` within 1 LSB
(float32 sums reassociate between XLA:CPU and ATen).  Stereo clips have
different left and right channels, so a transposed channel interleave
(``bin·ch + c``) cannot pass.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.frontend import mel as JF
from audiojax.models import melband_roformer as J
from audiojax.nn import core as jcore
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from test_torch_ckpt_builders import TINY, hold_bf16, one_thread  # noqa: F401

from audiojax_torch.frontend import mel as TF
from audiojax_torch.models import melband_roformer as T
from audiojax_torch.nn import core as tcore
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
SR = 44100
# the bf16 plan: the port's bf16 output against the JAX package's bf16 one on
# the CPU, int16 SNR, just below what was measured, mono and stereo (ROADMAP
# §C); against its float32 one: test_torch_ckpt_builders.hold_bf16
BF16_GATE_DB = 41.0


def _cfgs(ch: int, **over):
    kw = {**TINY["melband_roformer"], "channels": ch, **over}
    return J.MelBandConfig(**kw), T.MelBandConfig(**kw)


def _params(cfg, seed: int) -> dict:
    """The port's numpy draw with every RMSNorm gain perturbed."""
    pn = T.init_melband_numpy(seed, cfg)
    rng = np.random.default_rng(seed + 100)

    def jitter(node):
        if isinstance(node, dict):
            return {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k == "g" else jitter(v) for k, v in node.items()}
        if isinstance(node, list):
            return [jitter(v) for v in node]
        return node

    return jitter(pn)


@pytest.fixture(scope="module", params=[1, 2], ids=["mono", "stereo"])
def tiny(request):
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = _cfgs(request.param)
    pn = _params(tcfg, 3 + request.param)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _music(n: int, seed: int, channels: int = 1) -> np.ndarray:
    """A gliding voice over a harmonic accompaniment (chords at 110/165/220 Hz)
    plus noise; stereo pans the two apart, so left and right differ.  int16
    (n,) or (channels, n)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 330.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t)
    voice = sum(np.sin(k * 2 * np.pi * np.cumsum(f0) / SR) / k for k in range(1, 6))
    voice *= (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t)) ** 2
    band = sum(np.sin(2 * np.pi * f * t + k) for k, f in enumerate((110.0, 165.0, 220.0)))
    chans = [0.25 * voice * (1.0 - 0.4 * c) + 0.12 * band * (0.6 + 0.4 * c)
             + 0.02 * rng.standard_normal(n) for c in range(channels)]
    out = np.clip(np.round(np.stack(chans) * 32767), -32768, 32767).astype(np.int16)
    return out[0] if channels == 1 else out


@pytest.mark.parametrize("args", [(513, 0.0, 8000.0, 80, 48000.0),
                                  (1025, 0.0, 22050.0, 60, 44100.0),
                                  (129, 0.0, 22050.0, 8, 44100.0)])
def test_slaney_mel_fbanks_match_jax(args):
    """MossFormer2-SR's bank, Mel-Band's default and tiny ones: bit for bit."""
    got, want = TF.slaney_mel_fbanks(*args), JF.slaney_mel_fbanks(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_rms_norm_matches_jax_with_a_zero_row(eps):
    """The mean square is floored at float32's tiny even at eps 0: an
    all-zero row gives 0, not NaN."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    x[1, 2] = 0.0
    g = (1.0 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    ref = jcore.rms_norm({"g": jnp.asarray(g)}, jnp.asarray(x), eps=eps)
    got = tcore.rms_norm({"g": torch.from_numpy(g)}, torch.from_numpy(x), eps=eps)
    assert bool(torch.isfinite(got).all()) and float(got[1, 2].abs().max()) == 0.0
    _close(got, ref)
    _close(tcore.rms_norm(None, torch.from_numpy(x), eps=eps),
           jcore.rms_norm(None, jnp.asarray(x), eps=eps))


@pytest.mark.parametrize("ch", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("size", ["tiny", "default"])
def test_band_layout_matches_jax(ch, size):
    """Indices, widths and counts equal the JAX package's; the port's
    overlap gather sums what the JAX package's scatter-add sums."""
    jcfg, tcfg = _cfgs(ch) if size == "tiny" else (J.MelBandConfig(channels=ch),
                                                   T.MelBandConfig(channels=ch))
    (ji, jw, jc), (ti, tw, tc) = J.band_layout(jcfg), T.band_layout(tcfg)
    np.testing.assert_array_equal(ji, ti)
    assert jw == tw
    np.testing.assert_array_equal(jc, tc)
    if ch == 2:  # channel-interleaved: each bin's two channels adjacent
        assert np.all(ti.reshape(-1, 2)[:, 1] == ti.reshape(-1, 2)[:, 0] + 1)
    vals = np.random.default_rng(2).standard_normal(len(ti))
    scattered = np.zeros(len(tc))
    np.add.at(scattered, ti, vals)
    gathered = np.append(vals, 0.0)[T._overlap_gather_np(tcfg)].sum(axis=1)
    np.testing.assert_allclose(gathered, scattered, rtol=1e-12, atol=1e-12)


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_config_and_init_keys_and_shapes():
    """Keys and shapes at the tiny config and at the default band layout (60
    bands of 2048/441, mono and stereo) with narrow widths: the default
    tree holds ~180M parameters, too many to draw in a test."""
    narrow = dict(dim=16, mlp_expansion=1, depth=1, heads=1, dim_head=8)
    for ch in (1, 2):
        assert (dataclasses.asdict(T.MelBandConfig(channels=ch))
                == dataclasses.asdict(J.MelBandConfig(channels=ch)))
        full = jax.eval_shape(
            lambda k, c=ch: J.init_melband(k, J.MelBandConfig(channels=c, **narrow)),
            jax.random.PRNGKey(0))
        assert _keys_shapes(T.init_melband_numpy(0, T.MelBandConfig(channels=ch, **narrow))) == \
            _keys_shapes(full)
    jcfg, tcfg = _cfgs(1)
    assert _keys_shapes(T.init_melband_numpy(0, tcfg)) == \
        _keys_shapes(J.init_melband(jax.random.PRNGKey(0), jcfg))
    ported = T.init_melband(0, tcfg, device="cpu")
    assert tuple(ported["me_hidden"][0]["w"].shape) == (8, 32, 64)  # stacked dense, kept
    assert T.MelBandConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        T.MelBandConfig(compute_dtype="float16")


def test_bf16_plan_matches_jax(tiny):
    """The bf16 plan, mono and stereo: a 0.2 s two-row request (tiny widths)
    against the JAX package's bf16 and float32 forwards, on the same
    parameters cast by each package's ``prepare_compute_params``.  Both take
    float32 scores and softmax here (the JAX package's branch off the TPU)."""
    jcfg, tcfg, pj, pt = tiny
    jb, tb = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, tcfg))
    audio = np.stack([_music(8820, 11, tcfg.channels), _music(8820, 12, tcfg.channels)])
    ref32 = jax.jit(lambda p, a: J.melband_forward(p, a, jcfg))(pj, jnp.asarray(audio))
    ref16 = jax.jit(lambda p, a: J.melband_forward(p, a, jb))(
        jregistry.prepare_compute_params(pj, jb), jnp.asarray(audio))
    model = T.MelBandRoformer(pt, tb)
    assert {t.dtype for t in model.buffers()} == {torch.bfloat16}
    with torch.inference_mode():
        out = model(torch.from_numpy(audio))
    hold_bf16(np.asarray(ref32), np.asarray(ref16), out.numpy(), BF16_GATE_DB,
              f"melband_roformer ({tcfg.channels} channel(s))")


def test_net_matches_jax(tiny):
    jcfg, tcfg, pj, pt = tiny
    fc = tcfg.f_bins * tcfg.channels
    spec = np.random.default_rng(5).standard_normal((2, 13, fc, 2)).astype(np.float32)
    ref = jax.jit(lambda p, s: J.melband_net(p, s, jcfg))(pj, jnp.asarray(spec))
    _close(T.melband_net(pt, torch.from_numpy(spec), tcfg), ref)


@pytest.mark.parametrize("length", [4410, 4400])
def test_forward_matches_jax(tiny, length):
    """0.1 s on and off the hop grid, two clips: int16 within 1 LSB."""
    jcfg, tcfg, pj, pt = tiny
    audio = np.stack([_music(length, 6, tcfg.channels), _music(length, 7, tcfg.channels)])
    ref = jax.jit(lambda p, a: J.melband_forward(p, a, jcfg))(pj, jnp.asarray(audio))
    got = T.melband_forward(pt, torch.from_numpy(audio), tcfg)
    assert got.dtype == torch.int16 and tuple(got.shape) == audio.shape and bool(got.any())
    assert _lsb(ref, got) <= 1
    if tcfg.channels == 2:
        assert _lsb(got[:, 0], got[:, 1]) > 100  # left and right stay apart


def test_forward_default_widths_one_layer_matches_jax():
    """The default band layout (60 bands, 2048/441) and attention widths (dim
    384, 8 heads of 64), one axial layer and a one-layer mask MLP of width
    384, 0.25 s stereo: within 1 LSB."""
    kw = dict(depth=1, channels=2, mask_depth=1, mlp_expansion=1)
    jcfg, tcfg = J.MelBandConfig(**kw), T.MelBandConfig(**kw)
    pn = _params(tcfg, 9)
    audio = _music(11025, 8, 2)[None]
    ref = jax.jit(lambda p, a: J.melband_forward(p, a, jcfg))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(audio))
    pt = params_from_numpy(pn, device="cpu")
    got = T.melband_forward(pt, torch.from_numpy(audio), tcfg)
    assert bool(got.any()) and _lsb(ref, got) <= 1
    np.testing.assert_array_equal(T.MelBandRoformer(pt, tcfg)(torch.from_numpy(audio)).numpy(),
                                  got.numpy())


def test_session_matches_jax(tiny):
    """The registered manifest with its window cut to 0.2 s: a 0.5 s request
    is 3 windows bucketed to 4 (one all-zero), butt-joined per channel; within
    1 LSB of the JAX Session."""
    jcfg, tcfg, pj, pt = tiny
    name = "melband_roformer" if tcfg.channels == 1 else "melband_roformer_stereo"
    jspec, tspec = jregistry.get(name), tregistry.get(name)
    jm = dataclasses.replace(jspec.make_manifest(jcfg), input_audio_length=8820)
    tm = dataclasses.replace(tspec.make_manifest(tcfg), input_audio_length=8820)
    assert tm.runtime_config() == jm.runtime_config()
    clip = _music(22050, 10, tcfg.channels)
    seen = []
    model = tspec.make_module(pt, tcfg)
    model.register_forward_hook(lambda m, a, o: seen.append(tuple(a[0].shape)))
    ref = JSession(jspec.make_forward(jcfg), pj, jm).process(clip)
    out = TSession(model, tm, device="cpu").process(clip)
    assert seen == [(4, 8820) if tcfg.channels == 1 else (4, 2, 8820)]
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert _lsb(ref.audio, out.audio) <= 1


def test_kernel_routes_per_forward(tiny, monkeypatch):
    """One analysis on B1's route over every window and channel and one
    synthesis on B2's (``chip_smoke.py``'s 1 B1 and 1 B2 a forward)."""
    from audiojax_torch.ops import stft_cuda

    calls = {"b1": [], "b2": []}

    def counting(name, fn):
        def wrapped(x, *a, **kw):
            calls[name].append(tuple(x.shape))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(T, "fast_stft_packed", counting("b1", stft_cuda.fast_stft_packed))
    monkeypatch.setattr(T, "fast_istft_packed", counting("b2", stft_cuda.fast_istft_packed))
    _, tcfg, _, pt = tiny
    audio = np.stack([_music(4410, 11, tcfg.channels)] * 3)
    T.melband_forward(pt, torch.from_numpy(audio), tcfg)
    rows = 3 * tcfg.channels
    assert calls["b1"] == [(rows, 4416)] and [s[0] for s in calls["b2"]] == [rows]


def test_silence_maps_to_silence(tiny):
    _, tcfg, _, pt = tiny
    shape = (1, 4410) if tcfg.channels == 1 else (1, 2, 4410)
    out = T.melband_forward(pt, torch.zeros(shape, dtype=torch.int16), tcfg)
    assert out.dtype == torch.int16 and int(out.abs().max()) == 0
