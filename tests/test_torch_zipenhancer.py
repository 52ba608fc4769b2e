"""ZipEnhancer in the port against audiojax.models.zipenhancer / audiojax.nn.zipformer.

The blocks and the network run at the tiny widths of ``tests/test_zipenhancer.py``
on parameters JAX draws (``init_zipenhancer(PRNGKey(0))``), which reach the
port as numpy through ``params_from_numpy``.  The int16 forward runs at full
widths and depth on the port's own numpy draw, given to both packages.  The
JAX side runs on the CPU (its STFT/ISTFT take the jnp paths there and its
``relpos_scores`` is the jnp path on every backend); the port takes its
kernels' plain versions.

Tolerances: blocks and network agree to 1e-5 × max|ref|, float32 on both
sides with sums in another order.  The int16 outputs must reach 40 dB SNR,
the port's float32 gate.

The clips fed to the int16 forward and the Session are silent for the first
201 samples of every fold window.  Reflect padding makes the first STFT frame
of a window symmetric, so its spectrum is real in exact arithmetic and the
phase feature atan2(im, re + 1e-5) takes the sign of im's rounding noise
(±π where re < 0): two STFTs that sum in another order disagree there, and
the random-weight network carries the flip into every frame (a few dB instead
of > 40 dB).  With those samples silent the frame is exactly zero in both
packages.  ``test_frame0_phase_gap_is_the_reference_own`` holds the cause on a
clip without the silence: changing only frame 0 of the JAX package's own STFT
moves its output as far, and the port with that frame agrees with it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import zipenhancer as J
from audiojax.nn import zipformer as JZ
from audiojax.ops import stft_pallas as jstft
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_torch_ckpt_builders import hold_bf16, one_thread  # noqa: F401

from audiojax_torch.dsp.stft import _window_np
from audiojax_torch.models import zipenhancer as T
from audiojax_torch.nn import zipformer as TZ
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
MIN_SNR_DB = 40.0
# the bf16 plan: the port's bf16 output against the JAX package's bf16 one on
# the CPU, int16 SNR, just below what was measured (27.10 dB; ROADMAP §C);
# against its float32 one: test_torch_ckpt_builders.hold_bf16
BF16_GATE_DB = 26.0

TINY = dict(channels=16, num_heads=2, query_head_dim=8, pos_head_dim=4, value_head_dim=8,
            ff_hidden=24, nonlin_hidden=12, conv_kernel=7, pos_dim=16,
            encoder_downsample=((1, 1), (2, 2)), fold_window=0)
LAYER_KW = dict(num_heads=2, query_head_dim=8, pos_head_dim=4)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, the port's CPU tensors)."""
    jcfg, tcfg = J.ZipEnhancerConfig(**TINY), T.ZipEnhancerConfig(**TINY)
    pj = jax.jit(J.init_zipenhancer, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
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
    """Noisy tone, silent for the first 201 samples of every 24000 (frame 0
    of each fold window exactly zero, see the module note)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 3 * t) + 0.05 * rng.standard_normal(n)
    x[np.arange(n) % 24000 <= 200] = 0.0
    return np.round(x * 32767).astype(np.int16)


def test_config_and_init_keys_and_shapes(tiny):
    _, tcfg, pj, _ = tiny
    assert dataclasses.asdict(T.ZipEnhancerConfig()) == dataclasses.asdict(J.ZipEnhancerConfig())
    assert _keys_shapes(T.init_zipenhancer_numpy(0, tcfg)) == _keys_shapes(pj)
    # the default (full) configuration, shapes only
    full = jax.eval_shape(lambda k: J.init_zipenhancer(k, J.ZipEnhancerConfig()),
                          jax.random.PRNGKey(0))
    assert _keys_shapes(T.init_zipenhancer_numpy(0)) == _keys_shapes(full)
    ported = T.init_zipenhancer(0, tcfg, device="cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in jax.tree_util.tree_leaves(ported))
    # scalar and vector leaves survive the conversion and the module's buffers
    module = T.ZipEnhancer(ported, tcfg)
    assert module.params["ts0"]["f_layer"]["norm"]["log_scale"].shape == ()
    assert module.params["ts1"]["combine_scale"].shape == (16,)
    assert module.params["ts1"]["down_t"]["bias"].shape == (2,)
    # the bf16 plan is served; any other compute dtype is refused by name
    assert T.ZipEnhancerConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        T.ZipEnhancerConfig(compute_dtype="float16")


def test_blocks_match_jax():
    """swoosh, BiasNorm, down/upsampling (a ragged length), positional table."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(TZ.swoosh_l(xt), JZ.swoosh_l(xj))
    _close(TZ.swoosh_r(xt), JZ.swoosh_r(xj))
    norm = {"bias": rng.standard_normal(16).astype(np.float32) * 0.1,
            "log_scale": np.asarray(0.3, np.float32)}
    _close(TZ.bias_norm(params_from_numpy(norm, device="cpu"), xt),
           JZ.bias_norm(jax.tree.map(jnp.asarray, norm), xj))
    bias = {"bias": rng.standard_normal(3).astype(np.float32)}
    down = TZ.simple_downsample(params_from_numpy(bias, device="cpu"), xt, 3)
    _close(down, JZ.simple_downsample(jax.tree.map(jnp.asarray, bias), xj, 3))
    _close(TZ.simple_upsample(down, 3), JZ.simple_upsample(jnp.asarray(down.numpy()), 3))
    _close(TZ.compact_rel_pos(9, 16, torch.device("cpu")), JZ.compact_rel_pos(9, 16))


def test_attention_weights_and_layer_match_jax(tiny):
    _, _, pj, pt = tiny
    x = np.random.default_rng(2).standard_normal((5, 13, 16)).astype(np.float32)
    pos = TZ.compact_rel_pos(13, 16, torch.device("cpu"))
    jpos = JZ.compact_rel_pos(13, 16)
    lj, lt = pj["ts0"]["f_layer"], pt["ts0"]["f_layer"]
    ref = jax.jit(lambda p, x: JZ.attention_weights(p, x, jpos, **LAYER_KW))(lj["attn"],
                                                                              jnp.asarray(x))
    out = TZ.attention_weights(lt["attn"], torch.from_numpy(x), pos, **LAYER_KW)
    _close(out, ref)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    ref = jax.jit(lambda p, x: JZ.zipformer_layer(p, x, jpos, **LAYER_KW))(lj, jnp.asarray(x))
    _close(TZ.zipformer_layer(lt, torch.from_numpy(x), pos, **LAYER_KW), ref)


def test_net_matches_jax(tiny):
    """Dense encoder, a dual-path and a downsampled encoder (ragged 9 frames,
    101 bins), both decoders."""
    jcfg, tcfg, pj, pt = tiny
    rng = np.random.default_rng(4)
    mag = np.abs(rng.standard_normal((2, 9, 201))).astype(np.float32)
    pha = rng.uniform(-np.pi, np.pi, (2, 9, 201)).astype(np.float32)
    ref_m, ref_p = jax.jit(lambda p, m, a: J.zipenhancer_net(p, m, a, jcfg))(
        pj, jnp.asarray(mag), jnp.asarray(pha))
    out_m, out_p = T.zipenhancer_net(pt, torch.from_numpy(mag), torch.from_numpy(pha), tcfg)
    _close(out_m, ref_m)
    _close(out_p, ref_p)


def test_session_matches_jax(tiny):
    """A 7 s clip at the manifest's geometry: 2 windows of 6 s, each folded into
    four 1.5 s fold windows (tiny widths, ``fold_window=24000`` kept)."""
    _, _, pj, pt = tiny
    kw = {**TINY, "fold_window": 24000}
    jcfg, tcfg = J.ZipEnhancerConfig(**kw), T.ZipEnhancerConfig(**kw)
    clip = _noisy(7 * 16000, 4)
    jspec, tspec = jregistry.get("zipenhancer"), tregistry.get("zipenhancer")
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(tspec.make_module(pt, tcfg), manifest, device="cpu").process(clip)
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == clip.shape
    assert snr_db(ref.audio, out.audio) >= MIN_SNR_DB
    assert out.audio_duration_s == ref.audio_duration_s == 7.0


def test_bf16_forward_matches_jax(tiny):
    """The bf16 plan (tiny widths, three 0.25 s clips, no fold) against the JAX
    package's bf16 and float32 forwards, on the parameters carried across by
    ``params_from_numpy`` and cast by each package's
    ``prepare_compute_params``."""
    jcfg, tcfg, pj, pt = tiny
    jb, tb = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, tcfg))
    audio = np.stack([_noisy(4000, seed) for seed in (8, 9, 10)])
    ref32 = np.asarray(jax.jit(lambda p, a: J.zipenhancer_forward(p, a, jcfg))(
        pj, jnp.asarray(audio)))
    ref16 = np.asarray(jax.jit(lambda p, a: J.zipenhancer_forward(p, a, jb))(
        jregistry.prepare_compute_params(pj, jb), jnp.asarray(audio)))
    out = T.zipenhancer_forward(tregistry.prepare_compute_params(pt, tb), torch.from_numpy(audio),
                                tb).numpy()
    hold_bf16(ref32, ref16, out, BF16_GATE_DB, "zipenhancer")


def _stft64(x, cfg):
    """Float64 numpy STFT (centre reflect pad, rfft), packed ``[re | im]``, as float32."""
    xp = np.pad(np.asarray(x, np.float64), [(0, 0), (cfg.half, cfg.half)], mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(xp, cfg.n_fft, axis=-1)[:, :: cfg.hop]
    spec = np.fft.rfft(frames * _window_np(cfg).astype(np.float64), axis=-1)
    return np.concatenate([spec.real, spec.imag], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def full_width():
    """Full widths and depth, no fold, for (2, 3200) int16 clips: (port config,
    numpy params, port params, the jitted JAX forward, its frame-0 hook).

    The JAX forward's STFT passes frame 0 through a host callback that records
    it and, with ``hook["f64"]`` set, replaces it by a float64 frame; unset it
    changes nothing.  One compile serves every test that takes this fixture."""
    jcfg, tcfg = J.ZipEnhancerConfig(fold_window=0), T.ZipEnhancerConfig(fold_window=0)
    pn = T.init_zipenhancer_numpy(3, tcfg)
    jax_stft, hook = jstft.fast_stft_packed, {"f64": False, "frame0": []}

    def stft_frame0_hook(x, cfg):
        def frame0(a, f0):
            hook["frame0"].append(np.array(f0))
            return _stft64(a, cfg)[:, 0] if hook["f64"] else np.asarray(f0)

        pk = jax_stft(x, cfg)
        return pk.at[:, 0].set(jax.pure_callback(
            frame0, jax.ShapeDtypeStruct((pk.shape[0], pk.shape[2]), pk.dtype), x, pk[:, 0]))

    pj = jax.tree.map(jnp.asarray, pn)
    jitted = jax.jit(lambda p, a: J.zipenhancer_forward(p, a, jcfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstft, "fast_stft_packed", stft_frame0_hook)
        yield (tcfg, pn, params_from_numpy(pn, device="cpu"),
               lambda audio: np.asarray(jitted(pj, jnp.asarray(audio))), hook)


def test_forward_full_width_matches_jax(full_width):
    """Full widths and depth, a 0.2 s clip (no batch-fold)."""
    tcfg, _, pt, run_jax, _ = full_width
    audio = np.stack([_noisy(3200, 5), _noisy(3200, 6)])
    ref = run_jax(audio)
    out = T.zipenhancer_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    assert out.dtype == np.int16 and out.shape == audio.shape
    assert snr_db(ref, out) >= MIN_SNR_DB
    np.testing.assert_array_equal(T.ZipEnhancer(pt, tcfg)(torch.from_numpy(audio)).numpy(), out)


def test_frame0_phase_gap_is_the_reference_own(full_width, monkeypatch):
    """Why the int16 clips start silent.  Without the silence the JAX package
    disagrees with itself when only frame 0 of its STFT changes (its own
    float32 frame against a float64 one), and the port agrees with it once it
    takes the JAX package's frame 0 and keeps its own STFT for every other
    frame.  Full widths, a 0.2 s clip, no fold."""
    tcfg, _, pt, run_jax, hook = full_width
    audio = np.round(np.random.default_rng(7).standard_normal((2, 3200)) * 3000).astype(np.int16)
    port_stft = T.fast_stft_packed

    def port_with_jax_frame0(x, cfg):
        pk = port_stft(x, cfg).clone()
        pk[:, 0] = torch.from_numpy(jax_frame0)
        return pk

    hook["frame0"].clear()
    ref = run_jax(audio)
    jax_frame0 = hook["frame0"][0]
    out = T.zipenhancer_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    hook["f64"] = True
    try:
        ref_f0 = run_jax(audio)
    finally:
        hook["f64"] = False
    monkeypatch.setattr(T, "fast_stft_packed", port_with_jax_frame0)
    out_f0 = T.zipenhancer_forward(pt, torch.from_numpy(audio), tcfg).numpy()
    print(f"\nno silence: port vs JAX {snr_db(ref, out):.2f} dB; JAX vs JAX with a float64 "
          f"frame 0 {snr_db(ref, ref_f0):.2f} dB; port with the JAX frame 0 vs JAX "
          f"{snr_db(ref, out_f0):.2f} dB")
    assert snr_db(ref, ref_f0) < MIN_SNR_DB
    assert snr_db(ref, out_f0) >= MIN_SNR_DB
