"""The port's DSP layer (windows, PCM, plain STFT/ISTFT) against audiojax.dsp.

Inputs are drawn with numpy from a seed and fed to both packages; JAX runs
on the CPU, where its STFT is the jnp path (the Pallas kernels run only on a
TPU), and the Pallas kernels are also run in interpret mode at 512/256.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.dsp import StftConfig as JStftConfig
from audiojax.dsp import istft_packed as j_istft_packed
from audiojax.dsp import pcm as jpcm
from audiojax.dsp import stft_packed as j_stft_packed
from audiojax.dsp import windows as jwin
from audiojax.ops.stft_pallas import istft_packed_pallas, stft_packed_pallas

from audiojax_torch.dsp import pcm as tpcm
from audiojax_torch.dsp import windows as twin
from audiojax_torch.dsp.stft import StftConfig, istft_packed, num_frames, stft_packed
from audiojax_torch.ops import stft_cuda

# The geometries chip_smoke.py holds the kernels to: GTCRN, MossFormerGAN,
# ZipEnhancer, odd n_fft, and Mel-Band's large basis.
# (n_fft, hop, window, pad_mode, length)
GEOMETRIES = [
    (512, 256, "hann_sqrt", "reflect", 8000),
    (400, 100, "hamming", "reflect", 4000),
    (400, 100, "hann", "reflect", 4000),
    (319, 160, "hamming", "constant", 4000),
    (2048, 441, "hann", "reflect", 11025),
]

# Both sides are float32 products over n_fft (or 2F) terms summed in another
# order: agreement to 2e-5 of the largest magnitude is ~100 float32 ulps.
STFT_TOL = 2e-5


def _cfgs(n_fft, hop, window, pad_mode):
    kw = dict(window=window, pad_mode=pad_mode)
    return JStftConfig(n_fft, hop, **kw), StftConfig(n_fft, hop, **kw)


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, tol=STFT_TOL):
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


# ── windows ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("name", jwin.WINDOW_NAMES + ("unknown_falls_back",))
def test_windows_match(name):
    assert twin.WINDOW_NAMES == jwin.WINDOW_NAMES
    for n in (1, 2, 7, 319, 400, 512):
        np.testing.assert_array_equal(twin.get_window(name, n), jwin.get_window(name, n))
    for wl, n_fft in ((400, 512), (512, 400), (319, 320)):
        np.testing.assert_array_equal(twin.padded_window(name, wl, n_fft),
                                      jwin.padded_window(name, wl, n_fft))


# ── PCM ────────────────────────────────────────────────────────────────────

_EXTREMES = np.array([-32768, -32767, -16384, -1, 0, 1, 16384, 32766, 32767], np.int16)


def test_pcm_in_extremes():
    ref = np.asarray(jpcm.pcm_in(jnp.asarray(_EXTREMES)))
    out = tpcm.pcm_in(torch.from_numpy(_EXTREMES)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_pcm_out_extremes():
    """Clip in float32, then truncate toward zero through int32: exact."""
    x = np.concatenate([
        _EXTREMES.astype(np.float32) / 32768.0,
        np.array([-2.0, -1.0, -0.99999, -1e-5, 1e-5, 0.99999, 1.0, 1.5, 32767 / 32768,
                  -0.5 / 32767, 0.5 / 32767, 1.7 / 32767, -1.7 / 32767], np.float32),
    ])
    ref = np.asarray(jpcm.pcm_out(jnp.asarray(x)))
    out = tpcm.pcm_out(torch.from_numpy(x)).numpy()
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, ref)
    # an int16 round trip at full scale stays in range and in sign
    rt = tpcm.pcm_out(tpcm.pcm_in(torch.from_numpy(_EXTREMES))).numpy()
    np.testing.assert_array_equal(rt, np.asarray(jpcm.pcm_out(jpcm.pcm_in(jnp.asarray(_EXTREMES)))))


@pytest.mark.parametrize("out_length", [1000, 2205, 4800])
def test_resample_and_dc_match(out_length):
    x = _signal((2, 2205), seed=3)
    ref = np.asarray(jpcm.resample_linear(jpcm.remove_dc(jnp.asarray(x)), out_length))
    out = tpcm.resample_linear(tpcm.remove_dc(torch.from_numpy(x)), out_length).numpy()
    # float32 mean and lerp: a few ulps of the signal's scale
    np.testing.assert_allclose(out, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_fold_unfold_match():
    x = _signal((2, 12))
    f = tpcm.fold_windows(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jpcm.fold_windows(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpcm.unfold_windows(f, 2).numpy(), x)
    with pytest.raises(ValueError):
        tpcm.fold_windows(torch.from_numpy(x), 5)


# ── plain STFT / ISTFT ─────────────────────────────────────────────────────


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}-{g[1]}-{g[2]}")
def test_stft_matches_jax(geom):
    n_fft, hop, window, pad_mode, length = geom
    jcfg, tcfg = _cfgs(n_fft, hop, window, pad_mode)
    x = _signal((2, length))
    ref = np.asarray(j_stft_packed(jnp.asarray(x), jcfg))
    out = stft_packed(torch.from_numpy(x), tcfg).numpy()
    assert out.shape[-2] == num_frames(tcfg, length)
    _close(out, ref)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}-{g[1]}-{g[2]}")
def test_istft_matches_jax(geom):
    n_fft, hop, window, pad_mode, length = geom
    jcfg, tcfg = _cfgs(n_fft, hop, window, pad_mode)
    spec = np.asarray(j_stft_packed(jnp.asarray(_signal((2, length), seed=1)), jcfg))
    for out_length in (None, length - hop // 2, length):
        ref = np.asarray(j_istft_packed(jnp.asarray(spec), jcfg, out_length))
        out = istft_packed(torch.tensor(spec), tcfg, out_length).numpy()
        _close(out, ref)


def test_stft_istft_match_pallas_interpret():
    """At the GTCRN geometry the port also matches the Pallas kernels, run in
    interpret mode (3e-4 × max|ref|: the Pallas tests' own tolerance)."""
    jcfg, tcfg = _cfgs(512, 256, "hann_sqrt", "reflect")
    x = _signal((2, 6000), seed=2)
    ref = np.asarray(stft_packed_pallas(jnp.asarray(x), jcfg, frames_per_block=32, interpret=True))
    spec = stft_packed(torch.from_numpy(x), tcfg)
    _close(spec.numpy(), ref, tol=3e-4)
    ref_i = np.asarray(istft_packed_pallas(jnp.asarray(spec.numpy()), jcfg, frames_per_block=32,
                                           interpret=True))
    _close(istft_packed(spec, tcfg).numpy(), ref_i, tol=3e-4)


def test_reflect_pad_too_short_raises():
    tcfg = StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    with pytest.raises(ValueError, match="reflect center-pad"):
        stft_packed(torch.zeros(1, 256), tcfg)
    jcfg = JStftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    with pytest.raises(ValueError, match="reflect center-pad"):
        j_stft_packed(jnp.zeros((1, 256)), jcfg)


def test_istft_out_length_overrun_raises():
    tcfg = StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    spec = stft_packed(torch.from_numpy(_signal((1, 2560))), tcfg)
    istft_packed(spec, tcfg, out_length=2560 + 256)  # reaches into the right pad: allowed
    with pytest.raises(ValueError, match="out_length"):
        istft_packed(spec, tcfg, out_length=2560 + 257)


# ── the kernel module on the CPU ───────────────────────────────────────────


def test_fast_paths_take_plain_on_cpu():
    tcfg = StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    x = torch.from_numpy(_signal((2, 4096)))
    before = dict(stft_cuda.launches)
    spec = stft_cuda.fast_stft_packed(x, tcfg)
    y = stft_cuda.fast_istft_packed(spec, tcfg)
    assert stft_cuda.launches == before  # no kernel was launched
    assert torch.equal(spec, stft_packed(x, tcfg))
    assert torch.equal(y, istft_packed(spec, tcfg))


def test_kernel_wrappers_refuse_cpu_tensors():
    tcfg = StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    with pytest.raises(ValueError, match="CUDA tensor"):
        stft_cuda.stft_packed_cuda(torch.zeros(1, 4096), tcfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stft_cuda.istft_packed_cuda(torch.zeros(1, 17, 514), tcfg)
