"""The FFT plan and launch geometry of the port's STFT/ISTFT kernels (B1, B2).

The kernels (``audiojax_torch/csrc/stft.cu``) run only on the card.  What
they compute is emulated here in numpy from the same host-side plan: the
radix order, the twiddle tables (float32 for B1, float64 for B2) and the
windows of ``audiojax_torch.dsp.stft``, and the tiles, strips, frame groups
and overlap-add order that ``ops.stft_cuda`` launches.  The plan is held
against ``np.fft.rfft`` / ``np.fft.irfft`` at every n_fft of the model zoo:
B1's to 1e-6 × max|ref| both in float64 arithmetic and in its own float32,
B2's in its own float64 to 1e-12.  The emulated kernels are held against the
plain versions and the JAX package (2e-5 × max|ref|, the tolerance of
``tests/test_torch_dsp.py``).  The wrappers' refusals are held without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiojax.dsp import StftConfig as JStftConfig
from audiojax.dsp import istft_packed as j_istft_packed
from audiojax.dsp import stft_packed as j_stft_packed

from audiojax_torch.dsp import stft as D
from audiojax_torch.dsp.stft import StftConfig
from audiojax_torch.ops import stft_cuda

# The ten STFT geometries of the model zoo (tests/test_ops_pallas.py).
ZOO = [
    StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect"),      # gtcrn, ul_unas
    StftConfig(400, 100, window="hann", pad_mode="reflect"),           # zipenhancer
    StftConfig(400, 100, window="hamming", pad_mode="reflect"),        # mossformergan
    StftConfig(1024, 256, window="hann", pad_mode="constant"),         # nkf_aec
    StftConfig(319, 160, window="hamming", pad_mode="constant"),       # sdaec, deep_echo
    StftConfig(2048, 441, window="hann", pad_mode="reflect"),          # melband 44.1k
    StftConfig(1920, 960, window="hamming_periodic", center=False),    # dfsmn
    StftConfig(1920, 384, window="hamming_symmetric", center=False),   # mossformer2_se
    StftConfig(640, 320, window="hamming_symmetric", center=False),    # dfsmn_aec
    StftConfig(1024, 256, window="hann", center=False),                # mossformer_sr
]
ZOO_IDS = [f"{c.n_fft}-{c.hop}-{c.window}-{'c' if c.center else 'u'}" for c in ZOO]
# The geometries chip_smoke.py holds the kernels to, with small inputs.
CHECKED = [(ZOO[0], 8000), (ZOO[2], 4000), (ZOO[1], 4000), (ZOO[4], 4000), (ZOO[5], 11025),
           (ZOO[6], 19200)]
CHECKED_IDS = [f"{c.n_fft}-{c.hop}-{c.window}" for c, _ in CHECKED]
PLAN_TOL = 1e-6
PLAN_TOL_F64 = 1e-12
STFT_TOL = 2e-5
SM_COUNT = 132


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _table(n_fft, dtype, table):
    t = D._fft_table_np(n_fft, table).astype(np.float64)
    return (t[:, 0] + 1j * t[:, 1]).astype(dtype)


# ── numpy emulation of the kernels' FFT ───────────────────────────────────


def _fft(z, n_fft, dtype, table):
    """Forward FFT of the last axis by the plan's Stockham stages."""
    plan, tw = D.fft_plan(n_fft), _table(n_fft, dtype, table)
    m, src, ns = plan.m, z.astype(dtype), 1
    for r, off in zip(plan.radices, plan.offsets):
        nb = m // r
        j = np.arange(nb)
        k = j % ns
        v = np.stack([src[..., j + q * nb] for q in range(r)])
        for q in range(1, r):
            v[q] = v[q] * tw[off + k * (r - 1) + q - 1]
        if r in D.FIXED_RADICES:  # the butterflies' exact constants
            w = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r).astype(dtype)
        else:  # the table's roots, after the twiddles
            w = tw[off + ns * (r - 1) + np.outer(np.arange(r), np.arange(r)) % r]
        o = np.einsum("qr,r...->q...", w, v)
        dst = np.empty_like(src)
        for q in range(r):
            dst[..., (j - k) * r + k + q * ns] = o[q]
        src, ns = dst, ns * r
    return src


def _rfft(x, n_fft, dtype=np.complex128):
    """B1's transform of real frames (..., n_fft) → (..., F)."""
    plan, tw = D.fft_plan(n_fft), _table(n_fft, dtype, np.float32)
    if n_fft % 2:
        return _fft(x, n_fft, dtype, np.float32)[..., : n_fft // 2 + 1]
    m = plan.m
    z = _fft(x[..., 0::2] + 1j * x[..., 1::2], n_fft, dtype, np.float32)
    k = np.arange(m + 1)
    a, c = z[..., k % m], np.conj(z[..., (m - k) % m])
    w = tw[plan.post_offset + k]
    return 0.5 * (a + c) - 0.5j * w * (a - c)


def _irfft(spec, n_fft):
    """B2's unnormalised inverse (n_fft × irfft) of one-sided spectra (..., F),
    in float64: the forward FFT of the conjugate, Im of DC and Nyquist ignored."""
    dtype = np.complex128
    plan, tw = D.fft_plan(n_fft), _table(n_fft, dtype, np.float64)
    x = spec.astype(dtype).copy()
    x[..., 0] = x[..., 0].real
    if n_fft % 2:
        full = np.concatenate([x, np.conj(x[..., :0:-1])], axis=-1)
        return _fft(np.conj(full), n_fft, dtype, np.float64).real
    m = plan.m
    x[..., m] = x[..., m].real
    k = np.arange(m)
    a, c = x[..., k], np.conj(x[..., m - k])
    z = (a + c) + 1j * np.conj(tw[plan.post_offset + k]) * (a - c)
    y = np.conj(_fft(np.conj(z), n_fft, dtype, np.float64))
    out = np.empty(spec.shape[:-1] + (n_fft,))
    out[..., 0::2], out[..., 1::2] = y.real, y.imag
    return out


@pytest.mark.parametrize("cfg", ZOO, ids=ZOO_IDS)
def test_plan_matches_numpy_rfft(cfg):
    plan = D.fft_plan(cfg.n_fft)
    assert np.prod(plan.radices) == plan.m == (cfg.n_fft if cfg.n_fft % 2 else cfg.n_fft // 2)
    x = _signal((3, cfg.n_fft)).astype(np.float64)
    ref = np.fft.rfft(x)
    for dtype in (np.complex128, np.complex64):
        out = _rfft(x, cfg.n_fft, dtype)
        assert np.abs(out - ref).max() <= PLAN_TOL * np.abs(ref).max(), dtype


@pytest.mark.parametrize("cfg", ZOO, ids=ZOO_IDS)
def test_plan_matches_numpy_irfft(cfg):
    spec = np.fft.rfft(_signal((3, cfg.n_fft), seed=1).astype(np.float64))
    spec[:, 0] += 0.5j  # ignored, as irfft ignores it
    if cfg.n_fft % 2 == 0:
        spec[:, -1] -= 0.25j
    ref = np.fft.irfft(spec, cfg.n_fft) * cfg.n_fft
    out = _irfft(spec, cfg.n_fft)
    assert np.abs(out - ref).max() <= PLAN_TOL_F64 * np.abs(ref).max()


def test_plan_radices():
    """Eights and fours first, then 2, 3, 5, then the other primes;
    319 = 11·29 runs the generic stage twice."""
    assert D.fft_plan(512).radices == (8, 8, 4)
    assert D.fft_plan(400).radices == (8, 5, 5)
    assert D.fft_plan(2048).radices == (8, 8, 8, 2)
    assert D.fft_plan(1920).radices == (8, 8, 3, 5)
    assert D.fft_plan(319).radices == (11, 29)
    assert D.fft_plan(2 * 97).radices == (97,)  # a prime half-length: one dense stage


# ── numpy emulation of the kernels' tiles ──────────────────────────────────


def _emulate_stft(x, cfg):
    """B1 block by block: strips with the centre pad resolved by index."""
    b, length = x.shape
    geo = stft_cuda.stft_launch(cfg, b, length)
    win = D._analysis_window_np(cfg).astype(np.float64)
    half = cfg.half if cfg.center else 0
    out = np.full((b, geo.n_t, 2 * cfg.f_bins), np.nan)
    for row in range(b):
        for t0 in range(0, geo.n_t, geo.frames):
            nf = min(geo.frames, geo.n_t - t0)
            s = t0 * cfg.hop - half + np.arange((nf - 1) * cfg.hop + cfg.n_fft)
            inside = (s >= 0) & (s < length)
            if cfg.center and cfg.pad_mode == "reflect":
                s = np.where(s < 0, -s, np.where(s >= length, 2 * length - 2 - s, s))
                inside[:] = True
            strip = np.where(inside, x[row, np.clip(s, 0, length - 1)], 0.0)
            idx = np.arange(nf)[:, None] * cfg.hop + np.arange(cfg.n_fft)
            spec = _rfft(strip[idx] * win, cfg.n_fft)
            if cfg.n_fft % 2 == 0:  # Im X[n_fft/2] from the plain basis's own column
                spec.imag[:, -1] = strip[idx] @ D._nyquist_imag_np(cfg).astype(np.float64)
            out[row, t0 : t0 + nf] = np.concatenate([spec.real, spec.imag], axis=-1)
    return out


def _emulate_istft(spec, cfg, out_length=None):
    """B2 block by block: tiles of hop-rows, frame groups, overlap-add in
    frame order, the COLA reciprocal in the epilogue."""
    b, n_t, _ = spec.shape
    geo = stft_cuda.istft_launch(cfg, b, n_t, out_length)
    win = D._synthesis_window_np(cfg).astype(np.float64)
    cola = D._inv_win_sum_np(cfg, n_t, out_length).astype(np.float64)
    x = spec[..., : cfg.f_bins] + 1j * spec[..., cfg.f_bins :]
    hop, n = cfg.hop, cfg.n_fft
    out = np.full((b, geo.end - geo.start), np.nan)
    row_first = geo.start // hop
    for row in range(b):
        for r0 in range(row_first, (geo.end - 1) // hop + 1, geo.rows):
            p_lo, p_hi = max(r0 * hop, geo.start), min((r0 + geo.rows) * hop, geo.end)
            t_lo, t_hi = max(0, (p_lo - n) // hop + 1), min(n_t - 1, (p_hi - 1) // hop)
            acc = np.zeros(p_hi - p_lo)
            for g0 in range(t_lo, t_hi + 1, geo.group):
                frames = _irfft(x[row, g0 : min(g0 + geo.group, t_hi + 1)], n) * win
                for t, y in enumerate(frames, start=g0):
                    lo, hi = max(p_lo, t * hop), min(p_hi, t * hop + n)
                    acc[lo - p_lo : hi - p_lo] += y[lo - t * hop : hi - t * hop]
            out[row, p_lo - geo.start : p_hi - geo.start] = acc * cola[p_lo - geo.start :
                                                                       p_hi - geo.start]
    return out


def _close(out, ref, tol=STFT_TOL):
    assert out.shape == ref.shape and np.isfinite(out).all()  # every output written
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("cfg,length", CHECKED, ids=CHECKED_IDS)
def test_emulated_stft_kernel_matches_plain_and_jax(cfg, length):
    x = _signal((3, length), seed=4)
    out = _emulate_stft(x, cfg)
    _close(out, D.stft_packed(torch.from_numpy(x), cfg).numpy())
    jcfg = JStftConfig(cfg.n_fft, cfg.hop, window=cfg.window, center=cfg.center,
                       pad_mode=cfg.pad_mode)
    _close(out, np.asarray(j_stft_packed(jnp.asarray(x), jcfg)))


@pytest.mark.parametrize("cfg,length", [g for g in CHECKED if g[0].n_fft % 2 == 0],
                         ids=[i for g, i in zip(CHECKED, CHECKED_IDS) if g[0].n_fft % 2 == 0])
def test_emulated_stft_nyquist_imag_has_the_plain_sign(cfg, length):
    """Im X[n_fft/2] is rounding noise (exactly zero for real input), and
    ZipEnhancer's phase feature takes its sign: B1 takes it from the plain
    basis's own column, so its sign is the plain version's and the JAX
    package's, frame by frame."""
    x = _signal((3, length), seed=8)
    out = _emulate_stft(x, cfg)[..., -1]
    jcfg = JStftConfig(cfg.n_fft, cfg.hop, window=cfg.window, center=cfg.center,
                       pad_mode=cfg.pad_mode)
    for ref in (D.stft_packed(torch.from_numpy(x), cfg).numpy()[..., -1],
                np.asarray(j_stft_packed(jnp.asarray(x), jcfg))[..., -1]):
        assert np.all(ref != 0) and np.array_equal(np.sign(out), np.sign(ref))


@pytest.mark.parametrize("cfg,length", CHECKED, ids=CHECKED_IDS)
def test_emulated_istft_kernel_matches_plain_and_jax(cfg, length):
    spec = D.stft_packed(torch.from_numpy(_signal((3, length), seed=5)), cfg).numpy()
    jcfg = JStftConfig(cfg.n_fft, cfg.hop, window=cfg.window, center=cfg.center,
                       pad_mode=cfg.pad_mode)
    for out_length in (None, length - cfg.hop // 2):
        out = _emulate_istft(spec, cfg, out_length)
        _close(out, D.istft_packed(torch.from_numpy(spec), cfg, out_length).numpy())
        _close(out, np.asarray(j_istft_packed(jnp.asarray(spec), jcfg, out_length)))


def test_emulated_kernels_take_the_scales():
    cfg = StftConfig(400, 100, window="hann", pad_mode="reflect", input_scale=2.0,
                     output_scale=0.25)
    x = _signal((2, 2000), seed=6)
    spec = _emulate_stft(x, cfg)
    _close(spec, D.stft_packed(torch.from_numpy(x), cfg).numpy())
    _close(_emulate_istft(spec.astype(np.float32), cfg),
           D.istft_packed(torch.from_numpy(spec.astype(np.float32)), cfg).numpy())


# ── launch geometry ────────────────────────────────────────────────────────

# (config, batch, length): the serving shapes of GTCRN (30 s, 7 s, 1.3 s),
# MossFormerGAN (30 s, 6 s), ZipEnhancer (6 s), GTCRN's stream step (8 lanes
# of 4 hops after the 256-sample tail, uncentred), DFSMN's 6 s request (4
# windows of 99 frames), UL-UNAS's 7 s and 30 s requests and stream step,
# NKF-AEC's far‖near of a 6 s and a 30 s request and its near‖far stream
# step, MossFormer2-SE's 6 s and 30 s synthesis, and the other checked ones
GTCRN_STREAM = dataclasses.replace(ZOO[0], center=False)
UL_UNAS = StftConfig(512, 256, window="hann", pad_mode="reflect")
NKF = ZOO[3]
SERVING = [(ZOO[0], 16, 32000), (ZOO[0], 4, 32000), (ZOO[0], 1, 32000), (ZOO[2], 32, 24000),
           (ZOO[2], 4, 24000), (ZOO[1], 4, 24000), (GTCRN_STREAM, 8, 1280), (ZOO[6], 4, 96000),
           (ZOO[4], 4, 16000), (ZOO[5], 2, 88200), (ZOO[6], 2, 19200)]
SERVING_IDS = [f"{c.n_fft}-{c.hop}-{b}x{n}" for c, b, n in SERVING]
SERVING_NEW = [(UL_UNAS, 4, 32000), (UL_UNAS, 16, 32000),
               (dataclasses.replace(UL_UNAS, center=False), 8, 1280), (NKF, 8, 32000),
               (NKF, 32, 32000), (dataclasses.replace(NKF, center=False), 16, 1792),
               (ZOO[7], 4, 96000), (ZOO[7], 16, 96000)]
# SDAEC's and Deep-Echo's near‖far at a 6 s and a 30 s request, the
# DFSMN-AEC cascade's SDAEC backend, their stream steps, the mask synthesis
SERVING_NEW += [(ZOO[4], 2, 160000), (ZOO[4], 8, 160000), (ZOO[4], 8, 32000),
                (dataclasses.replace(ZOO[4], center=False), 16, 799),
                (dataclasses.replace(ZOO[4], center=False), 16, 1439),
                (ZOO[8], 4, 32000), (ZOO[8], 16, 32000)]
SERVING += SERVING_NEW
SERVING_IDS += [f"{c.n_fft}-{c.hop}-{c.window}-{'c' if c.center else 'u'}-{b}x{n}"
                for c, b, n in SERVING_NEW]


@pytest.mark.parametrize("cfg,batch,length", SERVING,
                         ids=SERVING_IDS)
def test_launch_geometry_fits_and_fills_the_card(cfg, batch, length):
    """Shared memory within a block's 227 KB; at least one block per SM
    wherever there are that many frames (B1) or hop-rows (B2)."""
    g1 = stft_cuda.stft_launch(cfg, batch, length)
    assert g1.n_t == D.num_frames(cfg, length)
    assert g1.smem <= stft_cuda.SMEM_MAX and 1 <= g1.frames <= g1.n_t
    assert g1.blocks == batch * -(-g1.n_t // g1.frames)
    assert g1.blocks >= min(SM_COUNT, batch * g1.n_t)
    g2 = stft_cuda.istft_launch(cfg, batch, g1.n_t)
    n_rows = (g2.end - 1) // cfg.hop - g2.start // cfg.hop + 1
    k_seg = -(-cfg.n_fft // cfg.hop)
    assert g2.smem <= stft_cuda.SMEM_MAX and 1 <= g2.group <= g2.rows + k_seg - 1
    assert g2.blocks >= min(SM_COUNT, batch * n_rows)


# ── the wrappers without a card ────────────────────────────────────────────


class _StubLib:
    """Records every call into the kernel library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            return 0
        return call


@pytest.fixture
def stub_lib(monkeypatch):
    """The wrappers with their device check off and a library that records calls."""
    stub = _StubLib()
    monkeypatch.setattr(stft_cuda, "_lib", lambda: stub)
    monkeypatch.setattr(stft_cuda, "_check", lambda *args: None)
    return stub


def test_stft_wrapper_raises_before_any_launch(stub_lib):
    before = dict(stft_cuda.launches)
    with pytest.raises(ValueError, match="reflect center-pad"):
        stft_cuda.stft_packed_cuda(torch.zeros(1, 256), ZOO[0])
    with pytest.raises(ValueError, match="input too short"):
        stft_cuda.stft_packed_cuda(torch.zeros(2, 1000), ZOO[6])
    assert stub_lib.calls == [] and stft_cuda.launches == before


def test_istft_wrapper_raises_before_any_launch(stub_lib):
    before = dict(stft_cuda.launches)
    spec = torch.zeros(1, 11, 2 * ZOO[0].f_bins)  # 11 frames cover 2560 output samples
    with pytest.raises(ValueError, match="out_length"):
        stft_cuda.istft_packed_cuda(spec, ZOO[0], out_length=2560 + 257)
    with pytest.raises(ValueError, match="packed bins"):
        stft_cuda.istft_packed_cuda(torch.zeros(1, 11, 10), ZOO[0])
    assert stub_lib.calls == [] and stft_cuda.launches == before


def test_wrappers_refuse_cpu_tensors_and_fast_paths_stay_plain():
    before = dict(stft_cuda.launches)
    for cfg in (ZOO[4], ZOO[6]):
        x = torch.from_numpy(_signal((2, 4000), seed=7))
        with pytest.raises(ValueError, match="CUDA tensor"):
            stft_cuda.stft_packed_cuda(x, cfg)
        spec = stft_cuda.fast_stft_packed(x, cfg)
        with pytest.raises(ValueError, match="CUDA tensor"):
            stft_cuda.istft_packed_cuda(spec, cfg)
        assert torch.equal(stft_cuda.fast_istft_packed(spec, cfg), D.istft_packed(spec, cfg))
    assert stft_cuda.launches == before
