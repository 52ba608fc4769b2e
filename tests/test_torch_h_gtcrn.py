"""H-GTCRN in the port against audiojax.models.h_gtcrn, on the CPU.

H-GTCRN runs at its default config (GTCRN's 16 channels, 18 taps of WPE, 36
CG steps, 10 AuxIVA iterations) on the port's numpy draw, given to both
packages; the same seeded two-microphone clips (a voice through a short
reverberant tail, reaching the second microphone 3 samples later, and a
noise source 2 samples earlier there) go through both.

Gates.  The front end's modules, on well-conditioned random data, within
1e-5 × max|ref| of the JAX package (``_cg_solve`` also against a float64
``numpy.linalg.solve``); GTCRN's backbone on the same 6-channel features
within 1e-5.  On speech the float32 WPE system is ill-conditioned: the port
and the JAX package each part from the port run in complex128 by 0.2–0.4 ×
max|ref| in the separated sources, so that comparison holds the port's
error to at most twice JAX's.  End to end the two packages part at
27.3–39.3 dB int16 SNR on these clips, so the int16 forwards and
``Session`` hold the JAX package's own gate for this family, 20 dB
(``audiojax/utils/parity.py``), and print the two source energies' relative
gap: a near tie would let the packages pick different sources.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.models import gtcrn as JG
from audiojax.models import h_gtcrn as J
from audiojax.nn import spatial as JS
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_torch_ckpt_builders import one_thread  # noqa: F401

from audiojax_torch.models import gtcrn as TG
from audiojax_torch.models import h_gtcrn as T
from audiojax_torch.nn import spatial as TS
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

TOL = 1e-5
GATE_DB = 20.0  # the JAX package's gate for this family (float32 WPE conditioning)


@pytest.fixture(scope="module")
def model():
    """(JAX params, the port's CPU tensors), from the port's numpy draw."""
    pn = T.init_h_gtcrn_numpy(0)
    return jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, device="cpu")


@pytest.fixture(scope="module")
def jforward():
    cfg = J.HGtcrnConfig()
    return jax.jit(lambda p, a: J.h_gtcrn_forward(p, a, cfg))


def two_mic(n: int, seed: int, sr: int = 16000) -> np.ndarray:
    """int16 (2, n): a gliding harmonic voice through a 50 ms decaying
    reverberant tail plus white noise at mic 0; at mic 1 the voice 3 samples
    later and the noise 2 samples earlier."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    voice = sum(np.sin(k * 2 * np.pi * np.cumsum(f0) / sr) / k for k in range(1, 11))
    voice *= (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) ** 2
    voice = 0.3 * voice / np.abs(voice).max()
    tail = 0.3 * rng.standard_normal(800) * np.exp(-np.arange(800) / 160.0)
    tail[0] = 1.0
    wet = np.convolve(voice, tail)[:n]
    noise = 0.05 * rng.standard_normal(n)
    mics = np.stack([wet + noise, np.roll(wet, 3) + np.roll(noise, -2)])
    return np.clip(np.round(mics * 32767), -32768, 32767).astype(np.int16)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _cplx(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _keys_shapes(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_config_and_init_keys_and_shapes(model):
    assert dataclasses.asdict(T.HGtcrnConfig()) == dataclasses.asdict(J.HGtcrnConfig())
    assert (dataclasses.asdict(T.HGtcrnConfig().gtcrn_cfg)
            == dataclasses.asdict(J.HGtcrnConfig().gtcrn_cfg))
    want = jax.eval_shape(lambda k: J.init_h_gtcrn(k), jax.random.PRNGKey(0))
    assert _keys_shapes(T.init_h_gtcrn_numpy(0)) == _keys_shapes(want)
    assert tuple(model[1]["enc0"]["conv"]["w"].shape) == (16, 18, 1, 5)


def test_cg_solve_matches_jax_and_float64():
    """WPE's system size (36 unknowns, 2 right-hand sides) a Hermitian PSD
    matrix per batch row, eps·I-regularised; 36 steps."""
    rng = np.random.default_rng(1)
    x = _cplx(rng, (3, 5, 36, 80))
    r = x @ np.conj(np.swapaxes(x, -1, -2)) / 80 + 0.05 * np.eye(36, dtype=np.complex64)
    p = _cplx(rng, (3, 5, 36, 2))
    ref = np.asarray(JS._cg_solve(jnp.asarray(r), jnp.asarray(p), 36))
    got = TS._cg_solve(torch.from_numpy(r), torch.from_numpy(p), 36).numpy()
    exact = np.linalg.solve(r.astype(np.complex128), p.astype(np.complex128))
    assert _rel(got, ref) <= TOL
    assert _rel(got, exact) <= 1e-4 and _rel(got, exact) <= 2.0 * _rel(ref, exact) + 1e-6


def test_cg_solve_freezes_converged_columns():
    """A right-hand side solved in one step stays solved over 36 steps."""
    r = np.broadcast_to(np.diag(np.arange(1.0, 5.0)).astype(np.complex64), (2, 4, 4)).copy()
    p = np.zeros((2, 4, 2), np.complex64)
    p[:, 0, 0] = 3.0  # an eigenvector: CG converges in one step
    p[:, :, 1] = _cplx(np.random.default_rng(2), (2, 4))
    got = TS._cg_solve(torch.from_numpy(r), torch.from_numpy(p), 36).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(r, p), rtol=0, atol=1e-5)
    assert np.isfinite(got).all()


def test_solve_2x2_matches_jax():
    rng = np.random.default_rng(3)
    a, rhs = _cplx(rng, (4, 7, 2, 2)), _cplx(rng, (4, 7, 2, 1))
    ref = JS._solve_2x2(jnp.asarray(a), jnp.asarray(rhs))
    got = TS._solve_2x2(torch.from_numpy(a), torch.from_numpy(rhs))
    assert _rel(got.numpy(), ref) <= TOL
    np.testing.assert_allclose(np.asarray(a) @ got.numpy(), rhs, rtol=0, atol=1e-4)


def test_wpe_matches_jax():
    x = _cplx(np.random.default_rng(4), (2, 2, 33, 60))
    ref = jax.jit(lambda x: JS.wpe(x, taps=6, delay=2, cg_iter=36))(jnp.asarray(x))
    got = TS.wpe(torch.from_numpy(x), taps=6, delay=2, cg_iter=36)
    assert got.dtype == torch.complex64 and _rel(got.numpy(), ref) <= TOL


def test_wpe_zero_row_stays_in_its_row():
    """A silent batch row divides 0 by 0: NaN there, and only there."""
    x = _cplx(np.random.default_rng(5), (2, 2, 9, 30))
    x[1] = 0.0
    got = TS.wpe(torch.from_numpy(x), taps=4).numpy()
    alone = TS.wpe(torch.from_numpy(x[:1]), taps=4).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], alone[0], rtol=0, atol=1e-5 * np.abs(alone).max())


def test_auxiva_matches_jax():
    x = _cplx(np.random.default_rng(6), (2, 2, 33, 60))
    ref = jax.jit(lambda x: JS.auxiva(x, n_iter=10))(jnp.asarray(x))
    got = TS.auxiva(torch.from_numpy(x), n_iter=10)
    assert _rel(got.numpy(), ref) <= TOL


def test_front_end_against_complex128():
    """On a reverberant two-microphone clip the float32 front end is
    ill-conditioned in both packages: the port's separated sources are no
    further from the port's complex128 front end than twice JAX's."""
    cfg, jcfg = T.HGtcrnConfig(), J.HGtcrnConfig()
    audio = np.stack([two_mic(16128, 7)])
    _, spec, sep = T._front(torch.from_numpy(audio), cfg)
    spec64 = spec.transpose(2, 3).to(torch.complex128)
    sep64 = TS.auxiva(TS.wpe(spec64, taps=cfg.wpe_taps, cg_iter=cfg.cg_iter), n_iter=10).numpy()
    jsep = jax.jit(lambda s: JS.auxiva(JS.wpe(s, taps=jcfg.wpe_taps, cg_iter=jcfg.cg_iter),
                                       n_iter=10))(jnp.asarray(spec.transpose(2, 3).numpy()))
    err_port, err_jax = _rel(sep.numpy(), sep64), _rel(np.asarray(jsep), sep64)
    print(f"separated sources vs complex128: port {err_port:.3e}, JAX {err_jax:.3e}")
    assert err_port <= 2.0 * err_jax


def test_backbone_matches_jax(model):
    """GTCRN-IVA's backbone (ERB 24.7, regular decoder GT convs) on the same
    6-channel features."""
    pj, pt = model
    feat = np.random.default_rng(8).standard_normal((2, 11, 257, 6)).astype(np.float32)
    gj = J.HGtcrnConfig().gtcrn_cfg
    ref = jax.jit(lambda p, f: JG.gtcrn_backbone(p, f, gj))(pj, jnp.asarray(feat))
    got = TG.gtcrn_backbone(pt, torch.from_numpy(feat), T.HGtcrnConfig().gtcrn_cfg)
    assert _rel(got.numpy(), ref) <= TOL


def _gap(audio) -> np.ndarray:
    e = T.source_energies(torch.from_numpy(audio)).numpy()
    return np.abs(e[:, 0] - e[:, 1]) / e.max(axis=1)


def test_forward_matches_jax(model, jforward):
    """Two clips of 1 s (off the hop grid: padded), int16 (B, L); each ≥ 20 dB
    against JAX (measured 27.3–39.3 dB over 14 such clips)."""
    pj, pt = model
    audio = np.stack([two_mic(16000, 1), two_mic(16000, 2)])
    ref = np.asarray(jforward(pj, jnp.asarray(audio)))
    got = T.h_gtcrn_forward(pt, torch.from_numpy(audio))
    assert got.dtype == torch.int16 and tuple(got.shape) == (2, 16000)
    np.testing.assert_array_equal(T.HGTCRN(pt)(torch.from_numpy(audio)).numpy(), got.numpy())
    snrs = [snr_db(r, o) for r, o in zip(ref, got.numpy())]
    print(f"port vs JAX SNR {[round(s, 2) for s in snrs]} dB; source energy gap "
          f"{np.round(_gap(audio), 4).tolist()}")
    assert min(snrs) >= GATE_DB


def test_silent_window_gives_zeros_and_leaves_the_others(model):
    """A batch of a clip and a silent window (Session's bucket pad): the
    silent one gives 0 (its NaN is replaced), the clip what it gives alone."""
    _, pt = model
    clip = two_mic(8000, 3)
    both = T.h_gtcrn_forward(pt, torch.from_numpy(np.stack([clip, np.zeros_like(clip)])))
    alone = T.h_gtcrn_forward(pt, torch.from_numpy(clip[None]))
    assert int(both[1].abs().max()) == 0
    assert snr_db(alone[0].numpy(), both[0].numpy()) >= 60.0


def test_session_matches_jax(model):
    """A 5 s two-microphone request at the manifest's geometry: 2 s windows, 3
    of them bucketed to 4 (one all-zero), mono out; ≥ 20 dB against the JAX
    Session."""
    pj, pt = model
    jspec, tspec = jregistry.get("h_gtcrn"), tregistry.get("h_gtcrn")
    tcfg, jcfg = tspec.make_config(), jspec.make_config()
    manifest = tspec.make_manifest(tcfg)
    assert manifest.runtime_config() == jspec.make_manifest(jcfg).runtime_config()
    clip = two_mic(80000, 4)
    seen = []
    mod = tspec.make_module(pt, tcfg)
    mod.register_forward_hook(lambda m, a, o: seen.append(tuple(a[0].shape)))
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(clip)
    out = TSession(mod, manifest, device="cpu").process(clip)
    assert seen == [(4, 2, 32000)]
    assert out.audio.dtype == np.int16 and out.audio.shape == ref.audio.shape == (80000,)
    snr = snr_db(ref.audio, out.audio)
    print(f"Session port vs JAX SNR {snr:.2f} dB")
    assert snr >= GATE_DB


def test_kernel_routes_per_forward(model, monkeypatch):
    """One analysis on B1's route over both microphones of every window and
    one synthesis on B2's (``chip_smoke.py``'s 1 B1 and 1 B2 a forward)."""
    from audiojax_torch.ops import stft_cuda

    calls = {"b1": [], "b2": []}

    def counting(name, fn):
        def wrapped(x, *a, **kw):
            calls[name].append(tuple(x.shape))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(T, "fast_stft_packed", counting("b1", stft_cuda.fast_stft_packed))
    monkeypatch.setattr(T, "fast_istft_packed", counting("b2", stft_cuda.fast_istft_packed))
    _, pt = model
    T.h_gtcrn_forward(pt, torch.from_numpy(np.stack([two_mic(4096, 5)] * 3)))
    assert calls == {"b1": [(6, 4096)], "b2": [(3, 17, 514)]}
