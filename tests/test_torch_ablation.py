"""The port's stage ablation (``utils/ablation.py``) and its three stage
profiles (``utils/{gan,ss,zip}_profile.py``) against the JAX package's, on
the CPU at tiny widths.

The two JAX ablation tests (``tests/test_utils.py``) run on both packages,
with the port's extra check: the function a stage replaced is called zero
times while it is stubbed.  Each profile has the JAX package's stage names
in its order, and each stub runs, keeps its stage's output shape and dtype
at every call and leaves the forward's output shape as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiojax.nn.mossformer as jmf
from audiojax.utils import ablation as jablation
from audiojax.utils import gan_profile as jgan
from audiojax.utils import ss_profile as jss
from audiojax.utils import zip_profile as jzip
from test_torch_ckpt_builders import TINY, one_thread  # noqa: F401
from torch_isolation import hide_module_stubs  # noqa: F401

import audiojax_torch.nn.mossformer as mf
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime.registry import prepare_compute_params
from audiojax_torch.utils import gan_profile, ss_profile, zip_profile
from audiojax_torch.utils.ablation import Stage, ablate, calls_of, output_specs, stubbed

FLASH = dict(group_size=8, qk_dim=8, rot_dim=4)


def _flash_params():
    """One FLASH layer's parameters from the JAX package's init, both ways."""
    jp = jmf.init_flash_layer(jax.random.PRNGKey(0), 16, vu_dim=16, qk_dim=8, dw_kernel=3)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_stage_ablation_mechanism():
    """ablate() stubs one stage at a time (restoring it), times the whole
    forward each time and attributes latency per stage, in both packages;
    the port's row also counts the stub's calls and the original's (zero)."""
    jp, tp = _flash_params()
    audio = np.zeros((1, 32, 16), np.float32)
    for pkg, module, params, x, make, (make_stage, run_ablate) in (
            ("jax", jmf, jp, jnp.asarray(audio), jax.jit, (jablation.Stage, jablation.ablate)),
            ("torch", mf, tp, torch.from_numpy(audio), lambda f: f, (Stage, ablate))):
        calls = {"real": 0, "stub": 0}
        real_flash = module.flash_layer

        def counting_flash(p, x, _real=real_flash, **kw):
            calls["real"] += 1
            return _real(p, x, **kw)

        def stub_flash(p, x, **kw):
            calls["stub"] += 1
            return x

        with stubbed(module, "flash_layer", counting_flash):
            def fwd(p, x, _m=module):
                return _m.flash_layer(p, x, **FLASH)

            report = run_ablate(make_fn=lambda: make(fwd), params=params, audio=x,
                                sample_rate=16000, iters=2, settle=0,
                                stages=[make_stage("flash", module, "flash_layer", stub_flash)])
        assert module.flash_layer is real_flash, pkg  # restored
        assert calls["real"] >= 1 and calls["stub"] >= 1, pkg  # both forwards ran
        (row,) = report["stages"]
        assert row["name"] == "flash"
        assert row["latency_s"] > 0 and report["baseline"]["latency_s"] > 0
        assert abs(row["attributed_pct"]
                   - 100.0 * row["attributed_s"] / report["baseline"]["latency_s"]) < 1e-9
    # the port ran the stub at every pass (a warm-up and two timed: no trace
    # cache) and the function it replaced at none of them
    assert row["stub_calls"] == 3 and row["original_calls"] == 0


def test_stage_ablation_rejects_unintercepted_stub():
    """A Stage whose stub never runs (wrong module targeted) must raise, not
    report ~0 attribution, in both packages."""
    with pytest.raises(ValueError, match="never called"):
        jablation.ablate(make_fn=lambda: jax.jit(lambda p, x: x * p["s"]),
                         params={"s": jnp.float32(2)}, audio=jnp.zeros((1, 8), jnp.float32),
                         sample_rate=16000, iters=1, settle=0,
                         stages=[jablation.Stage("flash", jmf, "flash_layer",
                                                 lambda p, x, **k: x)])
    with pytest.raises(ValueError, match="never called"):
        ablate(make_fn=lambda: (lambda p, x: x * p["s"]), params={"s": torch.tensor(2.0)},
               audio=torch.zeros((1, 8)), sample_rate=16000, iters=1, settle=0,
               stages=[Stage("flash", mf, "flash_layer", lambda p, x, **k: x)])


def test_stubbed_original_is_called_zero_times():
    """A forward that reaches the stubbed function through a second binding
    as well runs the stub and the original: the port raises, naming the
    count, where the stub count alone would pass."""
    _, params = _flash_params()
    direct = mf.flash_layer  # a binding the stub does not replace

    def fwd(p, x):
        return mf.flash_layer(p, direct(p, x, **FLASH), **FLASH)

    with pytest.raises(ValueError, match="was called 2 times while stubbed"):
        ablate(make_fn=lambda: fwd, params=params, audio=torch.zeros((1, 32, 16)),
               sample_rate=16000, iters=1, settle=0,
               stages=[Stage("flash", mf, "flash_layer", lambda p, x, **k: x)])
    assert mf.flash_layer is direct
    with calls_of(direct) as n:  # the counter sees every binding's call
        fwd(params, torch.zeros((1, 32, 16)))
    assert n[0] == 2


# ── the three profiles ─────────────────────────────────────────────────────

FOLD = 1600  # 0.1 s fold windows: two folds a clip


def _gan(dtype="float32"):
    import audiojax.models.mossformergan_se as JG

    import audiojax_torch.models.mossformergan_se as MG

    knobs = {**TINY["mossformergan_se"], "fold_window": FOLD, "compute_dtype": dtype}
    cfg, jcfg = MG.MossFormerGanConfig(**knobs), JG.MossFormerGanConfig(**knobs)
    params = prepare_compute_params(MG.init_mossformergan(0, cfg, "cpu"), cfg)
    return (jgan.build_stages(jcfg), gan_profile.build_stages(cfg),
            lambda: MG.make_mossformergan(cfg), params, 2 * FOLD)


def _ss(dtype="float32"):
    import audiojax.models.mossformer2_ss as JS

    import audiojax_torch.models.mossformer2_ss as SS

    knobs = {**TINY["mossformer2_ss"], "compute_dtype": dtype}
    cfg, jcfg = SS.MossFormer2SsConfig(**knobs), JS.MossFormer2SsConfig(**knobs)
    params = prepare_compute_params(SS.init_mossformer2_ss(0, cfg, "cpu"), cfg)
    return (jss.build_stages(jcfg), ss_profile.build_stages(cfg),
            lambda: SS.make_mossformer2_ss(cfg), params, 4000)


def _zip(dtype="float32"):
    import audiojax.models.zipenhancer as JZ

    import audiojax_torch.models.zipenhancer as ZM

    knobs = {**TINY["zipenhancer"], "fold_window": FOLD, "compute_dtype": dtype}
    cfg, jcfg = ZM.ZipEnhancerConfig(**knobs), JZ.ZipEnhancerConfig(**knobs)
    jparams = JZ.init_zipenhancer(jax.random.PRNGKey(0), jcfg)
    audio = torch.from_numpy(_clip(2 * FOLD))
    params = prepare_compute_params(ZM.init_zipenhancer(0, cfg, "cpu"), cfg)
    return (jzip.build_stages(jcfg, jparams, jnp.asarray(audio.numpy())),
            zip_profile.build_stages(cfg, params, audio),
            lambda: ZM.make_zipenhancer(cfg), params, 2 * FOLD)


def _clip(n: int) -> np.ndarray:
    return (np.random.default_rng(4).standard_normal((1, n)) * 3000).astype(np.int16)


def _per_call(stage: Stage, fn, run) -> list:
    """The output spec of every call of ``stage``'s attribute while ``run()``
    runs with ``fn`` in its place."""
    from audiojax_torch.utils.ablation import _spec

    seen = []

    def record(*a, **kw):
        out = fn(*a, **kw)
        seen.append(_spec(out))
        return out

    with stubbed(stage.module, stage.attr, record):
        run()
    return seen


@pytest.mark.parametrize("profile,dtype", [(_gan, "float32"), (_ss, "float32"),
                                           (_zip, "float32"), (_gan, "bfloat16"),
                                           (_ss, "bfloat16"), (_zip, "bfloat16")],
                         ids=["gan", "ss", "zip", "gan-bf16", "ss-bf16", "zip-bf16"])
def test_profile_stage_names_match_jax(profile, dtype):
    """Also in the bf16 plan, whose stubs must keep the stages' bf16 outputs."""
    jstages, stages, make_fn, params, n = profile(dtype)
    assert [s.name for s in stages] == [s.name for s in jstages]
    audio = torch.from_numpy(_clip(n))
    fwd = make_fn()

    def run():
        with torch.inference_mode():
            out = fwd(params, audio)
        for o in out if isinstance(out, tuple) else (out,):
            assert o.shape == audio.shape and o.dtype == torch.int16

    for st in stages:
        want = _per_call(st, getattr(st.module, st.attr), run)
        original = getattr(st.module, st.attr)
        with calls_of(original) as n_orig:
            got = _per_call(st, st.stub, run)
        assert want and got == want, st.name
        assert n_orig[0] == 0, st.name


def test_profile_run_reports_every_stage():
    """``ss_profile.run`` at the tiny widths on the CPU: the JAX package's
    report (baseline, a row a stage, the config) with the port's counts, and
    its markdown table."""
    import audiojax_torch.models.mossformer2_ss as SS

    cfg = SS.MossFormer2SsConfig(**TINY["mossformer2_ss"])
    report = ss_profile.run(seconds=1, iters=1, repeats=2, cfg=cfg, device="cpu")
    assert [r["name"] for r in report["stages"]] == [s.name for s in jss.build_stages(cfg)]
    assert report["config"] == {"seconds": 1, "dtype": "float32", "chip": "cpu"}
    assert report["baseline"]["latency_s"] > 0 and report["baseline"]["spread_s"] >= 0
    for r in report["stages"]:
        assert r["stub_calls"] > 0 and r["original_calls"] == 0 and r["spread_s"] >= 0
    md = ss_profile.to_markdown(report)
    assert md.startswith("Baseline: RTF") and md.count("\n| ") == 1 + len(report["stages"])


def test_output_specs_records_the_first_call():
    import audiojax_torch.models.zipenhancer as ZM

    cfg = ZM.ZipEnhancerConfig(**{**TINY["zipenhancer"], "fold_window": FOLD})
    params = ZM.init_zipenhancer(0, cfg, "cpu")
    audio = torch.from_numpy(_clip(2 * FOLD))
    encoder = ZM.dense_encoder
    specs = output_specs(lambda: ZM.make_zipenhancer(cfg)(params, audio), ZM,
                         ("dense_encoder", "decoder_pair"))
    t = FOLD // cfg.hop + 1
    assert specs["dense_encoder"] == ((2, t, (cfg.f_bins + 1) // 2, cfg.channels), torch.float32)
    assert specs["decoder_pair"] == (((2, t, cfg.f_bins), torch.float32),
                                     ((2, t, cfg.f_bins, 2), torch.float32))
    assert ZM.dense_encoder is encoder  # restored
    with pytest.raises(ValueError, match="never ran"):
        output_specs(lambda: None, ZM, ("dense_encoder",))
