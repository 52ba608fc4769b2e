"""The port's checkpoint importers against audiojax.importers.

Each family's synthetic upstream-layout dict (``test_torch_ckpt_builders``)
goes through both packages' ``import_checkpoint``.  GTCRN, UL-UNAS, NKF,
SDAEC and Deep-Echo run at their defaults, the others at the tiny widths of
the port's model tests (the DFSMN-AEC cascade: its default SDAEC backend and
DFSMN's tiny mask net).

Trees: the same key paths and shapes, float32 everywhere, and values equal
bit for bit — both packages run the same float64 numpy recipes and cast
once.  Forward: the port's ``Session`` on its tree (CPU) against the JAX
``Session`` on the JAX tree, ≥ 40 dB int16 SNR for each source, with a
reference output of at least 100 LSB RMS so that the gate measures
something; the echo cancellers take a (near, far) pair.  ZipEnhancer's clip starts with
201 silent samples: the first
STFT frame's phase feature is otherwise the sign of rounding noise
(``tests/test_torch_zipenhancer.py``).  Drift fails closed in both
packages, with equal messages and equal JSON reports.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiojax.importers import import_checkpoint as jimport
from audiojax.models import deep_echo as JDE
from audiojax.models import dfsmn as JDF
from audiojax.models import dfsmn_aec as JDA
from audiojax.models import gtcrn as JG
from audiojax.models import h_gtcrn as JHG
from audiojax.models import melband_roformer as JMB
from audiojax.models import mossformer2_se as JSE
from audiojax.models import mossformer2_ss as JSS
from audiojax.models import mossformer_sr as JSR
from audiojax.models import mossformergan_se as JGAN
from audiojax.models import nkf_aec as JNKF
from audiojax.models import sdaec as JSD
from audiojax.models import ul_unas as JUL
from audiojax.models import zipenhancer as JZIP
from audiojax.runtime import registry as jregistry
from audiojax.runtime.session import Session as JSession
from reference_loader import snr_db
from test_importers import (_gtcrn_state_dict, _h_gtcrn_state_dict, _m2se_state_dict,
                            _sdaec_state_dict, _ul_unas_state_dict)
from test_melband import _upstream_sd
from test_torch_ckpt_builders import (BUILDERS, TINY, flat_tree, import_kwargs,  # noqa: F401
                                     one_thread, tiny_config)

from audiojax_torch.importers import import_checkpoint as timport
from audiojax_torch.importers.common import KeyTracker, unwrap_state_dict
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.session import Session as TSession

MIN_SNR_DB = 40.0
MIN_REF_RMS = 100.0  # LSB
FAMILIES = sorted(BUILDERS)
JCONFIGS = {"gtcrn": JG.GtcrnConfig, "mossformergan_se": JGAN.MossFormerGanConfig,
            "zipenhancer": JZIP.ZipEnhancerConfig, "mossformer2_ss": JSS.MossFormer2SsConfig,
            "dfsmn": JDF.DfsmnConfig, "mossformer2_se": JSE.MossFormer2SeConfig,
            "ul_unas": JUL.UlUnasConfig, "nkf_aec": JNKF.NkfConfig, "sdaec": JSD.SdaecConfig,
            "deep_echo": JDE.DeepEchoConfig, "dfsmn_aec": JDA.DfsmnAecConfig,
            "melband_roformer": JMB.MelBandConfig, "melband_roformer_stereo": JMB.MelBandConfig,
            "mossformer2_sr": JSR.MossFormerSrConfig, "h_gtcrn": JHG.HGtcrnConfig}
SEEDS = {"gtcrn": 11, "mossformergan_se": 12, "zipenhancer": 13, "mossformer2_ss": 14,
         "dfsmn": 15, "mossformer2_se": 16, "ul_unas": 17, "nkf_aec": 18, "sdaec": 19,
         "deep_echo": 20, "dfsmn_aec": 21, "melband_roformer": 22,
         "melband_roformer_stereo": 23, "mossformer2_sr": 24, "h_gtcrn": 25}


def _configs(name):
    return JCONFIGS[name](**TINY[name]), tiny_config(name)


def assert_trees_equal(jtree, ttree):
    """Same key paths, shapes and float32 dtype; values equal bit for bit."""
    jf, tf = flat_tree(jtree), flat_tree(ttree)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert jf[k].dtype == tf[k].dtype == np.float32, k
        assert jf[k].shape == tf[k].shape, k
        np.testing.assert_array_equal(jf[k].view(np.uint32), tf[k].view(np.uint32), err_msg=k)


@pytest.fixture(scope="module")
def imported():
    """name → (JAX config, port config, state dict, JAX tree, port tree)."""
    out = {}
    for name in FAMILIES:
        jcfg, tcfg = _configs(name)
        sd = BUILDERS[name](tcfg, seed=SEEDS[name])
        out[name] = (jcfg, tcfg, sd, jimport(name, sd, **import_kwargs(name, jcfg)),
                     timport(name, sd, **import_kwargs(name, tcfg)))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_trees_equal_jax(imported, name):
    _, _, _, jtree, ttree = imported[name]
    assert_trees_equal(jtree, ttree)


def test_gtcrn_builder_keys_are_the_jax_tests():
    """The GTCRN builder's keys and shapes are ``_gtcrn_state_dict``'s, plus the ERB bank."""
    ours = BUILDERS["gtcrn"](seed=0)
    theirs = _gtcrn_state_dict()
    assert sorted(set(ours) - set(theirs)) == ["erb.erb_fc.weight", "erb.ierb_fc.weight"]
    assert not set(theirs) - set(ours)
    assert all(tuple(ours[k].shape) == tuple(theirs[k].shape) for k in theirs)


def _nkf_key_shapes(cfg) -> dict:
    """The key set of the JAX tests' NKF KGNet replica, from the same torch modules."""
    nn = torch.nn
    d_in, fc, rnn = 2 * cfg.filter_order + 1, cfg.fc_dim, cfg.rnn_dim
    mods = {"kg_net.fc_in.0": (d_in, fc), "kg_net.fc_out.0": (rnn, fc),
            "kg_net.fc_out.2": (fc, cfg.filter_order)}
    out = {f"{k}.linear_{part}.{n}": tuple(v.shape) for k, (i, o) in mods.items()
           for part in ("real", "imag") for n, v in nn.Linear(i, o).state_dict().items()}
    out.update({f"{k}.prelu.weight": (1,) for k in ("kg_net.fc_in.1", "kg_net.fc_out.1")})
    out.update({f"kg_net.complex_gru.gru_{part}.{n}": tuple(v.shape) for part in ("r", "i")
                for n, v in nn.GRU(fc, rnn, batch_first=True).state_dict().items()})
    return out


def _deep_echo_key_shapes(c=20, order=10) -> dict:
    """The key set of the JAX tests' inline Deep-Echo builder
    (``tests/test_importers.py:423-465``), from the same torch modules."""
    nn = torch.nn
    out = {}

    def conv2d(key, cin, cout, ksz):
        out.update({f"{key}.{n}": tuple(v.shape) for n, v in nn.Conv2d(cin, cout, ksz)
                    .state_dict().items()})

    def iccrn_ln(key, ch, f):
        out.update({f"{key}.w": (1, ch, f, 1), f"{key}.b": (1, ch, f, 1)})

    def ch_lstm(key, cin, feat, o, bi, layers=1):
        out.update({f"{key}.lstm2.{n}": tuple(v.shape) for n, v in
                    nn.LSTM(cin, feat, num_layers=layers, bidirectional=bi).state_dict().items()})
        out.update({f"{key}.linear.{n}": tuple(v.shape) for n, v in
                    nn.Linear((2 if bi else 1) * feat, o).state_dict().items()})

    def cfb(key, cin):
        conv2d(f"{key}.conv_gate", cin, c, (1, 1))
        conv2d(f"{key}.conv_input", cin, c, (1, 1))
        conv2d(f"{key}.conv", c, c, (3, 1))
        for ln, ch in (("LN0", cin), ("LN1", c), ("LN2", c)):
            iccrn_ln(f"{key}.{ln}", ch, 160)
        iccrn_ln(f"{key}.ceps_unit.LN", 2 * c, 81)
        ch_lstm(f"{key}.ceps_unit.ch_lstm_f", 2 * c, c, 2 * c, bi=True)

    ch_lstm("in_ch_lstm", 4, c, c, bi=True)
    conv2d("in_conv", 4 + c, c, (1, 1))
    cfb("cfb_e1", c)
    iccrn_ln("ln", c, 160)
    ch_lstm("ch_lstm", c, 2 * c, c, bi=False, layers=2)
    cfb("cfb_d1", c)
    ch_lstm("out_ch_lstm", 2 * c, c, 2 * c, bi=False)
    conv2d("out_conv", 3 * c, 2 * order, (1, 1))
    return out


def _dfsmn_aec_key_shapes(cfg) -> dict:
    """The JAX tests' cascade union (``tests/test_importers.py:550-578``):
    ``_sdaec_state_dict`` plus the mask net's and the VAD head's keys."""
    out = {k: tuple(v.shape) for k, v in _sdaec_state_dict().items()}
    feat, h, bins = 3 * cfg.n_mels, cfg.hidden, cfg.mask_bins
    out.update({"linear1.linear.weight": (h, feat), "linear1.linear.bias": (h,),
                "linear2.linear.weight": (bins, h), "linear2.linear.bias": (bins,)})
    if cfg.output_vad:
        out.update({"linear3.linear.weight": (1, h), "linear3.linear.bias": (1,)})
    for i in range(cfg.depth):
        out.update({f"deepfsmn.{i}.linear.weight": (h, h), f"deepfsmn.{i}.linear.bias": (h,),
                    f"deepfsmn.{i}.project.weight": (h, h),
                    f"deepfsmn.{i}.conv1.weight": (h, 1, cfg.lorder, 1)})
    return out


@pytest.mark.parametrize("name", ["mossformer2_se", "ul_unas", "nkf_aec", "sdaec", "deep_echo",
                                  "dfsmn_aec"])
def test_builder_keys_are_the_jax_tests(name):
    """The MossFormer2-SE, UL-UNAS, NKF, SDAEC, Deep-Echo and DFSMN-AEC
    builders' keys and shapes are those of the JAX tests' ``_m2se_state_dict``,
    ``_ul_unas_state_dict``, NKF replica, ``_sdaec_state_dict``, inline
    Deep-Echo builder and cascade union (with the VAD head)."""
    cfg = tiny_config(name)
    if name == "dfsmn_aec":
        cfg = dataclasses.replace(cfg, output_vad=True)
    ours = {k: tuple(v.shape) for k, v in BUILDERS[name](cfg, seed=0).items()}
    if name == "mossformer2_se":
        theirs = {k: tuple(v.shape)
                  for k, v in _m2se_state_dict(JCONFIGS[name](**TINY[name])).items()}
    elif name == "ul_unas":
        theirs = {k: tuple(v.shape) for k, v in _ul_unas_state_dict().items()}
    elif name == "sdaec":
        theirs = {k: tuple(v.shape) for k, v in _sdaec_state_dict().items()}
    elif name == "deep_echo":
        theirs = _deep_echo_key_shapes()
    elif name == "dfsmn_aec":
        theirs = _dfsmn_aec_key_shapes(cfg)
    else:
        theirs = _nkf_key_shapes(cfg)
    assert ours == theirs


def _sr_key_shapes(cfg) -> dict:
    """The key set of the JAX tests' inline MossFormer2-SR builder
    (``tests/test_importers.py:test_import_mossformer_sr_structure_and_forward``)."""
    mn, mm = "mask_net", "mask_net.mdl.intra_mdl.mossformerM"
    d, qk, vu, inner, k = cfg.dim, cfg.qk_dim, cfg.vu_dim, cfg.fsmn_inner, cfg.dw_kernel
    out = {}

    def lin(key, o, i, bias=True, k1=False):
        out[f"{key}.weight"] = (o, i, 1) if k1 else (o, i)
        if bias:
            out[f"{key}.bias"] = (o,)

    def ffconvm(key, o, i, scale_norm=True):
        if scale_norm:
            out[f"{key}.mdl.0.g"] = (1,)
        else:
            out[f"{key}.mdl.0.weight"] = out[f"{key}.mdl.0.bias"] = (i,)
        lin(f"{key}.mdl.1", o, i)
        out[f"{key}.mdl.3.sequential.1.conv.weight"] = (o, 1, k)

    out[f"{mn}.norm.weight"] = out[f"{mn}.norm.bias"] = (cfg.n_mels,)
    lin(f"{mn}.conv1d_encoder", d, cfg.n_mels, k1=True)
    out[f"{mn}.pos_enc.scale"] = (1,)
    for i in range(cfg.depth):
        fl, fb = f"{mm}.layers.{i}", f"{mm}.fsmn.{i}"
        ffconvm(f"{fl}.to_hidden", 2 * vu, d)
        ffconvm(f"{fl}.to_qk", qk, d)
        out[f"{fl}.qk_offset_scale.gamma"] = out[f"{fl}.qk_offset_scale.beta"] = (4, qk)
        ffconvm(f"{fl}.to_out", d, vu)
        lin(f"{fb}.conv1.0", inner, d, k1=True)
        out[f"{fb}.conv1.1.weight"] = (1,)
        for nrm in ("norm1", "norm2"):
            out[f"{fb}.{nrm}.weight"] = out[f"{fb}.{nrm}.bias"] = (inner,)
        ffconvm(f"{fb}.gated_fsmn.to_u", inner, inner, scale_norm=False)
        ffconvm(f"{fb}.gated_fsmn.to_v", inner, inner, scale_norm=False)
        lin(f"{fb}.gated_fsmn.fsmn.linear", inner, inner)
        lin(f"{fb}.gated_fsmn.fsmn.project", inner, inner, bias=False)
        out[f"{fb}.gated_fsmn.fsmn.conv1.weight"] = (inner, 1, 2 * cfg.lorder - 1, 1)
        lin(f"{fb}.conv2", d, inner, k1=True)
    for nrm in ("mdl.intra_mdl.norm", "mdl.intra_norm"):
        out[f"{mn}.{nrm}.weight"] = out[f"{mn}.{nrm}.bias"] = (d,)
    out[f"{mn}.prelu.weight"] = (1,)
    lin(f"{mn}.conv1d_out", d, d, k1=True)
    lin(f"{mn}.output.0", d, d, k1=True)
    lin(f"{mn}.output_gate.0", d, d, k1=True)
    lin(f"{mn}.conv1_decoder", cfg.n_mels, d, bias=False, k1=True)
    ch = cfg.gen_channels
    out["generator.conv_pre.weight"], out["generator.conv_pre.bias"] = (ch, cfg.n_mels, 7), (ch,)
    for i, kk in enumerate(cfg.gen_up_kernels):
        out[f"generator.snakes.{i}.alpha"] = (ch,)
        out[f"generator.ups.{i}.weight_v"] = (ch, ch // 2, kk)
        out[f"generator.ups.{i}.weight_g"] = (ch, 1, 1)
        out[f"generator.ups.{i}.bias"] = (ch // 2,)
        ch //= 2
        for j, rk in enumerate(cfg.gen_res_kernels):
            base = f"generator.resblocks.{i * len(cfg.gen_res_kernels) + j}"
            for jj in range(len(cfg.gen_res_dilations)):
                for n in (1, 2):
                    out[f"{base}.convs{n}_activates.{jj}.alpha"] = (ch,)
                    out[f"{base}.convs{n}.{jj}.weight"] = (ch, ch, rk)
                    out[f"{base}.convs{n}.{jj}.bias"] = (ch,)
    out["generator.snake_post.alpha"] = (ch,)
    out["generator.conv_post.weight"], out["generator.conv_post.bias"] = (1, ch, 7), (1,)
    return out


@pytest.mark.parametrize("name,checkpoint_channels", [
    ("melband_roformer", None), ("melband_roformer_stereo", None), ("melband_roformer", 2),
    ("mossformer2_sr", None), ("h_gtcrn", None)])
def test_new_family_builder_keys_are_the_jax_tests(name, checkpoint_channels):
    """The Mel-Band builder's keys and shapes are ``_upstream_sd``'s (mono,
    stereo, and a stereo checkpoint for the mono config), SR's the inline SR
    builder's, H-GTCRN's ``_h_gtcrn_state_dict``'s plus the ERB bank."""
    cfg = tiny_config(name)
    kw = {} if checkpoint_channels is None else {"checkpoint_channels": checkpoint_channels}
    ours = {k: tuple(v.shape) for k, v in BUILDERS[name](cfg, seed=0, **kw).items()}
    if name.startswith("melband"):
        jcfg = JCONFIGS[name](**TINY[name])
        widths = JMB.band_layout(jcfg)[1]
        stereo = (JMB.band_layout(dataclasses.replace(jcfg, channels=2))[1]
                  if checkpoint_channels else None)
        theirs = {k: tuple(v.shape)
                  for k, v in _upstream_sd(jcfg, widths, stereo_widths=stereo).items()}
    elif name == "mossformer2_sr":
        theirs = _sr_key_shapes(cfg)
    else:
        theirs = {k: tuple(v.shape) for k, v in _h_gtcrn_state_dict().items()}
        theirs.update({"erb.erb_fc.weight": (64, 192), "erb.ierb_fc.weight": (192, 64)})
    assert ours == theirs


def test_melband_stereo_checkpoint_folds_like_jax():
    """A stereo checkpoint for the mono config: both importers fold L/R, bit for bit."""
    cfg = tiny_config("melband_roformer")
    sd = BUILDERS["melband_roformer"](cfg, seed=4, checkpoint_channels=2)
    jtree = jimport("melband_roformer", sd, cfg=JMB.MelBandConfig(**TINY["melband_roformer"]))
    assert_trees_equal(jtree, timport("melband_roformer", sd, cfg=cfg))
    assert jtree["band_split"][0]["lin"]["w"].shape[0] == JMB.band_layout(
        JMB.MelBandConfig(**TINY["melband_roformer"]))[1][0]


def test_dfsmn_aec_cmvn_and_vad_head_equal_jax(tmp_path):
    """The cascade's optional parts: the CMVN fold into the first affine and
    the ``linear3`` VAD head, bit for bit against the JAX importer, every key
    read."""
    cfg = dataclasses.replace(tiny_config("dfsmn_aec"), output_vad=True, backend="deep_echo")
    jcfg = JDA.DfsmnAecConfig(**dataclasses.asdict(cfg))
    sd = BUILDERS["dfsmn_aec"](cfg, seed=5)
    rng = np.random.default_rng(3)
    cmvn = (rng.standard_normal(3 * cfg.n_mels).astype(np.float32),
            (rng.random(3 * cfg.n_mels) + 0.5).astype(np.float32))
    tt = timport("dfsmn_aec", sd, cfg=cfg, cmvn=cmvn, report_path=tmp_path / "r.json")
    assert_trees_equal(jimport("dfsmn_aec", sd, cfg=jcfg, cmvn=cmvn), tt)
    assert "vad_head" in tt and json.loads((tmp_path / "r.json").read_text())["unconsumed"] == []


def _clip(name, n, seed, channels=1):
    """One clip (channels, n) for a two-channel model, else (n,)."""
    if channels > 1:
        return np.stack([_clip(name, n, seed + 1000 * c) for c in range(channels)])
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    if name == "mossformer2_ss":  # two voices and noise
        x = (0.25 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t) ** 2
             + 0.2 * np.sin(2 * np.pi * 310 * t + 1.0) * np.cos(2 * np.pi * 2 * t) ** 2)
    else:
        x = 0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 3 * t)
    x = x + 0.05 * rng.standard_normal(n)
    if name == "zipenhancer":
        x[:201] = 0.0
    return np.round(x * 32767).astype(np.int16)


@pytest.mark.parametrize("name", FAMILIES)
def test_session_on_imported_tree_matches_jax(imported, name):
    """One window of each family's manifest (GTCRN, UL-UNAS, NKF, SS, DFSMN,
    SE, Mel-Band, SR and H-GTCRN 2 s, the GAN and ZipEnhancer 6 s unfolded at
    the tiny config) through both Sessions; NKF takes a (near, far) pair,
    stereo Mel-Band and H-GTCRN two channels.  Outputs are the input's
    length times the manifest's scale, with its output channels.  H-GTCRN
    holds the JAX package's own 20 dB gate for this family: float32 WPE is
    ill-conditioned, and the two packages part at 27.3–39.3 dB on its clips
    (``tests/test_torch_h_gtcrn.py``)."""
    jcfg, tcfg, _, jtree, ttree = imported[name]
    jspec, tspec = jregistry.get(name), tregistry.get(name)
    manifest = tspec.make_manifest(tcfg)
    clips = [_clip(name, 16000, SEEDS[name] + i, manifest.input_channels)
             for i in range(manifest.num_audio_inputs)]
    n_out = int(16000 * manifest.input_to_output_scale)
    shape = (n_out,) if manifest.output_channels == 1 else (manifest.output_channels, n_out)
    gate = 20.0 if name == "h_gtcrn" else MIN_SNR_DB
    ref = JSession(jspec.make_forward(jcfg), jax.tree.map(jnp.asarray, jtree),
                   jspec.make_manifest(jcfg)).process(*clips)
    out = TSession(tspec.make_module(params_from_numpy(ttree, device="cpu"), tcfg), manifest,
                   device="cpu").process(*clips)
    assert len(out.outputs) == len(ref.outputs) == manifest.output_sources
    for r, o in zip(ref.outputs, out.outputs):
        assert o.dtype == np.int16 and o.shape == r.shape == shape
        assert np.sqrt(np.mean(r.astype(np.float64) ** 2)) >= MIN_REF_RMS
        assert snr_db(r, o) >= gate


# ── fail-closed, in both packages ──────────────────────────────────────────


def _both(name, sd, tmp_path, **kw):
    """Import in both packages; returns (JAX outcome, port outcome, JAX report,
    port report), an outcome being the tree or the exception raised."""
    jcfg, tcfg = _configs(name)
    outcomes = []
    for tag, fn, cfg in (("jax", jimport, jcfg), ("port", timport, tcfg)):
        try:
            outcomes.append(fn(name, sd, report_path=tmp_path / f"{tag}.json", **kw,
                               **import_kwargs(name, cfg)))
        except (KeyError, ValueError) as e:
            outcomes.append(e)
    reports = [json.loads(p.read_text()) if p.exists() else None
               for p in (tmp_path / "jax.json", tmp_path / "port.json")]
    return (*outcomes, *reports)


@pytest.mark.parametrize("name", FAMILIES)
def test_extra_key_fails_closed(imported, name, tmp_path):
    sd = {**imported[name][2], "decoder.surplus.weight": torch.zeros(3)}
    je, te, jr, tr = _both(name, sd, tmp_path)
    assert isinstance(je, ValueError) and isinstance(te, ValueError)
    assert "decoder.surplus.weight" in str(te) and str(te) == str(je)
    assert tr == jr and tr["unconsumed"] == ["decoder.surplus.weight"]


@pytest.mark.parametrize("name", FAMILIES)
def test_extra_key_listed_when_not_strict(imported, name, tmp_path):
    sd = {**imported[name][2], "decoder.surplus.weight": torch.zeros(3)}
    jt, tt, jr, tr = _both(name, sd, tmp_path, strict=False)
    assert_trees_equal(jt, tt)
    assert_trees_equal(tt, imported[name][4])
    assert tr == jr and tr["unconsumed"] == ["decoder.surplus.weight"]


REQUIRED = {"gtcrn": "dpgrnn2.inter_rnn.rnn1.weight_hh_l0",
            "mossformergan_se": "blocks.0.inter_se.max_pool_layer.2.weight",
            "zipenhancer": "zip_enhancer.TSConformer.encoders.1.encoder.f_layers.0.norm.log_scale",
            "mossformer2_ss": "mossformer_ss.mask_net.mdl.intra_mdl.mossformerM.fsmn.1"
                              ".gated_fsmn.fsmn.conv.conv2.weight",
            "dfsmn": "deepfsmn.1.project.weight",
            "mossformer2_se": "mossformer_se.mdl.intra_mdl.mossformerM.fsmn.1"
                              ".gated_fsmn.fsmn.conv1.weight",
            "ul_unas": "dpgrnn.1.inter_rnn.rnn1.weight_hh_l0",
            "nkf_aec": "kg_net.fc_out.2.linear_imag.weight",
            "sdaec": "cfb_d3.ceps_unit.ch_lstm_f.lstm2.weight_hh_l0_reverse",
            "deep_echo": "ch_lstm.lstm2.weight_ih_l1",
            "dfsmn_aec": "deepfsmn.1.project.weight",
            "melband_roformer": "mask_estimators.0.to_freqs.3.0.2.weight",
            "melband_roformer_stereo": "band_split.to_features.5.0.gamma",
            "mossformer2_sr": "generator.resblocks.2.convs2.1.weight",
            "h_gtcrn": "decoder.de_convs.1.depth_conv.bn.running_var"}


@pytest.mark.parametrize("name", FAMILIES)
def test_missing_key_fails_closed(imported, name, tmp_path):
    sd = dict(imported[name][2])
    gone = REQUIRED[name]
    del sd[gone]
    je, te, jr, tr = _both(name, sd, tmp_path)
    assert isinstance(je, KeyError) and isinstance(te, KeyError)
    assert str(te) == str(je) and gone in str(te)
    assert jr is None and tr is None  # the import stopped before its report


def test_batch_counter_is_ignored(imported, tmp_path):
    """A BatchNorm step counter carries no weights: ignored, listed, not drift."""
    name = "zipenhancer"
    key = "zip_enhancer.dense_encoder.dense_conv_1.1.num_batches_tracked"
    sd = {**imported[name][2], key: torch.tensor(7)}
    jt, tt, jr, tr = _both(name, sd, tmp_path)
    assert_trees_equal(jt, tt)
    assert tr == jr and tr["ignored_buffers"] == [key] and tr["unconsumed"] == []


def test_moved_erb_bank_fails_closed(imported, tmp_path):
    sd = dict(imported["gtcrn"][2])
    sd["erb.erb_fc.weight"] = sd["erb.erb_fc.weight"] + 1e-3
    je, te, _, _ = _both("gtcrn", sd, tmp_path)
    assert isinstance(je, ValueError) and isinstance(te, ValueError)
    assert str(te) == str(je) and "erb.erb_fc.weight" in str(te)


@pytest.mark.parametrize("wrap", ["module_prefix", "state_dict"])
def test_wrapped_checkpoints_import_like_the_bare_dict(imported, wrap, tmp_path):
    name = "mossformer2_ss"
    sd = imported[name][2]
    ckpt = ({f"module.{k}": v for k, v in sd.items()} if wrap == "module_prefix"
            else {"state_dict": sd, "epoch": 3})
    jt, tt, jr, tr = _both(name, ckpt, tmp_path)
    assert_trees_equal(jt, tt)
    assert_trees_equal(tt, imported[name][4])
    assert tr == jr and tr["unconsumed"] == [] and tr["checkpoint_keys"] == len(sd)


def test_unwrap_keeps_the_tracker():
    """``import_checkpoint`` wraps the dict in a KeyTracker and each family
    importer unwraps it again: with nothing to strip, the tracker itself must
    come back, or the audit would see no key read."""
    tracker = KeyTracker({"a.weight": torch.zeros(1)})
    assert unwrap_state_dict(tracker) is tracker
    stripped = unwrap_state_dict(KeyTracker({"module.a.weight": torch.zeros(1)}))
    assert list(stripped) == ["a.weight"]


@pytest.mark.parametrize("name", ["melband_roformer", "mossformer2_sr", "h_gtcrn",
                                  "no_such_model"])
def test_unported_family_names_roadmap(imported, name):
    """Since the Mel-Band, SR and H-GTCRN slice every family has an importer:
    those three names reach their recipe (which refuses GTCRN's dict), and
    only a name no package serves is refused by name, with the JAX
    package's message listing every importer."""
    with pytest.raises((KeyError, ValueError)) as e:
        timport(name, imported["gtcrn"][2])
    unknown = "no importer registered" in str(e.value)
    assert unknown == (name == "no_such_model")
    if unknown:
        with pytest.raises(KeyError) as je:
            jimport(name, imported["gtcrn"][2])
        assert str(e.value) == str(je.value)
