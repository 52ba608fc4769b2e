"""Synthetic upstream-layout checkpoints for the fourteen families the port serves.

``build_<family>_state_dict(cfg, seed)`` returns a dict of CPU float32
tensors under the upstream module names, at any config (the defaults are
full width and depth).  The key sets are those of the JAX package's own
importer tests (``tests/test_importers.py``: ``_gtcrn_state_dict``,
``_ul_unas_state_dict``, ``_m2se_state_dict``, ``_sdaec_state_dict``, the NKF
KGNet replica, ``_h_gtcrn_state_dict``, the inline MossFormer2-SS,
MossFormerGAN-SE, ZipEnhancer, DFSMN, Deep-Echo, DFSMN-AEC cascade and
MossFormer2-SR builders, and ``tests/test_melband.py:_upstream_sd``), plus
GTCRN's and H-GTCRN's frozen ERB bank (``erb.erb_fc`` / ``erb.ierb_fc``, set
to the analytic bank the model bakes in; UL-UNAS's learned bank is set to it
too).
Values come from numpy's generator at ``seed``: weights uniform in
±1/sqrt(fan_in) (torch's default init), norm gains in [0.5, 1.5], small
shifts (the ICCRN LayerNorms' (1, C, F, 1) ``w`` and ``b`` too), BatchNorm
statistics as those tests draw them, LSTM weights uniform in ±1/sqrt(hidden)
(torch's), PReLU slopes 0.25
(NKF's 0.2 and 0.1, as its replica's), AffinePReLU gains N(1, 0.1), Snake
and RMSNorm gains in [0.5, 1.5].  NKF's
last KGNet layer (weight and bias) is drawn at ``RANDOM_GAIN_SCALE`` times
that bound, as the port's random init draws it: a Kalman gain of torch's
default scale makes the filter's recurrence overflow float32 at speech
levels.

This module imports torch, numpy and the port only, never JAX: the card's
``chip_smoke.py`` builds its checkpoints from it.  Its own tests check that
each builder's dict is read whole by the port's ``import_checkpoint`` and
gives the tree the port's model takes, at the tiny configs below.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from audiojax_torch.importers import import_checkpoint
from audiojax_torch.models.deep_echo import DeepEchoConfig, init_deep_echo_numpy
from audiojax_torch.models.dfsmn import DfsmnConfig, init_dfsmn_numpy
from audiojax_torch.models.dfsmn_aec import DfsmnAecConfig, init_dfsmn_aec_numpy, mask_net_config
from audiojax_torch.models.gtcrn import GtcrnConfig, init_gtcrn_numpy
from audiojax_torch.models.h_gtcrn import HGtcrnConfig, init_h_gtcrn_numpy
from audiojax_torch.models.melband_roformer import (MelBandConfig, band_layout,
                                                    init_melband_numpy)
from audiojax_torch.models.mossformer2_ss import MossFormer2SsConfig, init_mossformer2_ss_numpy
from audiojax_torch.models.mossformer2_se import MossFormer2SeConfig, init_mossformer2_se_numpy
from audiojax_torch.models.mossformer_sr import MossFormerSrConfig, init_mossformer_sr_numpy
from audiojax_torch.models.mossformergan_se import MossFormerGanConfig, init_mossformergan_numpy
from audiojax_torch.models.nkf_aec import RANDOM_GAIN_SCALE, NkfConfig, init_nkf_numpy
from audiojax_torch.models.sdaec import SdaecConfig, init_sdaec_numpy
from audiojax_torch.models.ul_unas import UlUnasConfig, init_ul_unas_numpy
from audiojax_torch.models.zipenhancer import ZipEnhancerConfig, init_zipenhancer_numpy
from audiojax_torch.nn.erb import erb_filters

# The tiny widths of the port's model tests (tests/test_torch_mossformergan.py,
# tests/test_torch_zipenhancer.py, tests/test_torch_mossformer2_ss.py,
# tests/test_torch_dfsmn.py, tests/test_torch_mossformer2_se.py), the
# cascade's mask net at DFSMN's; GTCRN, UL-UNAS (a fixed NAS plan), NKF,
# SDAEC and Deep-Echo are small at their defaults.
TINY = {
    "dfsmn": dict(depth=2, hidden=32, lorder=6),
    "gtcrn": {},
    "mossformergan_se": dict(emb_dim=16, emb_ks=2, uv_channels=24, n_blocks=1, dense_depth=2,
                             lorder=4, mf_hidden=32, mf_vdim=16, mf_qk=16, mf_rot=8,
                             dw_kernel=7, attn_heads=2, attn_q_ch=2, attn_v_ch=4,
                             fold_window=0),
    "zipenhancer": dict(channels=16, num_heads=2, query_head_dim=8, pos_head_dim=4,
                        value_head_dim=8, ff_hidden=24, nonlin_hidden=12, conv_kernel=7,
                        pos_dim=16, encoder_downsample=((1, 1), (2, 2)), fold_window=0),
    "mossformer2_ss": dict(dim=64, depth=2, group_size=16, qk_dim=32, vu_dim=96,
                           fsmn_inner=32, dw_kernel=5, rot_dim=8, lorder=5),
    "mossformer2_se": dict(dim=64, depth=2, group_size=16, qk_dim=32, vu_dim=96,
                           fsmn_inner=32, dw_kernel=5, rot_dim=8, lorder=5),
    "ul_unas": {},
    "nkf_aec": {},
    "sdaec": {},
    "deep_echo": {},
    "dfsmn_aec": dict(depth=2, hidden=32, lorder=6),
    "melband_roformer": dict(n_fft=256, hop=64, num_bands=8, dim=32, depth=1, heads=2,
                             dim_head=16, mlp_expansion=2, mask_depth=1),
    "melband_roformer_stereo": dict(n_fft=256, hop=64, num_bands=8, dim=32, depth=1, heads=2,
                                    dim_head=16, mlp_expansion=2, mask_depth=1, channels=2),
    "mossformer2_sr": dict(dim=64, depth=1, group_size=16, qk_dim=32, vu_dim=96,
                           fsmn_inner=32, dw_kernel=5, rot_dim=8, lorder=5, gen_channels=32,
                           gen_res_kernels=(3,), gen_res_dilations=(1, 3)),
    "h_gtcrn": {},
}
CONFIGS = {"gtcrn": GtcrnConfig, "mossformergan_se": MossFormerGanConfig,
           "zipenhancer": ZipEnhancerConfig, "mossformer2_ss": MossFormer2SsConfig,
           "dfsmn": DfsmnConfig, "mossformer2_se": MossFormer2SeConfig,
           "ul_unas": UlUnasConfig, "nkf_aec": NkfConfig, "sdaec": SdaecConfig,
           "deep_echo": DeepEchoConfig, "dfsmn_aec": DfsmnAecConfig,
           "melband_roformer": MelBandConfig, "melband_roformer_stereo": MelBandConfig,
           "mossformer2_sr": MossFormerSrConfig, "h_gtcrn": HGtcrnConfig}


def tiny_config(name: str):
    return CONFIGS[name](**TINY[name])


def import_kwargs(name: str, cfg) -> dict:
    """GTCRN's, H-GTCRN's and DFSMN's importers take no config; the others take ``cfg=``."""
    return {} if name in ("gtcrn", "h_gtcrn", "dfsmn") else {"cfg": cfg}


class _StateDict:
    """Fills an upstream-layout state dict from one numpy generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd: dict[str, torch.Tensor] = {}

    def put(self, key: str, a) -> None:
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def uniform(self, key: str, shape, lo: float, hi: float) -> None:
        self.put(key, self.rng.uniform(lo, hi, shape))

    def normal(self, key: str, shape, std: float, mean: float = 0.0) -> None:
        self.put(key, mean + std * self.rng.standard_normal(shape))

    def weight(self, key: str, shape, fan_in: int, bias: int | None = None) -> None:
        """``key.weight`` (and ``key.bias`` of ``bias`` entries) uniform in ±1/sqrt(fan_in)."""
        bound = 1.0 / math.sqrt(fan_in)
        self.uniform(f"{key}.weight", shape, -bound, bound)
        if bias is not None:
            self.uniform(f"{key}.bias", (bias,), -bound, bound)

    def linear(self, key: str, out: int, inp: int, bias: bool = True, k1: bool = False) -> None:
        """nn.Linear, or a 1×1 nn.Conv1d with ``k1``."""
        self.weight(key, (out, inp, 1) if k1 else (out, inp), inp, out if bias else None)

    def conv(self, key: str, out: int, inp: int, k: tuple, groups: int = 1,
             bias: bool = True) -> None:
        """nn.Conv{1,2}d: weight (out, in/groups, *k)."""
        fan_in = inp // groups * math.prod(k)
        self.weight(key, (out, inp // groups, *k), fan_in, out if bias else None)

    def deconv(self, key: str, inp: int, out: int, k: tuple, groups: int = 1) -> None:
        """nn.ConvTranspose2d: weight (in, out/groups, *k), torch's fan-in."""
        self.weight(key, (inp, out // groups, *k), out // groups * math.prod(k), out)

    def norm(self, key: str, shape, names=("weight", "bias")) -> None:
        """An affine norm's gain in [0.5, 1.5] and shift N(0, 0.05)."""
        self.uniform(f"{key}.{names[0]}", shape, 0.5, 1.5)
        self.normal(f"{key}.{names[1]}", shape, 0.05)

    def bn(self, key: str, c: int) -> None:
        """nn.BatchNorm2d in eval mode, with running statistics."""
        self.uniform(f"{key}.weight", (c,), 0.5, 1.5)
        self.uniform(f"{key}.bias", (c,), -0.3, 0.3)
        self.uniform(f"{key}.running_mean", (c,), -0.5, 0.5)
        self.uniform(f"{key}.running_var", (c,), 0.5, 2.0)
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def prelu(self, key: str, n: int = 1, slope: float = 0.25) -> None:
        self.put(f"{key}.weight", np.full((n,), slope))

    def lstm(self, key: str, inp: int, hidden: int, layers: int = 1,
             bidirectional: bool = False) -> None:
        """nn.LSTM: per layer (and direction) weight_ih / weight_hh / bias_ih /
        bias_hh, gate order i|f|g|o."""
        bound = 1.0 / math.sqrt(hidden)
        for layer in range(layers):
            d_in = inp if layer == 0 else hidden * (2 if bidirectional else 1)
            for suffix in ("", "_reverse") if bidirectional else ("",):
                for name, shape in ((f"weight_ih_l{layer}", (4 * hidden, d_in)),
                                    (f"weight_hh_l{layer}", (4 * hidden, hidden)),
                                    (f"bias_ih_l{layer}", (4 * hidden,)),
                                    (f"bias_hh_l{layer}", (4 * hidden,))):
                    self.uniform(f"{key}.{name}{suffix}", shape, -bound, bound)

    def gru(self, key: str, inp: int, hidden: int, bidirectional: bool = False) -> None:
        bound = 1.0 / math.sqrt(hidden)
        for suffix in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih_l0", (3 * hidden, inp)),
                                ("weight_hh_l0", (3 * hidden, hidden)),
                                ("bias_ih_l0", (3 * hidden,)), ("bias_hh_l0", (3 * hidden,))):
                self.uniform(f"{key}.{name}{suffix}", shape, -bound, bound)


# ── GTCRN ────────────────────────────────────────────────────────────────────


def build_gtcrn_state_dict(cfg: GtcrnConfig = GtcrnConfig(), seed: int = 0) -> dict:
    """Upstream gtcrn-main layout (``_gtcrn_state_dict`` of the JAX tests)."""
    s = _StateDict(seed)
    c, half = cfg.channels, cfg.channels // 2

    def conv_block(key, cin, cout, k, groups=1, deconv=False, last=False):
        if deconv:
            s.deconv(f"{key}.conv", cin, cout, k, groups)
        else:
            s.conv(f"{key}.conv", cout, cin, k, groups)
        s.bn(f"{key}.bn", cout)
        if not last:  # the last decoder block ends in tanh: no PReLU
            s.prelu(f"{key}.act")

    def gt_block(key, deconv=False):
        for name, cin, cout, k, g in (("point_conv1", 3 * half, c, (1, 1), 1),
                                      ("depth_conv", c, c, (3, 3), c),
                                      ("point_conv2", c, half, (1, 1), 1)):
            if deconv:
                s.deconv(f"{key}.{name}", cin, cout, k, g)
            else:
                s.conv(f"{key}.{name}", cout, cin, k, g)
        for name, ch in (("point_bn1", c), ("depth_bn", c), ("point_bn2", half)):
            s.bn(f"{key}.{name}", ch)
        s.prelu(f"{key}.point_act")
        s.prelu(f"{key}.depth_act")
        s.gru(f"{key}.tra.att_gru", half, c)
        s.linear(f"{key}.tra.att_fc", half, c)

    def dpgrnn(key):
        for sub in ("rnn1", "rnn2"):
            s.gru(f"{key}.intra_rnn.{sub}", half, c // 4, bidirectional=True)
            s.gru(f"{key}.inter_rnn.{sub}", half, half)
        for fc in ("intra_fc", "inter_fc"):
            s.linear(f"{key}.{fc}", c, c)
        for ln in ("intra_ln", "inter_ln"):
            s.norm(f"{key}.{ln}", (cfg.width, c))

    bank = erb_filters(cfg.n_low, cfg.n_erb, cfg.n_fft, scale=cfg.erb_scale)
    s.put("erb.erb_fc.weight", bank)
    s.put("erb.ierb_fc.weight", bank.T)
    conv_block("encoder.en_convs.0", 9, c, (1, 5))
    conv_block("encoder.en_convs.1", c, c, (1, 5), groups=2)
    for i in (2, 3, 4):
        gt_block(f"encoder.en_convs.{i}")
    dpgrnn("dpgrnn1")
    dpgrnn("dpgrnn2")
    for i in (0, 1, 2):
        gt_block(f"decoder.de_convs.{i}", deconv=True)
    conv_block("decoder.de_convs.3", c, c, (1, 5), groups=2, deconv=True)
    conv_block("decoder.de_convs.4", c, 2, (1, 5), deconv=True, last=True)
    return s.sd


# ── MossFormerGAN-SE ─────────────────────────────────────────────────────────


def build_mossformergan_se_state_dict(cfg: MossFormerGanConfig = MossFormerGanConfig(),
                                      seed: int = 0) -> dict:
    """ClearVoice SyncANet layout (the JAX tests' MossFormerGAN-SE builder)."""
    s = _StateDict(seed)
    c, f, uvc, k_mem = cfg.emb_dim, cfg.n_freqs, cfg.uv_channels, 2 * cfg.lorder - 1

    def dense(key):
        for i in range(cfg.dense_depth):
            s.conv(f"{key}.conv{i + 1}", c, c * (i + 1), (2, 3))
            s.norm(f"{key}.norm{i + 1}", (c,))
            s.prelu(f"{key}.prelu{i + 1}", c)
            fs = f"{key}.fsmn{i + 1}.fsmn"
            s.linear(f"{fs}.linear", c, c)
            s.linear(f"{fs}.project", c, c, bias=False)
            s.conv(f"{fs}.conv1", c, c, (k_mem, 1), groups=c, bias=False)

    def ffconvm(key, o, i):
        s.norm(f"{key}.mdl.0", (i,))
        s.linear(f"{key}.mdl.1", o, i)
        s.conv(f"{key}.mdl.3.sequential.1.conv", o, o, (cfg.dw_kernel,), groups=o, bias=False)

    s.conv("dense_encoder.conv_1.0", c, 3, (1, 1))
    s.norm("dense_encoder.conv_1.1", (c,))
    s.prelu("dense_encoder.conv_1.2", c)
    dense("dense_encoder.dilated_dense")
    s.conv("dense_encoder.conv_2.0", c, c, (1, 3))
    s.norm("dense_encoder.conv_2.1", (c,))
    s.prelu("dense_encoder.conv_2.2", c)

    for i in range(cfg.n_blocks):
        key = f"blocks.{i}"
        s.norm(f"{key}.intra_norm", (1, c, 1, 1), names=("gamma", "beta"))
        s.conv(f"{key}.Fconv", c * cfg.emb_ks, c, (1, cfg.emb_ks), groups=c)
        s.norm(f"{key}.inter_norm", (1, c, 1, 1), names=("gamma", "beta"))
        for pre in ("intra", "inter"):
            ffconvm(f"{key}.{pre}_to_u", uvc, c * cfg.emb_ks)
            ffconvm(f"{key}.{pre}_to_v", uvc, c * cfg.emb_ks)
            fs = f"{key}.{pre}_rnn.0"
            s.linear(f"{fs}.linear", uvc, uvc)
            s.linear(f"{fs}.project", uvc, uvc, bias=False)
            s.conv(f"{fs}.conv1", uvc, uvc, (k_mem,), groups=uvc, bias=False)
            s.weight(f"{key}.{pre}_linear", (uvc, c, cfg.emb_ks), c * cfg.emb_ks, c)
            mf = f"{key}.{pre}_mossformer"
            ffconvm(f"{mf}.to_hidden", cfg.mf_hidden, c)
            ffconvm(f"{mf}.to_qk", cfg.mf_qk, c)
            s.normal(f"{mf}.qk_offset_scale.gamma", (4, cfg.mf_qk), 0.1, mean=1.0)
            s.normal(f"{mf}.qk_offset_scale.beta", (4, cfg.mf_qk), 0.05)
            ffconvm(f"{mf}.to_out", c, cfg.mf_vdim)
            se = f"{key}.{pre}_se"
            for pool in ("avg_pool_layer", "max_pool_layer"):
                s.linear(f"{se}.{pool}.0", c // 4, c)
                s.linear(f"{se}.{pool}.2", c, c // 4)
        for j in range(cfg.attn_heads):
            for qkv, ch in (("Q", cfg.attn_q_ch), ("K", cfg.attn_q_ch), ("V", cfg.attn_v_ch)):
                m = f"{key}.attn_conv_{qkv}_{j}"
                s.conv(f"{m}.0", ch, c, (1, 1))
                s.prelu(f"{m}.1")
                s.norm(f"{m}.2", (1, ch, 1, f), names=("gamma", "beta"))
        s.conv(f"{key}.attn_concat_proj.0", c, cfg.attn_heads * cfg.attn_v_ch, (1, 1))
        s.prelu(f"{key}.attn_concat_proj.1")
        s.norm(f"{key}.attn_concat_proj.2", (1, c, 1, f), names=("gamma", "beta"))

    for dec in ("mask_decoder", "complex_decoder"):
        dense(f"{dec}.dense_block")
        s.conv(f"{dec}.sub_pixel.conv", 2 * c, c, (1, 3))
        s.norm(f"{dec}.norm", (c,))
        s.prelu(f"{dec}.prelu", c)
    s.conv("mask_decoder.conv_1", c, c, (1, 1))
    s.conv("mask_decoder.final_conv", 1, c, (1, 2))
    s.prelu("mask_decoder.prelu_out")
    s.conv("complex_decoder.conv", 2, c, (1, 2))
    return s.sd


# ── ZipEnhancer ──────────────────────────────────────────────────────────────


def build_zipenhancer_state_dict(cfg: ZipEnhancerConfig = ZipEnhancerConfig(),
                                 seed: int = 0) -> dict:
    """ModelScope Zipformer2 dual-path layout (the JAX tests' ZipEnhancer builder)."""
    s = _StateDict(seed)
    c = cfg.channels
    P, de = "zip_enhancer", "zip_enhancer.dense_encoder"

    def dense(key):
        for i in range(cfg.dense_depth):
            s.conv(f"{key}.dense_block.{i}.1", c, c * (i + 1), (2, 3))
            s.norm(f"{key}.dense_block.{i}.2", (c,))
            s.prelu(f"{key}.dense_block.{i}.3", c)

    def zlayer(key):
        h, qd, pdim, vd = cfg.num_heads, cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim
        s.linear(f"{key}.self_attn_weights.in_proj", h * (2 * qd + pdim), c)
        s.linear(f"{key}.self_attn_weights.linear_pos", h * pdim, cfg.pos_dim, bias=False)
        for ffn in ("feed_forward1", "feed_forward2", "feed_forward3"):
            s.linear(f"{key}.{ffn}.in_proj", cfg.ff_hidden, c)
            s.linear(f"{key}.{ffn}.out_proj", c, cfg.ff_hidden)
        s.linear(f"{key}.nonlin_attention.in_proj", 3 * cfg.nonlin_hidden, c)
        s.linear(f"{key}.nonlin_attention.out_proj", c, cfg.nonlin_hidden)
        for san in ("self_attn1", "self_attn2"):
            s.linear(f"{key}.{san}.in_proj", h * vd, c)
            s.linear(f"{key}.{san}.out_proj", c, h * vd)
        for cmn in ("conv_module1", "conv_module2"):
            s.linear(f"{key}.{cmn}.in_proj", 2 * c, c)
            s.conv(f"{key}.{cmn}.depthwise_conv", c, c, (cfg.conv_kernel,), groups=c)
            s.linear(f"{key}.{cmn}.out_proj", c, c)
        s.uniform(f"{key}.bypass_mid.bypass_scale", (c,), 0.0, 1.0)
        s.uniform(f"{key}.bypass.bypass_scale", (c,), 0.0, 1.0)
        s.normal(f"{key}.norm.bias", (c,), 0.05)
        s.normal(f"{key}.norm.log_scale", (1,), 0.1)

    s.conv(f"{de}.dense_conv_1.0", c, 2, (1, 1))
    s.norm(f"{de}.dense_conv_1.1", (c,))
    s.prelu(f"{de}.dense_conv_1.2", c)
    dense(f"{de}.dense_block")
    s.conv(f"{de}.dense_conv_2.0", c, c, (1, 3))
    s.norm(f"{de}.dense_conv_2.1", (c,))
    s.prelu(f"{de}.dense_conv_2.2", c)

    for i, (t_ds, f_ds) in enumerate(cfg.encoder_downsample):
        key = f"{P}.TSConformer.encoders.{i}"
        downsampled = t_ds > 1 or f_ds > 1
        inner = f"{key}.encoder" if downsampled else key
        zlayer(f"{inner}.f_layers.0")
        zlayer(f"{inner}.t_layers.0")
        s.uniform(f"{inner}.bypass_layers.0.bypass_scale", (c,), 0.0, 1.0)
        s.uniform(f"{inner}.bypass_layers.1.bypass_scale", (c,), 0.0, 1.0)
        if downsampled:
            s.uniform(f"{key}.out_combiner.bypass_scale", (c,), 0.0, 1.0)
            s.normal(f"{key}.downsample_t.bias", (t_ds,), 0.1)
            s.normal(f"{key}.downsample_f.bias", (f_ds,), 0.1)

    for dec, head in (("mask_decoder", "mask_conv"), ("phase_decoder", "phase_conv")):
        dense(f"{P}.{dec}.dense_block")
        s.conv(f"{P}.{dec}.{head}.0.conv1", 2 * c, c, (1, 3))
        s.norm(f"{P}.{dec}.{head}.1", (c,))
        s.prelu(f"{P}.{dec}.{head}.2", c)
    s.conv(f"{P}.mask_decoder.mask_conv.3", 1, c, (1, 2))
    s.conv(f"{P}.phase_decoder.phase_conv_r", 1, c, (1, 2))
    s.conv(f"{P}.phase_decoder.phase_conv_i", 1, c, (1, 2))
    return s.sd


# ── MossFormer2-SS ───────────────────────────────────────────────────────────


def build_mossformer2_ss_state_dict(cfg: MossFormer2SsConfig = MossFormer2SsConfig(),
                                    seed: int = 0) -> dict:
    """ClearVoice separation layout (the JAX tests' MossFormer2-SS builder)."""
    s = _StateDict(seed)
    P, mn = "mossformer_ss", "mossformer_ss.mask_net"
    mm = f"{mn}.mdl.intra_mdl.mossformerM"
    d, qk, vu, inner = cfg.dim, cfg.qk_dim, cfg.vu_dim, cfg.fsmn_inner

    def ffconvm(key, o, i, scale_norm=True):
        if scale_norm:
            s.uniform(f"{key}.mdl.0.g", (1,), 0.5, 1.5)
        else:
            s.norm(f"{key}.mdl.0", (i,))
        s.linear(f"{key}.mdl.1", o, i)
        s.conv(f"{key}.mdl.3.sequential.1.conv", o, o, (cfg.dw_kernel,), groups=o, bias=False)

    s.conv(f"{P}.enc.conv1d", d, 1, (cfg.enc_kernel,))
    s.weight(f"{P}.dec", (d, 1, cfg.enc_kernel), cfg.enc_kernel, 1)
    s.norm(f"{mn}.norm", (d,))
    s.linear(f"{mn}.conv1d_encoder", d, d, k1=True)
    s.uniform(f"{mn}.pos_enc.scale", (1,), 0.0, 1.0)
    for i in range(cfg.depth):
        fl = f"{mm}.layers.{i}"
        ffconvm(f"{fl}.to_hidden", 2 * vu, d)
        ffconvm(f"{fl}.to_qk", qk, d)
        s.normal(f"{fl}.qk_offset_scale.gamma", (4, qk), 0.1, mean=1.0)
        s.normal(f"{fl}.qk_offset_scale.beta", (4, qk), 0.05)
        ffconvm(f"{fl}.to_out", d, vu)
        fb = f"{mm}.fsmn.{i}"
        s.linear(f"{fb}.conv1.0", inner, d, k1=True)
        s.prelu(f"{fb}.conv1.1")
        s.norm(f"{fb}.norm1", (inner,))
        s.norm(f"{fb}.norm2", (inner,))
        ffconvm(f"{fb}.gated_fsmn.to_u", inner, inner, scale_norm=False)
        ffconvm(f"{fb}.gated_fsmn.to_v", inner, inner, scale_norm=False)
        s.linear(f"{fb}.gated_fsmn.fsmn.linear", inner, inner)
        s.linear(f"{fb}.gated_fsmn.fsmn.project", inner, inner, bias=False)
        for j in range(cfg.mem_depth):
            mem = f"{fb}.gated_fsmn.fsmn.conv"
            s.conv(f"{mem}.conv{j + 1}", inner, inner * (j + 1), (2 * cfg.lorder - 1, 1),
                   groups=inner, bias=False)
            s.norm(f"{mem}.norm{j + 1}", (inner,))
            s.prelu(f"{mem}.prelu{j + 1}", inner)
        s.linear(f"{fb}.conv2", d, inner, k1=True)
    s.norm(f"{mn}.mdl.intra_mdl.norm", (d,))
    s.norm(f"{mn}.mdl.intra_norm", (d,))
    s.prelu(f"{mn}.prelu")
    s.weight(f"{mn}.conv1d_out", (cfg.num_spks * d, d, 1), d, cfg.num_spks * d)
    s.linear(f"{mn}.output.0", d, d, k1=True)
    s.linear(f"{mn}.output_gate.0", d, d, k1=True)
    s.linear(f"{mn}.conv1_decoder", d, d, bias=False, k1=True)
    return s.sd


# ── DFSMN ────────────────────────────────────────────────────────────────────


def build_dfsmn_state_dict(cfg: DfsmnConfig = DfsmnConfig(), seed: int = 0) -> dict:
    """ModelScope ``speech_dfsmn_ans_psm_48k_causal`` layout (the inline
    builder of the JAX tests' ``test_import_dfsmn_matches_torch_semantics``):
    the FSMN memory is a (C, 1, lorder, 1) Conv2d weight."""
    s = _StateDict(seed)
    c = cfg.hidden
    s.linear("linear1.linear", c, cfg.n_mels)
    for i in range(cfg.depth):
        s.linear(f"deepfsmn.{i}.linear", c, c)
        s.linear(f"deepfsmn.{i}.project", c, c, bias=False)
        s.weight(f"deepfsmn.{i}.conv1", (c, 1, cfg.lorder, 1), cfg.lorder)
    s.linear("linear2.linear", cfg.stft_bins, c)
    return s.sd


# ── MossFormer2-SE ───────────────────────────────────────────────────────────


def _mossformer_mask_net(s: _StateDict, P: str, cfg, feat: int, out: int, spk_rows: int) -> None:
    """The ClearVoice MossFormer2 single-speaker mask net under ``P``:
    ``feat`` input features, ``out`` decoder rows, ``spk_rows`` rows of
    ``conv1d_out`` (MossFormer2-SE's ``_m2se_state_dict`` and the JAX
    tests' inline MossFormer2-SR builder)."""
    mm = f"{P}.mdl.intra_mdl.mossformerM"
    d, qk, vu, inner = cfg.dim, cfg.qk_dim, cfg.vu_dim, cfg.fsmn_inner

    def ffconvm(key, o, i, scale_norm=True):
        if scale_norm:
            s.uniform(f"{key}.mdl.0.g", (1,), 0.5, 1.5)
        else:
            s.norm(f"{key}.mdl.0", (i,))
        s.linear(f"{key}.mdl.1", o, i)
        s.conv(f"{key}.mdl.3.sequential.1.conv", o, o, (cfg.dw_kernel,), groups=o, bias=False)

    s.norm(f"{P}.norm", (feat,))
    s.linear(f"{P}.conv1d_encoder", d, feat, k1=True)
    s.uniform(f"{P}.pos_enc.scale", (1,), 0.0, 1.0)
    for i in range(cfg.depth):
        fl = f"{mm}.layers.{i}"
        ffconvm(f"{fl}.to_hidden", 2 * vu, d)
        ffconvm(f"{fl}.to_qk", qk, d)
        s.normal(f"{fl}.qk_offset_scale.gamma", (4, qk), 0.1, mean=1.0)
        s.normal(f"{fl}.qk_offset_scale.beta", (4, qk), 0.05)
        ffconvm(f"{fl}.to_out", d, vu)
        fb = f"{mm}.fsmn.{i}"
        s.linear(f"{fb}.conv1.0", inner, d, k1=True)
        s.prelu(f"{fb}.conv1.1")
        s.norm(f"{fb}.norm1", (inner,))
        ffconvm(f"{fb}.gated_fsmn.to_u", inner, inner, scale_norm=False)
        ffconvm(f"{fb}.gated_fsmn.to_v", inner, inner, scale_norm=False)
        s.linear(f"{fb}.gated_fsmn.fsmn.linear", inner, inner)
        s.linear(f"{fb}.gated_fsmn.fsmn.project", inner, inner, bias=False)
        s.conv(f"{fb}.gated_fsmn.fsmn.conv1", inner, inner, (2 * cfg.lorder - 1, 1),
               groups=inner, bias=False)
        s.norm(f"{fb}.norm2", (inner,))
        s.linear(f"{fb}.conv2", d, inner, k1=True)
    s.norm(f"{P}.mdl.intra_mdl.norm", (d,))
    s.norm(f"{P}.mdl.intra_norm", (d,))
    s.prelu(f"{P}.prelu")
    s.weight(f"{P}.conv1d_out", (spk_rows, d, 1), d, spk_rows)
    s.linear(f"{P}.output.0", d, d, k1=True)
    s.linear(f"{P}.output_gate.0", d, d, k1=True)
    s.linear(f"{P}.conv1_decoder", out, d, bias=False, k1=True)


def build_mossformer2_se_state_dict(cfg: MossFormer2SeConfig = MossFormer2SeConfig(),
                                    seed: int = 0) -> dict:
    """ClearVoice MossFormer2-SE-48K layout (``_m2se_state_dict`` of the JAX tests)."""
    s = _StateDict(seed)
    _mossformer_mask_net(s, "mossformer_se", cfg, 3 * cfg.n_mels, cfg.stft_bins, 2 * cfg.dim)
    return s.sd


# ── UL-UNAS ──────────────────────────────────────────────────────────────────


def build_ul_unas_state_dict(cfg: UlUnasConfig = UlUnasConfig(), seed: int = 0) -> dict:
    """The converted ULUNAS layout (``_ul_unas_state_dict`` of the JAX tests),
    at the model's fixed NAS plan."""
    from audiojax_torch.models.ul_unas import (_CHANNELS, _GROUPS, _KERNELS, _STRIDES, _TYPES,
                                               _WIDTHS)

    s = _StateDict(seed)

    def aprelu(key, c, w):
        s.normal(f"{key}.affine_weight", (1, c, 1, w), 0.1, mean=1.0)
        s.normal(f"{key}.affine_bias", (1, c, 1, w), 0.05)
        s.put(f"{key}.slope_weight", np.full((1, c, 1, 1), 0.25))

    def ctfa(key, c):
        s.gru(f"{key}.ta_gru", c, 2 * c)
        s.linear(f"{key}.ta_fc", c, 2 * c)
        s.gru(f"{key}.fa.gru", cfg.fa_ratio, cfg.fa_ratio, bidirectional=True)
        s.linear(f"{key}.fa.fc", cfg.fa_ratio, 2 * cfg.fa_ratio)

    def in_width(w, stride, deconv):
        return (w // 2 + 1 if deconv else w * 2 - 1) if stride == 2 else w

    def conv(key, cin, cout, k, groups, deconv):
        if deconv:
            s.deconv(key, cin, cout, k, groups)
        else:
            s.conv(key, cout, cin, k, groups)

    def block(key, btype, cin, cout, w, k, stride, groups, deconv=False, last=False):
        if btype == 0:
            conv(f"{key}.conv", cin, cout, k, groups, deconv)
            s.bn(f"{key}.bn", cout)
            if not last:
                aprelu(f"{key}.act", cout, w)
            ctfa(f"{key}.ctfa", cout)
            return
        pre = "pconv" if btype == 1 else "pconv1"
        s.conv(f"{key}.{pre}_conv", cout, cin, (1, 1), groups)
        s.bn(f"{key}.{pre}_bn", cout)
        aprelu(f"{key}.{pre}_act", cout, in_width(w, stride, deconv))
        conv(f"{key}.dconv_conv", cout, cout, k, cout, deconv)
        s.bn(f"{key}.dconv_bn", cout)
        if btype == 2 or not last:
            aprelu(f"{key}.dconv_act", cout, w)
        if btype == 1:
            ctfa(f"{key}.dconv_ctfa", cout)
            return
        s.conv(f"{key}.pconv2_conv", cout, cout, (1, 1), groups)
        s.bn(f"{key}.pconv2_bn", cout)
        ctfa(f"{key}.pconv2_ctfa", cout)

    bank = erb_filters(cfg.n_low, cfg.n_erb, cfg.n_fft)
    s.put("erb.erb_fc.weight", bank)
    s.put("erb.ierb_fc.weight", bank.T)
    n = len(_TYPES)
    cin = 1
    for i in range(n):
        block(f"encoder.en_convs.{i}", _TYPES[i], cin, _CHANNELS[i], _WIDTHS[i], _KERNELS[i],
              _STRIDES[i], _GROUPS[i])
        cin = _CHANNELS[i]
    for j, i in enumerate(range(n - 1, 0, -1)):
        block(f"decoder.de_convs.{j}", _TYPES[i], _CHANNELS[i], _CHANNELS[i - 1],
              _WIDTHS[i - 1], _KERNELS[i], _STRIDES[i], _GROUPS[i], deconv=True)
    block(f"decoder.de_convs.{n - 1}", _TYPES[0], _CHANNELS[0], 1, cfg.n_low + cfg.n_erb,
          _KERNELS[0], _STRIDES[0], _GROUPS[0], deconv=True, last=True)

    c, w = _CHANNELS[-1], _WIDTHS[-1]
    for key in ("dpgrnn.0", "dpgrnn.1"):
        for sub in ("rnn1", "rnn2"):
            s.gru(f"{key}.intra_rnn.{sub}", c // 2, c // 4, bidirectional=True)
            s.gru(f"{key}.inter_rnn.{sub}", c // 2, c // 2)
        for fc in ("intra_fc", "inter_fc"):
            s.linear(f"{key}.{fc}", c, c)
        for ln in ("intra_ln", "inter_ln"):
            s.norm(f"{key}.{ln}", (w, c))
    return s.sd


# ── NKF-AEC ──────────────────────────────────────────────────────────────────


def build_nkf_aec_state_dict(cfg: NkfConfig = NkfConfig(), seed: int = 0) -> dict:
    """The upstream KGNet layout (the NKF replica of the JAX tests'
    ``test_import_nkf_kgnet_matches_torch_replica``); the last layer drawn at
    ``RANDOM_GAIN_SCALE`` of torch's bound."""
    s = _StateDict(seed)
    d_in, fc, rnn, order = 2 * cfg.filter_order + 1, cfg.fc_dim, cfg.rnn_dim, cfg.filter_order
    for part in ("real", "imag"):
        s.linear(f"kg_net.fc_in.0.linear_{part}", fc, d_in)
        s.linear(f"kg_net.fc_out.0.linear_{part}", fc, rnn)
        key = f"kg_net.fc_out.2.linear_{part}"
        s.linear(key, order, fc)
        for name in ("weight", "bias"):
            s.sd[f"{key}.{name}"] = s.sd[f"{key}.{name}"] * RANDOM_GAIN_SCALE
    s.prelu("kg_net.fc_in.1.prelu", slope=0.2)
    s.prelu("kg_net.fc_out.1.prelu", slope=0.1)
    for part in ("r", "i"):
        s.gru(f"kg_net.complex_gru.gru_{part}", fc, rnn)
    return s.sd


# ── SDAEC, Deep-Echo and the DFSMN-AEC cascade ──────────────────────────────


def _iccrn_ln(s: _StateDict, key: str, ch: int, f: int) -> None:
    """An ICCRN LayerNorm: raw (1, C, F, 1) ``w`` and ``b``."""
    s.norm(key, (1, ch, f, 1), names=("w", "b"))


def _ch_lstm(s: _StateDict, key: str, cin: int, feat: int, out: int, bidirectional: bool,
             layers: int = 1) -> None:
    """CH_LSTM_F / CH_LSTM_T: an nn.LSTM as ``lstm2`` and its ``linear``."""
    s.lstm(f"{key}.lstm2", cin, feat, layers, bidirectional)
    s.linear(f"{key}.linear", out, (2 if bidirectional else 1) * feat)


def _cfb(s: _StateDict, key: str, cin: int, c: int, f: int) -> None:
    s.conv(f"{key}.conv_gate", c, cin, (1, 1))
    s.conv(f"{key}.conv_input", c, cin, (1, 1))
    s.conv(f"{key}.conv", c, c, (3, 1))
    _iccrn_ln(s, f"{key}.LN0", cin, f)
    _iccrn_ln(s, f"{key}.LN1", c, f)
    _iccrn_ln(s, f"{key}.LN2", c, f)
    _iccrn_ln(s, f"{key}.ceps_unit.LN", 2 * c, f // 2 + 1)
    _ch_lstm(s, f"{key}.ceps_unit.ch_lstm_f", 2 * c, c, 2 * c, bidirectional=True)


def _iccrn(s: _StateDict, c: int, f: int, levels: int, head: int) -> None:
    """The ICCRN trunk shared by SDAEC (5 levels, a 2-channel head) and
    Deep-Echo (1 level, a 2·order head)."""
    _ch_lstm(s, "in_ch_lstm", 4, c, c, bidirectional=True)
    s.conv("in_conv", c, 4 + c, (1, 1))
    for i in range(1, levels + 1):
        _cfb(s, f"cfb_e{i}", c, c, f)
    _iccrn_ln(s, "ln", c, f)
    _ch_lstm(s, "ch_lstm", c, 2 * c, c, bidirectional=False, layers=2)
    _cfb(s, f"cfb_d{levels}", c, c, f)
    for i in range(levels - 1, 0, -1):
        _cfb(s, f"cfb_d{i}", 2 * c, c, f)
    _ch_lstm(s, "out_ch_lstm", 2 * c, c, 2 * c, bidirectional=False)
    s.conv("out_conv", head, 3 * c, (1, 1))


def build_sdaec_state_dict(cfg: SdaecConfig = SdaecConfig(), seed: int = 0) -> dict:
    """The union of the upstream ICCRN and AlphaPredictor checkpoints
    (``_sdaec_state_dict`` of the JAX tests)."""
    s = _StateDict(seed)
    _iccrn(s, cfg.channels, cfg.f_bins, 5, 2)
    s.linear("linear1", 1, 2)
    s.linear("linear2", 1, cfg.alpha_k)
    return s.sd


def build_deep_echo_state_dict(cfg: DeepEchoConfig = DeepEchoConfig(), seed: int = 0) -> dict:
    """The upstream Deep-Echo layout (the inline builder of the JAX tests'
    ``test_import_deep_echo_structure_and_forward``)."""
    s = _StateDict(seed)
    _iccrn(s, cfg.channels, cfg.f_bins, 1, 2 * cfg.echo_order)
    return s.sd


def build_dfsmn_aec_state_dict(cfg: DfsmnAecConfig = DfsmnAecConfig(), seed: int = 0) -> dict:
    """The union of the backend's checkpoint and the ModelScope DFSMN-AEC net
    (the JAX tests' ``test_import_dfsmn_aec_cascade``), with the ``linear3``
    VAD head where ``cfg.output_vad``."""
    backend = {"sdaec": build_sdaec_state_dict, "deep_echo": build_deep_echo_state_dict,
               "nkf": build_nkf_aec_state_dict}[cfg.backend]
    sd = {**backend(seed=seed), **build_dfsmn_state_dict(mask_net_config(cfg), seed=seed + 1)}
    if cfg.output_vad:
        s = _StateDict(seed + 2)
        s.linear("linear3.linear", 1, cfg.hidden)
        sd.update(s.sd)
    return sd


# ── Mel-Band Roformer ────────────────────────────────────────────────────────


def build_melband_roformer_state_dict(cfg: MelBandConfig = MelBandConfig(), seed: int = 0,
                                      checkpoint_channels: int | None = None) -> dict:
    """Upstream lucidrains layout (``_upstream_sd`` of the JAX tests, the mask
    MLP at ``cfg.mask_depth`` hidden layers), its band widths those of
    ``checkpoint_channels`` (default: the config's): a stereo checkpoint for a
    mono config is the one the importer folds."""
    s = _StateDict(seed)
    ch = cfg.channels if checkpoint_channels is None else checkpoint_channels
    _, widths, _ = band_layout(dataclasses.replace(cfg, channels=ch))
    d, inner, hd = cfg.dim, cfg.mlp_expansion * cfg.dim, cfg.heads * cfg.dim_head
    for b, w in enumerate(widths):
        s.uniform(f"band_split.to_features.{b}.0.gamma", (w,), 0.5, 1.5)
        s.linear(f"band_split.to_features.{b}.1", d, w)
        for j in range(cfg.mask_depth):
            s.linear(f"mask_estimators.0.to_freqs.{b}.0.{2 * j}", inner, d if j == 0 else inner)
        s.linear(f"mask_estimators.0.to_freqs.{b}.0.{2 * cfg.mask_depth}", 2 * w, inner)
    for i in range(cfg.depth):
        for j in (0, 1):
            base = f"layers.{i}.{j}"
            s.uniform(f"{base}.layers.0.0.norm.gamma", (d,), 0.5, 1.5)
            s.linear(f"{base}.layers.0.0.to_qkv", 3 * hd, d, bias=False)
            s.linear(f"{base}.layers.0.0.to_gates", cfg.heads, d)
            s.linear(f"{base}.layers.0.0.to_out.0", d, hd, bias=False)
            s.uniform(f"{base}.layers.0.1.net.0.gamma", (d,), 0.5, 1.5)
            s.linear(f"{base}.layers.0.1.net.1", inner, d)
            s.linear(f"{base}.layers.0.1.net.4", d, inner)
            s.uniform(f"{base}.norm.gamma", (d,), 0.5, 1.5)
    return s.sd


# ── MossFormer2-SR ───────────────────────────────────────────────────────────


def build_mossformer2_sr_state_dict(cfg: MossFormerSrConfig = MossFormerSrConfig(),
                                    seed: int = 0) -> dict:
    """The mask net and HiFi-GAN generator (the JAX tests' inline MossFormer2-SR
    builder): the upsamplers in weight-norm form, Snake alphas in [0.5, 1.5]."""
    s = _StateDict(seed)
    _mossformer_mask_net(s, "mask_net", cfg, cfg.n_mels, cfg.n_mels, cfg.dim)
    ch = cfg.gen_channels
    s.conv("generator.conv_pre", ch, cfg.n_mels, (7,))
    for i, k in enumerate(cfg.gen_up_kernels):
        s.uniform(f"generator.snakes.{i}.alpha", (ch,), 0.5, 1.5)
        bound = 1.0 / math.sqrt(ch // 2 * k)
        s.uniform(f"generator.ups.{i}.weight_v", (ch, ch // 2, k), -bound, bound)
        s.uniform(f"generator.ups.{i}.weight_g", (ch, 1, 1), 0.5, 1.5)
        s.uniform(f"generator.ups.{i}.bias", (ch // 2,), -bound, bound)
        ch //= 2
        for j, rk in enumerate(cfg.gen_res_kernels):
            base = f"generator.resblocks.{i * len(cfg.gen_res_kernels) + j}"
            for jj in range(len(cfg.gen_res_dilations)):
                s.uniform(f"{base}.convs1_activates.{jj}.alpha", (ch,), 0.5, 1.5)
                s.conv(f"{base}.convs1.{jj}", ch, ch, (rk,))
                s.uniform(f"{base}.convs2_activates.{jj}.alpha", (ch,), 0.5, 1.5)
                s.conv(f"{base}.convs2.{jj}", ch, ch, (rk,))
    s.uniform("generator.snake_post.alpha", (ch,), 0.5, 1.5)
    s.conv("generator.conv_post", 1, ch, (7,))
    return s.sd


# ── H-GTCRN ──────────────────────────────────────────────────────────────────


def build_h_gtcrn_state_dict(cfg: HGtcrnConfig = HGtcrnConfig(), seed: int = 0) -> dict:
    """Upstream GTCRN-IVA layout (``_h_gtcrn_state_dict`` of the JAX tests):
    each GT block's conv/bn/act nested under its ConvBlock, regular convs in
    the decoder's GT blocks, an 18-channel first conv; plus the frozen ERB
    bank at scale 24.7."""
    s = _StateDict(seed)
    g = cfg.gtcrn_cfg
    c, half = g.channels, g.channels // 2

    def conv_block(key, cin, cout, k, groups=1, deconv=False, last=False):
        if deconv:
            s.deconv(f"{key}.conv", cin, cout, k, groups)
        else:
            s.conv(f"{key}.conv", cout, cin, k, groups)
        s.bn(f"{key}.bn", cout)
        if not last:
            s.prelu(f"{key}.act")

    def nested_gt(key):
        conv_block(f"{key}.point_conv1", 3 * half, c, (1, 1))
        conv_block(f"{key}.depth_conv", c, c, (3, 3), groups=c)
        conv_block(f"{key}.point_conv2", c, half, (1, 1), last=True)
        s.gru(f"{key}.tra.att_gru", half, c)
        s.linear(f"{key}.tra.att_fc", half, c)

    def dpgrnn(key):
        for sub in ("rnn1", "rnn2"):
            s.gru(f"{key}.intra_rnn.{sub}", half, c // 4, bidirectional=True)
            s.gru(f"{key}.inter_rnn.{sub}", half, half)
        for fc in ("intra_fc", "inter_fc"):
            s.linear(f"{key}.{fc}", c, c)
        for ln in ("intra_ln", "inter_ln"):
            s.norm(f"{key}.{ln}", (g.width, c))

    bank = erb_filters(g.n_low, g.n_erb, g.n_fft, scale=g.erb_scale)
    s.put("erb.erb_fc.weight", bank)
    s.put("erb.ierb_fc.weight", bank.T)
    conv_block("encoder.en_convs.0", 18, c, (1, 5))
    conv_block("encoder.en_convs.1", c, c, (1, 5), groups=2)
    for i in (2, 3, 4):
        nested_gt(f"encoder.en_convs.{i}")
    dpgrnn("dpgrnn1")
    dpgrnn("dpgrnn2")
    for i in (0, 1, 2):
        nested_gt(f"decoder.de_convs.{i}")
    conv_block("decoder.de_convs.3", c, c, (1, 5), groups=2, deconv=True)
    conv_block("decoder.de_convs.4", c, 2, (1, 5), deconv=True, last=True)
    return s.sd


BUILDERS = {
    "dfsmn": build_dfsmn_state_dict,
    "gtcrn": build_gtcrn_state_dict,
    "mossformergan_se": build_mossformergan_se_state_dict,
    "zipenhancer": build_zipenhancer_state_dict,
    "mossformer2_ss": build_mossformer2_ss_state_dict,
    "mossformer2_se": build_mossformer2_se_state_dict,
    "ul_unas": build_ul_unas_state_dict,
    "nkf_aec": build_nkf_aec_state_dict,
    "sdaec": build_sdaec_state_dict,
    "deep_echo": build_deep_echo_state_dict,
    "dfsmn_aec": build_dfsmn_aec_state_dict,
    "melband_roformer": build_melband_roformer_state_dict,
    "melband_roformer_stereo": build_melband_roformer_state_dict,
    "mossformer2_sr": build_mossformer2_sr_state_dict,
    "h_gtcrn": build_h_gtcrn_state_dict,
}


# ── the builders' own tests (no JAX) ─────────────────────────────────────────


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port while a module that imports this
    fixture runs.  The echo cancellers' forwards are Python loops of tens of
    thousands of small ops; beside the other test workers, each worker's
    thread pool made each op wait on the others (an SDAEC window on the CPU
    took ~100 s instead of ~3 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the bf16 plans against the JAX package on the CPU (ROADMAP §C): the port's
# bf16 output at least 15 dB from the JAX package's float32 one (its own bf16
# gate), and no more than BF16_MARGIN_DB further from it than the JAX
# package's bf16 is (measured at most 0.56 dB further, ZipEnhancer: XLA:CPU
# keeps fused bf16 chains in f32, the port rounds each op as the card does;
# with XLA's excess precision off the JAX package's own bf16 parts from its
# float32 as far); each family's gate against JAX bf16 is its own
BF16_VS_F32_DB = 15.0
BF16_MARGIN_DB = 1.0


def hold_bf16(ref32, ref16, out, gate_db: float, what: str) -> None:
    """The port's bf16 int16 output against the JAX package's bf16 one (at
    least ``gate_db``) and its float32 one (at least ``BF16_VS_F32_DB``, and
    no more than ``BF16_MARGIN_DB`` further from it than JAX bf16 is)."""
    from reference_loader import snr_db

    s16, s32, j32 = snr_db(ref16, out), snr_db(ref32, out), snr_db(ref32, ref16)
    rows = ", ".join(f"{snr_db(a, b):.2f}/{snr_db(c, b):.2f}/{snr_db(c, a):.2f}"
                     for a, b, c in zip(ref16, out, ref32))
    print(f"\n{what}: port bf16 vs JAX bf16 {s16:.2f} dB, vs JAX float32 {s32:.2f} dB; "
          f"JAX bf16 vs JAX float32 {j32:.2f} dB (by row, the same three: {rows})")
    assert out.dtype == np.int16 and out.shape == ref16.shape and np.any(out)
    assert s16 >= gate_db
    assert s32 >= BF16_VS_F32_DB
    assert s32 >= j32 - BF16_MARGIN_DB


INIT_NUMPY = {"gtcrn": init_gtcrn_numpy, "mossformergan_se": init_mossformergan_numpy,
              "zipenhancer": init_zipenhancer_numpy, "mossformer2_ss": init_mossformer2_ss_numpy,
              "dfsmn": init_dfsmn_numpy, "mossformer2_se": init_mossformer2_se_numpy,
              "ul_unas": init_ul_unas_numpy, "nkf_aec": init_nkf_numpy,
              "sdaec": init_sdaec_numpy, "deep_echo": init_deep_echo_numpy,
              "dfsmn_aec": init_dfsmn_aec_numpy, "melband_roformer": init_melband_numpy,
              "melband_roformer_stereo": init_melband_numpy,
              "mossformer2_sr": init_mossformer_sr_numpy, "h_gtcrn": init_h_gtcrn_numpy}
# leaves an imported tree has and a random one does not: UL-UNAS's learned ERB
# bank (random parameters take the analytic bank)
IMPORT_ONLY = {"ul_unas": {"/erb/fc": (192, 64), "/erb/ifc": (64, 192)}}


def flat_tree(tree, path="") -> dict:
    """A nested dict/list tree as {key path: numpy leaf} (CPU tensors too)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: np.asarray(tree)}
    return {k: v for key, sub in items for k, v in flat_tree(sub, f"{path}/{key}").items()}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_dict_is_read_whole(name, tmp_path):
    """Every key of the builder's dict is read by the port's importer (only
    BatchNorm's step counters are ignored), the dict holds CPU float32 weights,
    and the tree has the keys of the port's own init tree, with the shapes of
    its leaves or the (1,) and () that upstream PReLU slopes and scalar
    parameters have (and, for UL-UNAS, its imported ERB bank)."""
    import json

    cfg = tiny_config(name)
    sd = BUILDERS[name](cfg, seed=1)
    assert all(v.device.type == "cpu" for v in sd.values())
    assert all(v.dtype == torch.float32 for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    tree = import_checkpoint(name, sd, report_path=tmp_path / "report.json",
                             **import_kwargs(name, cfg))
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["unconsumed"] == []
    assert all(k.endswith("num_batches_tracked") for k in report["ignored_buffers"])
    assert report["checkpoint_keys"] == len(sd)
    assert report["consumed"] + len(report["ignored_buffers"]) == len(sd)

    want = {k: v.shape for k, v in flat_tree(INIT_NUMPY[name](0, cfg)).items()}
    want.update(IMPORT_ONLY.get(name, {}))
    got = {k: v.shape for k, v in flat_tree(tree).items()}
    assert sorted(got) == sorted(want)
    odd = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert all(g in ((1,), ()) for g, _ in odd.values()), odd


@pytest.mark.parametrize("name,key", [("mossformer2_ss", "mossformer_ss.enc.conv1d.weight"),
                                      ("dfsmn", "deepfsmn.1.conv1.weight")])
def test_builders_are_seeded(name, key):
    cfg = tiny_config(name)
    a, b = (BUILDERS[name](cfg, seed=3) for _ in range(2))
    c = BUILDERS[name](cfg, seed=4)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])

