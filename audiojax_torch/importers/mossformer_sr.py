"""MossFormer2-SR importer: the MossFormer mask net and the HiFi-GAN generator.

Counterpart of ``audiojax.importers.mossformer_sr``; it returns numpy.  The
checkpoint is the flat union of the mask net (``mask_net.*``) and the
generator (``generator.*``):

  generator.conv_pre / conv_post              7-tap convs
  generator.snakes.{i}.alpha, snake_post      Snake activations
  generator.ups.{i}                           ConvTranspose1d upsamplers
  generator.resblocks.{i·nk + j}.convs1/convs1_activates/convs2/…

A conv's weight is the plain ``weight`` or its weight-norm pair (``weight_g``
· ``weight_v`` / ‖``weight_v``‖), composed in float64.  The mask net takes
MossFormer2-SE's FLASH / FSMN recipes and its speaker-0 tail fold.
"""
from __future__ import annotations

import numpy as np

from ..models.mossformer_sr import MossFormerSrConfig
from .common import conv1d_w, deconv_kernel, to_np, unwrap_state_dict
from .mossformer2_se import _dense_k1, _flash, _gated_fsmn

__all__ = ["import_mossformer_sr"]


def _weight(sd, key):
    """Plain or weight-norm (weight_g · weight_v / ‖weight_v‖) conv weight."""
    if f"{key}.weight" in sd:
        return to_np(sd[f"{key}.weight"])
    g = to_np(sd[f"{key}.weight_g"])
    v = to_np(sd[f"{key}.weight_v"])
    norm = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _conv(sd, key, *, deconv=False):
    w = _weight(sd, key)
    p = {"w": deconv_kernel(w, 1).astype(np.float32) if deconv else conv1d_w(w)}
    if f"{key}.bias" in sd:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def _alpha(sd, key):
    return {"alpha": to_np(sd[f"{key}.alpha"]).reshape(-1).astype(np.float32)}


def import_mossformer_sr(ckpt, cfg=None):
    """MossFormer2-SR state dict (or a wrapper of one) → numpy tree."""
    cfg = cfg or MossFormerSrConfig()
    sd = unwrap_state_dict(ckpt)
    mn = "mask_net"
    mm = f"{mn}.mdl.intra_mdl.mossformerM"
    d = cfg.dim

    # single-speaker tail fold (MossFormer2-SE's recipe)
    spk_w = to_np(sd[f"{mn}.conv1d_out.weight"])[:d, :, 0]
    spk_b = to_np(sd[f"{mn}.conv1d_out.bias"])[:d]
    gate_w = np.concatenate([to_np(sd[f"{mn}.output.0.weight"]),
                             to_np(sd[f"{mn}.output_gate.0.weight"])], axis=0)[..., 0]
    gate_b = np.concatenate([to_np(sd[f"{mn}.output.0.bias"]),
                             to_np(sd[f"{mn}.output_gate.0.bias"])])

    def norm(key):
        return {"g": to_np(sd[f"{key}.weight"]).astype(np.float32),
                "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}

    params = {
        "front_norm": norm(f"{mn}.norm"),
        "front": _dense_k1(sd, f"{mn}.conv1d_encoder"),
        "pos_scale": to_np(sd[f"{mn}.pos_enc.scale"]).reshape(()).astype(np.float32),
        "mm_norm": norm(f"{mn}.mdl.intra_mdl.norm"),
        "intra_norm": norm(f"{mn}.mdl.intra_norm"),
        "tail_alpha": to_np(sd[f"{mn}.prelu.weight"]).reshape(()).astype(np.float32),
        "tail_gate": {"w": (gate_w @ spk_w).T.astype(np.float32),
                      "b": (gate_w @ spk_b + gate_b).astype(np.float32)},
        "decoder": _dense_k1(sd, f"{mn}.conv1_decoder", bias=False),
    }
    for i in range(cfg.depth):
        params[f"flash{i}"] = _flash(sd, f"{mm}.layers.{i}")
        params[f"fsmn{i}"] = _gated_fsmn(sd, f"{mm}.fsmn.{i}")

    # HiFi-GAN generator
    nk = len(cfg.gen_res_kernels)
    gen = {"pre": _conv(sd, "generator.conv_pre")}
    for i in range(len(cfg.gen_up_rates)):
        gen[f"up_snake{i}"] = _alpha(sd, f"generator.snakes.{i}")
        gen[f"up{i}"] = _conv(sd, f"generator.ups.{i}", deconv=True)
        for j in range(nk):
            rb = {}
            base = f"generator.resblocks.{i * nk + j}"
            for jj in range(len(cfg.gen_res_dilations)):
                rb[f"a1_{jj}"] = _alpha(sd, f"{base}.convs1_activates.{jj}")
                rb[f"c1_{jj}"] = _conv(sd, f"{base}.convs1.{jj}")
                rb[f"a2_{jj}"] = _alpha(sd, f"{base}.convs2_activates.{jj}")
                rb[f"c2_{jj}"] = _conv(sd, f"{base}.convs2.{jj}")
            gen[f"res{i}_{j}"] = rb
    gen["post_snake"] = _alpha(sd, "generator.snake_post")
    gen["post"] = _conv(sd, "generator.conv_post")
    params["gen"] = gen
    return params
