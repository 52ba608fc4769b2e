"""UL-UNAS checkpoint importer: converted ULUNAS state dict → parameter tree.

Counterpart of ``audiojax.importers.ul_unas``.  The contract is the module
tree of the upstream export after its ``convert_state_dict``:

  erb.{erb_fc,ierb_fc}.weight                 the learned ERB bank (frozen)
  encoder.en_convs.{i}.* / decoder.de_convs.{j}.*
      XConvBlock: conv+bn, act (AffinePReLU), ctfa
      XDWSBlock:  pconv_conv+pconv_bn, pconv_act, dconv_conv+dconv_bn,
                  dconv_act, dconv_ctfa
      XMBBlocks:  pconv1_* / dconv_* / pconv2_*, pconv2_ctfa
  dpgrnn.{0,1}.*                              GRNN pairs + fc + ln (GTCRN's recipe)

Fusions: BatchNorm into the conv and deconv weights; AffinePReLU's raw
(affine, slope) into the fused (pos = affine + 1, neg = affine + slope)
per-(freq, channel) weights.  The 0.5/ln10 log scale stays in the model.
"""
from __future__ import annotations

import numpy as np

from ..models.ul_unas import _CHANNELS, _GROUPS, _TYPES
from .common import fuse_bn_conv2d, fuse_bn_deconv2d, gru_params, linear, to_np, unwrap_state_dict
from .gtcrn import _dpgrnn

__all__ = ["import_ul_unas"]


def _aprelu(sd, key):
    aw = to_np(sd[f"{key}.affine_weight"])[0, :, 0, :].T  # (W, C)
    ab = to_np(sd[f"{key}.affine_bias"])[0, :, 0, :].T
    slope = to_np(sd[f"{key}.slope_weight"])[0, :, 0, 0]  # (C,)
    return {"pos": (aw + 1.0).astype(np.float32),
            "neg": (aw + slope[None, :]).astype(np.float32),
            "bias": ab.astype(np.float32)}


def _ctfa(sd, key):
    return {
        "ta_gru": gru_params(sd, f"{key}.ta_gru"),
        "ta_fc": linear(sd, f"{key}.ta_fc"),
        "fa": {"fwd": gru_params(sd, f"{key}.fa.gru"),
               "bwd": gru_params(sd, f"{key}.fa.gru", "_reverse"),
               "fc": linear(sd, f"{key}.fa.fc")},
    }


def _block(sd, key, btype, ch, groups, *, deconv=False, last=False):
    fuse = fuse_bn_deconv2d if deconv else fuse_bn_conv2d
    if btype == 0:  # XConvBlock
        p = {"conv": fuse(sd, f"{key}.conv", f"{key}.bn", groups=groups)}
        if not last:
            p["act"] = _aprelu(sd, f"{key}.act")
        p["ctfa"] = _ctfa(sd, f"{key}.ctfa")
        return p
    if btype == 1:  # XDWSBlock: depthwise main conv, groups = ch
        p = {"pconv": fuse_bn_conv2d(sd, f"{key}.pconv_conv", f"{key}.pconv_bn", groups=groups),
             "pconv_act": _aprelu(sd, f"{key}.pconv_act"),
             "dconv": fuse(sd, f"{key}.dconv_conv", f"{key}.dconv_bn", groups=ch)}
        if not last:
            p["dconv_act"] = _aprelu(sd, f"{key}.dconv_act")
        p["ctfa"] = _ctfa(sd, f"{key}.dconv_ctfa")
        return p
    return {  # XMBBlocks
        "pconv1": fuse_bn_conv2d(sd, f"{key}.pconv1_conv", f"{key}.pconv1_bn", groups=groups),
        "pconv1_act": _aprelu(sd, f"{key}.pconv1_act"),
        "dconv": fuse(sd, f"{key}.dconv_conv", f"{key}.dconv_bn", groups=ch),
        "dconv_act": _aprelu(sd, f"{key}.dconv_act"),
        "pconv2": fuse_bn_conv2d(sd, f"{key}.pconv2_conv", f"{key}.pconv2_bn", groups=groups),
        "ctfa": _ctfa(sd, f"{key}.pconv2_ctfa"),
    }


def import_ul_unas(ckpt, cfg=None):
    """Converted ULUNAS state dict (or a wrapper of one) → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    params = {
        "erb": {"fc": to_np(sd["erb.erb_fc.weight"]).T.astype(np.float32),    # (F_high, n_erb)
                "ifc": to_np(sd["erb.ierb_fc.weight"]).T.astype(np.float32)},  # (n_erb, F_high)
        "dp1": _dpgrnn(sd, "dpgrnn.0"),
        "dp2": _dpgrnn(sd, "dpgrnn.1"),
    }
    n = len(_TYPES)
    for i in range(n):
        params[f"enc{i}"] = _block(sd, f"encoder.en_convs.{i}", _TYPES[i], _CHANNELS[i],
                                   _GROUPS[i])
    # decoder block j mirrors encoder block i = n − 1 − j, out_ch = channels[i − 1]
    for j, i in enumerate(range(n - 1, 0, -1)):
        params[f"dec{j}"] = _block(sd, f"decoder.de_convs.{j}", _TYPES[i], _CHANNELS[i - 1],
                                   _GROUPS[i], deconv=True)
    params[f"dec{n - 1}"] = _block(sd, f"decoder.de_convs.{n - 1}", _TYPES[0], 1, _GROUPS[0],
                                   deconv=True, last=True)
    return params
