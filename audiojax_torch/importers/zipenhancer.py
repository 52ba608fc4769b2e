"""ZipEnhancer importer: ModelScope Zipformer2 dual-path checkpoint → parameter tree.

Counterpart of ``audiojax.importers.zipenhancer``.  The upstream ONNX export
pre-folds BiasNorm/bypass scales and fuses attn+ff1 projections; the model
keeps the algebraic (unfused) Zipformer2 form, so every module imports raw
and only layout transforms apply:

  zip_enhancer.dense_encoder.dense_conv_1.{0,1,2} / dense_block.dense_block.
      {i}.{1,2,3} / dense_conv_2.{0,1,2}
  zip_enhancer.TSConformer.encoders.{0..3}:
      plain:       f_layers.0, t_layers.0, bypass_layers.{0,1}.bypass_scale
      downsampled: downsample_{t,f}.bias, encoder.{f_layers.0, t_layers.0,
                   bypass_layers.{0,1}}, out_combiner.bypass_scale
  layer internals (:143-187): feed_forward{1,2,3}.{in_proj,out_proj},
      self_attn_weights.{in_proj,linear_pos}, nonlin_attention, self_attn{1,2},
      conv_module{1,2}.{in_proj,depthwise_conv,out_proj},
      bypass_mid/bypass.bypass_scale, norm.{bias,log_scale}
  zip_enhancer.mask_decoder.{dense_block, mask_conv.{0.conv1,1,2,3}} and
  phase_decoder.{dense_block, phase_conv.{0.conv1,1,2}, phase_conv_r/i}
      (the r/i heads fuse into one 2-channel conv).
"""
from __future__ import annotations

import numpy as np

from ..models.zipenhancer import ZipEnhancerConfig
from ..ops.attention_cuda import pos_stride
from .common import conv1d_w, conv2d_w, linear, to_np, unwrap_state_dict

__all__ = ["import_zipenhancer"]

_P = "zip_enhancer"


def _c2d(sd, key, bias=True):
    p = {"w": conv2d_w(to_np(sd[f"{key}.weight"]))}
    if bias and f"{key}.bias" in sd:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def _in_pr(sd, key):
    return {"g": to_np(sd[f"{key}.weight"]).astype(np.float32),
            "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}


def _alpha(sd, key):
    return {"alpha": to_np(sd[f"{key}.weight"]).astype(np.float32)}


def _dense_block(sd, key, depth):
    """DenseBlockV2: Sequential per layer = [pad(0), conv(1), norm(2), prelu(3)]."""
    p = {}
    for i in range(depth):
        lk = f"{key}.dense_block.{i}"
        p[f"layer{i}"] = {
            "conv": _c2d(sd, f"{lk}.1"),
            "norm": _in_pr(sd, f"{lk}.2"),
            "act": _alpha(sd, f"{lk}.3"),
        }
    return p


def _repack_attn_in_proj(lin, num_heads: int, query_head_dim: int, pos_head_dim: int):
    """Checkpoint in_proj rows are [Q_allheads | K_allheads | P_allheads];
    ``nn/zipformer.py:attention_weights`` reads one packed projection
    [Q(H·q) | K(H·q) | P(H·stride)] with each head's P slot zero-padded to
    ``pos_stride`` lanes, which B3 reads in place — Q/K pass through in
    checkpoint order, P columns spread onto the strided slots."""
    qd, pd, h = query_head_dim, pos_head_dim, num_heads
    stride = pos_stride(pd)
    w = lin["w"]
    out_w = np.zeros((w.shape[0], h * (2 * qd + stride)), dtype=w.dtype)
    out_w[:, : 2 * h * qd] = w[:, : 2 * h * qd]
    out = {"w": out_w}
    if "b" in lin:
        out["b"] = np.zeros((h * (2 * qd + stride),), dtype=lin["b"].dtype)
    for i in range(h):
        dst = 2 * h * qd + i * stride
        src = 2 * h * qd + i * pd
        out_w[:, dst : dst + pd] = w[:, src : src + pd]
        if "b" in lin:
            out["b"][2 * h * qd + i * stride : 2 * h * qd + i * stride + pd] = (
                lin["b"][src : src + pd])
    if "b" in lin:
        out["b"][: 2 * h * qd] = lin["b"][: 2 * h * qd]
    return out


def _zip_layer(sd, key, *, num_heads, query_head_dim, pos_head_dim):
    def ff(name):
        return {"in": linear(sd, f"{key}.{name}.in_proj"),
                "out": linear(sd, f"{key}.{name}.out_proj")}

    def sa(name):
        return {"in_proj": linear(sd, f"{key}.{name}.in_proj"),
                "out_proj": linear(sd, f"{key}.{name}.out_proj")}

    def cm(name):
        dw = to_np(sd[f"{key}.{name}.depthwise_conv.weight"])
        p = {"in_proj": linear(sd, f"{key}.{name}.in_proj"),
             "dw": {"w": conv1d_w(dw)},
             "out_proj": linear(sd, f"{key}.{name}.out_proj")}
        if f"{key}.{name}.depthwise_conv.bias" in sd:
            p["dw"]["b"] = to_np(sd[f"{key}.{name}.depthwise_conv.bias"]).astype(np.float32)
        return p

    return {
        "attn": {
            "in_proj": _repack_attn_in_proj(
                linear(sd, f"{key}.self_attn_weights.in_proj"),
                num_heads, query_head_dim, pos_head_dim),
            "linear_pos": linear(sd, f"{key}.self_attn_weights.linear_pos", bias=False),
        },
        "ff1": ff("feed_forward1"),
        "ff2": ff("feed_forward2"),
        "ff3": ff("feed_forward3"),
        "nonlin": {"in_proj": linear(sd, f"{key}.nonlin_attention.in_proj"),
                   "out_proj": linear(sd, f"{key}.nonlin_attention.out_proj")},
        "sa1": sa("self_attn1"),
        "sa2": sa("self_attn2"),
        "conv1": cm("conv_module1"),
        "conv2": cm("conv_module2"),
        "bypass_mid": to_np(sd[f"{key}.bypass_mid.bypass_scale"]).astype(np.float32),
        "bypass": to_np(sd[f"{key}.bypass.bypass_scale"]).astype(np.float32),
        "norm": {"bias": to_np(sd[f"{key}.norm.bias"]).astype(np.float32),
                 "log_scale": to_np(sd[f"{key}.norm.log_scale"]).reshape(()).astype(np.float32)},
    }


def _ts_encoder(sd, key, downsampled, *, num_heads, query_head_dim, pos_head_dim):
    dims = dict(num_heads=num_heads, query_head_dim=query_head_dim,
                pos_head_dim=pos_head_dim)
    inner = f"{key}.encoder" if downsampled else key
    p = {
        "f_layer": _zip_layer(sd, f"{inner}.f_layers.0", **dims),
        "t_layer": _zip_layer(sd, f"{inner}.t_layers.0", **dims),
        "bypass_f": to_np(sd[f"{inner}.bypass_layers.0.bypass_scale"]).astype(np.float32),
        "bypass_t": to_np(sd[f"{inner}.bypass_layers.1.bypass_scale"]).astype(np.float32),
    }
    if downsampled:
        p["combine_scale"] = to_np(sd[f"{key}.out_combiner.bypass_scale"]).astype(np.float32)
        p["down_t"] = {"bias": to_np(sd[f"{key}.downsample_t.bias"]).astype(np.float32)}
        p["down_f"] = {"bias": to_np(sd[f"{key}.downsample_f.bias"]).astype(np.float32)}
    return p


def import_zipenhancer(ckpt, cfg=None):
    cfg = cfg or ZipEnhancerConfig()
    sd = unwrap_state_dict(ckpt)
    de = f"{_P}.dense_encoder"
    md = f"{_P}.mask_decoder"
    pd = f"{_P}.phase_decoder"

    # phase real/imag output heads fuse into one 2-channel (1,2) conv
    phase_w = np.concatenate([to_np(sd[f"{pd}.phase_conv_r.weight"]),
                              to_np(sd[f"{pd}.phase_conv_i.weight"])], axis=0)
    phase_b = np.concatenate([to_np(sd[f"{pd}.phase_conv_r.bias"]),
                              to_np(sd[f"{pd}.phase_conv_i.bias"])])

    params = {
        "encoder": {
            "conv1": _c2d(sd, f"{de}.dense_conv_1.0"),
            "norm1": _in_pr(sd, f"{de}.dense_conv_1.1"),
            "act1": _alpha(sd, f"{de}.dense_conv_1.2"),
            "dense": _dense_block(sd, f"{de}.dense_block", cfg.dense_depth),
            "conv2": _c2d(sd, f"{de}.dense_conv_2.0"),
            "norm2": _in_pr(sd, f"{de}.dense_conv_2.1"),
            "act2": _alpha(sd, f"{de}.dense_conv_2.2"),
        },
        "decoder": {
            "mask_dense": _dense_block(sd, f"{md}.dense_block", cfg.dense_depth),
            "phase_dense": _dense_block(sd, f"{pd}.dense_block", cfg.dense_depth),
            "mask_up": {"conv": _c2d(sd, f"{md}.mask_conv.0.conv1"),
                        "norm": _in_pr(sd, f"{md}.mask_conv.1"),
                        "act": _alpha(sd, f"{md}.mask_conv.2")},
            "phase_up": {"conv": _c2d(sd, f"{pd}.phase_conv.0.conv1"),
                         "norm": _in_pr(sd, f"{pd}.phase_conv.1"),
                         "act": _alpha(sd, f"{pd}.phase_conv.2")},
            "mask_out": _c2d(sd, f"{md}.mask_conv.3"),
            "phase_out": {"w": conv2d_w(phase_w), "b": phase_b.astype(np.float32)},
        },
    }
    for i, (t_ds, f_ds) in enumerate(cfg.encoder_downsample):
        params[f"ts{i}"] = _ts_encoder(sd, f"{_P}.TSConformer.encoders.{i}",
                                       downsampled=not (t_ds == 1 and f_ds == 1),
                                       num_heads=cfg.num_heads,
                                       query_head_dim=cfg.query_head_dim,
                                       pos_head_dim=cfg.pos_head_dim)
    return params
