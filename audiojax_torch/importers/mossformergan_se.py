"""MossFormerGAN-SE-16K importer: ClearVoice SyncANet checkpoint → parameter tree.

Counterpart of ``audiojax.importers.mossformergan_se``, the same float64
recipes: the ONNX export's prefusions of the ClearVoice model, applied at
import:

- DenseEncoder / decoder dense blocks: conv%d/norm%d/prelu%d +
  fsmn%d.fsmn.{linear,project,conv1} (freq-axis memory, kernel rotated
  (K,1)→(1,K)).
- Per block: LayerNormalization4D affine folded into the intra Fconv
  (grouped Conv2d) and synthesized into the inter unfold conv
  (_fold_norm4d_unfold1d); intra/inter to_u‖to_v FFConvM pairs fused with
  their LayerNorm affines folded in; intra/inter_rnn UniDeepFsmn;
  intra/inter_linear ConvTranspose1d refolds; GAU (intra/inter_mossformer)
  to_hidden‖to_qk fused with LayerNorm folds, qk_offset_scale raw;
  SELayer avg/max MLPs; triple attention Q/K/V 1×1 convs concatenated with
  per-head LayerNormalization4DCF affines carrying the D^-1/4 scale.
- Mask decoder (sub_pixel, conv_1, norm, prelu, final_conv, prelu_out) and
  complex decoder (sub_pixel, norm, prelu, conv).
"""
from __future__ import annotations

import numpy as np

from ..models.mossformergan_se import MossFormerGanConfig
from .common import conv1d_w, conv2d_w, deconv_w, linear, to_np, unwrap_state_dict
from .mossformer2_se import _fold_ln_linear_raw

__all__ = ["import_mossformergan_se"]


def _c2d(sd, key, bias=True):
    p = {"w": conv2d_w(to_np(sd[f"{key}.weight"]))}
    if bias and f"{key}.bias" in sd:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def _in_norm(sd, key):
    return {"g": to_np(sd[f"{key}.weight"]).astype(np.float32),
            "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}


def _dense_fsmn(sd, key, depth):
    p = {}
    for i in range(depth):
        fs = f"{key}.fsmn{i + 1}.fsmn"
        mem = to_np(sd[f"{fs}.conv1.weight"])  # (C, 1, K, 1) → freq kernel (1, K)
        p[f"layer{i}"] = {
            "conv": _c2d(sd, f"{key}.conv{i + 1}"),
            "norm": _in_norm(sd, f"{key}.norm{i + 1}"),
            "act": {"alpha": to_np(sd[f"{key}.prelu{i + 1}.weight"]).astype(np.float32)},
            "fsmn_lin": {"w": conv2d_w(to_np(sd[f"{fs}.linear.weight"])[:, :, None, None]),
                         "b": to_np(sd[f"{fs}.linear.bias"]).astype(np.float32)},
            "fsmn_proj": {"w": conv2d_w(to_np(sd[f"{fs}.project.weight"])[:, :, None, None])},
            "fsmn_mem": {"w": conv2d_w(mem.transpose(0, 1, 3, 2))},
        }
    return p


def _ffconvm_pair(sd, key_u, key_v):
    """Fused to_u‖to_v: LayerNorm affines folded into one Linear + one conv."""
    wu, bu = _fold_ln_linear_raw(sd, f"{key_u}.mdl.0", f"{key_u}.mdl.1")
    wv, bv = _fold_ln_linear_raw(sd, f"{key_v}.mdl.0", f"{key_v}.mdl.1")
    cu = to_np(sd[f"{key_u}.mdl.3.sequential.1.conv.weight"])
    cv = to_np(sd[f"{key_v}.mdl.3.sequential.1.conv.weight"])
    return {
        "lin": {"w": np.concatenate([wu, wv], axis=0).T.astype(np.float32),
                "b": np.concatenate([bu, bv]).astype(np.float32)},
        "conv": {"w": conv1d_w(np.concatenate([cu, cv], axis=0))},
    }


def _uni_fsmn_1d(sd, key):
    mem = to_np(sd[f"{key}.conv1.weight"])
    if mem.ndim == 4:
        mem = mem[..., 0]
    return {
        "lin": linear(sd, f"{key}.linear"),
        "proj": {"w": to_np(sd[f"{key}.project.weight"]).T.astype(np.float32)},
        "mem": {"w": conv1d_w(mem)},
    }


def _gau(sd, key):
    wh, bh = _fold_ln_linear_raw(sd, f"{key}.to_hidden.mdl.0", f"{key}.to_hidden.mdl.1")
    wq, bq = _fold_ln_linear_raw(sd, f"{key}.to_qk.mdl.0", f"{key}.to_qk.mdl.1")
    wo, bo = _fold_ln_linear_raw(sd, f"{key}.to_out.mdl.0", f"{key}.to_out.mdl.1")
    ch = to_np(sd[f"{key}.to_hidden.mdl.3.sequential.1.conv.weight"])
    cq = to_np(sd[f"{key}.to_qk.mdl.3.sequential.1.conv.weight"])
    co = to_np(sd[f"{key}.to_out.mdl.3.sequential.1.conv.weight"])
    return {
        "in_lin": {"w": np.concatenate([wh, wq], axis=0).T.astype(np.float32),
                   "b": np.concatenate([bh, bq]).astype(np.float32)},
        "in_conv": {"w": conv1d_w(np.concatenate([ch, cq], axis=0))},
        "gamma": to_np(sd[f"{key}.qk_offset_scale.gamma"]).astype(np.float32),
        "beta": to_np(sd[f"{key}.qk_offset_scale.beta"]).astype(np.float32),
        "out_lin": {"w": wo.T.astype(np.float32), "b": bo.astype(np.float32)},
        "out_conv": {"w": conv1d_w(co)},
    }


def _se(sd, key):
    return {
        "avg1": linear(sd, f"{key}.avg_pool_layer.0"),
        "avg2": linear(sd, f"{key}.avg_pool_layer.2"),
        "max1": linear(sd, f"{key}.max_pool_layer.0"),
        "max2": linear(sd, f"{key}.max_pool_layer.2"),
    }


def _fold_norm4d_fconv(sd, norm_key, conv_key, groups):
    """LayerNormalization4D affine → grouped Conv2d (the export's Fconv fold), emitted
    as our freq-axis conv1d kernel (ks, 1, C·ks)."""
    w = to_np(sd[f"{conv_key}.weight"])  # (C·ks, 1, 1, ks)
    gamma = to_np(sd[f"{norm_key}.gamma"]).reshape(-1)
    beta = to_np(sd[f"{norm_key}.beta"]).reshape(-1)
    out_ch, in_pg = w.shape[:2]
    opg = out_ch // groups
    wg = w.reshape(groups, opg, in_pg, *w.shape[2:])
    scale = gamma.reshape(groups, 1, in_pg, 1, 1)
    shift = beta.reshape(groups, 1, in_pg, 1, 1)
    bias = np.zeros(out_ch)
    if f"{conv_key}.bias" in sd:
        bias = to_np(sd[f"{conv_key}.bias"])
    bias = bias.reshape(groups, opg) + (wg * shift).sum(axis=(2, 3, 4))
    w_f = (wg * scale).reshape(out_ch, in_pg, *w.shape[2:])
    return {"w": conv1d_w(w_f[:, :, 0, :]), "b": bias.reshape(-1).astype(np.float32)}


def _norm4d_unfold(sd, norm_key, ks):
    """LayerNormalization4D affine → sparse grouped unfold conv
    (the export's unfold conv): weight[c·ks+o, 0, o] = γ_c, bias = β_c."""
    gamma = to_np(sd[f"{norm_key}.gamma"]).reshape(-1)
    beta = to_np(sd[f"{norm_key}.beta"]).reshape(-1)
    c = gamma.shape[0]
    w = np.zeros((c * ks, 1, ks))
    b = np.empty(c * ks)
    for ch in range(c):
        for o in range(ks):
            w[ch * ks + o, 0, o] = gamma[ch]
            b[ch * ks + o] = beta[ch]
    return {"w": conv1d_w(w), "b": b.astype(np.float32)}


def _attn(sd, key, cfg):
    h, qc, vc, f = cfg.attn_heads, cfg.attn_q_ch, cfg.attn_v_ch, cfg.n_freqs
    mods = ([f"{key}.attn_conv_Q_{j}" for j in range(h)]
            + [f"{key}.attn_conv_K_{j}" for j in range(h)]
            + [f"{key}.attn_conv_V_{j}" for j in range(h)])
    conv_w = np.concatenate([to_np(sd[f"{m}.0.weight"]) for m in mods], axis=0)
    conv_b = np.concatenate([to_np(sd[f"{m}.0.bias"]) for m in mods])
    prelu = np.concatenate([
        np.broadcast_to(to_np(sd[f"{m}.1.weight"]), (to_np(sd[f"{m}.0.weight"]).shape[0],))
        for m in mods
    ])
    scale = float((qc * f) ** -0.25)

    def norm_affine(m):  # LayerNormalization4DCF gamma/beta (1, C, 1, F) → (C, F)
        return (to_np(sd[f"{m}.2.gamma"])[0, :, 0, :], to_np(sd[f"{m}.2.beta"])[0, :, 0, :])

    qg = np.stack([norm_affine(f"{key}.attn_conv_Q_{j}")[0] for j in range(h)]) * scale
    qb = np.stack([norm_affine(f"{key}.attn_conv_Q_{j}")[1] for j in range(h)]) * scale
    kg = np.stack([norm_affine(f"{key}.attn_conv_K_{j}")[0] for j in range(h)]) * scale
    kb = np.stack([norm_affine(f"{key}.attn_conv_K_{j}")[1] for j in range(h)]) * scale
    vg = np.stack([norm_affine(f"{key}.attn_conv_V_{j}")[0] for j in range(h)])
    vb = np.stack([norm_affine(f"{key}.attn_conv_V_{j}")[1] for j in range(h)])
    return {
        "qkv": {"w": conv2d_w(conv_w), "b": conv_b.astype(np.float32)},
        "qkv_act": {"alpha": prelu.astype(np.float32)},
        "qk_g": np.stack([qg, kg])[:, :, None].astype(np.float32),  # (2, h, 1, qc, f)
        "qk_b": np.stack([qb, kb])[:, :, None].astype(np.float32),
        "v_g": vg[:, None].astype(np.float32),  # (h, 1, vc, f)
        "v_b": vb[:, None].astype(np.float32),
        "proj": _c2d(sd, f"{key}.attn_concat_proj.0"),
        "proj_act": {"alpha": to_np(sd[f"{key}.attn_concat_proj.1.weight"]).astype(np.float32)},
        "cf_g": to_np(sd[f"{key}.attn_concat_proj.2.gamma"])[0, :, 0, :].T.astype(np.float32),
        "cf_b": to_np(sd[f"{key}.attn_concat_proj.2.beta"])[0, :, 0, :].T.astype(np.float32),
    }


def _path(sd, key, cfg, *, axis):
    c = cfg.emb_dim
    if axis == "f":
        unfold = _fold_norm4d_fconv(sd, f"{key}.intra_norm", f"{key}.Fconv", c)
        pre = "intra"
    else:
        unfold = _norm4d_unfold(sd, f"{key}.inter_norm", cfg.emb_ks)
        pre = "inter"
    return {
        "unfold": unfold,
        "uv": _ffconvm_pair(sd, f"{key}.{pre}_to_u", f"{key}.{pre}_to_v"),
        "fsmn": _uni_fsmn_1d(sd, f"{key}.{pre}_rnn.0"),
        "refold": {"w": deconv_w(to_np(sd[f"{key}.{pre}_linear.weight"])),
                   "b": to_np(sd[f"{key}.{pre}_linear.bias"]).astype(np.float32)},
        "mf": _gau(sd, f"{key}.{pre}_mossformer"),
        "se": _se(sd, f"{key}.{pre}_se"),
    }


def import_mossformergan_se(ckpt, cfg=None):
    cfg = cfg or MossFormerGanConfig()
    sd = unwrap_state_dict(ckpt)
    params = {
        "enc_conv1": _c2d(sd, "dense_encoder.conv_1.0"),
        "enc_norm1": _in_norm(sd, "dense_encoder.conv_1.1"),
        "enc_act1": {"alpha": to_np(sd["dense_encoder.conv_1.2.weight"]).astype(np.float32)},
        "enc_dense": _dense_fsmn(sd, "dense_encoder.dilated_dense", cfg.dense_depth),
        "enc_conv2": _c2d(sd, "dense_encoder.conv_2.0"),
        "enc_norm2": _in_norm(sd, "dense_encoder.conv_2.1"),
        "enc_act2": {"alpha": to_np(sd["dense_encoder.conv_2.2.weight"]).astype(np.float32)},
        "mask_dec": {"dense": _dense_fsmn(sd, "mask_decoder.dense_block", cfg.dense_depth),
                     "sp_conv": _c2d(sd, "mask_decoder.sub_pixel.conv")},
        "mask_conv1": _c2d(sd, "mask_decoder.conv_1"),
        "mask_norm": _in_norm(sd, "mask_decoder.norm"),
        "mask_act": {"alpha": to_np(sd["mask_decoder.prelu.weight"]).astype(np.float32)},
        "mask_final": _c2d(sd, "mask_decoder.final_conv"),
        "mask_out_alpha": to_np(sd["mask_decoder.prelu_out.weight"]).reshape(()).astype(np.float32),
        "cplx_dec": {"dense": _dense_fsmn(sd, "complex_decoder.dense_block", cfg.dense_depth),
                     "sp_conv": _c2d(sd, "complex_decoder.sub_pixel.conv")},
        "cplx_norm": _in_norm(sd, "complex_decoder.norm"),
        "cplx_act": {"alpha": to_np(sd["complex_decoder.prelu.weight"]).astype(np.float32)},
        "cplx_final": _c2d(sd, "complex_decoder.conv"),
    }
    for i in range(cfg.n_blocks):
        key = f"blocks.{i}"
        params[f"block{i}"] = {
            "intra": _path(sd, key, cfg, axis="f"),
            "inter": _path(sd, key, cfg, axis="t"),
            "attn": _attn(sd, key, cfg),
        }
    return params
