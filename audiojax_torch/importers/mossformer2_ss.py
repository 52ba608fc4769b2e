"""MossFormer2-SS-16K importer: ClearVoice separation checkpoint → parameter tree.

Counterpart of ``audiojax.importers.mossformer2_ss``.  Module tree under
``mossformer_ss.``: enc.conv1d (time-domain encoder k=16 s=8), dec
(ConvTranspose1d), mask_net.{norm, conv1d_encoder, pos_enc.scale,
mdl.intra_mdl.mossformerM.{layers,fsmn}, mdl.intra_mdl.norm, mdl.intra_norm,
conv1d_out, output.0, output_gate.0, conv1_decoder}.

Fusions (mirroring the upstream ONNX export):
- FLASH layers: identical recipe to MossFormer2-SE (shared helpers).
- Gated_FSMN_Block_Dilated: to_u‖to_v LayerNorm-folded fuse; the
  UniDeepFsmn_dilated memory imports its DenseNet stack RAW
  (conv{j}/norm{j}/prelu{j}, width-one Conv2d → Conv1d).
- Per-speaker tail fold: conv1d_out speaker rows × shared output‖output_gate
  1×1 convs → one ``tail_gate`` dense laid out [spk0: out‖gate, spk1: …].
"""
from __future__ import annotations

import numpy as np

from ..models.mossformer2_ss import MossFormer2SsConfig
from .common import conv1d_w, deconv_kernel, linear, to_np, unwrap_state_dict
from .mossformer2_se import _dense_k1, _ffconvm_parts, _flash, _fold_ln_linear_raw

__all__ = ["import_mossformer2_ss"]

_P = "mossformer_ss"


def _gated_fsmn_dilated(sd, key, mem_depth):
    un, ul, uc = _ffconvm_parts(sd, f"{key}.gated_fsmn.to_u")
    vn, vl, vc = _ffconvm_parts(sd, f"{key}.gated_fsmn.to_v")
    wu, bu = _fold_ln_linear_raw(sd, un, ul)
    wv, bv = _fold_ln_linear_raw(sd, vn, vl)
    fsmn = f"{key}.gated_fsmn.fsmn"
    mem_stack = []
    for j in range(mem_depth):
        w = to_np(sd[f"{fsmn}.conv.conv{j + 1}.weight"])  # (C, in/g, k, 1)
        mem_stack.append({
            "conv": {"w": w[..., 0].transpose(2, 1, 0).astype(np.float32)},
            "norm": {"g": to_np(sd[f"{fsmn}.conv.norm{j + 1}.weight"]).astype(np.float32),
                     "b": to_np(sd[f"{fsmn}.conv.norm{j + 1}.bias"]).astype(np.float32)},
            "act": {"alpha": to_np(sd[f"{fsmn}.conv.prelu{j + 1}.weight"]).astype(np.float32)},
        })
    return {
        "front": _dense_k1(sd, f"{key}.conv1.0"),
        "front_alpha": to_np(sd[f"{key}.conv1.1.weight"]).reshape(()).astype(np.float32),
        "norm1": {"g": to_np(sd[f"{key}.norm1.weight"]).astype(np.float32),
                  "b": to_np(sd[f"{key}.norm1.bias"]).astype(np.float32)},
        "uv_lin": {"w": np.concatenate([wu, wv], axis=0).T.astype(np.float32),
                   "b": np.concatenate([bu, bv]).astype(np.float32)},
        "uv_conv": {"w": conv1d_w(np.concatenate(
            [to_np(sd[f"{uc}.weight"]), to_np(sd[f"{vc}.weight"])], axis=0))},
        "mem_lin": linear(sd, f"{fsmn}.linear"),
        "mem_proj": {"w": to_np(sd[f"{fsmn}.project.weight"]).T.astype(np.float32)},
        "mem_stack": mem_stack,
        "norm2": {"g": to_np(sd[f"{key}.norm2.weight"]).astype(np.float32),
                  "b": to_np(sd[f"{key}.norm2.bias"]).astype(np.float32)},
        "back": _dense_k1(sd, f"{key}.conv2"),
    }


def import_mossformer2_ss(ckpt, cfg=None):
    cfg = cfg or MossFormer2SsConfig()
    sd = unwrap_state_dict(ckpt)
    mn = f"{_P}.mask_net"
    mm = f"{mn}.mdl.intra_mdl.mossformerM"
    d, spks = cfg.dim, cfg.num_spks

    # per-speaker tail fold (the export's speaker batching):
    # gate_s = (output‖output_gate) ∘ conv1d_out rows of speaker s
    spk_w = to_np(sd[f"{_P}.mask_net.conv1d_out.weight"])[..., 0]  # (spks·d, d)
    spk_b = to_np(sd[f"{_P}.mask_net.conv1d_out.bias"])
    gate_w = np.concatenate([to_np(sd[f"{mn}.output.0.weight"]),
                             to_np(sd[f"{mn}.output_gate.0.weight"])], axis=0)[..., 0]
    gate_b = np.concatenate([to_np(sd[f"{mn}.output.0.bias"]),
                             to_np(sd[f"{mn}.output_gate.0.bias"])])
    tw, tb = [], []
    for s in range(spks):
        ws = spk_w[s * d : (s + 1) * d]
        bs = spk_b[s * d : (s + 1) * d]
        tw.append(gate_w @ ws)
        tb.append(gate_w @ bs + gate_b)
    tail_w = np.concatenate(tw, axis=0)  # (spks·2·d, d)
    tail_b = np.concatenate(tb)

    params = {
        "encoder": {"w": conv1d_w(to_np(sd[f"{_P}.enc.conv1d.weight"])),
                    "b": to_np(sd[f"{_P}.enc.conv1d.bias"]).astype(np.float32)}
        if f"{_P}.enc.conv1d.bias" in sd else
        {"w": conv1d_w(to_np(sd[f"{_P}.enc.conv1d.weight"]))},
        "front_norm": {"g": to_np(sd[f"{mn}.norm.weight"]).astype(np.float32),
                       "b": to_np(sd[f"{mn}.norm.bias"]).astype(np.float32)},
        "front": _dense_k1(sd, f"{mn}.conv1d_encoder"),
        "pos_scale": to_np(sd[f"{mn}.pos_enc.scale"]).reshape(()).astype(np.float32),
        "mm_norm": {"g": to_np(sd[f"{mn}.mdl.intra_mdl.norm.weight"]).astype(np.float32),
                    "b": to_np(sd[f"{mn}.mdl.intra_mdl.norm.bias"]).astype(np.float32)},
        "intra_norm": {"g": to_np(sd[f"{mn}.mdl.intra_norm.weight"]).astype(np.float32),
                       "b": to_np(sd[f"{mn}.mdl.intra_norm.bias"]).astype(np.float32)},
        "tail_alpha": to_np(sd[f"{mn}.prelu.weight"]).reshape(()).astype(np.float32),
        "tail_gate": {"w": tail_w.T.astype(np.float32), "b": tail_b.astype(np.float32)},
        "mask_decoder": _dense_k1(sd, f"{mn}.conv1_decoder", bias=False),
        "decoder": {"w": _deconv1d_w(to_np(sd[f"{_P}.dec.weight"]))},
    }
    if f"{_P}.dec.bias" in sd:
        params["decoder"]["b"] = to_np(sd[f"{_P}.dec.bias"]).astype(np.float32)
    for i in range(cfg.depth):
        params[f"flash{i}"] = _flash(sd, f"{mm}.layers.{i}")
        params[f"fsmn{i}"] = _gated_fsmn_dilated(sd, f"{mm}.fsmn.{i}", cfg.mem_depth)
    return params


def _deconv1d_w(w):
    """torch ConvTranspose1d (in, out, k) → equivalent forward WIO kernel."""
    return deconv_kernel(w, 1).astype(np.float32)
