"""MossFormer2-SE-48K importer: ClearVoice checkpoint → parameter tree, and
the FLASH / LayerNorm-fold recipes the ClearVoice MossFormer2 family shares.

Counterpart of ``audiojax.importers.mossformer2_se``.  Its helpers, which the
MossFormerGAN-SE and MossFormer2-SS importers share:

- FLASH to_hidden‖to_qk → one fused in Linear and depthwise conv, with each
  branch's scalar ScaleNorm gain folded into its weight rows (in_norm → 1).
- to_out ScaleNorm gain folded into the out Linear (out_norm → 1).
- qk_offset_scale (γ, β) imported raw.
- A LayerNorm's affine folded into the Linear after it, in torch's (out, in)
  orientation, so that two branches can be stacked before the transpose.

``import_mossformer2_se`` adds the gated FSMN block (to_u‖to_v fused with
each branch's LayerNorm affine folded in, the memory conv imported raw) and
the speaker-0 tail fold: the ``conv1d_out`` rows of speaker 0 times the
``output``‖``output_gate`` 1×1 convs make one ``tail_gate`` dense.

ClearVoice module tree (keys under ``mossformer_se.``): norm,
conv1d_encoder, pos_enc.scale, mdl.intra_mdl.mossformerM.{layers,fsmn}.{i},
mdl.intra_mdl.norm, mdl.intra_norm, prelu, conv1d_out, output.0,
output_gate.0, conv1_decoder.
"""
from __future__ import annotations

import numpy as np

from ..models.mossformer2_se import MossFormer2SeConfig
from .common import conv1d_w, linear, to_np, unwrap_state_dict

__all__ = ["import_mossformer2_se"]

_P = "mossformer_se"


def _dense_k1(sd, key, bias=True):
    w = to_np(sd[f"{key}.weight"])  # (out, in, 1)
    p = {"w": w[:, :, 0].T.astype(np.float32)}
    if bias and f"{key}.bias" in sd:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def _ffconvm_parts(sd, key):
    """FFConvM submodule paths: mdl.0 norm, mdl.1 Linear, mdl.3.…conv."""
    return (f"{key}.mdl.0", f"{key}.mdl.1", f"{key}.mdl.3.sequential.1.conv")


def _flash(sd, key):
    hn, hl, hc = _ffconvm_parts(sd, f"{key}.to_hidden")
    qn, ql, qc = _ffconvm_parts(sd, f"{key}.to_qk")
    on, ol, oc = _ffconvm_parts(sd, f"{key}.to_out")
    gh = to_np(sd[f"{hn}.g"]).reshape(())
    gqk = to_np(sd[f"{qn}.g"]).reshape(())
    gout = to_np(sd[f"{on}.g"]).reshape(())
    w_in = np.concatenate([to_np(sd[f"{hl}.weight"]) * gh,
                           to_np(sd[f"{ql}.weight"]) * gqk], axis=0)
    b_in = np.concatenate([to_np(sd[f"{hl}.bias"]), to_np(sd[f"{ql}.bias"])])
    c_in = np.concatenate([to_np(sd[f"{hc}.weight"]), to_np(sd[f"{qc}.weight"])], axis=0)
    return {
        "in_norm": {"g": np.float32(1.0)},
        "in_lin": {"w": w_in.T.astype(np.float32), "b": b_in.astype(np.float32)},
        "in_conv": {"w": conv1d_w(c_in)},
        "os_gamma": to_np(sd[f"{key}.qk_offset_scale.gamma"]).astype(np.float32),
        "os_beta": to_np(sd[f"{key}.qk_offset_scale.beta"]).astype(np.float32),
        "out_norm": {"g": np.float32(1.0)},
        "out_lin": {"w": (to_np(sd[f"{ol}.weight"]) * gout).T.astype(np.float32),
                    "b": to_np(sd[f"{ol}.bias"]).astype(np.float32)},
        "out_conv": {"w": conv1d_w(to_np(sd[f"{oc}.weight"]))},
    }


def _fold_ln_linear_raw(sd, ln_key, lin_key):
    """W' = W·diag(γ), b' = W·β + b — torch orientation (out, in)."""
    w = to_np(sd[f"{lin_key}.weight"])
    b = to_np(sd[f"{lin_key}.bias"]) if f"{lin_key}.bias" in sd else 0.0
    g = to_np(sd[f"{ln_key}.weight"])
    beta = to_np(sd[f"{ln_key}.bias"])
    return w * g[None, :], w @ beta + b


def _gated_fsmn(sd, key):
    un, ul, uc = _ffconvm_parts(sd, f"{key}.gated_fsmn.to_u")
    vn, vl, vc = _ffconvm_parts(sd, f"{key}.gated_fsmn.to_v")
    wu, bu = _fold_ln_linear_raw(sd, un, ul)
    wv, bv = _fold_ln_linear_raw(sd, vn, vl)
    fsmn = f"{key}.gated_fsmn.fsmn"
    mem = to_np(sd[f"{fsmn}.conv1.weight"])  # (C, 1, k[, 1])
    if mem.ndim == 4:
        mem = mem[..., 0]
    return {
        "conv1": _dense_k1(sd, f"{key}.conv1.0"),
        "conv1_act": {"alpha": to_np(sd[f"{key}.conv1.1.weight"]).astype(np.float32)},
        "norm1": {"g": to_np(sd[f"{key}.norm1.weight"]).astype(np.float32),
                  "b": to_np(sd[f"{key}.norm1.bias"]).astype(np.float32)},
        "uv_lin": {"w": np.concatenate([wu, wv], axis=0).T.astype(np.float32),
                   "b": np.concatenate([bu, bv]).astype(np.float32)},
        "uv_conv": {"w": conv1d_w(np.concatenate(
            [to_np(sd[f"{uc}.weight"]), to_np(sd[f"{vc}.weight"])], axis=0))},
        "mem_lin": linear(sd, f"{fsmn}.linear"),
        "mem_proj": {"w": to_np(sd[f"{fsmn}.project.weight"]).T.astype(np.float32)},
        "mem_conv": {"w": conv1d_w(mem)},
        "norm2": {"g": to_np(sd[f"{key}.norm2.weight"]).astype(np.float32),
                  "b": to_np(sd[f"{key}.norm2.bias"]).astype(np.float32)},
        "conv2": _dense_k1(sd, f"{key}.conv2"),
    }


def import_mossformer2_se(ckpt, cfg=None):
    """ClearVoice MossFormer2-SE-48K state dict (or a wrapper of one) → numpy tree."""
    cfg = cfg or MossFormer2SeConfig()
    sd = unwrap_state_dict(ckpt)

    # speaker-0 tail fold
    d = cfg.dim
    spk_w = to_np(sd[f"{_P}.conv1d_out.weight"])[:d, :, 0]
    spk_b = to_np(sd[f"{_P}.conv1d_out.bias"])[:d]
    gate_w = np.concatenate([to_np(sd[f"{_P}.output.0.weight"]),
                             to_np(sd[f"{_P}.output_gate.0.weight"])], axis=0)[:, :, 0]
    gate_b = np.concatenate([to_np(sd[f"{_P}.output.0.bias"]),
                             to_np(sd[f"{_P}.output_gate.0.bias"])])

    mm = f"{_P}.mdl.intra_mdl.mossformerM"
    params = {
        "in_norm": {"g": to_np(sd[f"{_P}.norm.weight"]).astype(np.float32),
                    "b": to_np(sd[f"{_P}.norm.bias"]).astype(np.float32)},
        "encoder": _dense_k1(sd, f"{_P}.conv1d_encoder"),
        "pos_scale": to_np(sd[f"{_P}.pos_enc.scale"]).reshape(()).astype(np.float32),
        "mm_norm": {"g": to_np(sd[f"{_P}.mdl.intra_mdl.norm.weight"]).astype(np.float32),
                    "b": to_np(sd[f"{_P}.mdl.intra_mdl.norm.bias"]).astype(np.float32)},
        "intra_norm": {"g": to_np(sd[f"{_P}.mdl.intra_norm.weight"]).astype(np.float32),
                       "b": to_np(sd[f"{_P}.mdl.intra_norm.bias"]).astype(np.float32)},
        "tail_act": {"alpha": to_np(sd[f"{_P}.prelu.weight"]).reshape(()).astype(np.float32)},
        "tail_gate": {"w": (gate_w @ spk_w).T.astype(np.float32),
                      "b": (gate_w @ spk_b + gate_b).astype(np.float32)},
        "decoder": _dense_k1(sd, f"{_P}.conv1_decoder", bias=False),
    }
    for i in range(cfg.depth):
        params[f"flash{i}"] = _flash(sd, f"{mm}.layers.{i}")
        params[f"fsmn{i}"] = _gated_fsmn(sd, f"{mm}.fsmn.{i}")
    return params
