"""Shared FLASH / LayerNorm-fold recipes of the ClearVoice MossFormer2 family.

Counterpart of the helpers of ``audiojax.importers.mossformer2_se``, which
the MossFormerGAN-SE and MossFormer2-SS importers share:

- FLASH to_hidden‖to_qk → one fused in Linear and depthwise conv, with each
  branch's scalar ScaleNorm gain folded into its weight rows (in_norm → 1).
- to_out ScaleNorm gain folded into the out Linear (out_norm → 1).
- qk_offset_scale (γ, β) imported raw.
- A LayerNorm's affine folded into the Linear after it, in torch's (out, in)
  orientation, so that two branches can be stacked before the transpose.

``import_mossformer2_se`` itself comes with the MossFormer2-SE slice
(ROADMAP A.9).
"""
from __future__ import annotations

import numpy as np

from .common import conv1d_w, to_np

__all__ = []


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
