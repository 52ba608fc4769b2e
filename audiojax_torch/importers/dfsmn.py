"""DFSMN checkpoint importer: ModelScope DfsmnAns state dict → parameter tree.

Counterpart of ``audiojax.importers.dfsmn.import_dfsmn``; it returns numpy
(the JAX package wraps the same tree in ``jnp`` arrays).  Key map (ModelScope
``speech_dfsmn_ans_psm_48k_causal``):

  linear1.linear.{weight,bias}   → lin1
  deepfsmn.{i}.linear.{weight,bias} / .project.weight / .conv1.weight
                                 → layers[i]; the inner residual
                                   p1 + conv(p1) is folded into the
                                   current-frame memory tap
  linear2.linear.{weight,bias}   → lin2
"""
from __future__ import annotations

import numpy as np

from .common import to_np, unwrap_state_dict

__all__ = ["import_dfsmn"]


def _dense(sd, key: str, bias: bool = True) -> dict:
    p = {"w": to_np(sd[f"{key}.weight"]).T.astype(np.float32)}
    if bias:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def import_dfsmn(ckpt) -> dict:
    sd = unwrap_state_dict(ckpt)
    layers = []
    i = 0
    while f"deepfsmn.{i}.linear.weight" in sd:
        mem = to_np(sd[f"deepfsmn.{i}.conv1.weight"])  # (C, 1, lorder[, 1])
        if mem.ndim == 4:
            mem = mem[..., 0]
        mem = mem.transpose(2, 1, 0).copy()  # (lorder, 1, C)
        mem[-1, 0, :] += 1.0  # fold the inner residual p1 + conv(p1)
        layers.append({
            "lin": _dense(sd, f"deepfsmn.{i}.linear"),
            "proj": _dense(sd, f"deepfsmn.{i}.project", bias=False),
            "mem": {"w": mem.astype(np.float32)},
        })
        i += 1
    if not layers:
        raise KeyError("no deepfsmn layers found in checkpoint")
    return {"lin1": _dense(sd, "linear1.linear"), "lin2": _dense(sd, "linear2.linear"),
            "layers": layers}
