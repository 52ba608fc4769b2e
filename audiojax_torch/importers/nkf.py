"""NKF-AEC checkpoint importer: upstream KGNet state dict → parameter tree.

Counterpart of ``audiojax.importers.nkf``.  The upstream KGNet stores its
complex layers as paired real modules under Sequential indices; they map to
the real/imaginary decomposition of ``models/nkf_aec.py``:

    kg_net.fc_in.0.linear_{real,imag}   → fc_in.{r,i}
    kg_net.fc_in.1.prelu                → fc_in_slope
    kg_net.complex_gru.gru_{r,i}        → gru_{r,i}   (torch nn.GRU layer 0)
    kg_net.fc_out.0.linear_{real,imag}  → fc_mid.{r,i}
    kg_net.fc_out.1.prelu               → fc_mid_slope
    kg_net.fc_out.2.linear_{real,imag}  → fc_out.{r,i}
"""
from __future__ import annotations

import numpy as np

from .common import gru_params, linear, to_np, unwrap_state_dict

__all__ = ["import_nkf"]


def _cdense(sd, key):
    return {"r": linear(sd, f"{key}.linear_real"), "i": linear(sd, f"{key}.linear_imag")}


def _prelu_slope(sd, key) -> np.ndarray:
    """The complex PReLU's slope, shared by both parts: a scalar slope stays a
    0-d leaf; a per-channel one gets a trailing axis, to broadcast over the
    (..., D, 2) layout."""
    w = to_np(sd[f"{key}.prelu.weight"]).astype(np.float32)
    return w.reshape(-1, 1) if w.size > 1 else w.reshape(())


def import_nkf(ckpt, cfg=None):
    """Upstream NKF state dict (or a wrapper of one) → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    return {
        "fc_in": _cdense(sd, "kg_net.fc_in.0"),
        "fc_in_slope": _prelu_slope(sd, "kg_net.fc_in.1"),
        "gru_r": gru_params(sd, "kg_net.complex_gru.gru_r"),
        "gru_i": gru_params(sd, "kg_net.complex_gru.gru_i"),
        "fc_mid": _cdense(sd, "kg_net.fc_out.0"),
        "fc_mid_slope": _prelu_slope(sd, "kg_net.fc_out.1"),
        "fc_out": _cdense(sd, "kg_net.fc_out.2"),
    }
