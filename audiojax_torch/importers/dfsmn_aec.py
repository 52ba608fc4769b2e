"""DFSMN-AEC cascade importer: a backend checkpoint + the ModelScope DFSMN-AEC net.

Counterpart of ``audiojax.importers.dfsmn_aec``; it returns numpy.  The
cascade loads two upstream checkpoints (the light-AEC backend its config
names, and the DFSMN mask net); pass their union as one dict (the backend's
keys are ``in_ch_lstm`` / ``kg_net`` / …, the mask net's ``linear1.linear``
/ ``deepfsmn.*`` / ``linear2.linear``, the VAD head's ``linear3.linear``).

``cmvn=(shift, scale)`` (each (3·n_mels,)) folds the preprocessor's CMVN
into the first affine, as the upstream export does; omitted, that affine
imports unfolded.
"""
from __future__ import annotations

import numpy as np

from .common import linear, unwrap_state_dict
from .deep_echo import import_deep_echo
from .dfsmn import import_dfsmn
from .nkf import import_nkf
from .sdaec import import_sdaec

__all__ = ["import_dfsmn_aec"]

_BACKEND_IMPORTERS = {"sdaec": import_sdaec, "deep_echo": import_deep_echo, "nkf": import_nkf}


def import_dfsmn_aec(ckpt, cfg=None, *, cmvn=None) -> dict:
    """Union of the backend and DFSMN-AEC state dicts → numpy cascade tree."""
    from ..models.dfsmn_aec import DfsmnAecConfig

    cfg = cfg or DfsmnAecConfig()
    sd = unwrap_state_dict(ckpt)
    params = {"backend": _BACKEND_IMPORTERS[cfg.backend](sd), "mask_net": import_dfsmn(sd)}
    if cmvn is not None:
        shift = np.asarray(cmvn[0], np.float64)
        scale = np.asarray(cmvn[1], np.float64)
        w = np.asarray(params["mask_net"]["lin1"]["w"], np.float64)  # (in, out)
        b = np.asarray(params["mask_net"]["lin1"]["b"], np.float64)
        params["mask_net"]["lin1"] = {"w": (w * scale[:, None]).astype(np.float32),
                                      "b": (b + (shift * scale) @ w).astype(np.float32)}
    if "linear3.linear.weight" in sd:
        params["vad_head"] = linear(sd, "linear3.linear")
    return params
