"""Mel-Band Roformer checkpoint importer, with stereo → mono folding.

Counterpart of ``audiojax.importers.melband``; it returns numpy.  The
upstream (lucidrains-layout) tree:

    band_split.to_features.{b}.0.gamma / .1.{weight,bias}
    layers.{i}.{0|1}.layers.0.0.{norm.gamma,to_qkv,to_gates,to_out.0}   (attention)
    layers.{i}.{0|1}.layers.0.1.net.{0.gamma,1,4}                        (feed-forward)
    layers.{i}.{0|1}.norm.gamma                                          (final norm)
    mask_estimators.{s}.to_freqs.{b}.0.{0,2,...}.{weight,bias}           (mask MLP)

(j = 0 the time transformer, j = 1 the band transformer; the MLP's linears
sit at even Sequential indices with Tanh between, and the last one feeds the
GLU.)  A mono config given a stereo checkpoint (band inputs twice as wide)
averages L and R on the channel-dependent edges, per (re, im): the
band-split gains and input-Linear columns, and the rows of the mask head's
last Linear within each GLU half.
"""
from __future__ import annotations

import numpy as np

from ..models.melband_roformer import MelBandConfig, band_layout
from .common import linear, stereo_to_mono_linear, to_np, unwrap_state_dict

__all__ = ["import_melband", "fold_glu_rows_stereo_to_mono"]


def _rms(sd, key):
    return {"g": to_np(sd[f"{key}.gamma"]).astype(np.float32)}


def _transformer(sd, base):
    attn = f"{base}.layers.0.0"
    ff = f"{base}.layers.0.1.net"
    return {
        "attn": {
            "norm": _rms(sd, f"{attn}.norm"),
            "to_qkv": linear(sd, f"{attn}.to_qkv", bias=False),
            "to_gates": linear(sd, f"{attn}.to_gates"),
            "to_out": linear(sd, f"{attn}.to_out.0", bias=False),
        },
        "ff_norm": _rms(sd, f"{ff}.0"),
        "ff1": linear(sd, f"{ff}.1"),
        "ff2": linear(sd, f"{ff}.4"),
        "out_norm": _rms(sd, f"{base}.norm"),
    }


def _fold_gamma_stereo_to_mono(gamma: np.ndarray) -> np.ndarray:
    """(4·bins,) grouped [re_L, im_L, re_R, im_R] → (2·bins,) L/R average."""
    return gamma.reshape(-1, 2, 2).mean(axis=1).reshape(-1).astype(np.float32)


def fold_glu_rows_stereo_to_mono(w: np.ndarray, b: np.ndarray):
    """The mask head's last Linear, torch (out, in): its rows (2 GLU halves ×
    4·bins) → 2 × 2·bins, L/R averaged per (re, im) within each half."""
    half = w.shape[0] // 2

    def fold(rows):  # (4·bins, …) → (2·bins, …)
        return rows.reshape(-1, 2, 2, *rows.shape[1:]).mean(axis=1).reshape(-1, *rows.shape[1:])

    w_new = np.concatenate([fold(w[:half]), fold(w[half:])], axis=0)
    b_new = np.concatenate([fold(b[:half]), fold(b[half:])], axis=0)
    return w_new.astype(np.float32), b_new.astype(np.float32)


def import_melband(ckpt, cfg=None, stem: int = 0):
    """Upstream Mel-Band Roformer state dict (or a wrapper of one) → numpy
    tree; mask estimator ``stem``.  A mono config on a stereo checkpoint
    (band-split inputs twice the config's width) folds L/R."""
    cfg = cfg or MelBandConfig()
    sd = unwrap_state_dict(ckpt)
    _, widths, _ = band_layout(cfg)

    params = {}
    depth = 0
    while f"layers.{depth}.0.norm.gamma" in sd:
        depth += 1
    if depth != cfg.depth:
        raise ValueError(f"checkpoint has {depth} axial layers, config expects {cfg.depth}")
    for i in range(depth):
        params[f"time{i}"] = _transformer(sd, f"layers.{i}.0")
        params[f"freq{i}"] = _transformer(sd, f"layers.{i}.1")

    # a stereo checkpoint is told by band 0's input width
    ck_w0 = to_np(sd["band_split.to_features.0.1.weight"]).shape[1]
    fold_mono = cfg.channels == 1 and ck_w0 == 2 * widths[0]
    if not fold_mono and ck_w0 != widths[0]:
        raise ValueError(
            f"band 0 width mismatch: checkpoint {ck_w0}, config {widths[0]} "
            f"(channels={cfg.channels})"
        )
    band_split = []
    for b in range(len(widths)):
        gamma = to_np(sd[f"band_split.to_features.{b}.0.gamma"]).astype(np.float32)
        lin = linear(sd, f"band_split.to_features.{b}.1")
        if fold_mono:
            gamma = _fold_gamma_stereo_to_mono(gamma)
            lin = {"w": stereo_to_mono_linear(lin["w"].T).T, "b": lin["b"]}
        band_split.append({"norm": {"g": gamma}, "lin": lin})
    params["band_split"] = band_split

    # mask MLP: linears at even Sequential indices; the last is the per-band
    # GLU head, the others the shared-width tanh stack
    n_lin = 0
    while f"mask_estimators.{stem}.to_freqs.0.0.{2 * n_lin}.weight" in sd:
        n_lin += 1
    if n_lin - 1 != cfg.mask_depth:
        raise ValueError(f"checkpoint mask MLP depth {n_lin - 1}, config expects {cfg.mask_depth}")
    hidden = []
    for j in range(cfg.mask_depth):
        lays = [linear(sd, f"mask_estimators.{stem}.to_freqs.{b}.0.{2 * j}")
                for b in range(len(widths))]
        hidden.append({"w": np.stack([q["w"] for q in lays]),
                       "b": np.stack([q["b"] for q in lays])})
    params["me_hidden"] = hidden

    me_out = []
    for b in range(len(widths)):
        lay = linear(sd, f"mask_estimators.{stem}.to_freqs.{b}.0.{2 * cfg.mask_depth}")
        if fold_mono:
            w_t, b_t = fold_glu_rows_stereo_to_mono(lay["w"].T, lay["b"])
            lay = {"w": w_t.T, "b": b_t}
        me_out.append(lay)
    params["me_out"] = me_out
    return params
