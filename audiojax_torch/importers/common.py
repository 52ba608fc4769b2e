"""Checkpoint-import toolbox: torch state dict → parameter-tree transforms.

Counterpart of ``audiojax.importers.common``: the same recipes, in numpy, so
that the port's trees equal the JAX package's bit for bit.  Every fusion
runs in float64 and each leaf is cast to float32 once, at the end.

Layout conversions (the JAX package's layouts; ``audiojax_torch.params``
turns them into torch's):

  torch Linear  (out, in)            → dense  w (in, out)
  torch Conv1d  (out, in/g, k)       → conv1d w (k, in/g, out)
  torch Conv2d  (out, in/g, kh, kw)  → conv2d w (kh, kw, in/g, out)
  torch ConvT{1,2}d                  → equivalent forward kernel (deconv_kernel)
  torch GRU/LSTM weight_ih/hh (G·H, in) → transposed (in, G·H)
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "KeyTracker",
    "unwrap_state_dict",
    "to_np",
    "deconv_kernel",
    "linear",
    "conv1d_w",
    "conv2d_w",
    "deconv_w",
    "gru_params",
    "lstm_params",
    "fuse_bn_conv2d",
    "fuse_bn_deconv2d",
    "fold_ln_into_linear",
    "prelu_alpha",
    "stereo_to_mono_linear",
]


def to_np(t) -> np.ndarray:
    """torch tensor / array-like → float64 numpy (fusions run in float64)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def deconv_kernel(w_torch: np.ndarray, groups: int = 1) -> np.ndarray:
    """torch ConvTranspose{1,2}d weight → equivalent forward kernel ({W,HW}IO).

    torch stores (Cin, Cout/groups, k...) where input channel i drives the
    outputs of its own group.  The equivalent input-dilated forward conv needs
    (k..., Cin/groups, Cout) with spatial axes flipped:
    ``kernel[k, i_local, o_global(g, o_local)] = w[i_global(g, i_local), o_local, K-1-k]``.
    (A copy of ``audiojax.nn.core.deconv_kernel``.)
    """
    w = np.asarray(w_torch)
    cin = w.shape[0]
    opg = w.shape[1]
    spatial = w.shape[2:]
    nsp = len(spatial)
    ipg = cin // groups
    w = w.reshape(groups, ipg, opg, *spatial)
    # → (*spatial, ipg, groups, opg)
    w = np.moveaxis(w, [0, 1, 2], [nsp + 1, nsp, nsp + 2])
    w = w.reshape(*spatial, ipg, groups * opg)
    return np.flip(w, axis=tuple(range(nsp))).copy()


class KeyTracker(dict):
    """State dict that records which keys an importer read.

    After an import, any unread checkpoint tensor means the upstream layout
    drifted from the recipe; :func:`audiojax_torch.importers.import_checkpoint`
    reports it instead of dropping it silently.
    """

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default

    @property
    def unconsumed(self) -> list:
        return sorted(set(self) - self.consumed)


def unwrap_state_dict(ckpt, prefixes=("module.", "model.", "network.", "net.")):
    """Dig the state dict out of common checkpoint wrappers and strip a
    uniform prefix.

    Where there is nothing to unwrap or strip, ``ckpt`` itself comes back: a
    family importer calls this again on the :class:`KeyTracker` that
    ``import_checkpoint`` made, and a copy would record no key as read."""
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model_state_dict", "model", "network", "net"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    if not isinstance(ckpt, dict):
        raise TypeError("unsupported checkpoint format (expected a mapping)")
    for prefix in prefixes:
        if ckpt and all(k.startswith(prefix) for k in ckpt):
            ckpt = {k[len(prefix) :]: v for k, v in ckpt.items()}
    return ckpt


def linear(sd, key, bias=True):
    p = {"w": to_np(sd[f"{key}.weight"]).T.astype(np.float32)}
    if bias and f"{key}.bias" in sd:
        p["b"] = to_np(sd[f"{key}.bias"]).astype(np.float32)
    return p


def conv1d_w(w) -> np.ndarray:
    return to_np(w).transpose(2, 1, 0).astype(np.float32)  # (k, in/g, out)


def conv2d_w(w) -> np.ndarray:
    return to_np(w).transpose(2, 3, 1, 0).astype(np.float32)  # (kh, kw, in/g, out)


def deconv_w(w, groups: int = 1) -> np.ndarray:
    return deconv_kernel(to_np(w), groups).astype(np.float32)


def gru_params(sd, key, suffix=""):
    """torch nn.GRU layer-0 weights → gru params (gate order r|z|n)."""
    return {
        "w_i": to_np(sd[f"{key}.weight_ih_l0{suffix}"]).T.astype(np.float32),
        "w_h": to_np(sd[f"{key}.weight_hh_l0{suffix}"]).T.astype(np.float32),
        "b_i": to_np(sd[f"{key}.bias_ih_l0{suffix}"]).astype(np.float32),
        "b_h": to_np(sd[f"{key}.bias_hh_l0{suffix}"]).astype(np.float32),
    }


def lstm_params(sd, key, suffix="", layer=0):
    return {
        "w_i": to_np(sd[f"{key}.weight_ih_l{layer}{suffix}"]).T.astype(np.float32),
        "w_h": to_np(sd[f"{key}.weight_hh_l{layer}{suffix}"]).T.astype(np.float32),
        "b_i": to_np(sd[f"{key}.bias_ih_l{layer}{suffix}"]).astype(np.float32),
        "b_h": to_np(sd[f"{key}.bias_hh_l{layer}{suffix}"]).astype(np.float32),
    }


def _bn_scale_bias(sd, bn_key, eps=1e-5):
    var = to_np(sd[f"{bn_key}.running_var"])
    mean = to_np(sd[f"{bn_key}.running_mean"])
    gamma = to_np(sd[f"{bn_key}.weight"])
    beta = to_np(sd[f"{bn_key}.bias"])
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def fuse_bn_conv2d(sd, conv_key, bn_key, groups: int = 1, eps=1e-5):
    """BatchNorm folded into a Conv2d, emitted in HWIO layout.

    ``groups`` is unused: BatchNorm scales the output-channel axis (axis 0 of
    torch's (out, in/g, kh, kw)), which grouping never re-partitions."""
    w = to_np(sd[f"{conv_key}.weight"])  # (out, in/g, kh, kw)
    scale, bias = _bn_scale_bias(sd, bn_key, eps)
    w = w * scale[:, None, None, None]
    b = bias.copy()
    if f"{conv_key}.bias" in sd:
        b = b + to_np(sd[f"{conv_key}.bias"]) * scale
    return {"w": w.transpose(2, 3, 1, 0).astype(np.float32), "b": b.astype(np.float32)}


def fuse_bn_deconv2d(sd, conv_key, bn_key, groups: int = 1, eps=1e-5):
    """BatchNorm folded into a ConvTranspose2d; the scale applies to the
    output-channel axis, which for torch's transposed convs is axis 1 within
    each group."""
    w = to_np(sd[f"{conv_key}.weight"])  # (in, out/g, kh, kw)
    scale, bias = _bn_scale_bias(sd, bn_key, eps)
    cin, opg = w.shape[0], w.shape[1]
    ipg = cin // groups
    wg = w.reshape(groups, ipg, opg, *w.shape[2:])
    scale_g = scale.reshape(groups, opg)
    wg = wg * scale_g[:, None, :, None, None]
    w = wg.reshape(cin, opg, *w.shape[2:])
    b = bias.copy()
    if f"{conv_key}.bias" in sd:
        b = b + to_np(sd[f"{conv_key}.bias"]) * scale
    return {"w": deconv_kernel(w, groups).astype(np.float32), "b": b.astype(np.float32)}


def fold_ln_into_linear(sd, ln_key, lin_key):
    """Affine LayerNorm folded into the following Linear (float64):
    W' = W·diag(γ), b' = W·β + b."""
    w = to_np(sd[f"{lin_key}.weight"])
    b = to_np(sd[f"{lin_key}.bias"]) if f"{lin_key}.bias" in sd else 0.0
    g = to_np(sd[f"{ln_key}.weight"])
    beta = to_np(sd[f"{ln_key}.bias"])
    w2 = w * g[None, :]
    b2 = w @ beta + b
    return {"w": w2.T.astype(np.float32), "b": b2.astype(np.float32)}


def prelu_alpha(sd, key):
    return {"alpha": to_np(sd[f"{key}.weight"]).astype(np.float32)}


def stereo_to_mono_linear(w):
    """Mel-Band mono folding: average the interleaved L/R input columns of a
    band-split Linear.  w: torch-layout (out, 2·win) → (out, win); a stereo
    band's columns run (bin, channel, re/im)."""
    w = to_np(w)
    out, win2 = w.shape
    w4 = w.reshape(out, win2 // 4, 2, 2)  # (out, bins, ch, complex)
    return w4.mean(axis=2).reshape(out, win2 // 2).astype(np.float32)
