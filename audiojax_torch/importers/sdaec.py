"""SDAEC checkpoint importer: upstream ICCRN + AlphaPredictor → parameter tree.

Counterpart of ``audiojax.importers.sdaec``; it returns numpy.  The upstream
repository ships two checkpoints (ICCRN and alpha); pass their union as one
dict (the key spaces do not collide).  The recipes:

- AlphaPredictor fusion: linear2 (k → 1) ∘ linear1 (2 → 1) over the frame
  powers folds into one causal two-channel conv kernel (k, 2, 1),
  [mix: w₂·w₁[1], far: w₂·w₁[0]], with bias b₂ + Σw₂·b₁.
- ICCRN LayerNorm: the raw (1, C, F, 1) weights transpose to (F, C); the
  unbiased-variance form lives in ``nn.cfb.iccrn_layer_norm``, so they
  import unchanged.
- CFB 1×1 convs → dense; the (3, 1) frequency conv → HWIO (1, 3, in, out);
  CH_LSTM_F / CH_LSTM_T under ``lstm2`` + ``linear`` (the bidirectional one
  with torch's ``_reverse`` suffix, the bottleneck with two layers).
"""
from __future__ import annotations

import numpy as np

from .common import linear, lstm_params, to_np, unwrap_state_dict

__all__ = ["import_sdaec"]


def _iccrn_ln(sd, key) -> dict:
    return {"w": to_np(sd[f"{key}.w"])[0, :, :, 0].T.astype(np.float32),
            "b": to_np(sd[f"{key}.b"])[0, :, :, 0].T.astype(np.float32)}


def _dense_1x1(sd, key) -> dict:
    w = to_np(sd[f"{key}.weight"])  # (out, in, 1, 1)
    return {"w": w[:, :, 0, 0].T.astype(np.float32),
            "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}


def _freq_conv3(sd, key) -> dict:
    w = to_np(sd[f"{key}.weight"])  # (out, in, 3, 1): the kernel runs over frequency
    return {"w": w[:, :, :, 0].transpose(2, 1, 0)[None].astype(np.float32),
            "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}


def _ch_lstm_f(sd, key) -> dict:
    return {
        "fwd": lstm_params(sd, f"{key}.lstm2"),
        "bwd": lstm_params(sd, f"{key}.lstm2", suffix="_reverse"),
        "linear": linear(sd, f"{key}.linear"),
    }


def _ch_lstm_t(sd, key, num_layers: int = 1) -> dict:
    return {
        "layers": [lstm_params(sd, f"{key}.lstm2", layer=i) for i in range(num_layers)],
        "linear": linear(sd, f"{key}.linear"),
    }


def _cfb(sd, key) -> dict:
    return {
        "gate": _dense_1x1(sd, f"{key}.conv_gate"),
        "input": _dense_1x1(sd, f"{key}.conv_input"),
        "conv": _freq_conv3(sd, f"{key}.conv"),
        "ln0": _iccrn_ln(sd, f"{key}.LN0"),
        "ln1": _iccrn_ln(sd, f"{key}.LN1"),
        "ln2": _iccrn_ln(sd, f"{key}.LN2"),
        "ceps": {
            "ln": _iccrn_ln(sd, f"{key}.ceps_unit.LN"),
            "lstm": _ch_lstm_f(sd, f"{key}.ceps_unit.ch_lstm_f"),
        },
    }


def _alpha(sd) -> dict:
    """linear2 ∘ linear1 fused into the causal two-channel conv kernel (k, 2, 1)."""
    w1 = to_np(sd["linear1.weight"])[0]  # (2,)
    b1 = to_np(sd["linear1.bias"])[0]
    w2 = to_np(sd["linear2.weight"])[0]  # (k,)
    b2 = to_np(sd["linear2.bias"])
    kernel = np.zeros((w2.shape[0], 2, 1))
    kernel[:, 0, 0] = w2 * w1[1]  # mix-power taps
    kernel[:, 1, 0] = w2 * w1[0]  # far-power taps
    return {"w": kernel.astype(np.float32), "b": (b2 + w2.sum() * b1).astype(np.float32)}


def import_sdaec(ckpt, cfg=None) -> dict:
    """Union of the upstream ICCRN + alpha state dicts → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    params = {
        "alpha": _alpha(sd),
        "in_lstm": _ch_lstm_f(sd, "in_ch_lstm"),
        "in_conv": _dense_1x1(sd, "in_conv"),
        "mid_ln": _iccrn_ln(sd, "ln"),
        "mid_lstm": _ch_lstm_t(sd, "ch_lstm", num_layers=2),
        "out_lstm": _ch_lstm_t(sd, "out_ch_lstm"),
        "out_conv": _dense_1x1(sd, "out_conv"),
    }
    for i in range(5):
        params[f"enc{i}"] = _cfb(sd, f"cfb_e{i + 1}")
        params[f"dec{i}"] = _cfb(sd, f"cfb_d{5 - i}")
    return params
