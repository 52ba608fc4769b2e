"""Deep-Echo checkpoint importer (the ICCRN family, an order-10 echo-path head).

Counterpart of ``audiojax.importers.deep_echo``; it returns numpy.  One CFB
encoder and one CFB decoder around a two-layer time-LSTM bottleneck, with a
(2·order)-channel 1×1 head predicting the complex echo-path filter.  The
LayerNorms (the CepsUnit's fp16-safe variant included) reduce to SDAEC's
unbiased-variance form, so the raw weights import unchanged (eps 1e-8 in the
model).
"""
from __future__ import annotations

from .common import unwrap_state_dict
from .sdaec import _cfb, _ch_lstm_f, _ch_lstm_t, _dense_1x1, _iccrn_ln

__all__ = ["import_deep_echo"]


def import_deep_echo(ckpt, cfg=None) -> dict:
    """Upstream Deep-Echo state dict → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    return {
        "in_lstm": _ch_lstm_f(sd, "in_ch_lstm"),
        "in_conv": _dense_1x1(sd, "in_conv"),
        "enc": _cfb(sd, "cfb_e1"),
        "mid_ln": _iccrn_ln(sd, "ln"),
        "mid_lstm": _ch_lstm_t(sd, "ch_lstm", num_layers=2),
        "dec": _cfb(sd, "cfb_d1"),
        "out_lstm": _ch_lstm_t(sd, "out_ch_lstm"),
        "out_conv": _dense_1x1(sd, "out_conv"),
    }
