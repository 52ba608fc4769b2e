"""Deep-Echo AEC — explicit complex echo-path estimation, 16 kHz, in PyTorch.

Counterpart of ``audiojax.models.deep_echo``: SDAEC's 319/160 STFT and its
CFB / CepsUnit family (LayerNorm eps 1e-8), with a lighter net (one CFB
encoder, one decoder) whose head predicts an order-10 complex echo-path
filter per (bin, frame).  The echo estimate is Σ_l path_l · far delayed by
(order − 1 − l) frames, as L shifted slices; the output is mic − echo →
ISTFT.

On the card the offline forward stacks near‖far into one call of kernel B1
and synthesises on kernel B2 with the exact ``out_length``; the stream step
analyses near‖far of all its lanes in one B1 call, uncentred, carries the
far spectrum's delay-bank history, and synthesises with
``dsp.stft.stream_istft``.  The LSTMs are Python loops of small launches.

Channel order of the net's input: [mix_re, far_re, mix_im, far_im], the
checkpoint's (SDAEC's differs).  Argument order: (near, far).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.pcm import pcm_in, pcm_out, resample_linear
from ..dsp.stft import StftConfig, stream_istft
from ..nn import core
from ..nn.cfb import (cfb, ch_lstm_f, ch_lstm_t, iccrn_layer_norm, init_cfb_numpy,
                      init_ch_lstm_f_numpy, init_ch_lstm_t_numpy, init_iccrn_ln_numpy)
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, dense_np
from .sdaec import _lstm_state, _stream_check, stream_spectra

__all__ = [
    "LN_EPS",
    "DeepEchoConfig",
    "DeepEcho",
    "apply_echo_path",
    "deep_echo_net",
    "deep_echo_forward",
    "deep_echo_stream_init",
    "deep_echo_stream_step",
    "init_deep_echo_numpy",
    "init_deep_echo",
    "make_deep_echo",
]

LN_EPS = 1e-8  # Deep-Echo's LayerNorm epsilon


@dataclasses.dataclass(frozen=True)
class DeepEchoConfig:
    n_fft: int = 319
    hop: int = 160
    window: str = "hamming"
    channels: int = 20
    echo_order: int = 10
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0
    center: bool = True  # False = snip-edges framing (streaming-equivalent)
    # the standalone export mean-centres the pair; the DFSMN-AEC cascade does not
    demean: bool = True
    # the cascade chains the waveform in float (see SdaecConfig.float_output)
    float_output: bool = False

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode="constant", center=self.center)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1


def apply_echo_path(far: torch.Tensor, path: torch.Tensor, order: int,
                    history: torch.Tensor | None = None) -> torch.Tensor:
    """echo = Σ_l path_l · far delayed by (order − 1 − l) frames (complex).

    far: (B, T, F, 2); path: (B, T, F, 2, order) → echo (B, T, F, 2).
    ``history``: the previous (order − 1) far frames when streaming (zeros are
    the offline left pad)."""
    t = far.shape[1]
    if history is None:
        padded = F.pad(far, (0, 0, 0, 0, order - 1, 0))
    else:
        padded = torch.cat([history, far], dim=1)
    delayed = torch.stack([padded[:, lag:lag + t] for lag in range(order)], dim=-1)
    dr, di = delayed[..., 0, :], delayed[..., 1, :]
    pr, pi = path[..., 0, :], path[..., 1, :]
    echo_re = torch.sum(pr * dr - pi * di, dim=-1)
    echo_im = torch.sum(pr * di + pi * dr, dim=-1)
    return torch.stack([echo_re, echo_im], dim=-1)


def deep_echo_net(p, mix: torch.Tensor, far: torch.Tensor, cfg: DeepEchoConfig, state=None):
    """mix / far (B, T, F, 2) complex-last → enhanced packed (B, T, 2F).

    ``state`` (from :func:`deep_echo_stream_init`) carries the two time-LSTM
    stacks and the far spectrum's delay-bank history across streaming
    chunks, and then ``(packed, new_state)`` comes back."""
    x = torch.stack([mix[..., 0], far[..., 0], mix[..., 1], far[..., 1]], dim=-1)
    e0 = ch_lstm_f(p["in_lstm"], x)
    e0 = core.dense(p["in_conv"], torch.cat([e0, x], dim=-1))
    e1 = cfb(p["enc"], e0, LN_EPS)
    mid, mid_state = ch_lstm_t(p["mid_lstm"], iccrn_layer_norm(p["mid_ln"], e1, LN_EPS),
                               state=None if state is None else state["mid"],
                               return_state=True)
    d1 = cfb(p["dec"], e1 * mid, LN_EPS)
    d0, out_state = ch_lstm_t(p["out_lstm"], torch.cat([e0, d1], dim=-1),
                              state=None if state is None else state["out"],
                              return_state=True)
    out = core.dense(p["out_conv"], torch.cat([d0, d1], dim=-1))  # (B, T, F, 2·order)
    path = out.reshape(*out.shape[:-1], 2, cfg.echo_order)
    hist = None if state is None else state["far_hist"]
    enhanced = mix - apply_echo_path(far, path, cfg.echo_order, history=hist)
    packed = torch.cat([enhanced[..., 0], enhanced[..., 1]], dim=-1).contiguous()
    if state is None:
        return packed
    far_full = torch.cat([hist, far], dim=1)
    # slice by start: -(order-1) with order = 1 would be -0: (the whole history)
    return packed, {"mid": mid_state, "out": out_state,
                    "far_hist": far_full[:, far_full.shape[1] - (cfg.echo_order - 1):]}


def _complex_last(packed: torch.Tensor, fb: int) -> torch.Tensor:
    return torch.stack([packed[..., :fb], packed[..., fb:]], dim=-1)  # (B, T, F, 2)


def deep_echo_forward(params, near_end: torch.Tensor, far_end: torch.Tensor,
                      cfg: DeepEchoConfig = DeepEchoConfig()) -> torch.Tensor:
    """(near int16 (B, L), far int16 (B, L)) → echo-cancelled int16 (B, L)
    (float with ``cfg.float_output``)."""
    x = pcm_in(torch.cat([near_end, far_end], dim=0))
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)
    if cfg.demean:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    model_len = x.shape[-1]
    if cfg.fold_window:
        raise ValueError("in-graph batch-fold is unsupported for odd-NFFT models; "
                         "use session-level window batching instead")
    padded = -(-model_len // cfg.hop) * cfg.hop
    x = F.pad(x, (0, padded - model_len)).contiguous()

    spec = fast_stft_packed(x, cfg.stft)  # near‖far, one B1 call
    nb, fb = spec.shape[0] // 2, cfg.f_bins
    out = deep_echo_net(params, _complex_last(spec[:nb], fb), _complex_last(spec[nb:], fb), cfg)
    y = fast_istft_packed(out, cfg.stft, out_length=padded)[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    return y if cfg.float_output else pcm_out(y)


def make_deep_echo(cfg: DeepEchoConfig = DeepEchoConfig()):
    """Return ``fn(params, near_int16, far_int16) -> int16``."""
    return partial(deep_echo_forward, cfg=cfg)


class DeepEcho(ParamModule):
    """Deep-Echo with its converted parameters as buffers; ``forward(near,
    far)`` as :class:`audiojax_torch.models.sdaec.SDAEC`'s."""

    def __init__(self, params, cfg: DeepEchoConfig = DeepEchoConfig()):
        super().__init__(params, cfg)

    def forward(self, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
        return deep_echo_forward(self.params, near, far, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming: SDAEC's recipe plus the far spectrum's delay-bank history
# ─────────────────────────────────────────────────────────────────────────────


def deep_echo_stream_init(cfg: DeepEchoConfig = DeepEchoConfig(), batch: int = 1,
                          device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card)."""
    _stream_check(cfg)
    zeros = partial(torch.zeros, dtype=torch.float32, device=resolve_device(device))
    carry = cfg.n_fft - cfg.hop
    c, n = cfg.channels, batch * cfg.f_bins
    return {
        "near_tail": zeros((batch, carry)),
        "far_tail": zeros((batch, carry)),
        "net": {
            "mid": [_lstm_state(zeros, n, 2 * c), _lstm_state(zeros, n, 2 * c)],
            "out": [_lstm_state(zeros, n, c)],
            "far_hist": zeros((batch, cfg.echo_order - 1, cfg.f_bins, 2)),
        },
        "ola_tail": zeros((batch, carry)),
    }


def deep_echo_stream_step(params, state: dict, near_chunk: torch.Tensor,
                          far_chunk: torch.Tensor,
                          cfg: DeepEchoConfig = DeepEchoConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming AEC step: int16 chunks (B, m·hop) → (state, int16 out);
    the offline ``center=False`` path on the zero-prepended pair, delayed by
    n_fft − hop samples, with no DC removal."""
    if near_chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {near_chunk.shape[-1]} must be a multiple of hop "
                         f"{cfg.hop}")
    frame_cfg = dataclasses.replace(cfg.stft, center=False)
    mix, far, buf_n, buf_f = stream_spectra(state, near_chunk, far_chunk, frame_cfg)
    fb = cfg.f_bins
    packed, net_state = deep_echo_net(params, _complex_last(mix, fb), _complex_last(far, fb),
                                      cfg, state=state["net"])
    out, new_tail = stream_istft(packed, frame_cfg, state["ola_tail"], near_chunk.shape[-1])
    carry = cfg.n_fft - cfg.hop
    new_state = {"near_tail": buf_n[:, -carry:], "far_tail": buf_f[:, -carry:],
                 "net": net_state, "ola_tail": new_tail}
    return new_state, (out if cfg.float_output else pcm_out(out))


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def init_deep_echo_numpy(seed: int = 0, cfg: DeepEchoConfig = DeepEchoConfig()) -> dict:
    """Random Deep-Echo parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.deep_echo.init_deep_echo`` and its
    distributions, drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    c, fb = cfg.channels, cfg.f_bins
    return {
        "in_lstm": init_ch_lstm_f_numpy(rng, 4, c, c),
        "in_conv": dense_np(rng, 4 + c, c),
        "enc": init_cfb_numpy(rng, c, c, fb),
        "mid_ln": init_iccrn_ln_numpy(fb, c),
        "mid_lstm": init_ch_lstm_t_numpy(rng, c, 2 * c, c, num_layers=2),
        "dec": init_cfb_numpy(rng, c, c, fb),
        "out_lstm": init_ch_lstm_t_numpy(rng, 2 * c, c, 2 * c),
        "out_conv": dense_np(rng, 3 * c, 2 * cfg.echo_order),
    }


def init_deep_echo(seed: int = 0, cfg: DeepEchoConfig = DeepEchoConfig(), device=None) -> dict:
    """Random Deep-Echo parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_deep_echo_numpy(seed, cfg), device)
