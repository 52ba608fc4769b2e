"""SDAEC — time-alignment-free acoustic echo cancellation, 16 kHz, in PyTorch.

Counterpart of ``audiojax.models.sdaec``: an odd-n_fft STFT (319/160,
periodic Hamming, constant centre pad, 160 bins); the AlphaPredictor's time
alignment fused into one causal two-channel conv over the per-frame powers
(k = 10) that scales the far-end spectrum; then the ICCRN: a frequency LSTM
in → 1×1 → 5 CFB encoders → a two-layer time-LSTM bottleneck → 5 CFB
decoders with skip concatenations → a time LSTM out → 1×1 → packed
(real, imag) → ISTFT.  The blocks live in ``nn.cfb``.

On the card the offline forward stacks near‖far into one call of kernel B1
and synthesises on kernel B2 with the exact ``out_length`` (B2's float64
overlap-add rebuilds the decaying COLA edge of the last half window).  The
stream step analyses near‖far of all its lanes in one B1 call, uncentred,
and synthesises with ``dsp.stft.stream_istft``.  Everything else is plain
PyTorch: the alignment conv is a conv of one group (``F.conv1d``), and the
LSTMs are Python loops of small launches, which set the forward's time
(about 28k launches a window; see PERF.md).

Argument order: (near, far), the microphone first, in every function here.
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
from .base import ParamModule, dense_np, glorot_np

__all__ = [
    "LN_EPS",
    "SdaecConfig",
    "SDAEC",
    "alpha_align",
    "iccrn_net",
    "sdaec_forward",
    "sdaec_stream_init",
    "sdaec_stream_step",
    "init_sdaec_numpy",
    "init_sdaec",
    "make_sdaec",
]

LN_EPS = 1e-6  # SDAEC's LayerNorm epsilon (unbiased variance)


@dataclasses.dataclass(frozen=True)
class SdaecConfig:
    n_fft: int = 319
    hop: int = 160
    window: str = "hamming"  # periodic
    channels: int = 20
    alpha_k: int = 10
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0
    center: bool = True  # False = snip-edges framing (streaming-equivalent)
    # the standalone export mean-centres the pair; the DFSMN-AEC cascade does not
    demean: bool = True
    # the cascade passes the echo-cancelled waveform between stages in float
    # (an int16 round trip of a small residual costs ~-17 dB)
    float_output: bool = False

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode="constant", center=self.center)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1  # 160


def alpha_align(p, mix_power: torch.Tensor, far_power: torch.Tensor, k: int, cache=None, *,
                return_cache: bool = False):
    """The fused AlphaPredictor: a causal conv over the [mix, far] frame
    powers, each (B, T) → |alpha| (B, T).

    ``cache`` carries the previous (k − 1) power pairs across streaming
    chunks (a zero history is the offline left pad).  The conv has one group
    (two input channels, one output), so ``core.conv1d`` runs it on
    ``F.conv1d``, as the JAX package runs it on its plain conv."""
    feats = torch.stack([mix_power, far_power], dim=-1)  # (B, T, 2)
    if cache is None:
        cache = feats.new_zeros((feats.shape[0], k - 1, 2))
    full = torch.cat([cache, feats], dim=1)
    alpha = torch.abs(core.conv1d(p, full)[..., 0])  # kernel (k, 2, 1), valid over T
    # slice by start index: -(k-1) with k = 1 would be -0: (the whole history)
    return (alpha, full[:, full.shape[1] - (k - 1):]) if return_cache else alpha


def iccrn_net(p, x: torch.Tensor, cfg: SdaecConfig, state=None):
    """(B, T, 160, 4) [mix_re, mix_im, far_re, far_im] → (B, T, 320) packed.

    The time recurrence lives in the two CH_LSTM_T stacks; ``state`` (from
    :func:`sdaec_stream_init`) carries their (h, c) pairs across streaming
    chunks, and then ``(packed, new_state)`` comes back."""
    e0 = ch_lstm_f(p["in_lstm"], x)
    e0 = core.dense(p["in_conv"], torch.cat([e0, x], dim=-1))
    enc = [e0]
    h = e0
    for i in range(5):
        h = cfb(p[f"enc{i}"], h, LN_EPS)
        enc.append(h)
    mid, mid_state = ch_lstm_t(p["mid_lstm"], iccrn_layer_norm(p["mid_ln"], h, LN_EPS),
                               state=None if state is None else state["mid"],
                               return_state=True)
    h = cfb(p["dec0"], enc[5] * mid, LN_EPS)
    for i in range(1, 5):
        h = cfb(p[f"dec{i}"], torch.cat([enc[5 - i], h], dim=-1), LN_EPS)
    d0, out_state = ch_lstm_t(p["out_lstm"], torch.cat([e0, h], dim=-1),
                              state=None if state is None else state["out"],
                              return_state=True)
    out = core.dense(p["out_conv"], torch.cat([d0, h], dim=-1))  # (B, T, 160, 2)
    packed = torch.cat([out[..., 0], out[..., 1]], dim=-1).contiguous()  # (B, T, 320)
    return packed if state is None else (packed, {"mid": mid_state, "out": out_state})


def _features(mix: torch.Tensor, far: torch.Tensor, alpha: torch.Tensor, fb: int):
    """Packed spectra (B, T, 2F) and |alpha| → the net's (B, T, F, 4) input."""
    far = far * alpha[..., None]
    return torch.stack([mix[..., :fb], mix[..., fb:], far[..., :fb], far[..., fb:]], dim=-1)


def _power(spec: torch.Tensor) -> torch.Tensor:
    return torch.sum(spec * spec, dim=-1)


def sdaec_forward(params, near_end: torch.Tensor, far_end: torch.Tensor,
                  cfg: SdaecConfig = SdaecConfig()) -> torch.Tensor:
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
    # hop-align; the exact-out_length ISTFT then reconstructs all ``padded``
    # samples, the last half window from the decaying COLA edge
    padded = -(-model_len // cfg.hop) * cfg.hop
    x = F.pad(x, (0, padded - model_len)).contiguous()

    spec = fast_stft_packed(x, cfg.stft)  # near‖far, one B1 call
    nb = spec.shape[0] // 2
    mix, far = spec[:nb], spec[nb:]
    alpha = alpha_align(params["alpha"], _power(mix), _power(far), cfg.alpha_k)
    out = iccrn_net(params, _features(mix, far, alpha, cfg.f_bins), cfg)
    y = fast_istft_packed(out, cfg.stft, out_length=padded)[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    return y if cfg.float_output else pcm_out(y)


def make_sdaec(cfg: SdaecConfig = SdaecConfig()):
    """Return ``fn(params, near_int16, far_int16) -> int16``."""
    return partial(sdaec_forward, cfg=cfg)


class SDAEC(ParamModule):
    """SDAEC with its converted parameters as buffers.

    ``forward(near, far)`` takes two int16 PCM ``(B, L)`` batches on the
    module's device (the microphone, then the far-end reference) and returns
    the echo-cancelled int16 PCM of the same shape."""

    def __init__(self, params, cfg: SdaecConfig = SdaecConfig()):
        super().__init__(params, cfg)

    def forward(self, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
        return sdaec_forward(self.params, near, far, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming: the frequency LSTMs run per frame; the two time-LSTM stacks and
# the alignment conv carry explicit state
# ─────────────────────────────────────────────────────────────────────────────


def _stream_check(cfg) -> None:
    if cfg.in_sample_rate != cfg.sample_rate or cfg.out_sample_rate != cfg.sample_rate:
        raise ValueError(
            f"streaming runs at the model rate only ({cfg.sample_rate} Hz); "
            "resample on the host (the offline forward resamples "
            "in-graph, the stream step does not)")


def _lstm_state(zeros, n: int, hidden: int) -> list:
    return [zeros((n, hidden)), zeros((n, hidden))]


def sdaec_stream_init(cfg: SdaecConfig = SdaecConfig(), batch: int = 1, device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card): the framing
    tails, the alignment conv's power history, the time LSTMs' (h, c) pairs
    (B·F, hidden) batch-major, and the overlap-add tail."""
    _stream_check(cfg)
    zeros = partial(torch.zeros, dtype=torch.float32, device=resolve_device(device))
    carry = cfg.n_fft - cfg.hop
    c, n = cfg.channels, batch * cfg.f_bins
    return {
        "near_tail": zeros((batch, carry)),
        "far_tail": zeros((batch, carry)),
        "alpha": zeros((batch, cfg.alpha_k - 1, 2)),
        "net": {"mid": [_lstm_state(zeros, n, 2 * c), _lstm_state(zeros, n, 2 * c)],
                "out": [_lstm_state(zeros, n, c)]},
        "ola_tail": zeros((batch, carry)),
    }


def stream_spectra(state: dict, near_chunk: torch.Tensor, far_chunk: torch.Tensor,
                   frame_cfg: StftConfig):
    """The step's framing: the carried tails ahead of the new samples, near‖far
    of every lane in one B1 call → (mix, far spectra, near buffer, far buffer)."""
    buf_n = torch.cat([state["near_tail"], pcm_in(near_chunk)], dim=-1)
    buf_f = torch.cat([state["far_tail"], pcm_in(far_chunk)], dim=-1)
    b = buf_n.shape[0]
    spec = fast_stft_packed(torch.cat([buf_n, buf_f], dim=0), frame_cfg)
    return spec[:b], spec[b:], buf_n, buf_f


def sdaec_stream_step(params, state: dict, near_chunk: torch.Tensor, far_chunk: torch.Tensor,
                      cfg: SdaecConfig = SdaecConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming AEC step: int16 chunks (B, m·hop) → (state, int16 out).

    Processes the pair as if (n_fft − hop) zeros were prepended, with
    snip-edges framing: the offline ``center=False`` path on the
    zero-prepended pair, delayed by n_fft − hop samples.  No DC removal (the
    offline path removes the clip's mean, which a live stream cannot know)."""
    if near_chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {near_chunk.shape[-1]} must be a multiple of hop "
                         f"{cfg.hop}")
    frame_cfg = dataclasses.replace(cfg.stft, center=False)
    mix, far, buf_n, buf_f = stream_spectra(state, near_chunk, far_chunk, frame_cfg)
    alpha, alpha_cache = alpha_align(params["alpha"], _power(mix), _power(far), cfg.alpha_k,
                                     state["alpha"], return_cache=True)
    packed, net_state = iccrn_net(params, _features(mix, far, alpha, cfg.f_bins), cfg,
                                  state=state["net"])
    out, new_tail = stream_istft(packed, frame_cfg, state["ola_tail"], near_chunk.shape[-1])
    carry = cfg.n_fft - cfg.hop
    new_state = {"near_tail": buf_n[:, -carry:], "far_tail": buf_f[:, -carry:],
                 "alpha": alpha_cache, "net": net_state, "ola_tail": new_tail}
    return new_state, (out if cfg.float_output else pcm_out(out))


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def init_sdaec_numpy(seed: int = 0, cfg: SdaecConfig = SdaecConfig()) -> dict:
    """Random SDAEC parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.sdaec.init_sdaec`` and its distributions,
    drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    c, fb = cfg.channels, cfg.f_bins
    params = {
        "alpha": {"w": glorot_np(rng, (cfg.alpha_k, 2, 1)), "b": np.zeros((1,), np.float32)},
        "in_lstm": init_ch_lstm_f_numpy(rng, 4, c, c),
        "in_conv": dense_np(rng, 4 + c, c),
        "mid_ln": init_iccrn_ln_numpy(fb, c),
        "mid_lstm": init_ch_lstm_t_numpy(rng, c, 2 * c, c, num_layers=2),
        "out_lstm": init_ch_lstm_t_numpy(rng, 2 * c, c, 2 * c),
        "out_conv": dense_np(rng, 3 * c, 2),
    }
    for i in range(5):
        params[f"enc{i}"] = init_cfb_numpy(rng, c, c, fb)
    params["dec0"] = init_cfb_numpy(rng, c, c, fb)
    for i in range(1, 5):
        params[f"dec{i}"] = init_cfb_numpy(rng, 2 * c, c, fb)
    return params


def init_sdaec(seed: int = 0, cfg: SdaecConfig = SdaecConfig(), device=None) -> dict:
    """Random SDAEC parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_sdaec_numpy(seed, cfg), device)
