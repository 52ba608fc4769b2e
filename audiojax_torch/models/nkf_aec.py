"""NKF-AEC — neural-Kalman-filter acoustic echo cancellation, 16 kHz, in PyTorch.

Counterpart of ``audiojax.models.nkf_aec``.  Per STFT frame t and bin f an
order-L complex Kalman filter tracks the echo path:

  x_t    = ref[t−L+1 … t]                  (delay line, zero history)
  dh     = h_post − h_prior ; swap(h_prior, h_post)
  e      = mic_t − ⟨x_t, h_prior⟩          (complex dot over L taps)
  kg     = KGNet([x_t, e, dh])             (complex dense → complex GRU →
                                            dense → dense, shared over bins)
  h_post = h_prior + kg·e ;  echo_t = ⟨x_t, h_post⟩
  out    = ISTFT(mic − echo)

"Complex" modules follow the real decomposition: ComplexDense applies
independent real affines to the two parts; ComplexGRU combines four real GRU
passes as (h_rr − h_ii, h_ri + h_ir), run as two ``gru_cell`` calls on the
stacked parts; ComplexPReLU is one shared slope.  The recurrence is a Python
loop over frames carrying (h_prior, h_post, the four GRU states), and the
scan operator while ``torch.export`` traces.

On the card the offline forward stacks far‖near into one B1 call and
synthesises on B2 (1024/256 hann, constant pad, centred); the stream step
analyses near‖far over its stacked 2·lanes rows in one B1 call and
synthesises with ``dsp.stft.stream_istft``.

Argument order: ``nkf_forward`` takes ``(far, near)``, as the upstream
export binds them; the serving module, ``make_nkf`` and the stream step take
``(near, far)``, the order of every AEC model here.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.pcm import fold_windows, pcm_in, pcm_out, resample_linear, unfold_windows
from ..dsp.stft import StftConfig, stream_istft
from ..nn import core
from ..nn.rnn import gru_cell, time_scan
from ..ops import _build
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, dense_np
from .gtcrn import _gru_np

__all__ = [
    "NkfConfig",
    "NKF",
    "kg_net",
    "nkf_scan",
    "nkf_forward",
    "nkf_stream_init",
    "nkf_stream_step",
    "init_nkf_numpy",
    "init_nkf",
    "make_nkf",
]


@dataclasses.dataclass(frozen=True)
class NkfConfig:
    n_fft: int = 1024
    hop: int = 256
    window: str = "hann"
    filter_order: int = 4  # L
    fc_dim: int = 18
    rnn_dim: int = 18
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0
    # the standalone export mean-centres the pair; the DFSMN-AEC cascade does not
    demean: bool = True
    # the cascade chains the waveform in float
    float_output: bool = False
    center: bool = True  # False = snip-edges framing (streaming-equivalent)

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode="constant", center=self.center)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1


def _cdense(p, x: torch.Tensor) -> torch.Tensor:
    """ComplexDense: independent real affines on the parts.  (..., D, 2) → (..., O, 2)."""
    return torch.stack([core.dense(p["r"], x[..., 0]), core.dense(p["i"], x[..., 1])], dim=-1)


def _leaky(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex dot over the tap axis: (..., L, 2) × (..., L, 2) → (..., 2)."""
    re = torch.sum(a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1], dim=-1)
    im = torch.sum(a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0], dim=-1)
    return torch.stack([re, im], dim=-1)


def _cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    return torch.stack([re, im], dim=-1)


def kg_net(p, x: torch.Tensor, grus):
    """KGNet step: x (N, 2L+1, 2) → (kg (N, L, 2), new GRU states).

    ``grus`` = (h_rr, h_ir, h_ri, h_ii), each (N, rnn_dim).  The four real GRU
    passes run as two cell calls (gru_r and gru_i, each on [re; im])."""
    h_rr, h_ir, h_ri, h_ii = grus
    x = _leaky(_cdense(p["fc_in"], x), p["fc_in_slope"])
    both = torch.cat([x[..., 0], x[..., 1]], dim=0)
    n = x.shape[0]
    out_r = gru_cell(p["gru_r"], both, torch.cat([h_rr, h_ir], dim=0))
    out_i = gru_cell(p["gru_i"], both, torch.cat([h_ri, h_ii], dim=0))
    h_rr, h_ir, h_ri, h_ii = out_r[:n], out_r[n:], out_i[:n], out_i[n:]
    y = torch.stack([h_rr - h_ii, h_ri + h_ir], dim=-1)  # (N, rnn_dim, 2)
    y = _leaky(_cdense(p["fc_mid"], y), p["fc_mid_slope"])
    return _cdense(p["fc_out"], y), (h_rr, h_ir, h_ri, h_ii)


def _kalman_step(params, carry, xt: torch.Tensor, mic_t: torch.Tensor):
    """One frame of the recurrence: ``xt`` (B, F, L, 2), ``mic_t`` (B, F, 2)
    → (new carry, echo (B, F, 2)).  The new h_prior is the old h_post
    itself, and the GRU states are views of one cell output each."""
    h_prior, h_post, grus = carry
    b, f_bins, filter_l, _ = xt.shape
    dh = h_post - h_prior
    h_prior, h_post = h_post, h_prior
    e = mic_t - _cdot(xt, h_prior)  # (B, F, 2)
    feat = torch.cat([xt, e[..., None, :], dh], dim=-2)  # (B, F, 2L+1, 2)
    kg, grus = kg_net(params, feat.reshape(b * f_bins, 2 * filter_l + 1, 2), grus)
    h_post = h_prior + _cmul(kg.reshape(b, f_bins, filter_l, 2), e[..., None, :])
    return (h_prior, h_post, grus), _cdot(xt, h_post)


def nkf_scan(params, ref_spec: torch.Tensor, mic_spec: torch.Tensor, cfg: NkfConfig,
             state=None):
    """Kalman recurrence over frames: specs (B, T, F, 2) → echo (B, T, F, 2).

    ``state`` = (carry (h_prior, h_post, (h_rr, h_ir, h_ri, h_ii)), the
    reference delay line's history (B, L − 1, F, 2)); with it the recurrence
    continues exactly across streaming chunks and ``(echo, new_state)``
    comes back.  Without ``state``, while ``torch.export`` traces, the
    frames run as the scan operator (``nn.rnn.time_scan``)."""
    b, t_frames, f_bins, _ = ref_spec.shape
    filter_l = cfg.filter_order
    if state is None:
        padded = F.pad(ref_spec, (0, 0, 0, 0, filter_l - 1, 0))
    else:
        padded = torch.cat([state[1], ref_spec], dim=1)
    # xt[t] = ref[t − L + 1 … t]: (B, T, F, L, 2)
    xt_all = torch.stack([padded[:, k:k + t_frames] for k in range(filter_l)], dim=-2)

    if state is None and _build.loops_as_scan():
        # the scan's carries are tensors of their own, and so are its outputs
        zeros_h = ref_spec.new_zeros((b, f_bins, filter_l, 2))
        grus = tuple(ref_spec.new_zeros((b * f_bins, cfg.rnn_dim)) for _ in range(4))

        def step(carry, xs):
            carry, echo_t = _kalman_step(params, carry, *xs)
            h_prior, h_post, grus = carry
            return (h_prior.clone(), h_post, tuple(g.clone() for g in grus)), echo_t

        _, echo = time_scan(step, (zeros_h, torch.zeros_like(zeros_h), grus),
                            (xt_all, mic_spec), dim=1)
        return echo
    if state is None:
        zeros_h = ref_spec.new_zeros((b, f_bins, filter_l, 2))
        zeros_g = ref_spec.new_zeros((b * f_bins, cfg.rnn_dim))
        carry = (zeros_h, zeros_h, (zeros_g,) * 4)
    else:
        carry = state[0]
    echoes = []
    for t in range(t_frames):
        carry, echo_t = _kalman_step(params, carry, xt_all[:, t], mic_spec[:, t])
        echoes.append(echo_t)
    h_prior, h_post, grus = carry
    echo = torch.stack(echoes, dim=1)  # (B, T, F, 2)
    if state is None:
        return echo
    # slice by start: -(L−1) with L = 1 would keep the whole array
    return echo, ((h_prior, h_post, tuple(grus)), padded[:, padded.shape[1] - (filter_l - 1):])


def _spec(packed: torch.Tensor, fb: int) -> torch.Tensor:
    return torch.stack([packed[..., :fb], packed[..., fb:]], dim=-1)  # (B, T, F, 2)


def _packed(spec: torch.Tensor) -> torch.Tensor:
    return torch.cat([spec[..., 0], spec[..., 1]], dim=-1).contiguous()


def nkf_forward(params, far_end: torch.Tensor, near_end: torch.Tensor,
                cfg: NkfConfig = NkfConfig()) -> torch.Tensor:
    """(far int16 (B, L), near int16 (B, L)) → echo-cancelled int16 (B, L)
    (float with ``cfg.float_output``)."""
    x = pcm_in(torch.cat([far_end, near_end], dim=0))
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)
    if cfg.demean and not cfg.fold_window:
        x = x - torch.mean(x, dim=-1, keepdim=True)

    batch = far_end.shape[0]
    model_len = x.shape[-1]
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = -(-model_len // align) * align
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)
        if cfg.demean:  # folded: demean each window, as the upstream export does
            x = x - torch.mean(x, dim=-1, keepdim=True)

    spec = _spec(fast_stft_packed(x.contiguous(), cfg.stft), cfg.f_bins)  # far‖near, one B1
    nb = spec.shape[0] // 2
    ref_spec, mic_spec = spec[:nb], spec[nb:]
    out = mic_spec - nkf_scan(params, ref_spec, mic_spec, cfg)
    y = fast_istft_packed(_packed(out), cfg.stft)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    return y if cfg.float_output else pcm_out(y)


def make_nkf(cfg: NkfConfig = NkfConfig()):
    """Return ``fn(params, near_int16, far_int16) -> int16``: the (near, far)
    order of the serving contract."""

    def fn(params, near_end, far_end):
        return nkf_forward(params, far_end, near_end, cfg=cfg)

    return fn


class NKF(ParamModule):
    """NKF-AEC with its converted parameters as buffers.

    ``forward(near, far)`` takes two int16 PCM ``(B, L)`` batches on the
    module's device (the microphone, then the far-end reference) and returns
    the echo-cancelled int16 PCM of the same shape."""

    def __init__(self, params, cfg: NkfConfig = NkfConfig()):
        super().__init__(params, cfg)

    def forward(self, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
        return nkf_forward(self.params, far, near, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming: the Kalman state and the delay line carried across chunks
# ─────────────────────────────────────────────────────────────────────────────


def nkf_stream_init(cfg: NkfConfig = NkfConfig(), batch: int = 1, device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card); the GRU states
    fold the batch batch-major, (B·F, rnn_dim)."""
    if cfg.in_sample_rate != cfg.sample_rate or cfg.out_sample_rate != cfg.sample_rate:
        raise ValueError(
            f"streaming runs at the model rate only ({cfg.sample_rate} Hz); "
            "resample on the host (the offline forward resamples "
            "in-graph, the stream step does not)")
    zeros = partial(torch.zeros, dtype=torch.float32, device=resolve_device(device))
    carry = cfg.n_fft - cfg.hop
    f, filter_l = cfg.f_bins, cfg.filter_order
    zeros_h = zeros((batch, f, filter_l, 2))
    zeros_g = zeros((batch * f, cfg.rnn_dim))
    return {
        "near_tail": zeros((batch, carry)),
        "far_tail": zeros((batch, carry)),
        "kalman": ((zeros_h, zeros_h.clone(), tuple(zeros_g.clone() for _ in range(4))),
                   zeros((batch, filter_l - 1, f, 2))),
        "ola_tail": zeros((batch, carry)),
    }


def nkf_stream_step(params, state: dict, near_chunk: torch.Tensor, far_chunk: torch.Tensor,
                    cfg: NkfConfig = NkfConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming AEC step: int16 chunks (B, m·hop) → (state, int16 out).

    Processes the pair as if (n_fft − hop) zeros were prepended, with
    snip-edges framing and no demeaning; the Kalman state (h_prior, h_post,
    the four GRU states, the reference delay line) carries exactly."""
    if near_chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {near_chunk.shape[-1]} must be a multiple of hop "
                         f"{cfg.hop}")
    frame_cfg = dataclasses.replace(cfg.stft, center=False)
    buf_n = torch.cat([state["near_tail"], pcm_in(near_chunk)], dim=-1)
    buf_f = torch.cat([state["far_tail"], pcm_in(far_chunk)], dim=-1)
    b = buf_n.shape[0]
    spec = _spec(fast_stft_packed(torch.cat([buf_n, buf_f], dim=0), frame_cfg), cfg.f_bins)
    mic_spec, ref_spec = spec[:b], spec[b:]  # near‖far in one B1 call

    echo, kalman = nkf_scan(params, ref_spec, mic_spec, cfg, state=state["kalman"])
    out, new_tail = stream_istft(_packed(mic_spec - echo), frame_cfg, state["ola_tail"],
                                 near_chunk.shape[-1])
    carry = cfg.n_fft - cfg.hop
    new_state = {"near_tail": buf_n[:, -carry:], "far_tail": buf_f[:, -carry:],
                 "kalman": kalman, "ola_tail": new_tail}
    return new_state, (out if cfg.float_output else pcm_out(out))


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


# Scale of the random ``fc_out`` weights against the JAX package's glorot draw.
# KGNet's GRU saturates, so a random Kalman gain is O(1) whatever the input
# level, and h_post = h_prior + kg·e then grows by about |kg|·|x|² a frame:
# at speech levels (bins of ~10–100) a glorot-scale gain overflows float32
# within a 2 s window, 0.01 × glorot within 30 s of stream, and 1e-3 × glorot
# grows the filter ~10⁵× over 30 s.  1e-4 keeps the random filter bounded, as
# a trained one is (the JAX package's own tests damp it the same way, by
# 0.05, on unit-level spectra).
RANDOM_GAIN_SCALE = 1e-4


def init_nkf_numpy(seed: int = 0, cfg: NkfConfig = NkfConfig()) -> dict:
    """Random NKF parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.nkf_aec.init_nkf`` and its distributions
    (the PReLU slopes 0-d, 0.2), drawn from ``numpy.random.default_rng(seed)``;
    the ``fc_out`` weights are scaled by :data:`RANDOM_GAIN_SCALE`."""
    rng = np.random.default_rng(seed)
    d_in = 2 * cfg.filter_order + 1

    def cdense(din, dout):
        return {"r": dense_np(rng, din, dout), "i": dense_np(rng, din, dout)}

    return {
        "fc_in": cdense(d_in, cfg.fc_dim),
        "fc_in_slope": np.asarray(0.2, np.float32),
        "gru_r": _gru_np(rng, cfg.fc_dim, cfg.rnn_dim),
        "gru_i": _gru_np(rng, cfg.fc_dim, cfg.rnn_dim),
        "fc_mid": cdense(cfg.rnn_dim, cfg.fc_dim),
        "fc_mid_slope": np.asarray(0.2, np.float32),
        "fc_out": {part: {"w": d["w"] * np.float32(RANDOM_GAIN_SCALE), "b": d["b"]}
                   for part, d in cdense(cfg.fc_dim, cfg.filter_order).items()},
    }


def init_nkf(seed: int = 0, cfg: NkfConfig = NkfConfig(), device=None) -> dict:
    """Random NKF parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_nkf_numpy(seed, cfg), device)
