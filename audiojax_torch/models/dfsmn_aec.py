"""DFSMN-AEC — a two-stage echo-cancellation cascade with an optional VAD, 16 kHz.

Counterpart of ``audiojax.models.dfsmn_aec``.  A light AEC backend (SDAEC,
Deep-Echo or NKF, chosen by config) makes a temporary echo-reduced waveform
``temp``, passed on in float; a Kaldi fbank (80 mels, 640/320 frames, a
1024-point DFT, symmetric Hamming) runs over [near, temp, echo = near −
factor·temp] (3 × 80 = 240 features); the DFSMN mask net (linear → ReLU →
nine UniDeepFsmn layers → linear → sigmoid) masks temp's 640/320 STFT; an
ISTFT reconstructs.  A second head (linear → sigmoid) optionally gives
per-frame speech probabilities; ``runtime.vad`` turns them into timestamps.

On the card the backend runs its kernels (SDAEC and Deep-Echo: B1 over
near‖far and B2; NKF: B1 over far‖near and B2), each FSMN memory runs on
kernel B4 (``nn.core.conv1d``), and the mask synthesis on kernel B2 (the
JAX package calls its plain ISTFT there; the port routes it to the kernel,
as DFSMN's served synthesis).  The three fbanks run as one framing and one
product over the stacked signals, and the mask STFT is a product of temp's
frames with the plain DFT basis, as in the JAX package.

Streaming (SDAEC and Deep-Echo backends): the backend's stream step, a
161-sample FIFO on temp and a hop FIFO on the int16 near end that delay both
by one stage-2 hop (the backend lags by n_fft − hop = 159 samples), then the
stage-2 framing tails, the FSMN memories and the overlap-add tail; the
latency is 2·hop.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.pcm import INV_INT16, pcm_in, pcm_out, resample_linear
from ..dsp.stft import StftConfig, frame_signal, stft_basis, stream_istft
from ..frontend.kaldi import log_mel_fbank
from ..nn import core
from ..ops.stft_cuda import fast_istft_packed
from ..params import params_from_numpy
from .base import ParamModule, dense_np
from .deep_echo import (DeepEchoConfig, deep_echo_forward, deep_echo_stream_init,
                        deep_echo_stream_step, init_deep_echo_numpy)
from .dfsmn import DfsmnConfig, dfsmn_mask_net, init_dfsmn_numpy
from .nkf_aec import NkfConfig, init_nkf_numpy, nkf_forward
from .sdaec import (SdaecConfig, _stream_check, init_sdaec_numpy, sdaec_forward,
                    sdaec_stream_init, sdaec_stream_step)

__all__ = [
    "BACKENDS",
    "DfsmnAecConfig",
    "DfsmnAEC",
    "dfsmn_aec_forward",
    "dfsmn_aec_stream_init",
    "dfsmn_aec_stream_step",
    "init_dfsmn_aec_numpy",
    "init_dfsmn_aec",
    "make_dfsmn_aec",
    "mask_net_config",
]

BACKENDS = ("sdaec", "deep_echo", "nkf")


@dataclasses.dataclass(frozen=True)
class DfsmnAecConfig:
    backend: str = "sdaec"
    n_mels: int = 80
    hidden: int = 256
    depth: int = 9
    lorder: int = 20
    frame_len: int = 640
    hop: int = 320
    kaldi_nfft: int = 1024
    preemph: float = 0.97
    echo_factor: float = 1.15  # the upstream DFSMN echo estimate's scaling
    output_vad: bool = False
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000

    @property
    def mask_cfg(self) -> StftConfig:
        return StftConfig(self.frame_len, self.hop, window="hamming_symmetric", center=False)

    @property
    def mask_bins(self) -> int:
        return self.frame_len // 2 + 1  # 321


def _backend(cfg: DfsmnAecConfig):
    """(backend config, numpy init, forward(params, near, far, bcfg)).

    demean=False: unlike the standalone exports, the cascade does not
    mean-centre the pair.  float_output=True: the cascade passes temp on in
    float; an int16 round trip would bury a small residual under ~-17 dB of
    quantization noise.  NKF's forward takes (far, near)."""
    if cfg.backend == "sdaec":
        return SdaecConfig(demean=False, float_output=True), init_sdaec_numpy, sdaec_forward
    if cfg.backend == "deep_echo":
        return (DeepEchoConfig(demean=False, float_output=True), init_deep_echo_numpy,
                deep_echo_forward)
    if cfg.backend == "nkf":
        return (NkfConfig(demean=False, float_output=True), init_nkf_numpy,
                lambda p, near, far, bcfg: nkf_forward(p, far, near, bcfg))
    raise ValueError(f"unknown backend {cfg.backend!r}; expected one of {BACKENDS}")


def _features(near: torch.Tensor, temp: torch.Tensor, cfg: DfsmnAecConfig):
    """The 3 × n_mels Kaldi features over [near, temp, echo] (int16-domain
    powers), one framing and one product over the stacked signals → (feat
    (B, T, 3·n_mels), temp's frames (B, T, frame_len))."""
    b = near.shape[0]
    sigs = torch.cat([near, temp, near - cfg.echo_factor * temp], dim=0)
    frames = frame_signal(sigs, cfg.mask_cfg)
    fbank = log_mel_fbank(sigs, frame_len=cfg.frame_len, hop=cfg.hop, nfft=cfg.kaldi_nfft,
                          n_mels=cfg.n_mels, fs=cfg.sample_rate, preemph=cfg.preemph,
                          power_scale=1.0 / (INV_INT16 * INV_INT16), frames=frames)
    return torch.cat([fbank[:b], fbank[b:2 * b], fbank[2 * b:]], dim=-1), frames[b:2 * b]


def _mask(params, feat: torch.Tensor, cfg: DfsmnAecConfig, state=None):
    """The mask net (and with ``output_vad`` the VAD head) → (mask, FSMN
    state, vad or None)."""
    if not cfg.output_vad:
        return (*dfsmn_mask_net(params["mask_net"], feat, state), None)
    mask, fsmn_state, trunk = dfsmn_mask_net(params["mask_net"], feat, state,
                                             return_trunk=True)
    return mask, fsmn_state, torch.sigmoid(core.dense(params["vad_head"], trunk))[..., 0]


def _masked_spectrum(frames: torch.Tensor, mask: torch.Tensor, cfg: DfsmnAecConfig):
    spec = torch.matmul(frames, stft_basis(cfg.mask_cfg, frames.device))
    return (spec * torch.cat([mask, mask], dim=-1)).contiguous()


def dfsmn_aec_forward(params, near_end: torch.Tensor, far_end: torch.Tensor,
                      cfg: DfsmnAecConfig = DfsmnAecConfig()):
    """(near int16 (B, L), far int16 (B, L)) → aec int16 (B, L) [, vad (B, T)]."""
    bcfg, _, backend_fwd = _backend(cfg)
    temp = backend_fwd(params["backend"], near_end, far_end, bcfg)  # float

    near = pcm_in(near_end)
    if cfg.in_sample_rate != cfg.sample_rate:
        tgt = near.shape[-1] * cfg.sample_rate // cfg.in_sample_rate
        near, temp = resample_linear(near, tgt), resample_linear(temp, tgt)
    model_len = near.shape[-1]
    padded = max(-(-model_len // cfg.hop) * cfg.hop, cfg.frame_len)
    if padded != model_len:
        near = F.pad(near, (0, padded - model_len))
        temp = F.pad(temp, (0, padded - model_len))

    feat, frames = _features(near, temp, cfg)
    mask, _, vad = _mask(params, feat, cfg)
    y = fast_istft_packed(_masked_spectrum(frames, mask, cfg), cfg.mask_cfg)[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    out = pcm_out(y)
    return (out, vad) if cfg.output_vad else out


def make_dfsmn_aec(cfg: DfsmnAecConfig = DfsmnAecConfig()):
    """Return ``fn(params, near_int16, far_int16) -> int16 [, vad]``."""
    return partial(dfsmn_aec_forward, cfg=cfg)


class DfsmnAEC(ParamModule):
    """The DFSMN-AEC cascade with its converted parameters as buffers.

    ``forward(near, far)`` takes two int16 PCM ``(B, L)`` batches on the
    module's device and returns the echo-cancelled int16 PCM of the same
    shape (and, with ``output_vad``, the per-frame speech probabilities)."""

    def __init__(self, params, cfg: DfsmnAecConfig = DfsmnAecConfig()):
        super().__init__(params, cfg)

    def forward(self, near: torch.Tensor, far: torch.Tensor):
        return dfsmn_aec_forward(self.params, near, far, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming: the backend's stream, FIFOs re-aligning temp and near to one
# stage-2 hop, then the streaming mask net
# ─────────────────────────────────────────────────────────────────────────────


def _stream_backend(cfg: DfsmnAecConfig):
    """(backend config, stream init, stream step, the backend's delay)."""
    if cfg.backend == "sdaec":
        bcfg = SdaecConfig(float_output=True)
        return bcfg, sdaec_stream_init, sdaec_stream_step, bcfg.n_fft - bcfg.hop
    if cfg.backend == "deep_echo":
        bcfg = DeepEchoConfig(float_output=True)
        return bcfg, deep_echo_stream_init, deep_echo_stream_step, bcfg.n_fft - bcfg.hop
    raise ValueError(f"backend {cfg.backend!r} has no streaming path (sdaec/deep_echo do)")


def dfsmn_aec_stream_init(cfg: DfsmnAecConfig = DfsmnAecConfig(), batch: int = 1,
                          device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card): the backend's
    stream state, the re-alignment FIFOs (temp float, near int16), the
    stage-2 framing tails, the FSMN memories and the overlap-add tail."""
    _stream_check(cfg)
    bcfg, b_init, _, b_delay = _stream_backend(cfg)
    dev = resolve_device(device)
    zeros = partial(torch.zeros, dtype=torch.float32, device=dev)
    carry2 = cfg.frame_len - cfg.hop
    return {
        "backend": b_init(bcfg, batch, dev),
        "temp_fifo": zeros((batch, cfg.hop - b_delay)),  # 320 − 159 = 161
        "near_fifo": torch.zeros((batch, cfg.hop), dtype=torch.int16, device=dev),
        "near_tail": zeros((batch, carry2)),
        "temp_tail": zeros((batch, carry2)),
        "fsmn": [zeros((batch, cfg.lorder - 1, cfg.hidden)) for _ in range(cfg.depth)],
        "ola_tail": zeros((batch, carry2)),
    }


def dfsmn_aec_stream_step(params, state: dict, near_chunk: torch.Tensor,
                          far_chunk: torch.Tensor, cfg: DfsmnAecConfig = DfsmnAecConfig()):
    """One cascade step: int16 chunks (B, m·hop) → (state, int16 out[, vad]).

    The delay against the offline cascade is 2·hop samples (one hop of
    backend re-alignment and the stage-2 zero prefix); inside the clip the
    output matches the offline path past the FSMN's receptive field."""
    if near_chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {near_chunk.shape[-1]} must be a multiple of hop "
                         f"{cfg.hop}")
    bcfg, _, b_step, _ = _stream_backend(cfg)
    m = near_chunk.shape[-1]
    bstate, temp_raw = b_step(params["backend"], state["backend"], near_chunk, far_chunk, bcfg)

    # temp lags the input by the backend's delay: buffer it (and near) so
    # that both lag by exactly one stage-2 hop
    temp_buf = torch.cat([state["temp_fifo"], temp_raw], dim=-1)
    near_buf = torch.cat([state["near_fifo"], near_chunk], dim=-1)
    buf_n = torch.cat([state["near_tail"], pcm_in(near_buf[:, :m])], dim=-1)
    buf_t = torch.cat([state["temp_tail"], temp_buf[:, :m]], dim=-1)

    feat, frames = _features(buf_n, buf_t, cfg)
    mask, fsmn_state, vad = _mask(params, feat, cfg, state["fsmn"])
    out, new_tail = stream_istft(_masked_spectrum(frames, mask, cfg), cfg.mask_cfg,
                                 state["ola_tail"], m)
    carry2 = cfg.frame_len - cfg.hop
    new_state = {"backend": bstate, "temp_fifo": temp_buf[:, m:], "near_fifo": near_buf[:, m:],
                 "near_tail": buf_n[:, -carry2:], "temp_tail": buf_t[:, -carry2:],
                 "fsmn": fsmn_state, "ola_tail": new_tail}
    result = pcm_out(out)
    return (new_state, (result, vad)) if cfg.output_vad else (new_state, result)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draws in the JAX package's layouts, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def mask_net_config(cfg: DfsmnAecConfig) -> DfsmnConfig:
    """The DFSMN geometry of the cascade's mask net (3·n_mels in, 321 bins out)."""
    return DfsmnConfig(n_mels=3 * cfg.n_mels, hidden=cfg.hidden, depth=cfg.depth,
                       lorder=cfg.lorder, n_fft=cfg.frame_len, hop=cfg.hop)


def init_dfsmn_aec_numpy(seed: int = 0, cfg: DfsmnAecConfig = DfsmnAecConfig()) -> dict:
    """Random cascade parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.dfsmn_aec.init_dfsmn_aec``: the backend's
    numpy init (NKF's with its damped gain), DFSMN's for the mask net and,
    with ``output_vad``, a glorot VAD head; the three draws are seeded from
    ``numpy.random.default_rng(seed)``."""
    bcfg, backend_init, _ = _backend(cfg)
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31, 3)
    params = {"backend": backend_init(int(seeds[0]), bcfg),
              "mask_net": init_dfsmn_numpy(int(seeds[1]), mask_net_config(cfg))}
    if cfg.output_vad:
        params["vad_head"] = dense_np(np.random.default_rng(seeds[2]), cfg.hidden, 1)
    return params


def init_dfsmn_aec(seed: int = 0, cfg: DfsmnAecConfig = DfsmnAecConfig(), device=None) -> dict:
    """Random cascade parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_dfsmn_aec_numpy(seed, cfg), device)
