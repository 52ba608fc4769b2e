"""H-GTCRN — two-microphone hybrid denoiser (WPE → AuxIVA → GTCRN-IVA), 16 kHz,
in PyTorch.

Counterpart of ``audiojax.models.h_gtcrn``: the two microphones' STFT
(512/256, hann, reflect; one B1 launch over 2·B rows) → WPE dereverberation
(rt60·fs/hop taps, complex CG) → 10-iteration AuxIVA → the source of lower
energy picked → 6-channel features [mic 0 re/im, mic 1 re/im, picked
log-magnitude, other log-magnitude] → GTCRN's backbone (ERB scale 24.7,
regular causal convs in the decoder's GT blocks, an 18-channel first conv)
→ complex ratio mask on mic 0 → ISTFT (B2).  DC removal takes the mean over
both microphones.  A window of silence makes WPE divide 0 by 0: its rows
turn NaN, which stays in them (every stage keeps batch rows apart) and
becomes 0 at the output, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import pcm_in, resample_linear
from ..dsp.stft import StftConfig
from ..nn.spatial import auxiva, wpe
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, conv_np
from .gtcrn import GtcrnConfig, gtcrn_backbone, init_gtcrn_numpy

__all__ = ["HGtcrnConfig", "HGTCRN", "source_energies", "h_gtcrn_forward",
           "init_h_gtcrn_numpy", "init_h_gtcrn", "make_h_gtcrn"]


@dataclasses.dataclass(frozen=True)
class HGtcrnConfig:
    n_fft: int = 512
    hop: int = 256
    window: str = "hann"
    pad_mode: str = "reflect"
    rt60: float = 0.3
    wpe_delay: int = 2
    wpe_iter: int = 1
    cg_iter: int = 36
    iva_iter: int = 10
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window, pad_mode=self.pad_mode)

    @property
    def wpe_taps(self) -> int:
        return int(self.rt60 * self.sample_rate / self.hop)

    @property
    def gtcrn_cfg(self) -> GtcrnConfig:
        return GtcrnConfig(n_fft=self.n_fft, hop=self.hop, window=self.window,
                           pad_mode=self.pad_mode, erb_scale=24.7, dec_gt_deconv=False)


def _front(audio: torch.Tensor, cfg: HGtcrnConfig):
    """int16 (B, 2, L) → (DC-removed model-rate length, spectrum (B, 2, T, F)
    complex, separated sources (B, 2, F, T) complex)."""
    b, ch, length = audio.shape
    if ch != 2:
        raise ValueError(f"H-GTCRN takes 2-channel input, got {ch}")
    x = pcm_in(audio)
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, length * cfg.sample_rate // cfg.in_sample_rate)
    x = x - torch.mean(x, dim=(-2, -1), keepdim=True)  # global DC over both mics

    model_len = x.shape[-1]
    padded = -(-model_len // cfg.hop) * cfg.hop
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))

    packed = fast_stft_packed(x.reshape(b * 2, -1).contiguous(), cfg.stft)  # B1, (2B, T, 2F)
    fb = cfg.stft.f_bins
    t = packed.shape[1]
    spec = torch.complex(packed[..., :fb], packed[..., fb:]).reshape(b, 2, t, fb)
    drb = wpe(spec.transpose(2, 3), taps=cfg.wpe_taps, delay=cfg.wpe_delay,
              num_iter=cfg.wpe_iter, cg_iter=cfg.cg_iter)
    return model_len, spec, auxiva(drb, n_iter=cfg.iva_iter)


def source_energies(audio: torch.Tensor, cfg: HGtcrnConfig = HGtcrnConfig()) -> torch.Tensor:
    """The two separated sources' energies (B, 2) that pick the source: the
    first is picked where it is the lower (a near tie can pick differently
    on two devices)."""
    return torch.sum(torch.abs(_front(audio, cfg)[2]) ** 2, dim=(2, 3))


def h_gtcrn_forward(params, audio: torch.Tensor,
                    cfg: HGtcrnConfig = HGtcrnConfig()) -> torch.Tensor:
    """int16 (B, 2, L) two-microphone audio → denoised int16 (B, L)."""
    model_len, spec, sep = _front(audio, cfg)

    power = torch.abs(sep) ** 2
    energy = torch.sum(power, dim=(2, 3))  # (B, 2)
    pick_first = (energy[:, 0] < energy[:, 1])[:, None, None]
    log_mag = 0.5 * torch.log10(torch.clamp(power, min=1e-24))  # (B, 2, F, T)
    sel_log = torch.where(pick_first, log_mag[:, 0], log_mag[:, 1])
    unsel_log = torch.where(pick_first, log_mag[:, 1], log_mag[:, 0])
    feat = torch.stack([spec[:, 0].real, spec[:, 0].imag, spec[:, 1].real, spec[:, 1].imag,
                        sel_log.transpose(1, 2), unsel_log.transpose(1, 2)], dim=-1)

    m = gtcrn_backbone(params, feat, cfg.gtcrn_cfg)  # (B, T, F, 2)
    re0, im0 = spec[:, 0].real, spec[:, 0].imag
    s_re = re0 * m[..., 0] - im0 * m[..., 1]
    s_im = im0 * m[..., 0] + re0 * m[..., 1]
    y = fast_istft_packed(torch.cat([s_re, s_im], dim=-1), cfg.stft)  # B2
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    y = torch.where(torch.isnan(y), torch.zeros_like(y), y * 32767.0)
    return torch.clamp(y, -32768.0, 32767.0).to(torch.int16)


def make_h_gtcrn(cfg: HGtcrnConfig = HGtcrnConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(h_gtcrn_forward, cfg=cfg)


class HGTCRN(ParamModule):
    """H-GTCRN with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, 2, L)`` on the module's device
    and returns int16 PCM ``(B, L)``."""

    def __init__(self, params, cfg: HGtcrnConfig = HGtcrnConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return h_gtcrn_forward(self.params, audio, self.cfg)


def init_h_gtcrn_numpy(seed: int = 0, cfg: HGtcrnConfig = HGtcrnConfig()) -> dict:
    """Random H-GTCRN parameters as numpy arrays: GTCRN's tree
    (``init_gtcrn_numpy``) with an 18-channel first encoder conv, as
    ``audiojax.models.h_gtcrn.init_h_gtcrn`` lays it out."""
    gcfg = cfg.gtcrn_cfg
    params = init_gtcrn_numpy(seed, gcfg)
    params["enc0"]["conv"] = conv_np(np.random.default_rng([seed, 1]), (1, 5), 18, gcfg.channels)
    return params


def init_h_gtcrn(seed: int = 0, cfg: HGtcrnConfig = HGtcrnConfig(), device=None) -> dict:
    """Random H-GTCRN parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_h_gtcrn_numpy(seed, cfg), device)
