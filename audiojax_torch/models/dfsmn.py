"""DFSMN — 48 kHz causal denoiser (ModelScope DfsmnAns PSM mask network), in PyTorch.

Counterpart of ``audiojax.models.dfsmn``: Kaldi log-mel fbank (120 mel,
1920/960 frames, 2048-point DFT, pre-emphasis 0.97, per-frame DC removal)
and a 1920-point mask STFT over the SAME frames; mask net = linear(120→256)
→ ReLU → depth × UniDeepFsmn (ReLU-linear → projection → causal depthwise
memory conv of ``lorder`` taps, the inner residual folded into the
current-frame tap) → linear(256→961) → sigmoid mask; ISTFT with a
*periodic* Hamming synthesis window (the analysis window is symmetric),
uncentred.

On the card each FSMN memory runs on kernel B4 (``nn.core.conv1d`` routes
every depthwise conv there) and the synthesis on kernel B2
(``fast_istft_packed``).  The analysis stays a matrix product of the frames
with the plain DFT basis, as in the JAX package: the fbank and the mask STFT
share those frames.

Streaming: ``dfsmn_mask_net`` threads an explicit per-layer memory state
``(B, lorder − 1, hidden)``; ``dfsmn_stream_init`` / ``dfsmn_stream_step``
carry it, the audio framing tail and the overlap-add tail across chunks.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dsp.pcm import INV_INT16, fold_windows, pcm_in, pcm_out, resample_linear, unfold_windows
from ..dsp.stft import StftConfig, frame_signal, stft_basis, stream_istft
from ..frontend.kaldi import log_mel_fbank
from ..nn import core
from ..ops.stft_cuda import fast_istft_packed
from ..params import params_from_numpy
from .base import ParamModule, dense_np, glorot_np

__all__ = [
    "DfsmnConfig",
    "DFSMN",
    "dfsmn_mask_net",
    "dfsmn_forward",
    "dfsmn_stream_init",
    "dfsmn_stream_step",
    "init_dfsmn_numpy",
    "init_dfsmn",
    "make_dfsmn",
]


@dataclasses.dataclass(frozen=True)
class DfsmnConfig:
    n_mels: int = 120
    hidden: int = 256
    depth: int = 9
    lorder: int = 20
    n_fft: int = 1920
    hop: int = 960
    kaldi_nfft: int = 2048
    preemph: float = 0.97
    sample_rate: int = 48000
    in_sample_rate: int = 48000
    out_sample_rate: int = 48000
    fold_window: int = 0

    @property
    def frame_cfg(self) -> StftConfig:
        # analysis framing shared by the fbank and the mask STFT: symmetric
        # Hamming, snip-edges (center=False)
        return StftConfig(self.n_fft, self.hop, window="hamming_symmetric", center=False)

    @property
    def istft_cfg(self) -> StftConfig:
        # synthesis uses the PERIODIC Hamming window (librosa.istft's default)
        return StftConfig(self.n_fft, self.hop, window="hamming_periodic", center=False)

    @property
    def stft_bins(self) -> int:
        return self.n_fft // 2 + 1


def dfsmn_mask_net(p, fbank: torch.Tensor, state=None, *, return_trunk: bool = False):
    """(B, T, n_mels) log-fbank → ((B, T, stft_bins) sigmoid mask, new state).

    ``state``: optional per-layer causal memories, each (B, lorder − 1,
    hidden); passing the returned state into the next call continues the
    causal memory exactly (streaming).  With ``return_trunk`` the FSMN trunk
    before the mask head (B, T, hidden) comes third: the DFSMN-AEC VAD head
    reads it."""
    x = torch.relu(core.dense(p["lin1"], fbank))
    lorder = core.weight_shape(p["layers"][0]["mem"]["w"])[-1]  # the port's (C, 1, lorder)
    new_state = []
    for i, layer in enumerate(p["layers"]):
        f1 = torch.relu(core.dense(layer["lin"], x))
        p1 = core.dense(layer["proj"], f1)
        pad = (p1.new_zeros((p1.shape[0], lorder - 1, p1.shape[-1])) if state is None
               else state[i])
        mem_in = torch.cat([pad, p1], dim=1)
        # the depthwise causal memory conv (B4 on the card); the importer
        # folds the inner residual (p1 + conv(p1)) into the current-frame tap
        mem = core.conv1d(layer["mem"], mem_in, groups=p1.shape[-1])
        # slice by start: -(lorder-1) with lorder=1 would keep the WHOLE buffer
        new_state.append(mem_in[:, mem_in.shape[1] - (lorder - 1):])
        x = x + mem
    mask = torch.sigmoid(core.dense(p["lin2"], x))
    return (mask, new_state, x) if return_trunk else (mask, new_state)


def _analysis(x: torch.Tensor, cfg: DfsmnConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared framing → (log-fbank (B, T, n_mels), packed spectrum (B, T, 2F))."""
    frames = frame_signal(x, cfg.frame_cfg)
    fbank = log_mel_fbank(x, frame_len=cfg.n_fft, hop=cfg.hop, nfft=cfg.kaldi_nfft,
                          n_mels=cfg.n_mels, fs=cfg.sample_rate, preemph=cfg.preemph,
                          power_scale=1.0 / (INV_INT16 * INV_INT16), frames=frames)
    return fbank, torch.matmul(frames, stft_basis(cfg.frame_cfg, x.device))


def dfsmn_forward(params, audio: torch.Tensor, cfg: DfsmnConfig = DfsmnConfig()) -> torch.Tensor:
    """int16 PCM (B, L) at the input rate → denoised int16 PCM (B, L_out)."""
    x = pcm_in(audio)
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, int(round(x.shape[-1] * cfg.sample_rate / cfg.in_sample_rate)))

    batch = x.shape[0]
    model_len = x.shape[-1]
    if cfg.fold_window and (cfg.fold_window % cfg.hop or cfg.fold_window < cfg.n_fft):
        raise ValueError(
            f"fold_window={cfg.fold_window} must be a hop ({cfg.hop}) multiple "
            f">= n_fft ({cfg.n_fft}): the snip-edges ISTFT emits frames*hop "
            f"samples per window and a misaligned fold silently drops samples "
            f"at every window boundary")
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = max(-(-model_len // align) * align, cfg.n_fft)
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    fbank, spec = _analysis(x, cfg)
    mask, _ = dfsmn_mask_net(params, fbank)
    y = fast_istft_packed((spec * torch.cat([mask, mask], dim=-1)).contiguous(), cfg.istft_cfg)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    # the uncentred ISTFT emits n_fft + hop·(T − 1) = padded samples; trim the tail
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, int(round(model_len * cfg.out_sample_rate / cfg.sample_rate)))
    return pcm_out(y)


def make_dfsmn(cfg: DfsmnConfig = DfsmnConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(dfsmn_forward, cfg=cfg)


class DFSMN(ParamModule):
    """DFSMN with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape."""

    def __init__(self, params, cfg: DfsmnConfig = DfsmnConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return dfsmn_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming (state carry)
# ─────────────────────────────────────────────────────────────────────────────


def dfsmn_stream_init(cfg: DfsmnConfig = DfsmnConfig(), batch: int = 1, device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card): the audio tail
    (n_fft − hop raw samples), the per-layer FSMN memories and the overlap-add
    tail of the synthesis window."""
    if cfg.in_sample_rate != cfg.sample_rate or cfg.out_sample_rate != cfg.sample_rate:
        raise ValueError(
            f"streaming runs at the model rate only ({cfg.sample_rate} Hz); "
            "resample on the host (the offline forward resamples "
            "in-graph, the stream step does not)")
    zeros = partial(torch.zeros, dtype=torch.float32, device=resolve_device(device))
    carry = cfg.n_fft - cfg.hop
    return {
        "audio_tail": zeros((batch, carry)),
        "fsmn": [zeros((batch, cfg.lorder - 1, cfg.hidden)) for _ in range(cfg.depth)],
        "ola_tail": zeros((batch, carry)),
    }


def dfsmn_stream_step(params, state: dict, chunk: torch.Tensor,
                      cfg: DfsmnConfig = DfsmnConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming step: int16 chunk (B, k·hop) → (state, int16 out (B, k·hop)).

    The stream processes the input as if (n_fft − hop) zeros were prepended:
    output sample i equals the offline path's on that zero-prepended signal
    for i ≥ hop, to within 1 int16 LSB (float32 reassociation), delayed by
    n_fft − hop samples against the plain offline output; the extra
    zero-context first frame perturbs the mask only within the FSMN
    receptive field, 1 + depth·(lorder − 1) frames.
    """
    if chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {chunk.shape[-1]} must be a multiple of hop {cfg.hop}")
    buf = torch.cat([state["audio_tail"], pcm_in(chunk)], dim=-1)
    fbank, spec = _analysis(buf, cfg)  # k frames
    mask, fsmn_state = dfsmn_mask_net(params, fbank, state["fsmn"])
    masked = spec * torch.cat([mask, mask], dim=-1)
    out, new_tail = stream_istft(masked, cfg.istft_cfg, state["ola_tail"], chunk.shape[-1])
    carry = cfg.n_fft - cfg.hop
    return {"audio_tail": buf[:, -carry:], "fsmn": fsmn_state, "ola_tail": new_tail}, pcm_out(out)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def init_dfsmn_numpy(seed: int = 0, cfg: DfsmnConfig = DfsmnConfig()) -> dict:
    """Random DFSMN parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.dfsmn.init_dfsmn`` and its distributions
    (the memory taps glorot × 0.1, the current-frame tap + 1: the folded
    inner residual), drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    layers = []
    for _ in range(cfg.depth):
        lin = dense_np(rng, cfg.hidden, cfg.hidden)
        proj = dense_np(rng, cfg.hidden, cfg.hidden, bias=False)
        mem_w = glorot_np(rng, (cfg.lorder, 1, cfg.hidden)) * np.float32(0.1)
        mem_w[-1, 0, :] += 1.0
        layers.append({"lin": lin, "proj": proj, "mem": {"w": mem_w}})
    return {
        "lin1": dense_np(rng, cfg.n_mels, cfg.hidden),
        "lin2": dense_np(rng, cfg.hidden, cfg.stft_bins),
        "layers": layers,
    }


def init_dfsmn(seed: int = 0, cfg: DfsmnConfig = DfsmnConfig(), device=None) -> dict:
    """Random DFSMN parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_dfsmn_numpy(seed, cfg), device)
