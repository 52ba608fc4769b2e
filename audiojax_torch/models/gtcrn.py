"""GTCRN — 16 kHz speech denoiser, offline path, in PyTorch.

Counterpart of ``audiojax.models.gtcrn``: ERB 65+64 band split, SFE subband
unfolding, conv encoder/decoder with causal group-temporal conv blocks
(dilations 1/2/5), TRA recurrent attention, two grouped dual-path GRU blocks
over frequency (width 33) and time, complex ratio mask, int16 PCM contract
with the STFT (512/256, hann_sqrt, reflect) on the card's kernels.

Layout is channel-last ``(B, T, F, C)`` throughout, as in the JAX package.

Streaming (state carry): ``gtcrn_stream_init`` / ``gtcrn_stream_step`` carry
every temporal dependency (the depthwise conv caches, the TRA GRU states,
the dual-path inter GRU states, the audio framing tail and the overlap-add
tail) across chunks, so a stream's latency is its block plus n_fft − hop
samples.  The step's analysis is B1 (``fast_stft_packed``, uncentred); its
synthesis is ``dsp.stft.stream_istft``.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import fold_windows, pcm_in, pcm_out, remove_dc, resample_linear, unfold_windows
from ..device import resolve_device
from ..dsp.stft import StftConfig, stream_istft
from ..nn import core, rnn
from ..nn.erb import erb_compress, erb_expand
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, conv_np, dense_np

__all__ = [
    "GtcrnConfig",
    "GTCRN",
    "sfe",
    "tra",
    "conv_block",
    "gt_conv_block",
    "dpgrnn",
    "gtcrn_backbone",
    "gtcrn_net",
    "gtcrn_forward",
    "gtcrn_stream_init",
    "gtcrn_stream_step",
    "init_gtcrn",
    "make_gtcrn",
]


@dataclasses.dataclass(frozen=True)
class GtcrnConfig:
    n_fft: int = 512
    hop: int = 256
    window: str = "hann_sqrt"
    pad_mode: str = "reflect"
    n_low: int = 65
    n_erb: int = 64
    channels: int = 16
    width: int = 33  # frequency width at the dual-path stage
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0  # batch-fold window length in samples; 0 = off
    center: bool = True
    erb_scale: float = 21.4
    dec_gt_deconv: bool = True  # decoder GT depth convs as transposed convs

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode=self.pad_mode, center=self.center)


# ─────────────────────────────────────────────────────────────────────────────
# Blocks
# ─────────────────────────────────────────────────────────────────────────────


def sfe(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Subband feature extraction: channel-last unfold over frequency.

    Output channel c*kernel+o is input channel c shifted by (o - k//2) bins.
    """
    half = (kernel - 1) // 2
    f = x.shape[-2]
    xp = F.pad(x, (0, 0, half, half))
    shifted = [xp[..., o : o + f, :] for o in range(kernel)]
    return torch.stack(shifted, dim=-1).reshape(*x.shape[:-1], x.shape[-1] * kernel)


def tra(p, x: torch.Tensor, h: torch.Tensor | None = None, *, return_state: bool = False):
    """Temporal recurrent attention: GRU over per-frame channel energies.
    ``h`` carries the GRU state across streaming chunks."""
    z = torch.mean(x * x, dim=-2)  # (B, T, C)
    g, h_last = rnn.gru(p["gru"], z, h, return_state=True)
    a = torch.sigmoid(core.dense(p["fc"], g))
    y = x * a[..., None, :]
    return (y, h_last) if return_state else y


def conv_block(p, x, *, stride, padding, groups=1, deconv=False, last=False):
    f = core.conv2d_transpose if deconv else core.conv2d
    y = f(p["conv"], x, stride=stride, padding=padding, groups=groups)
    return torch.tanh(y) if last else core.prelu(p, y)


def gt_conv_block(p, x: torch.Tensor, *, dilation: int, deconv: bool, state=None):
    """Group temporal conv block.

    Causal over time: the encoder pads (k-1)·d zero frames on the left; the
    decoder uses a transposed conv and trims the (k-1)·d tail frames.  Both
    depend only on the current and the previous 2·dilation frames, so a
    stream carries a ``cache`` of those frames and the TRA GRU state; with
    ``state`` the block returns ``(out, new_state)``.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    pad_t = 2 * dilation  # (kernel_t - 1) * dilation with kernel_t = 3

    h = core.prelu(p["pc1"], core.conv2d(p["pc1"], sfe(x1)))
    new_cache = None
    if state is None and deconv:
        # offline deconv: implicit zero history; trim the future tail
        h = core.conv2d_transpose(p["depth"], h, padding=(0, 1), dilation=(dilation, 1),
                                  groups=h.shape[-1])
        h = h[:, :-pad_t]
    else:
        hist = h.new_zeros((h.shape[0], pad_t) + h.shape[2:]) if state is None else state["cache"]
        hx = torch.cat([hist, h], dim=1)  # (B, pad_t + T, F, C)
        new_cache = hx[:, -pad_t:]
        if deconv:
            y = core.conv2d_transpose(p["depth"], hx, padding=(0, 1), dilation=(dilation, 1),
                                      groups=hx.shape[-1])
            h = y[:, pad_t:-pad_t]  # drop the history-only head and the future tail
        else:
            h = core.conv2d(p["depth"], hx, padding=(0, 1), dilation=(dilation, 1),
                            groups=hx.shape[-1])
    h = core.prelu(p["depth_a"], h)
    h = core.conv2d(p["pc2"], h)
    h, tra_h = tra(p["tra"], h, None if state is None else state["tra"], return_state=True)
    # interleave transformed/bypass channels: out[2i]=h[i], out[2i+1]=x2[i]
    out = torch.stack([h, x2], dim=-1).reshape(*x.shape[:-1], 2 * half)
    if state is None:
        return out
    return out, {"cache": new_cache, "tra": tra_h}


def dpgrnn(p, x: torch.Tensor, *, width: int, hidden: int, state=None,
           return_state: bool = False):
    """Grouped dual-path RNN over (freq=width) then (time), each path with
    Linear + LayerNorm((width, hidden)) + residual.

    The intra path runs over frequency (stateless in time); the inter path is
    a unidirectional GRU over time whose hidden state (G=2, B·width, C/2),
    batch-major, carries across streaming chunks through ``state``."""
    b, t, w, c = x.shape

    intra = x.reshape(b * t, w, c)
    intra = rnn.grouped_gru_bidir(p["intra_fwd"], p["intra_bwd"], intra, groups=2)
    intra = core.dense(p["intra_fc"], intra).reshape(b, t, w, hidden)
    x = x + core.layer_norm(p["intra_ln"], intra, ndims=2, eps=1e-8)

    inter = x.transpose(1, 2).reshape(b * w, t, c)
    inter, h_last = rnn.grouped_gru(p["inter"], inter, groups=2, h0=state, return_state=True)
    inter = core.dense(p["inter_fc"], inter).reshape(b, w, t, hidden)
    out = x + core.layer_norm(p["inter_ln"], inter.transpose(1, 2), ndims=2, eps=1e-8)
    return (out, h_last) if return_state else out


# ─────────────────────────────────────────────────────────────────────────────
# Network
# ─────────────────────────────────────────────────────────────────────────────

_ENC_DIL = (1, 2, 5)


def gtcrn_backbone(p, feat: torch.Tensor, cfg: GtcrnConfig, state=None):
    """ERB-compressed feature map (B, T, F, C) → complex mask (B, T, F, 2).

    With ``state`` (from :func:`gtcrn_stream_init`) all temporal context is
    carried across chunks and ``(mask, new_state)`` is returned."""
    feat = erb_compress(feat, cfg.n_low, cfg.n_erb, cfg.n_fft, scale=cfg.erb_scale)
    feat = sfe(feat)  # (B, T, 129, 3C)

    e = conv_block(p["enc0"], feat, stride=(1, 2), padding=(0, 2))
    skips = [e]
    e = conv_block(p["enc1"], e, stride=(1, 2), padding=(0, 2), groups=2)
    skips.append(e)
    ns = {"enc_gt": [], "dec_gt": []} if state is not None else None
    for i, d in enumerate(_ENC_DIL):
        if state is None:
            e = gt_conv_block(p[f"enc_gt{i}"], e, dilation=d, deconv=False)
        else:
            e, s = gt_conv_block(p[f"enc_gt{i}"], e, dilation=d, deconv=False,
                                 state=state["enc_gt"][i])
            ns["enc_gt"].append(s)
        skips.append(e)

    if state is None:
        e = dpgrnn(p["dp1"], e, width=cfg.width, hidden=cfg.channels)
        e = dpgrnn(p["dp2"], e, width=cfg.width, hidden=cfg.channels)
    else:
        e, ns["dp1"] = dpgrnn(p["dp1"], e, width=cfg.width, hidden=cfg.channels,
                              state=state["dp1"], return_state=True)
        e, ns["dp2"] = dpgrnn(p["dp2"], e, width=cfg.width, hidden=cfg.channels,
                              state=state["dp2"], return_state=True)

    for i, d in enumerate(reversed(_ENC_DIL)):
        if state is None:
            e = gt_conv_block(p[f"dec_gt{i}"], e + skips[4 - i], dilation=d,
                              deconv=cfg.dec_gt_deconv)
        else:
            e, s = gt_conv_block(p[f"dec_gt{i}"], e + skips[4 - i], dilation=d,
                                 deconv=cfg.dec_gt_deconv, state=state["dec_gt"][i])
            ns["dec_gt"].append(s)
    e = conv_block(p["dec1"], e + skips[1], stride=(1, 2), padding=(0, 2), groups=2, deconv=True)
    m = conv_block(p["dec0"], e + skips[0], stride=(1, 2), padding=(0, 2), deconv=True, last=True)
    mask = erb_expand(m, cfg.n_low, cfg.n_erb, cfg.n_fft, scale=cfg.erb_scale)
    return mask if state is None else (mask, ns)


def _apply_mask(spec_ri: torch.Tensor, mask: torch.Tensor, fb: int) -> torch.Tensor:
    re, im = spec_ri[..., :fb], spec_ri[..., fb:]
    m0, m1 = mask[..., 0], mask[..., 1]
    return torch.cat([re * m0 - im * m1, im * m0 + re * m1], dim=-1)


def _features(spec_ri: torch.Tensor, fb: int) -> torch.Tensor:
    re, im = spec_ri[..., :fb], spec_ri[..., fb:]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    return torch.stack([mag, re, im], dim=-1)  # (B, T, F, 3)


def gtcrn_net(p, spec_ri: torch.Tensor, cfg: GtcrnConfig) -> torch.Tensor:
    """Enhance a packed spectrum: (B, T, 2F) → (B, T, 2F)."""
    fb = cfg.stft.f_bins
    return _apply_mask(spec_ri, gtcrn_backbone(p, _features(spec_ri, fb), cfg), fb)


def gtcrn_forward(params, audio: torch.Tensor, cfg: GtcrnConfig = GtcrnConfig()) -> torch.Tensor:
    """int16 PCM (B, L) → denoised int16 PCM (B, L).

    Resample sandwich, 1/32768 scale, DC removal, optional batch-fold, STFT
    kernel, network, ISTFT kernel, ×32767 + int16 clamp.
    """
    x = pcm_in(audio)
    if cfg.in_sample_rate > cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)
    x = remove_dc(x)
    if cfg.in_sample_rate < cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)

    batch = x.shape[0]
    model_len = x.shape[-1]
    # pad to a whole number of hops (or fold windows) so STFT→ISTFT is
    # length-exact
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = -(-model_len // align) * align
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    spec = fast_stft_packed(x.contiguous(), cfg.stft)
    enhanced = gtcrn_net(params, spec, cfg)
    y = fast_istft_packed(enhanced.contiguous(), cfg.stft)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, y.shape[-1] * cfg.out_sample_rate // cfg.sample_rate)
    return pcm_out(y)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming (state carry)
# ─────────────────────────────────────────────────────────────────────────────


def gtcrn_stream_init(cfg: GtcrnConfig = GtcrnConfig(), batch: int = 1, device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card): the audio
    framing tail, per-block depthwise conv caches and TRA GRU states, the
    dual-path inter GRU states (G=2, batch·width, C/2), batch-major, and the
    synthesis overlap-add tail."""
    if cfg.in_sample_rate != cfg.sample_rate or cfg.out_sample_rate != cfg.sample_rate:
        raise ValueError(
            f"streaming runs at the model rate only ({cfg.sample_rate} Hz); "
            "resample on the host (the offline forward resamples "
            "in-graph, the stream step does not)")
    dev = resolve_device(device)
    c = cfg.channels
    carry = cfg.n_fft - cfg.hop
    zeros = partial(torch.zeros, dtype=torch.float32, device=dev)

    def gt_state(d):
        return {"cache": zeros((batch, 2 * d, cfg.width, c)), "tra": zeros((batch, c))}

    return {
        "audio_tail": zeros((batch, carry)),
        "net": {
            "enc_gt": [gt_state(d) for d in _ENC_DIL],
            "dec_gt": [gt_state(d) for d in reversed(_ENC_DIL)],
            "dp1": zeros((2, batch * cfg.width, c // 2)),
            "dp2": zeros((2, batch * cfg.width, c // 2)),
        },
        "ola_tail": zeros((batch, carry)),
    }


def gtcrn_stream_step(params, state: dict, chunk: torch.Tensor,
                      cfg: GtcrnConfig = GtcrnConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming step: int16 chunk (B, k·hop) → (state, int16 out (B, k·hop)).

    The stream processes the input as if (n_fft − hop) zeros were prepended,
    with snip-edges (center=False) framing: output sample i equals the
    offline ``center=False`` path on that zero-prepended signal for i ≥ hop
    (to within float32 reassociation), delayed by n_fft − hop samples
    against the live input.  No DC removal (the offline path removes the
    clip's mean, which a live stream cannot know).
    """
    if chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {chunk.shape[-1]} must be a multiple of hop {cfg.hop}")
    x = pcm_in(chunk)
    buf = torch.cat([state["audio_tail"], x], dim=-1)

    frame_cfg = dataclasses.replace(cfg.stft, center=False)
    spec = fast_stft_packed(buf, frame_cfg)  # (B, k, 2F), B1
    fb = frame_cfg.f_bins
    mask, net_state = gtcrn_backbone(params, _features(spec, fb), cfg, state=state["net"])
    enhanced = _apply_mask(spec, mask, fb)

    carry = cfg.n_fft - cfg.hop
    out, new_tail = stream_istft(enhanced, frame_cfg, state["ola_tail"], chunk.shape[-1])
    new_state = {"audio_tail": buf[:, -carry:], "net": net_state, "ola_tail": new_tail}
    return new_state, pcm_out(out)


def make_gtcrn(cfg: GtcrnConfig = GtcrnConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(gtcrn_forward, cfg=cfg)


class GTCRN(ParamModule):
    """GTCRN with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape.  ``params`` is the nested dict view
    that the functional API takes.
    """

    def __init__(self, params, cfg: GtcrnConfig = GtcrnConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return gtcrn_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _gru_np(rng, din, hidden, stack=()):
    s = 1.0 / np.sqrt(hidden)
    u = lambda *sh: rng.uniform(-s, s, stack + sh).astype(np.float32)
    return {"w_i": u(din, 3 * hidden), "w_h": u(hidden, 3 * hidden),
            "b_i": u(3 * hidden), "b_h": u(3 * hidden)}


def _alpha(c):
    return np.full((c,), 0.25, np.float32)


def _conv_block_np(rng, cin, cout, groups=1, last=False):
    p = {"conv": conv_np(rng, (1, 5), cin, cout, groups=groups)}
    if not last:
        p["alpha"] = _alpha(cout)
    return p


def _gt_block_np(rng, c):
    half, hid = c // 2, c
    return {
        "pc1": {**conv_np(rng, (1, 1), half * 3, hid), "alpha": _alpha(hid)},
        "depth": conv_np(rng, (3, 3), hid, hid, groups=hid),
        "depth_a": {"alpha": _alpha(hid)},
        "pc2": conv_np(rng, (1, 1), hid, half),
        "tra": {"gru": _gru_np(rng, half, 2 * half), "fc": dense_np(rng, 2 * half, half)},
    }


def _dpgrnn_np(rng, c, width):
    ln = lambda: {"g": np.ones((width, c), np.float32), "b": np.zeros((width, c), np.float32)}
    return {
        "intra_fwd": _gru_np(rng, c // 2, c // 4, stack=(2,)),
        "intra_bwd": _gru_np(rng, c // 2, c // 4, stack=(2,)),
        "intra_fc": dense_np(rng, c, c),
        "intra_ln": ln(),
        "inter": _gru_np(rng, c // 2, c // 2, stack=(2,)),
        "inter_fc": dense_np(rng, c, c),
        "inter_ln": ln(),
    }


def init_gtcrn_numpy(seed: int = 0, cfg: GtcrnConfig = GtcrnConfig()) -> dict:
    """Random GTCRN parameters as numpy arrays, with the JAX package's keys,
    shapes and layouts (``audiojax.models.gtcrn.init_gtcrn``), drawn from
    ``numpy.random.default_rng(seed)`` with the same distributions."""
    rng = np.random.default_rng(seed)
    c = cfg.channels
    params = {
        "enc0": _conv_block_np(rng, 9, c),
        "enc1": _conv_block_np(rng, c, c, groups=2),
        "dec1": _conv_block_np(rng, c, c, groups=2),
        "dec0": _conv_block_np(rng, c, 2, last=True),
        "dp1": _dpgrnn_np(rng, c, cfg.width),
        "dp2": _dpgrnn_np(rng, c, cfg.width),
    }
    for i in range(3):
        params[f"enc_gt{i}"] = _gt_block_np(rng, c)
        params[f"dec_gt{i}"] = _gt_block_np(rng, c)
    return params


def init_gtcrn(seed: int = 0, cfg: GtcrnConfig = GtcrnConfig(), device=None) -> dict:
    """Random GTCRN parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_gtcrn_numpy(seed, cfg), device)
