"""UL-UNAS — NAS-derived U-Net denoiser, 16 kHz, in PyTorch.

Counterpart of ``audiojax.models.ul_unas``: log-power ERB features → an
encoder of NAS-chosen blocks (XConvBlock / XDWSBlock / XMBBlocks, causal in
time by a symmetric time pad and a tail trim), each gated by a causal
time-frequency attention (cTFA: a temporal GRU gate times a frequency-GRU
gate) and AffinePReLU → two grouped dual-path GRU blocks (GTCRN's
``dpgrnn``) → the mirrored
decoder → sigmoid mask on the packed spectrum → ISTFT.  BatchNorm is fused
into the convs by the importer.

On the card the offline forward's analysis is B1 and its synthesis B2
(``ops/stft_cuda.py``, 512/256 hann reflect, centred); the 2-D depthwise and
grouped convs run on cuDNN through ``nn.core.conv2d`` / ``conv2d_transpose``,
as the JAX package leaves them to lax.

Streaming (state carry): ``ul_unas_stream_init`` / ``ul_unas_stream_step``
carry the causal conv caches ((kt − 1) frames a block; the kt = 1 blocks
carry a zero-length one), the cTFA temporal GRU states, the dual-path inter
GRU states (G=2, B·33, 8), batch-major, the audio framing tail and the
overlap-add tail.  The step's analysis is B1, uncentred; its synthesis is
``dsp.stft.stream_istft``.

Channel-last ``(B, T, F, C)`` throughout.
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
from ..nn import core, rnn
from ..nn.erb import erb_compress, erb_expand
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from . import gtcrn
from .base import ParamModule, conv_np, dense_np

__all__ = [
    "UlUnasConfig",
    "ULUNAS",
    "affine_prelu",
    "shuffle_channels",
    "freq_attention",
    "ctfa",
    "x_conv_block",
    "x_dws_block",
    "x_mb_block",
    "ul_unas_net",
    "ul_unas_forward",
    "ul_unas_stream_init",
    "ul_unas_stream_step",
    "init_ul_unas_numpy",
    "init_ul_unas",
    "make_ul_unas",
]

# encoder block plan (type, out_ch, out_width, (kt, kf), stride_f, groups):
# the NAS result, as the JAX package hard-codes it
_TYPES = (0, 2, 1, 2, 1)  # 0=XConv, 1=XDWS, 2=XMB
_CHANNELS = (12, 24, 24, 32, 16)
_WIDTHS = (65, 33, 33, 33, 33)
_KERNELS = ((3, 3), (2, 3), (2, 3), (1, 5), (1, 5))
_STRIDES = (2, 2, 1, 1, 1)
_GROUPS = (1, 2, 2, 2, 2)
_SPECS = tuple(zip(_TYPES, _CHANNELS, _WIDTHS, _KERNELS, _STRIDES, _GROUPS))


@dataclasses.dataclass(frozen=True)
class UlUnasConfig:
    n_fft: int = 512
    hop: int = 256
    window: str = "hann"
    pad_mode: str = "reflect"
    n_low: int = 65
    n_erb: int = 64
    fa_ratio: int = 4
    sample_rate: int = 16000
    in_sample_rate: int = 16000
    out_sample_rate: int = 16000
    fold_window: int = 0
    center: bool = True  # False = snip-edges framing (streaming-equivalent)

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window,
                          pad_mode=self.pad_mode, center=self.center)


# ─────────────────────────────────────────────────────────────────────────────
# Blocks
# ─────────────────────────────────────────────────────────────────────────────


def affine_prelu(p, x: torch.Tensor) -> torch.Tensor:
    """Per-(freq, channel) AffinePReLU in its export-fused form:
    where(x > 0, affine + 1, affine + slope) · x + bias."""
    return torch.where(x > 0, p["pos"], p["neg"]) * x + p["bias"]


def shuffle_channels(x: torch.Tensor) -> torch.Tensor:
    """Interleave the two channel groups: out[2i] = x[i], out[2i+1] = x[half+i]."""
    half = x.shape[-1] // 2
    return torch.stack([x[..., :half], x[..., half:]], dim=-1).reshape(*x.shape[:-1], 2 * half)


def freq_attention(p, power: torch.Tensor, ratio: int) -> torch.Tensor:
    """FA: a bidirectional GRU over frequency super-bands of ``ratio`` bins of
    the channel-mean power.  power (B, T, F, C) → gate logits (B, T, F, 1)."""
    x = torch.mean(power, dim=-1)  # (B, T, F)
    b, t, f = x.shape
    pad = (-f) % ratio
    if pad:
        x = F.pad(x, (0, pad))
    seq = x.reshape(b * t, (f + pad) // ratio, ratio)
    y = core.dense(p["fc"], rnn.gru_bidir(p["fwd"], p["bwd"], seq)).reshape(b, t, f + pad)
    return y[..., :f, None]


def ctfa(p, x: torch.Tensor, ratio: int, h: torch.Tensor | None = None, *,
         return_state: bool = False):
    """Causal time-frequency attention; ``h`` carries the temporal GRU state
    across streaming chunks."""
    power = x * x
    g, h_last = rnn.gru(p["ta_gru"], torch.mean(power, dim=-2), h, return_state=True)
    at = torch.sigmoid(core.dense(p["ta_fc"], g))
    af = torch.sigmoid(freq_attention(p["fa"], power, ratio))
    y = at[..., None, :] * x * af
    return (y, h_last) if return_state else y


def _causal_conv(p, x: torch.Tensor, *, kernel, stride_f: int, groups: int, deconv: bool,
                 cache: torch.Tensor | None = None):
    """Causal time conv or deconv.  ``cache`` ((kt − 1) input frames) carries
    the time context of a stream; ``(y, new_cache)`` comes back when it is
    given.  Offline the conv pads kt − 1 frames each side and trims them at
    the end; the cached deconv trims kt − 1 frames at both ends."""
    kt, kf = kernel
    if cache is None:
        if deconv:
            y = core.conv2d_transpose(p, x, stride=(1, stride_f), padding=(0, kf // 2),
                                      groups=groups)
        else:
            y = core.conv2d(p, x, stride=(1, stride_f), padding=(kt - 1, kf // 2),
                            groups=groups)
        return y[:, : -(kt - 1)] if kt > 1 else y
    if kt == 1:
        xx, new_cache = x, cache  # no history
    else:
        xx = torch.cat([cache, x], dim=1)
        new_cache = xx[:, xx.shape[1] - (kt - 1):]
    if deconv:
        y = core.conv2d_transpose(p, xx, stride=(1, stride_f), padding=(0, kf // 2),
                                  groups=groups)
        if kt > 1:
            y = y[:, kt - 1: -(kt - 1)]
    else:
        y = core.conv2d(p, xx, stride=(1, stride_f), padding=(0, kf // 2), groups=groups)
    return y, new_cache


def _conv_step(p, x, spec, deconv, groups, state):
    """The block's causal conv, offline or with its cache: (y, cache or None)."""
    _, _, _, kernel, stride, _ = spec
    if state is None:
        return _causal_conv(p, x, kernel=kernel, stride_f=stride, groups=groups,
                            deconv=deconv), None
    return _causal_conv(p, x, kernel=kernel, stride_f=stride, groups=groups, deconv=deconv,
                        cache=state["cache"])


def x_conv_block(p, x, spec, cfg, *, deconv=False, last=False, state=None):
    groups = spec[5]
    y, cache = _conv_step(p["conv"], x, spec, deconv, groups, state)
    if not last:
        y = affine_prelu(p["act"], y)
    y, ta = ctfa(p["ctfa"], y, cfg.fa_ratio, None if state is None else state["ta"],
                 return_state=True)
    if groups == 2 and not last:
        y = shuffle_channels(y)
    return y if state is None else (y, {"cache": cache, "ta": ta})


def x_dws_block(p, x, spec, cfg, *, deconv=False, last=False, state=None):
    groups = spec[5]
    out_ch = core.weight_shape(p["pconv"]["w"])[0]  # decoder blocks differ from the spec
    h = affine_prelu(p["pconv_act"], core.conv2d(p["pconv"], x, groups=groups))
    if groups == 2:
        h = shuffle_channels(h)
    h, cache = _conv_step(p["dconv"], h, spec, deconv, out_ch, state)
    if not last:
        h = affine_prelu(p["dconv_act"], h)
    h, ta = ctfa(p["ctfa"], h, cfg.fa_ratio, None if state is None else state["ta"],
                 return_state=True)
    return h if state is None else (h, {"cache": cache, "ta": ta})


def x_mb_block(p, x, spec, cfg, *, deconv=False, last=False, state=None):
    in_ch, stride, groups = x.shape[-1], spec[4], spec[5]
    out_ch = core.weight_shape(p["pconv1"]["w"])[0]  # decoder blocks differ from the spec
    h = affine_prelu(p["pconv1_act"], core.conv2d(p["pconv1"], x, groups=groups))
    if groups == 2:
        h = shuffle_channels(h)
    h, cache = _conv_step(p["dconv"], h, spec, deconv, out_ch, state)
    h = core.conv2d(p["pconv2"], affine_prelu(p["dconv_act"], h), groups=groups)
    h, ta = ctfa(p["ctfa"], h, cfg.fa_ratio, None if state is None else state["ta"],
                 return_state=True)
    if in_ch == out_ch and stride == 1:
        h = h + x
    if groups == 2 and not last:
        h = shuffle_channels(h)
    return h if state is None else (h, {"cache": cache, "ta": ta})


_BLOCK_FNS = (x_conv_block, x_dws_block, x_mb_block)


# ─────────────────────────────────────────────────────────────────────────────
# Network
# ─────────────────────────────────────────────────────────────────────────────


def ul_unas_net(p, spec_ri: torch.Tensor, cfg: UlUnasConfig, state=None):
    """(B, T, 2F) packed spectrum → (B, T, 2F) masked spectrum.

    With ``state`` (from :func:`ul_unas_stream_init`'s ``"net"``) every
    temporal dependency carries across chunks and ``(out, new_state)`` comes
    back.  Imported parameters carry their own ERB bank (``p["erb"]``);
    random ones take the analytic filters."""
    fb = cfg.stft.f_bins
    re, im = spec_ri[..., :fb], spec_ri[..., fb:]
    # log10(sqrt(power)) = 0.5/ln10 · log(power)
    feat = torch.log(torch.clamp(re * re + im * im, min=1e-24)) * float(0.5 / np.log(10.0))
    erb_w = p.get("erb")
    x = erb_compress(feat[..., None], cfg.n_low, cfg.n_erb, cfg.n_fft,
                     weight=None if erb_w is None else erb_w["fc"])

    ns = {"enc": [], "dec": []} if state is not None else None

    def block(path, i, x, spec, **kw):
        fn, bp = _BLOCK_FNS[spec[0]], p[f"{path}{i}"]
        if state is None:
            return fn(bp, x, spec, cfg, **kw)
        y, bs = fn(bp, x, spec, cfg, state=state[path][i], **kw)
        ns[path].append(bs)
        return y

    skips = []
    for i, s in enumerate(_SPECS):
        x = block("enc", i, x, s)
        skips.append(x)
    # the dual-path blocks are GTCRN's (their fcs map the hidden width, 16,
    # back to the input width, also 16)
    for name in ("dp1", "dp2"):
        if state is None:
            x = gtcrn.dpgrnn(p[name], x, width=_WIDTHS[-1], hidden=_CHANNELS[-1])
        else:
            x, ns[name] = gtcrn.dpgrnn(p[name], x, width=_WIDTHS[-1], hidden=_CHANNELS[-1],
                                       state=state[name], return_state=True)
    for j, i in enumerate(range(len(_SPECS) - 1, -1, -1)):
        x = block("dec", j, x + skips[i], _SPECS[i], deconv=True, last=i == 0)

    mask = erb_expand(torch.sigmoid(x), cfg.n_low, cfg.n_erb, cfg.n_fft,
                      weight=None if erb_w is None else erb_w["ifc"])[..., 0]
    out = spec_ri * torch.cat([mask, mask], dim=-1)
    return out if state is None else (out, ns)


def ul_unas_forward(params, audio: torch.Tensor,
                    cfg: UlUnasConfig = UlUnasConfig()) -> torch.Tensor:
    """int16 PCM (B, L) → denoised int16 PCM (B, L); no DC removal."""
    x = pcm_in(audio)
    if cfg.in_sample_rate != cfg.sample_rate:
        x = resample_linear(x, x.shape[-1] * cfg.sample_rate // cfg.in_sample_rate)

    batch = x.shape[0]
    model_len = x.shape[-1]
    align = cfg.fold_window if cfg.fold_window else cfg.hop
    padded = -(-model_len // align) * align
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))
    if cfg.fold_window:
        x = fold_windows(x, cfg.fold_window)

    spec = fast_stft_packed(x.contiguous(), cfg.stft)
    y = fast_istft_packed(ul_unas_net(params, spec, cfg).contiguous(), cfg.stft)

    if cfg.fold_window:
        y = unfold_windows(y, batch)
    y = y[..., :model_len]
    if cfg.out_sample_rate != cfg.sample_rate:
        y = resample_linear(y, model_len * cfg.out_sample_rate // cfg.sample_rate)
    return pcm_out(y)


def make_ul_unas(cfg: UlUnasConfig = UlUnasConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(ul_unas_forward, cfg=cfg)


class ULUNAS(ParamModule):
    """UL-UNAS with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` on the module's device and
    returns int16 PCM of the same shape."""

    def __init__(self, params, cfg: UlUnasConfig = UlUnasConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return ul_unas_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Streaming (state carry)
# ─────────────────────────────────────────────────────────────────────────────


def _stream_plan(cfg: UlUnasConfig):
    """Per block (kt, width, cache channels, out channels), encoder and decoder."""
    enc, dec = [], []
    width, ch_in = cfg.n_low + cfg.n_erb, 1
    for btype, ch, w_out, (kt, _), _, _ in _SPECS:
        # XConv caches its input; DWS and MB cache the output of their pconv
        enc.append((kt, width, ch_in if btype == 0 else ch, ch))
        width, ch_in = w_out, ch
    n = len(_SPECS)
    for i in range(n - 1, 0, -1):
        btype, (kt, _) = _SPECS[i][0], _SPECS[i][3]
        out_ch = _CHANNELS[i - 1]
        dec.append((kt, width, ch_in if btype == 0 else out_ch, out_ch))
        width, ch_in = _WIDTHS[i - 1], out_ch
    btype, (kt, _) = _SPECS[0][0], _SPECS[0][3]
    dec.append((kt, width, ch_in if btype == 0 else 1, 1))
    return enc, dec


def ul_unas_stream_init(cfg: UlUnasConfig = UlUnasConfig(), batch: int = 1,
                        device=None) -> dict:
    """Fresh streaming state on ``device`` (default: the card)."""
    if cfg.in_sample_rate != cfg.sample_rate or cfg.out_sample_rate != cfg.sample_rate:
        raise ValueError(
            f"streaming runs at the model rate only ({cfg.sample_rate} Hz); "
            "resample on the host (the offline forward resamples "
            "in-graph, the stream step does not)")
    zeros = partial(torch.zeros, dtype=torch.float32, device=resolve_device(device))
    carry = cfg.n_fft - cfg.hop
    enc_plan, dec_plan = _stream_plan(cfg)

    def block_state(kt, width, cache_ch, out_ch):
        return {"cache": zeros((batch, kt - 1, width, cache_ch)), "ta": zeros((batch, 2 * out_ch))}

    w, c = _WIDTHS[-1], _CHANNELS[-1]
    return {
        "audio_tail": zeros((batch, carry)),
        "net": {
            "enc": [block_state(*pl) for pl in enc_plan],
            "dec": [block_state(*pl) for pl in dec_plan],
            "dp1": zeros((2, batch * w, c // 2)),
            "dp2": zeros((2, batch * w, c // 2)),
        },
        "ola_tail": zeros((batch, carry)),
    }


def ul_unas_stream_step(params, state: dict, chunk: torch.Tensor,
                        cfg: UlUnasConfig = UlUnasConfig()) -> tuple[dict, torch.Tensor]:
    """One streaming step: int16 chunk (B, k·hop) → (state, int16 out (B, k·hop)).

    The stream processes the input as if (n_fft − hop) zeros were prepended,
    with snip-edges framing: from sample ``hop`` on, its output equals the
    offline ``center=False`` path on that zero-prepended signal (to within
    float32 reassociation), delayed by n_fft − hop samples."""
    if chunk.shape[-1] % cfg.hop:
        raise ValueError(f"chunk length {chunk.shape[-1]} must be a multiple of hop {cfg.hop}")
    frame_cfg = dataclasses.replace(cfg.stft, center=False)
    buf = torch.cat([state["audio_tail"], pcm_in(chunk)], dim=-1)
    spec = fast_stft_packed(buf, frame_cfg)  # (B, k, 2F), B1
    out_spec, net_state = ul_unas_net(params, spec, cfg, state=state["net"])
    out, new_tail = stream_istft(out_spec, frame_cfg, state["ola_tail"], chunk.shape[-1])
    carry = cfg.n_fft - cfg.hop
    return {"audio_tail": buf[:, -carry:], "net": net_state, "ola_tail": new_tail}, pcm_out(out)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def _affine_prelu_np(width, ch):
    return {"pos": np.full((width, ch), 1.0, np.float32),
            "neg": np.full((width, ch), 1.25, np.float32),
            "bias": np.zeros((width, ch), np.float32)}


def _ctfa_np(rng, ch, ratio):
    return {
        "ta_gru": gtcrn._gru_np(rng, ch, 2 * ch),
        "ta_fc": dense_np(rng, 2 * ch, ch),
        "fa": {"fwd": gtcrn._gru_np(rng, ratio, ratio), "bwd": gtcrn._gru_np(rng, ratio, ratio),
               "fc": dense_np(rng, 2 * ratio, ratio)},
    }


def _in_width_for(width, stride, deconv):
    if stride == 2:
        return width // 2 + 1 if deconv else width * 2 - 1
    return width


def _block_np(rng, spec, in_ch, cfg, *, deconv=False, last=False, out_ch=None, width=None):
    btype, ch, w, (kt, kf), stride, groups = spec
    ch = out_ch if out_ch is not None else ch
    w = width if width is not None else w
    p = {}
    if btype == 0:  # XConv
        p["conv"] = conv_np(rng, (kt, kf), in_ch, ch, groups=groups)
        if not last:
            p["act"] = _affine_prelu_np(w, ch)
    elif btype == 1:  # XDWS
        p["pconv"] = conv_np(rng, (1, 1), in_ch, ch, groups=groups)
        p["pconv_act"] = _affine_prelu_np(_in_width_for(w, stride, deconv), ch)
        p["dconv"] = conv_np(rng, (kt, kf), ch, ch, groups=ch)
        if not last:
            p["dconv_act"] = _affine_prelu_np(w, ch)
    else:  # XMB
        p["pconv1"] = conv_np(rng, (1, 1), in_ch, ch, groups=groups)
        p["pconv1_act"] = _affine_prelu_np(_in_width_for(w, stride, deconv), ch)
        p["dconv"] = conv_np(rng, (kt, kf), ch, ch, groups=ch)
        p["dconv_act"] = _affine_prelu_np(w, ch)
        p["pconv2"] = conv_np(rng, (1, 1), ch, ch, groups=groups)
    p["ctfa"] = _ctfa_np(rng, ch, cfg.fa_ratio)
    return p


def init_ul_unas_numpy(seed: int = 0, cfg: UlUnasConfig = UlUnasConfig()) -> dict:
    """Random UL-UNAS parameters as numpy arrays, with the keys, shapes and
    layouts of ``audiojax.models.ul_unas.init_ul_unas`` and its
    distributions, drawn from ``numpy.random.default_rng(seed)`` (no ``erb``
    subtree: the analytic bank serves)."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 1
    for i, s in enumerate(_SPECS):
        params[f"enc{i}"] = _block_np(rng, s, in_ch, cfg)
        in_ch = s[1]
    n = len(_SPECS)
    for j, i in enumerate(range(n - 1, 0, -1)):
        params[f"dec{j}"] = _block_np(rng, _SPECS[i], in_ch, cfg, deconv=True,
                                      out_ch=_CHANNELS[i - 1], width=_WIDTHS[i - 1])
        in_ch = _CHANNELS[i - 1]
    params[f"dec{n - 1}"] = _block_np(rng, _SPECS[0], in_ch, cfg, deconv=True, last=True,
                                      out_ch=1, width=cfg.n_low + cfg.n_erb)
    params["dp1"] = gtcrn._dpgrnn_np(rng, _CHANNELS[-1], _WIDTHS[-1])
    params["dp2"] = gtcrn._dpgrnn_np(rng, _CHANNELS[-1], _WIDTHS[-1])
    return params


def init_ul_unas(seed: int = 0, cfg: UlUnasConfig = UlUnasConfig(), device=None) -> dict:
    """Random UL-UNAS parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_ul_unas_numpy(seed, cfg), device)
