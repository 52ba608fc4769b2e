"""Mel-Band Roformer — vocal separation at 44.1 kHz (mono and stereo), in PyTorch.

Counterpart of ``audiojax.models.melband_roformer``: STFT 2048/441 (hann,
reflect) → the slaney mel filterbank split into 60 overlapping bands (a bin
belongs to a band where its filter is positive, the DC and Nyquist corners
forced in; stereo interleaves the channels into the bin axis, ``bin·ch + c``)
→ per-band RMSNorm + Linear to ``dim`` → ``depth`` × axial transformers (time
attention, then band attention; RoPE over the whole head, per-head sigmoid
gates, exact GELU, a final RMSNorm each) → per-band tanh MLP + GLU mask →
overlap-averaged complex mask → complex product → ISTFT.

The JAX package takes the plain ``dsp.stft``/``istft`` here; the port runs
the analysis on B1 and the synthesis on B2 (``ops.stft_cuda``), one launch
each a forward over every window and channel.  Attention is ``torch.matmul``
and softmax in float32 (no ``scaled_dot_product_attention``, whose backends
choose their own precision).  Bands of equal width run as one batched
product (the JAX package's ``_width_runs``).  The overlap average is a
gather: each bin adds the mask entries of the bands that hold it (at most
two at the default layout) in band order and divides by their count, so no
atomics and the same sum on every run.  ``shard_hint`` (an identity without
a mesh) is dropped.

``compute_dtype="bfloat16"`` is the JAX package's bf16 plan: the parameter
tree's float32 leaves are cast once, and the band split, the axial
transformers and the mask estimator run in bf16; the band selection, B1, B2,
the overlap average and the complex product stay float32 (the mask is widened
once).  The attention scores and their softmax are float32 products of the
bf16 q and k on every device, and the probabilities are rounded to bf16: the
JAX package keeps that branch on every backend but the TPU
(``f32_scores = x.dtype == float32 or backend != "tpu"``), and the CPU
reference the port is held to takes it; the TPU's bf16 scores are not ported
(ROADMAP §C).

The q8 plans' quantized weights are read through ``core.as_weight``, the
band split's, the mask MLP's stacked and the GLU heads' as in the JAX package;
``dense`` takes the dynamic int8 route on the others under q8dyn.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pcm import pcm_in, pcm_out
from ..dsp.stft import StftConfig
from ..frontend.mel import slaney_mel_fbanks
from ..nn import core
from ..nn.core import rms_norm
from ..nn.mossformer import rope_mm_tables
from ..ops.stft_cuda import fast_istft_packed, fast_stft_packed
from ..params import params_from_numpy
from .base import ParamModule, dense_np, glorot_np

__all__ = [
    "MelBandConfig",
    "MelBandRoformer",
    "band_layout",
    "melband_net",
    "melband_forward",
    "init_melband_numpy",
    "init_melband",
    "make_melband",
]


@dataclasses.dataclass(frozen=True)
class MelBandConfig:
    n_fft: int = 2048
    hop: int = 441
    window: str = "hann"
    pad_mode: str = "reflect"
    num_bands: int = 60
    dim: int = 384
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_expansion: int = 4
    mask_depth: int = 2  # hidden tanh layers of the mask-estimator MLP
    channels: int = 1  # 1 = mono, 2 = stereo
    sample_rate: int = 44100
    in_sample_rate: int = 44100
    out_sample_rate: int = 44100
    fold_window: int = 0
    # the transformer stack's dtype: "float32" or "bfloat16" (B1, B2 and the
    # complex mask stay float32)
    compute_dtype: str = "float32"

    def __post_init__(self):
        core.compute_dtype(self.compute_dtype)  # raises on any other name

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.n_fft, self.hop, window=self.window, pad_mode=self.pad_mode)

    @property
    def f_bins(self) -> int:
        return self.n_fft // 2 + 1


@lru_cache(maxsize=None)
def band_layout(cfg: MelBandConfig):
    """(freq_indices, band_widths, counts): the overlapping mel bands.  Indices
    are into the channel-interleaved bin axis of length f_bins·channels;
    each band's width is 2 (re, im) × its bins × channels."""
    fb = slaney_mel_fbanks(cfg.f_bins, 0.0, cfg.sample_rate / 2.0, cfg.num_bands,
                           float(cfg.sample_rate)).T.copy()  # (bands, bins)
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    member = fb > 0
    indices, widths = [], []
    for b in range(cfg.num_bands):
        bins = np.nonzero(member[b])[0]
        if cfg.channels == 1:
            sel = bins
        else:  # stereo: channel-interleaved bin axis (bin·ch + c)
            sel = np.stack([bins * cfg.channels + c for c in range(cfg.channels)],
                           axis=1).reshape(-1)
        indices.append(sel)
        widths.append(2 * len(bins) * cfg.channels)
    freq_indices = np.concatenate(indices).astype(np.int32)
    counts = np.zeros((cfg.f_bins * cfg.channels,), np.float32)
    np.add.at(counts, freq_indices, 1.0)
    return freq_indices, tuple(widths), np.maximum(counts, 1.0)


def _width_runs(widths):
    """Consecutive equal-width runs of the band layout: [(start, count, w)]."""
    runs = []
    for i, w in enumerate(widths):
        if runs and runs[-1][2] == w:
            runs[-1][1] += 1
        else:
            runs.append([i, 1, w])
    return [tuple(r) for r in runs]


@lru_cache(maxsize=None)
def _overlap_gather_np(cfg: MelBandConfig) -> np.ndarray:
    """(bins·ch, slots) positions into the band-major selection that each bin
    sums, in band order; a bin held by fewer bands points its spare slots at
    position S, a zero row appended after the S selected entries."""
    freq_idx, _, counts = band_layout(cfg)
    s = len(freq_idx)
    pos = np.full((len(counts), int(counts.max())), s, np.int64)
    fill = np.zeros(len(counts), np.int64)
    for j, f in enumerate(freq_idx):
        pos[f, fill[f]] = j
        fill[f] += 1
    return pos


@lru_cache(maxsize=None)
def _layout_tensors(cfg: MelBandConfig, device: torch.device):
    """The band selection, the overlap gather and 1/count on ``device``, once."""
    freq_idx, _, counts = band_layout(cfg)
    return (torch.from_numpy(freq_idx.astype(np.int64)).to(device),
            torch.from_numpy(_overlap_gather_np(cfg)).to(device),
            torch.from_numpy(1.0 / counts).to(device))


def _attention(p, x: torch.Tensor, rope, cfg: MelBandConfig) -> torch.Tensor:
    n, s, _ = x.shape
    h, dh = cfg.heads, cfg.dim_head
    normed = rms_norm(p["norm"], x, eps=0.0)
    qkv = core.dense(p["to_qkv"], normed).reshape(n, s, 3, h, dh)
    gates = torch.sigmoid(core.dense(p["to_gates"], normed))  # (n, s, h)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (n, s, h, dh)
    cos, sin, swap = rope  # (s, dh), (s, dh), (dh, dh): over the interior head axis
    cos_b, sin_b = cos[:, None, :], sin[:, None, :]
    q = q * cos_b + torch.matmul(q, swap) * sin_b
    k = k * cos_b + torch.matmul(k, swap) * sin_b
    # float32 scores and softmax on every device (the module docstring says why)
    scores = core.matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * dh**-0.5
    attn = torch.softmax(scores, dim=-1).to(x.dtype)  # (n, h, s, s)
    del scores  # ~1.2 GB at a 30 s request's time attention: one such tensor alive, not two
    out = core.matmul_f32(attn, v.permute(0, 2, 1, 3)).to(x.dtype).permute(0, 2, 1, 3)
    out = out * gates[..., None]  # (n, s, h, dh)
    return core.dense(p["to_out"], out.reshape(n, s, h * dh))


def _transformer(p, x: torch.Tensor, rope, cfg: MelBandConfig) -> torch.Tensor:
    x = x + _attention(p["attn"], x, rope, cfg)
    h = F.gelu(core.dense(p["ff1"], rms_norm(p["ff_norm"], x, eps=0.0)), approximate="none")
    x = x + core.dense(p["ff2"], h)
    return rms_norm(p["out_norm"], x, eps=0.0)


def melband_net(p, spec: torch.Tensor, cfg: MelBandConfig) -> torch.Tensor:
    """spec (B, T, F·ch, 2), complex last, channels interleaved → the masked
    spectrum, same shape."""
    _, widths, _ = band_layout(cfg)
    sel_idx, gather, inv_counts = _layout_tensors(cfg, spec.device)
    dtype = core.compute_dtype(cfg.compute_dtype)
    core.expect_cast(p["band_split"][0]["norm"]["g"], dtype)
    b, t, fc, _ = spec.shape
    bt = b * t
    flat = spec[:, :, sel_idx, :].reshape(bt, -1).to(dtype)  # (B·T, 2S): band-major [re, im]

    # band split: per-band RMSNorm + Linear, each equal-width run one batched
    # product → (bands, B·T, dim)
    feats, off = [], 0
    for i0, r, w in _width_runs(widths):
        part = flat[:, off: off + r * w].reshape(bt, r, w)
        off += r * w
        bands = p["band_split"][i0: i0 + r]
        gains = torch.stack([q["norm"]["g"] for q in bands])  # (r, w)
        normed = (rms_norm(None, part, eps=0.0) * gains).transpose(0, 1)  # (r, B·T, w)
        wts = torch.stack([core.as_weight(q["lin"]["w"]) for q in bands])  # (r, w, dim)
        bias = torch.stack([q["lin"]["b"] for q in bands])  # (r, dim)
        feats.append(torch.baddbmm(bias[:, None, :], normed, wts))
    x = torch.cat(feats, dim=0)  # (nb, B·T, dim)
    nb, d, dh = cfg.num_bands, cfg.dim, cfg.dim_head

    trope = rope_mm_tables(t, dh, dh, spec.device, dtype)
    frope = rope_mm_tables(nb, dh, dh, spec.device, dtype)
    for i in range(cfg.depth):
        # time attention over the nb·B band rows, then band attention over the B·T frames
        seq = _transformer(p[f"time{i}"], x.reshape(nb * b, t, d), trope, cfg)
        seq = seq.reshape(nb, bt, d).transpose(0, 1)  # (B·T, nb, dim)
        seq = _transformer(p[f"freq{i}"], seq, frope, cfg)
        x = seq.transpose(0, 1)  # (nb, B·T, dim)

    # mask estimator: the shared-width tanh MLP batched over bands (its
    # products and tanh in float32, as the JAX package asks), then each run's
    # GLU head as one batched product
    h = x
    for lay in p["me_hidden"]:
        h = torch.tanh(torch.baddbmm(lay["b"][:, None, :].float(), h.float(),
                                     core.as_weight(lay["w"]).float())).to(dtype)
    masks = []
    for i0, r, w in _width_runs(widths):
        heads = p["me_out"][i0: i0 + r]
        wts = torch.stack([core.as_weight(q["w"]) for q in heads])  # (r, inner, 2w)
        bias = torch.stack([q["b"] for q in heads])  # (r, 2w)
        g = torch.baddbmm(bias[:, None, :], h[i0: i0 + r], wts)  # (r, B·T, 2w)
        m = g[..., :w] * torch.sigmoid(g[..., w:])  # GLU
        masks.append(m.transpose(0, 1).reshape(bt, r * w))  # band-major flatten
    mask = torch.cat(masks, dim=-1).reshape(bt, -1, 2).float()  # (B·T, S, 2), the f32 island

    # overlap average: each bin sums the entries of the bands that hold it
    mask = torch.cat([mask, mask.new_zeros((bt, 1, 2))], dim=1)
    acc = mask[:, gather].sum(dim=2)  # (B·T, F·ch, slots, 2) → (B·T, F·ch, 2)
    mask_avg = (acc * inv_counts[None, :, None]).reshape(b, t, fc, 2)

    mr, mi = mask_avg[..., 0], mask_avg[..., 1]
    sr, si = spec[..., 0], spec[..., 1]
    return torch.stack([sr * mr - si * mi, sr * mi + si * mr], dim=-1)


def melband_forward(params, audio: torch.Tensor,
                    cfg: MelBandConfig = MelBandConfig()) -> torch.Tensor:
    """int16 (B, ch, L), or (B, L) for mono → separated vocals, same shape."""
    squeeze = audio.dim() == 2
    if squeeze:
        audio = audio[:, None, :]
    b, ch, length = audio.shape
    if ch != cfg.channels:
        raise ValueError(f"model expects {cfg.channels} channel(s), got {ch}")

    x = pcm_in(audio.reshape(b * ch, length))
    model_len = x.shape[-1]
    padded = -(-model_len // cfg.hop) * cfg.hop
    if padded != model_len:
        x = F.pad(x, (0, padded - model_len))

    fb = cfg.f_bins
    packed = fast_stft_packed(x.contiguous(), cfg.stft)  # (B·ch, T, 2F), B1
    t = packed.shape[1]
    spec = torch.stack([packed[..., :fb], packed[..., fb:]], dim=-1).reshape(b, ch, t, fb, 2)
    spec = spec.permute(0, 2, 3, 1, 4).reshape(b, t, fb * ch, 2)  # bin·ch + c

    out = melband_net(params, spec, cfg)

    out = out.reshape(b, t, fb, ch, 2).permute(0, 3, 1, 2, 4).reshape(b * ch, t, fb, 2)
    y = fast_istft_packed(torch.cat([out[..., 0], out[..., 1]], dim=-1), cfg.stft)  # B2
    y = pcm_out(y[..., :model_len].reshape(b, ch, model_len))
    return y[:, 0] if squeeze else y


def make_melband(cfg: MelBandConfig = MelBandConfig()):
    """Return ``fn(params, audio_int16) -> audio_int16``."""
    return partial(melband_forward, cfg=cfg)


class MelBandRoformer(ParamModule):
    """Mel-Band Roformer with its converted parameters as buffers.

    ``forward(audio)`` takes int16 PCM ``(B, L)`` (mono) or ``(B, 2, L)``
    (stereo) at 44.1 kHz on the module's device and returns int16 PCM of the
    same shape."""

    def __init__(self, params, cfg: MelBandConfig = MelBandConfig()):
        super().__init__(params, cfg)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return melband_forward(self.params, audio, self.cfg)


# ─────────────────────────────────────────────────────────────────────────────
# Random init (numpy draw in the JAX package's layout, then converted)
# ─────────────────────────────────────────────────────────────────────────────


def init_melband_numpy(seed: int = 0, cfg: MelBandConfig = MelBandConfig()) -> dict:
    """Random Mel-Band Roformer parameters as numpy arrays, with the keys,
    shapes and layouts of ``audiojax.models.melband_roformer.init_melband``
    and its distributions (each band's hidden mask weight its own glorot
    draw), from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    _, widths, _ = band_layout(cfg)
    d, inner, hd = cfg.dim, cfg.mlp_expansion * cfg.dim, cfg.heads * cfg.dim_head
    ones = lambda n: {"g": np.ones((n,), np.float32)}  # noqa: E731

    def tf():
        return {
            "attn": {
                "norm": ones(d),
                "to_qkv": dense_np(rng, d, 3 * hd, bias=False),
                "to_gates": dense_np(rng, d, cfg.heads),
                "to_out": dense_np(rng, hd, d, bias=False),
            },
            "ff_norm": ones(d),
            "ff1": dense_np(rng, d, inner),
            "ff2": dense_np(rng, inner, d),
            "out_norm": ones(d),
        }

    p = {}
    for i in range(cfg.depth):
        p[f"time{i}"] = tf()
        p[f"freq{i}"] = tf()
    p["band_split"] = [{"norm": ones(w), "lin": dense_np(rng, w, d)} for w in widths]
    p["me_hidden"] = []
    d_in = d
    for _ in range(cfg.mask_depth):
        p["me_hidden"].append({
            "w": np.stack([glorot_np(rng, (d_in, inner)) for _ in widths]),
            "b": np.zeros((len(widths), inner), np.float32),
        })
        d_in = inner
    p["me_out"] = [dense_np(rng, inner, 2 * w) for w in widths]
    return p


def init_melband(seed: int = 0, cfg: MelBandConfig = MelBandConfig(), device=None) -> dict:
    """Random Mel-Band Roformer parameters on ``device`` (default: the card)."""
    return params_from_numpy(init_melband_numpy(seed, cfg), device)
