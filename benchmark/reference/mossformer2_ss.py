"""Plain float32 reference of MossFormer2-SS-16K (ClearerVoice-Studio's
two-speaker separator), one forward over a batch of windows.

int16 mix (B, L) in, one int16 (B, L) per speaker out.  The mix is scaled to
[-1, 1), padded so the decoder gives its length back, normalised in two RMS
stages (−25 dB, then the high-energy re-norm), encoded by a k16/s8 conv and a
ReLU, normalised (GroupNorm of one group), projected, given sinusoidal
positions, run through ``depth`` × [FLASH layer (token shift, ScaleNorm,
u‖v‖qk projection with a depthwise conv, offset-scaled rotary heads,
group-local relu² attention plus global linear attention, gate, out
projection with a depthwise conv) + dilated gated FSMN (a two-level dense
memory: a depthwise conv, then a conv over two lanes a group)], normalised,
gated per speaker, applied as a mask to the encoding, decoded by a
transposed conv and restored to the input's RMS.

Written from the model's published description and the program's forward as
a pattern, with ``benchmark.reference.common``'s plain operations only.  The
configuration is the dict under ``"model"`` in the configuration file.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C


def output_sources(cfg: dict) -> int:
    return cfg["num_spks"]


def param_table(cfg: dict) -> list:
    """The parameter tree's rows ``(path, shape, lo, hi)``, in the program's
    key layout (``mem_stack`` a list) and torch's weight layouts."""
    t = C.Table()
    d, inner, dw = cfg["dim"], cfg["fsmn_inner"], cfg["dw_kernel"]
    c = 2 * cfg["vu_dim"] + cfg["qk_dim"]
    t.conv("encoder", (cfg["enc_kernel"],), 1, d)
    t.norm("front_norm", d)
    t.dense("front", d, d)
    t.gain("pos_scale", (), d ** -0.5)
    t.norm("mm_norm", d)
    t.norm("intra_norm", d)
    t.gain("tail_alpha", (), 0.25)
    t.dense("tail_gate", d, cfg["num_spks"] * 2 * d)
    t.dense("mask_decoder", d, d, bias=False)
    t.conv("decoder", (cfg["enc_kernel"],), d, 1)
    for i in range(cfg["depth"]):
        p = f"flash{i}"
        t.gain(f"{p}/in_norm/g", ())
        t.dense(f"{p}/in_lin", d, c)
        t.conv(f"{p}/in_conv", (dw,), c, c, groups=c, bias=False)
        t.gain(f"{p}/os_gamma", (4, cfg["qk_dim"]), 0.1)
        t.offset(f"{p}/os_beta", (4, cfg["qk_dim"]))
        t.gain(f"{p}/out_norm/g", ())
        t.dense(f"{p}/out_lin", cfg["vu_dim"], d)
        t.conv(f"{p}/out_conv", (dw,), d, d, groups=d, bias=False)
        p = f"fsmn{i}"
        t.dense(f"{p}/front", d, inner)
        t.gain(f"{p}/front_alpha", (), 0.25)
        t.norm(f"{p}/norm1", inner)
        t.dense(f"{p}/uv_lin", inner, 2 * inner)
        t.conv(f"{p}/uv_conv", (dw,), 2 * inner, 2 * inner, groups=2 * inner, bias=False)
        t.dense(f"{p}/mem_lin", inner, inner)
        t.dense(f"{p}/mem_proj", inner, inner, bias=False)
        for j in range(cfg["mem_depth"]):
            m = f"{p}/mem_stack/{j}"
            t.conv(f"{m}/conv", (2 * cfg["lorder"] - 1,), inner * (j + 1), inner, groups=inner,
                   bias=False)
            t.norm(f"{m}/norm", inner)
            t.gain(f"{m}/act/alpha", (inner,), 0.25)
        t.norm(f"{p}/norm2", inner)
        t.dense(f"{p}/back", inner, d)
    return t.rows


def _scale_norm(g, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * (x.shape[-1] ** -0.5)
    return x * (g / (norm + eps))


def _group_norm(p, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """GroupNorm(1, C) over (T, C) jointly, per-channel affine; x (B, T, C)."""
    mu = torch.mean(x, dim=(-2, -1), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(-2, -1), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _conv_module(p, x: torch.Tensor) -> torch.Tensor:
    k = p["w"].shape[-1]
    return x + C.conv1d(p, x, padding=(k - 1) // 2, groups=x.shape[-1])


def _flash(p, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, t, d = x.shape
    half, qk_dim, group = d // 2, cfg["qk_dim"], cfg["group_size"]
    shifted = torch.cat([F.pad(x[..., :half], (0, 0, 1, 0))[:, :t], x[..., half:]], dim=-1)
    h = _scale_norm(p["in_norm"]["g"], shifted)
    proj = _conv_module(p["in_conv"], F.silu(C.dense(p["in_lin"], h)))
    vu2 = proj.shape[-1] - qk_dim
    vu = vu2 // 2
    v, u, qk = proj[..., :vu], proj[..., vu:vu2], proj[..., vu2:]
    quad_q, lin_q, quad_k, lin_k = (
        C.rotary(qk * p["os_gamma"][i] + p["os_beta"][i], cfg["rot_dim"]) for i in range(4))
    vug = proj[..., :vu2]
    pad = (-t) % group
    g = (t + pad) // group

    def grouped(a):  # zero-padded after the rotary step, so padded keys stay zero
        return F.pad(a, (0, 0, 0, pad)).reshape(b * g, group, a.shape[-1])

    quad = C.quad_attention(grouped(quad_q), grouped(quad_k), grouped(vug), scale=1.0 / group)
    lin_kv = torch.matmul(lin_k.transpose(1, 2), vug) / t
    att = quad.reshape(b, g * group, vu2)[:, :t] + torch.matmul(lin_q, lin_kv)
    out = (att[..., vu:] * v) * torch.sigmoid(att[..., :vu] * u)
    out = _scale_norm(p["out_norm"]["g"], out)
    return x + _conv_module(p["out_conv"], F.silu(C.dense(p["out_lin"], out)))


def _instance_norm_t(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=-2, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-2, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _fsmn(p, x: torch.Tensor, cfg: dict, eps: float = 1e-8) -> torch.Tensor:
    h = C.prelu(p["front_alpha"], C.dense(p["front"], x))
    gf_in = C.layer_norm(h, eps=eps, g=p["norm1"]["g"], b=p["norm1"]["b"])
    proj = _conv_module(p["uv_conv"], F.silu(C.dense(p["uv_lin"], C.layer_norm(gf_in, eps=eps))))
    inner = proj.shape[-1] // 2
    xu, xv = proj[..., :inner], proj[..., inner:]
    feat = C.dense(p["mem_proj"], torch.relu(C.dense(p["mem_lin"], xu)))
    levels = p["mem_stack"]
    for j, mp in enumerate(levels):
        dil = 2 ** j
        mem = C.conv1d(mp["conv"], feat, padding=dil * (cfg["lorder"] - 1), dilation=dil,
                       groups=inner)
        mem = C.prelu(mp["act"]["alpha"], _instance_norm_t(mp["norm"], mem))
        if j + 1 < len(levels):
            feat = torch.cat([mem, feat], dim=-1)
    y = C.layer_norm(xv * (xu + mem) + gf_in, eps=eps, g=p["norm2"]["g"], b=p["norm2"]["b"])
    return C.dense(p["back"], y) + x


def _norm_audio(x: torch.Tensor, factor: float, eps: float = 1e-6):
    pow_x = x * x
    avg_pow = torch.mean(pow_x, dim=-1, keepdim=True)
    rms = torch.sqrt(avg_pow)
    scalar = factor / (rms + eps)
    mask = (pow_x > avg_pow).to(x.dtype)
    cnt = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    high_rms = torch.sqrt(torch.sum(pow_x * mask, dim=-1, keepdim=True) / cnt)
    gain = scalar * (factor / (high_rms * scalar + eps))
    return x * gain, rms * gain * (1.0 / (gain + eps)) * 32767.0


def forward(params, audio: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, ...]:
    """int16 mixes (B, L) → one int16 (B, L) per speaker."""
    if cfg["in_sample_rate"] != cfg["sample_rate"] or cfg["out_sample_rate"] != cfg["sample_rate"]:
        raise ValueError("the reference serves the model at its own sample rate only")
    p = params
    x = audio.to(torch.float32) * (1.0 / 32768.0)
    b, length = x.shape
    kern, stride, d, spks = cfg["enc_kernel"], cfg["enc_stride"], cfg["dim"], cfg["num_spks"]
    x = F.pad(x, (0, -(-(length - kern) // stride) * stride + kern - length))
    normed, rms_in = _norm_audio(x, cfg["norm_factor"])

    enc = torch.relu(C.conv1d(p["encoder"], normed[..., None], stride=stride))
    n = enc.shape[1]
    h = C.dense(p["front"], _group_norm(p["front_norm"], enc))
    h = h + torch.from_numpy(C.sinusoid_np(n, d)).to(h.device)[None] * p["pos_scale"]
    first = h
    for i in range(cfg["depth"]):
        h = _fsmn(p[f"fsmn{i}"], _flash(p[f"flash{i}"], h, cfg), cfg)
    mask = _group_norm(p["intra_norm"], C.layer_norm(h, g=p["mm_norm"]["g"],
                                                      b=p["mm_norm"]["b"])) + first
    mask = C.prelu(p["tail_alpha"], mask)
    gate = C.dense(p["tail_gate"], mask).reshape(b, n, spks, 2 * d)
    m = torch.tanh(gate[..., :d]) * torch.sigmoid(gate[..., d:])
    m = torch.relu(C.dense(p["mask_decoder"], m))
    sep = (enc[:, :, None, :] * m).movedim(2, 1).reshape(b * spks, n, d)
    wav = C.conv1d_transpose(p["decoder"], sep, stride=stride)[..., 0].reshape(b, spks, -1)

    rms_out = torch.sqrt(torch.mean(wav * wav, dim=-1, keepdim=True))
    gain = torch.where(rms_out > 0.0, rms_in[:, None, :] / rms_out, torch.zeros_like(rms_out))
    out = torch.clamp((wav * gain)[..., :length], -32768.0, 32767.0)
    out = out.to(torch.int32).to(torch.int16)
    return tuple(out[:, s] for s in range(spks))
