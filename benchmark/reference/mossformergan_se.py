"""Plain float32 reference of MossFormerGAN-SE-16K (ClearerVoice-Studio's
SyncANet speech enhancer), one forward over a batch of 6 s windows.

int16 (B, L) in, int16 (B, L) out.  Each window is folded into rows of
``fold_window`` samples; each row is divided by its RMS, transformed by a
400/100 periodic-Hamming STFT with reflect padding, power-compressed (0.3),
run through the dense encoder, ``n_blocks`` SyncANet blocks (an intra path
over frequency and an inter path over time, each a grouped unfold conv, a
fused u‖v FFConvM, a UniDeepFsmn, a refold conv and a MossFormer GAU with
local, cross-row and linear attention, then an SE layer; then a 4-head
triple attention), a mask decoder and a complex decoder, decompressed,
inverted by the ISTFT and multiplied by its RMS again.

Written from the model's published description and the program's forward as
a pattern, with ``benchmark.reference.common``'s plain operations only.  The
configuration is the dict under ``"model"`` in the configuration file.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C

def output_sources(cfg: dict) -> int:
    return 1


def param_table(cfg: dict) -> list:
    """The parameter tree's rows ``(path, shape, lo, hi)``, in the program's
    key layout and torch's weight layouts."""
    t = C.Table()
    c, depth, lorder = cfg["emb_dim"], cfg["dense_depth"], cfg["lorder"]
    ks, uv, dw = cfg["emb_ks"], cfg["uv_channels"], cfg["dw_kernel"]
    qk, hidden = cfg["mf_qk"], cfg["mf_hidden"]
    h, qc, vc = cfg["attn_heads"], cfg["attn_q_ch"], cfg["attn_v_ch"]
    f = ((cfg["n_fft"] // 2 + 1) + 2 - 3) // 2 + 1

    def dense_fsmn(path):
        for i in range(depth):
            lp = f"{path}/layer{i}"
            t.conv(f"{lp}/conv", (2, 3), c * (i + 1), c)
            t.norm(f"{lp}/norm", c)
            t.gain(f"{lp}/act/alpha", (c,), 0.25)
            t.conv(f"{lp}/fsmn_lin", (1, 1), c, c)
            t.conv(f"{lp}/fsmn_proj", (1, 1), c, c, bias=False)
            t.conv(f"{lp}/fsmn_mem", (1, 2 * lorder - 1), c, c, groups=c, bias=False)

    t.conv("enc_conv1", (1, 1), 3, c)
    t.norm("enc_norm1", c)
    t.gain("enc_act1/alpha", (c,), 0.25)
    dense_fsmn("enc_dense")
    t.conv("enc_conv2", (1, 3), c, c)
    t.norm("enc_norm2", c)
    t.gain("enc_act2/alpha", (c,), 0.25)
    for head in ("mask_dec", "cplx_dec"):
        dense_fsmn(f"{head}/dense")
        t.conv(f"{head}/sp_conv", (1, 3), c, 2 * c)
    t.conv("mask_conv1", (1, 1), c, c)
    t.norm("mask_norm", c)
    t.gain("mask_act/alpha", (c,), 0.25)
    t.conv("mask_final", (1, 2), c, 1)
    t.gain("mask_out_alpha", (), 0.25)
    t.norm("cplx_norm", c)
    t.gain("cplx_act/alpha", (c,), 0.25)
    t.conv("cplx_final", (1, 2), c, 2)
    for i in range(cfg["n_blocks"]):
        for side in ("intra", "inter"):
            p = f"block{i}/{side}"
            t.conv(f"{p}/unfold", (ks,), c, c * ks, groups=c)
            t.dense(f"{p}/uv/lin", c * ks, 2 * uv)
            t.conv(f"{p}/uv/conv", (dw,), 2 * uv, 2 * uv, groups=2 * uv, bias=False)
            t.dense(f"{p}/fsmn/lin", uv, uv)
            t.dense(f"{p}/fsmn/proj", uv, uv, bias=False)
            t.conv(f"{p}/fsmn/mem", (2 * lorder - 1,), uv, uv, groups=uv, bias=False)
            t.conv(f"{p}/refold", (ks,), uv, c)
            d_in = hidden + qk
            t.dense(f"{p}/mf/in_lin", c, d_in)
            t.conv(f"{p}/mf/in_conv", (dw,), d_in, d_in, groups=d_in, bias=False)
            t.gain(f"{p}/mf/gamma", (4, qk), 0.1)
            t.offset(f"{p}/mf/beta", (4, qk))
            t.dense(f"{p}/mf/out_lin", cfg["mf_vdim"], c)
            t.conv(f"{p}/mf/out_conv", (dw,), c, c, groups=c, bias=False)
            for name, din, dout in (("avg1", c, c // 4), ("avg2", c // 4, c),
                                    ("max1", c, c // 4), ("max2", c // 4, c)):
                t.dense(f"{p}/se/{name}", din, dout)
        a = f"block{i}/attn"
        out_ch = 2 * h * qc + h * vc
        t.conv(f"{a}/qkv", (1, 1), c, out_ch)
        t.gain(f"{a}/qkv_act/alpha", (out_ch,), 0.25)
        t.gain(f"{a}/qk_g", (2, h, 1, qc, f), float((qc * f) ** -0.25))
        t.offset(f"{a}/qk_b", (2, h, 1, qc, f))
        t.gain(f"{a}/v_g", (h, 1, vc, f))
        t.offset(f"{a}/v_b", (h, 1, vc, f))
        t.conv(f"{a}/proj", (1, 1), h * vc, c)
        t.gain(f"{a}/proj_act/alpha", (c,), 0.25)
        t.gain(f"{a}/cf_g", (f, c))
        t.offset(f"{a}/cf_b", (f, c))
    return t.rows


# ── blocks ───────────────────────────────────────────────────────────────────


def _instance_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d over (T, F) per (batch, channel); x (B, T, F, C)."""
    mu = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _depthwise(p, x: torch.Tensor, k: int) -> torch.Tensor:
    return C.conv1d(p, x, padding=(k - 1) // 2, groups=x.shape[-1])


def _gau(p, x: torch.Tensor, cfg: dict, b: int) -> torch.Tensor:
    """MossFormer GAU over x (b·R, Q, C): relu² attention along Q, relu²
    attention across the R rows of each batch item (diagonal masked), linear
    attention along Q, gated."""
    n, q_len, c = x.shape
    rows = n // b
    half = c // 2
    shifted = torch.cat([F.pad(x[..., :half], (0, 0, 1, 0))[:, :q_len], x[..., half:]], -1)
    huv = F.silu(C.dense(p["in_lin"], C.layer_norm(shifted)))
    huv = huv + _depthwise(p["in_conv"], huv, cfg["dw_kernel"])
    hidden, qk = huv[..., : cfg["mf_hidden"]], huv[..., cfg["mf_hidden"]:]
    quad_q, lin_q, quad_k, lin_k = (C.rotary(qk * p["gamma"][i] + p["beta"][i], cfg["mf_rot"])
                                    for i in range(4))

    att = C.quad_attention(quad_q, quad_k, hidden, scale=1.0 / q_len)
    att = att + torch.matmul(torch.matmul(lin_q, lin_k.transpose(1, 2)) / q_len, hidden)

    def across(a):
        return a.reshape(b, rows, q_len, -1).transpose(1, 2).reshape(b * q_len, rows, -1)

    cross = C.quad_attention(across(quad_q), across(quad_k), across(hidden), scale=1.0 / rows,
                             mask_diag=True)
    att = att + cross.reshape(b, q_len, rows, -1).transpose(1, 2).reshape(n, q_len, -1)

    vd = cfg["mf_vdim"]
    out = (att[..., vd:] * hidden[..., :vd]) * torch.sigmoid(att[..., :vd] * hidden[..., vd:])
    o = F.silu(C.dense(p["out_lin"], C.layer_norm(out)))
    return x + o + _depthwise(p["out_conv"], o, cfg["dw_kernel"])


def _se(p, x: torch.Tensor) -> torch.Tensor:
    avg, mx = torch.mean(x, dim=(1, 2)), torch.amax(x, dim=(1, 2))
    ga = torch.sigmoid(C.dense(p["avg2"], torch.relu(C.dense(p["avg1"], avg))))
    gm = torch.sigmoid(C.dense(p["max2"], torch.relu(C.dense(p["max1"], mx))))
    return x * (ga + gm)[:, None, None, :]


def _path(p, x: torch.Tensor, cfg: dict, axis: str) -> torch.Tensor:
    b, t, f, c = x.shape
    h = C.layer_norm(x)
    seq = h.reshape(b * t, f, c) if axis == "f" else h.transpose(1, 2).reshape(b * f, t, c)
    seq = C.conv1d(p["unfold"], seq, stride=cfg["emb_hs"], groups=c)
    huv = F.silu(C.dense(p["uv"]["lin"], C.layer_norm(seq)))
    huv = huv + _depthwise(p["uv"]["conv"], huv, cfg["dw_kernel"])
    uv = cfg["uv_channels"]
    iu, iv = huv[..., :uv], huv[..., uv:]
    p1 = C.dense(p["fsmn"]["proj"], torch.relu(C.dense(p["fsmn"]["lin"], iu)))
    mem = C.conv1d(p["fsmn"]["mem"], p1, padding=cfg["lorder"] - 1, groups=uv)
    g = iv * (iu + p1 + mem)
    g = C.conv1d_transpose(p["refold"], g, stride=cfg["emb_hs"])
    g = _gau(p["mf"], g, cfg, b)
    g = g.reshape(b, t, f, c) if axis == "f" else g.reshape(b, f, t, c).transpose(1, 2)
    return _se(p["se"], g) + x


def _triple_attention(p, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, t, f, c = x.shape
    h, qc, vc = cfg["attn_heads"], cfg["attn_q_ch"], cfg["attn_v_ch"]
    qkv = C.prelu(p["qkv_act"]["alpha"], C.conv2d(p["qkv"], x))
    qk = torch.movedim(qkv[..., : 2 * h * qc].reshape(b, t, f, 2, h, qc), (3, 4), (1, 2))
    qk = C.layer_norm(qk.transpose(-1, -2), ndims=2) * p["qk_g"] + p["qk_b"]
    vv = torch.movedim(qkv[..., 2 * h * qc:].reshape(b, t, f, h, vc), 3, 1)
    vv = C.layer_norm(vv.transpose(-1, -2), ndims=2) * p["v_g"] + p["v_b"]
    q, k = qk[:, 0].reshape(b, h, t, qc * f), qk[:, 1].reshape(b, h, t, qc * f)
    v = vv.reshape(b, h, t, vc * f)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
    y = torch.matmul(attn, v).reshape(b, h, t, vc, f).permute(0, 2, 4, 1, 3)
    y = C.prelu(p["proj_act"]["alpha"], C.conv2d(p["proj"], y.reshape(b, t, f, h * vc)))
    return C.layer_norm(y, ndims=2) * p["cf_g"] + p["cf_b"] + x


def _dense_fsmn(p, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    skip, out, lorder = x, x, cfg["lorder"]
    for i in range(cfg["dense_depth"]):
        lp, d = p[f"layer{i}"], 1 << i
        h = C.conv2d(lp["conv"], F.pad(skip, (0, 0, 0, 0, d, 0)), padding=(0, 1),
                     dilation=(d, 1))
        h = C.prelu(lp["act"]["alpha"], _instance_norm(lp["norm"], h))
        p1 = C.conv2d(lp["fsmn_proj"], torch.relu(C.conv2d(lp["fsmn_lin"], h)))
        mem = C.conv2d(lp["fsmn_mem"], p1, padding=(0, lorder - 1), groups=p1.shape[-1])
        out = h + p1 + mem
        skip = torch.cat([out, skip], dim=-1)
    return out


def _decoder(p, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    h = C.conv2d(p["sp_conv"], _dense_fsmn(p["dense"], x, cfg), padding=(0, 1))
    b, t, f, c2 = h.shape
    return h.reshape(b, t, f * 2, c2 // 2)  # sub-pixel ×2 along frequency


def _net(p, mag_c: torch.Tensor, spec_c: torch.Tensor, cfg: dict) -> torch.Tensor:
    x = torch.cat([mag_c[..., None], spec_c], dim=-1)
    x = C.prelu(p["enc_act1"]["alpha"], _instance_norm(p["enc_norm1"], C.conv2d(p["enc_conv1"], x)))
    x = _dense_fsmn(p["enc_dense"], x, cfg)
    x = C.conv2d(p["enc_conv2"], x, stride=(1, 2), padding=(0, 1))
    x = C.prelu(p["enc_act2"]["alpha"], _instance_norm(p["enc_norm2"], x))
    for i in range(cfg["n_blocks"]):
        blk = p[f"block{i}"]
        x = _path(blk["intra"], x, cfg, "f")
        x = _path(blk["inter"], x, cfg, "t")
        x = _triple_attention(blk["attn"], x, cfg)

    m = C.conv2d(p["mask_conv1"], _decoder(p["mask_dec"], x, cfg))
    m = C.prelu(p["mask_act"]["alpha"], _instance_norm(p["mask_norm"], m))
    mask = C.prelu(p["mask_out_alpha"], C.conv2d(p["mask_final"], m)[..., 0])
    cx = C.prelu(p["cplx_act"]["alpha"],
                 _instance_norm(p["cplx_norm"], _decoder(p["cplx_dec"], x, cfg)))
    final = mask[..., None] * spec_c + C.conv2d(p["cplx_final"], cx)
    power = torch.sum(final * final, dim=-1)
    final = final * torch.pow(torch.clamp(power, min=1e-12),
                              (1.0 / cfg["compress"] - 1.0) * 0.5)[..., None]
    return torch.cat([final[..., 0], final[..., 1]], dim=-1)


def forward(params, audio: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, ...]:
    """int16 windows (B, L) → (denoised int16 (B, L),)."""
    if cfg["in_sample_rate"] != cfg["sample_rate"] or cfg["out_sample_rate"] != cfg["sample_rate"]:
        raise ValueError("the reference serves the model at its own sample rate only")
    x = audio.to(torch.float32)
    batch, length = x.shape
    fold = cfg["fold_window"] or cfg["hop"]
    x = F.pad(x, (0, -(-length // fold) * fold - length))
    if cfg["fold_window"]:
        x = x.reshape(-1, cfg["fold_window"])
    norm = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    n_fft, hop, fb = cfg["n_fft"], cfg["hop"], cfg["n_fft"] // 2 + 1
    pk = C.stft(x / norm, n_fft, hop, cfg["window"], cfg["pad_mode"])
    re, im = pk[..., :fb], pk[..., fb:]
    power = re * re + im * im
    mag_c = torch.pow(power, cfg["compress"] * 0.5)
    scale = torch.pow(torch.clamp(power, min=torch.finfo(torch.float32).tiny),
                      cfg["compress"] * 0.5 - 0.5)
    spec_c = torch.stack([re, im], dim=-1) * scale[..., None]
    y = C.istft(_net(params, mag_c, spec_c, cfg), n_fft, hop, cfg["window"]) * norm
    y = y.reshape(batch, -1)[:, :length]
    y = torch.where(torch.isnan(y), 0.0, y)
    return (torch.clamp(y, -32768.0, 32767.0).to(torch.int32).to(torch.int16),)
