"""Plain copy of a serving session's arithmetic: how a request is
conditioned and cut into windows, how many windows a batch is rounded up to,
and how the windows' outputs are joined and trimmed.

``serving`` is the dict under ``"serving"`` in a configuration file:
``window`` (input samples a window), ``pad_head`` (silent samples put before
the clip), ``overlap`` (input samples two neighbouring windows share: 0
butt-joins the outputs, more overlap-adds them under a Hann taper),
``bucket`` (``pow2``: the batch of windows is rounded up to a power of two
with silent windows, which are dropped), ``scale`` (output samples an input
sample), ``inputs`` (audio inputs a request: an echo canceller takes two),
``channels`` (channels an input; a request with more is averaged to mono
where the model takes one) and ``normalize_rms`` (None, or the RMS that
each input is scaled to first).  int16 in and out.
"""
from __future__ import annotations

import numpy as np
import torch


def windows_needed(n: int, serving: dict) -> int:
    """Windows a clip of ``n`` samples needs."""
    w, total = serving["window"], n + serving["pad_head"]
    stride = w - serving["overlap"]
    return 1 if total <= w else -(-(total - w) // stride) + 1


def windows_run(needed: int, serving: dict) -> int:
    """Windows the model runs for a clip that needs ``needed``."""
    if serving["bucket"] == "pow2" and needed > 1:
        return 1 << (needed - 1).bit_length()
    return needed


def condition(audio: np.ndarray, serving: dict) -> np.ndarray:
    """One input as ``(channels, n)`` int16, averaged to mono and scaled to
    the RMS target where ``serving`` says."""
    a = np.asarray(audio)
    a = a[None] if a.ndim == 1 else a
    if a.shape[0] != serving["channels"]:
        if serving["channels"] != 1:
            raise ValueError(f"the model takes {serving['channels']} channels, got {a.shape[0]}")
        a = np.round(a.astype(np.float32).mean(0, keepdims=True)).astype(np.int16)
    if serving["normalize_rms"] is not None:
        x = a.astype(np.float32)
        rms = float(np.sqrt(np.mean(x * x)))
        if rms > 0.0:
            x *= serving["normalize_rms"] / (rms + 1e-7)
        a = np.clip(x, -32768.0, 32767.0).astype(np.int16)
    return a


def stitch(windows: np.ndarray, stride_in: int, scale: float) -> np.ndarray:
    """(num, [ch,] w_out) → ([ch,] total): butt-joined, or where windows
    overlap, added under a Hann taper (the first window's head and the last
    one's tail untapered) and divided by the taper's sum."""
    num, w_out = windows.shape[0], windows.shape[-1]
    stride_out = int(round(stride_in * scale))
    if num == 1:
        return windows[0]
    overlap = w_out - stride_out
    if overlap <= 0:
        return np.moveaxis(windows, 0, -2).reshape(*windows.shape[1:-1], num * w_out)
    if windows.ndim == 3:
        return np.stack([stitch(windows[:, c], stride_in, scale)
                         for c in range(windows.shape[1])])
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 1) / (overlap + 1))
    total = (num - 1) * stride_out + w_out
    acc = np.zeros(total, np.float32)
    norm = np.zeros(total, np.float32)
    for i in range(num):
        t = np.ones(w_out, np.float32)
        t[:overlap] = ramp
        t[-overlap:] = ramp[::-1]
        if i == 0:
            t[:overlap] = 1.0
        if i == num - 1:
            t[-overlap:] = 1.0
        s = i * stride_out
        acc[s: s + w_out] += windows[i].astype(np.float32) * t
        norm[s: s + w_out] += t
    out = acc / np.maximum(norm, 1e-7)
    if windows.dtype == np.int16:
        return np.clip(np.round(out), -32768, 32767).astype(np.int16)
    return out.astype(windows.dtype)


def serve(forward, params, clip: tuple, cfg: dict, serving: dict, device,
          block: int) -> tuple[np.ndarray, ...]:
    """``forward(params, *windows, cfg)`` over the windows of one request
    (a tuple of inputs), ``block`` windows a call; each source's outputs
    stitched and trimmed."""
    if len(clip) != serving["inputs"]:
        raise ValueError(f"the model takes {serving['inputs']} inputs, got {len(clip)}")
    w, head, scale = serving["window"], serving["pad_head"], serving["scale"]
    stride = w - serving["overlap"]
    inputs = [condition(a, serving) for a in clip]
    n = max(a.shape[-1] for a in inputs)
    num = windows_needed(n, serving)
    batches = []
    for a in inputs:
        a = np.pad(a, [(0, 0), (head, max(0, (num - 1) * stride + w - head - a.shape[-1]))])
        wins = np.stack([a[:, s: s + w] for s in range(0, num * stride, stride)])
        batches.append(wins[:, 0] if wins.shape[1] == 1 else wins)
    outs = []
    for s in range(0, num, block):
        xs = [torch.from_numpy(np.ascontiguousarray(b[s: s + block])).to(device) for b in batches]
        with torch.no_grad():
            outs.append([o.cpu().numpy() for o in forward(params, *xs, cfg)])
    out_total, head_out = int(round(n * scale)), int(round(head * scale))
    return tuple(stitch(np.concatenate([o[k] for o in outs]), stride, scale)
                 [..., head_out: head_out + out_total] for k in range(len(outs[0])))
