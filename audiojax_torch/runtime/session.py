"""Serving session: manifest-driven windowing, batching, stitching, RTF.

Counterpart of ``audiojax.runtime.session``: fixed-size window slicing with
tail zero-pad, optional RMS normalisation, the PAD_HEAD warm-up prefix,
per-source output trimming, butt-join or Hann-taper overlap-add stitching,
and an RTF report.  All windows of a request are stacked on the batch axis
and go through the model in one call; the window count is rounded up to a
power of two (all-zero pad windows, dropped before stitching), as in the JAX
package, unless ``bucket_windows=False``.  With a ``mesh``
(``audiojax_torch.parallel.make_mesh``) the model is replicated on each
distinct device, the window batch is padded to a whole number a ``dp`` row
and then bucketed, each row's windows run on its device, and the outputs
are gathered before the stitch.  Windows are sliced and stitched in numpy,
where the JAX package takes its native bridge for mono int16: on the card's
host the bridge's slicing is slower than numpy's strided copies and its
Hann-taper stitch no faster (``chip_smoke.py`` phase 26 times both), so one
route serves.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..parallel import replicate, shard_batch, sharded_model_fn
from ..utils.profiling import span
from .audio_io import normalise_rms
from .manifest import Manifest

__all__ = ["Session", "SessionResult"]


@dataclass
class SessionResult:
    outputs: tuple[np.ndarray, ...]  # per output source, int16 (n,)
    rtf: float
    elapsed_s: float
    audio_duration_s: float

    @property
    def audio(self) -> np.ndarray:
        return self.outputs[0]


class Session:
    """Runs ``model(*audio_batches) -> out | (outs…)`` per manifest on ``device``
    (default: the card; the model is moved there), or over the ``dp`` rows of
    ``mesh`` (the outputs gathered on its first device).  ``device`` and
    ``mesh`` together are an error."""

    def __init__(self, model: nn.Module, manifest: Manifest, *, device=None, mesh=None,
                 bucket_windows: bool = True):
        self.manifest = manifest
        self.cfg = manifest.runtime_config()
        self.mesh = mesh
        self.bucket_windows = bucket_windows
        if mesh is None:
            self.device = resolve_device(device)
            self.model = model.to(self.device).eval()
            self._dp = 1
            return
        if device is not None:
            raise ValueError("Session takes device= or mesh=, not both: a mesh names its "
                             "devices (make_mesh(devices=...))")
        self._dp = mesh.shape["dp"]
        self.device = mesh.devices.reshape(-1)[0]
        self._replicas = replicate(mesh, model.eval())
        self.model = self._replicas[self.device]
        self._sharded = sharded_model_fn(mesh, lambda m, *audios: m(*audios))

    # ── host-side conditioning ───────────────────────────────────────────

    def _condition(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio)
        if audio.ndim == 1:
            audio = audio[None]  # (channels, n)
        if audio.shape[0] != self.cfg["INPUT_CHANNELS"]:
            if self.cfg["INPUT_CHANNELS"] == 1:
                audio = np.round(audio.astype(np.float32).mean(0, keepdims=True)).astype(np.int16)
            else:
                raise ValueError(
                    f"model expects {self.cfg['INPUT_CHANNELS']} channels, got {audio.shape[0]}"
                )
        if self.cfg["NORMALIZE_AUDIO"]:
            audio = normalise_rms(audio, self.cfg["NORMALIZE_TARGET_RMS"])
        return audio

    def _window_geometry(self, n: int):
        w = self.cfg["INPUT_AUDIO_LENGTH"]
        overlap = self.cfg["OVERLAP_LENGTH"]
        if overlap and overlap >= w:
            raise ValueError(
                f"manifest OVERLAP_LENGTH ({overlap}) must be smaller than "
                f"INPUT_AUDIO_LENGTH ({w}) — window stride would be {w - overlap}")
        stride = w - overlap if overlap else w
        num = 1 if n <= w else int(np.ceil((n - w) / stride)) + 1
        # a whole number of windows a dp row, then a power of two of them
        num_padded = -(-num // self._dp) * self._dp
        if self.bucket_windows and num_padded > 1:
            num_padded = self._dp * (1 << (num_padded // self._dp - 1).bit_length())
        return w, stride, num, num_padded

    # ── main entry ───────────────────────────────────────────────────────

    def process(self, *audios: np.ndarray) -> SessionResult:
        """Enhance one clip (AEC passes two clips: near_end, far_end).

        Under ``torch.profiler`` the call is a ``session.process`` span of
        six back-to-back phases (``utils.profiling.span``):
        ``session.condition``, ``session.slice``, ``session.to_device``,
        ``model.forward`` (the host's enqueue of the forward; the models
        mark their stages inside it), ``session.to_host`` (the copy back and
        the synchronisation) and ``session.stitch``; the middle three are
        the interval ``elapsed_s`` times."""
        with span("session.process"):
            return self._process(audios)

    def _process(self, audios) -> SessionResult:
        if len(audios) != self.cfg["NUM_AUDIO_INPUTS"]:
            raise ValueError(
                f"model expects {self.cfg['NUM_AUDIO_INPUTS']} audio inputs, got {len(audios)}"
            )
        with span("session.condition"):
            conditioned = [self._condition(a) for a in audios]
        with span("session.slice"):
            n = max(a.shape[-1] for a in conditioned)
            pad_head = self.cfg["PAD_HEAD"]
            total = n + pad_head
            w, stride, num, num_padded = self._window_geometry(total)
            need = (num_padded - 1) * stride + w

            batches = []
            for a in conditioned:
                a = np.pad(a, [(0, 0)] * (a.ndim - 1)
                           + [(pad_head, max(0, need - pad_head - a.shape[-1]))])
                wins = np.stack([a[..., s : s + w] for s in range(0, num_padded * stride, stride)])
                # (num, channels, w) → model contract is (batch, w) for mono
                batches.append(wins[:, 0] if wins.shape[1] == 1 else wins)

        start = time.perf_counter()
        with torch.inference_mode():
            with span("session.to_device"):
                if self.mesh is None:
                    inputs = [torch.from_numpy(np.ascontiguousarray(b)).to(self.device)
                              for b in batches]
                else:
                    inputs = [shard_batch(self.mesh, b) for b in batches]
            with span("model.forward"):
                if self.mesh is None:
                    out = self.model(*inputs)
                else:
                    out = self._sharded(self._replicas, *inputs)
            with span("session.to_host"):
                outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
                outs = tuple(o[:num].cpu().numpy() for o in outs)  # drop the pad windows
                for dev in ([self.device] if self.mesh is None else self.mesh.distinct()):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - start

        with span("session.stitch"):
            scale = self.cfg["INPUT_TO_OUTPUT_SCALE"]
            out_total = int(round(n * scale))
            head_out = int(round(pad_head * scale))
            # trim on the TIME axis — outputs may be (num, w) or (num, ch, w)
            stitched = tuple(
                self._stitch(o, stride, scale)[..., head_out : head_out + out_total] for o in outs
            )

        duration = out_total / self.cfg["OUT_SAMPLE_RATE"]
        return SessionResult(
            outputs=stitched,
            rtf=elapsed / duration if duration > 0 else float("inf"),
            elapsed_s=elapsed,
            audio_duration_s=duration,
        )

    def _stitch(self, windows: np.ndarray, stride_in: int, scale: float) -> np.ndarray:
        """(num, [ch,] w_out) → ([ch,] n): butt-join, or Hann-taper OLA when
        overlapped; multi-channel outputs stitch per channel."""
        num, w_out = windows.shape[0], windows.shape[-1]
        stride_out = int(round(stride_in * scale))
        if num == 1:
            return windows[0]
        overlap = w_out - stride_out
        if overlap <= 0:
            # butt-join along TIME, preserving any channel axis
            return np.moveaxis(windows, 0, -2).reshape(*windows.shape[1:-1], num * w_out)
        if windows.ndim == 3:  # (num, ch, w): OLA each channel independently
            return np.stack(
                [self._stitch(windows[:, c], stride_in, scale) for c in range(windows.shape[1])]
            )
        taper = np.ones(w_out, np.float32)
        ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(overlap) + 1) / (overlap + 1))
        taper[:overlap] = ramp
        taper[-overlap:] = ramp[::-1]
        total = (num - 1) * stride_out + w_out
        acc = np.zeros(total, np.float32)
        norm = np.zeros(total, np.float32)
        for i in range(num):
            s = i * stride_out
            t = taper.copy()
            if i == 0:
                t[:overlap] = 1.0
            if i == num - 1:
                t[-overlap:] = 1.0
            acc[s : s + w_out] += windows[i].astype(np.float32) * t
            norm[s : s + w_out] += t
        out = acc / np.maximum(norm, 1e-7)
        if windows.dtype == np.int16:
            return np.clip(np.round(out), -32768, 32767).astype(np.int16)
        return out.astype(windows.dtype)
