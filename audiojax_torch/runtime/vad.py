"""Host-side VAD post-processing: frame probabilities → speech timestamps.

A copy of ``audiojax.runtime.vad`` (the port imports nothing of the JAX
package), host numpy: a two-threshold hysteresis state machine over per-frame
speech probabilities with a look-ahead mean confirmation; then segments
shorter than the minimum are dropped BEFORE adjacent segments are fused
across small gaps, the upstream DFSMN-AEC inference script's order.
"""
from __future__ import annotations

import numpy as np

__all__ = ["probabilities_to_silence", "fuse_timestamps", "vad_timestamps"]


def probabilities_to_silence(probs, *, speaking_score: float, silence_score: float,
                             look_ahead_frames: int) -> np.ndarray:
    """Per-frame silence states (True = silence).

    Hysteresis: silence → speech requires the frame to clear
    ``speaking_score`` AND the fraction of the look-ahead window above it to
    clear the score too (upstream compares the mean of the boolean future
    window against the score itself); speech → silence mirrors with
    ``silence_score``.  The final ``look_ahead_frames`` frames (no full
    window left) use the plain two-threshold hysteresis.
    """
    probs = np.asarray(probs, np.float64).reshape(-1)
    n = len(probs)
    look = max(0, int(look_ahead_frames))
    states = np.empty(n, bool)
    silence = True
    tail_start = max(0, n - look)
    for i in range(tail_start):
        future = probs[i:i + look]
        if silence:
            silence = not (probs[i] >= speaking_score
                           and np.mean(future >= speaking_score) >= speaking_score)
        elif probs[i] <= silence_score:
            silence = np.mean(future <= silence_score) > silence_score
        else:
            silence = False
        states[i] = silence
    for i in range(tail_start, n):
        silence = (probs[i] < speaking_score) if silence else (probs[i] <= silence_score)
        states[i] = silence
    return states


def fuse_timestamps(timestamps, *, fusion_threshold_s: float,
                    min_speech_s: float) -> list[tuple[float, float]]:
    """Drop sub-minimum segments first, then fuse gaps ≤ ``fusion_threshold_s``
    (the reverse order would let bridged noise blips pass the minimum)."""
    kept = [(s, e) for s, e in timestamps if e - s >= min_speech_s]
    fused: list[tuple[float, float]] = []
    for s, e in kept:
        if fused and s - fused[-1][1] <= fusion_threshold_s:
            fused[-1] = (fused[-1][0], e)
        else:
            fused.append((s, e))
    return fused


def vad_timestamps(probs: np.ndarray, *, hop: int, sample_rate: int, threshold: float = 0.5,
                   silence_score: float | None = None, look_ahead_s: float = 0.3,
                   min_speech_s: float = 0.2,
                   fusion_threshold_s: float = 0.3) -> list[tuple[float, float]]:
    """Per-frame speech probabilities → merged (start_s, end_s) segments.

    ``threshold`` is upstream's speaking score; ``silence_score`` defaults to
    the same value (both 0.5 upstream).  A segment ends at the first silent
    frame's time plus one frame, as upstream's does."""
    probs = np.asarray(probs).reshape(-1)
    frame_s = hop / sample_rate
    look = max(1, int(round(look_ahead_s / frame_s)))
    sil = threshold if silence_score is None else silence_score
    states = probabilities_to_silence(probs, speaking_score=threshold, silence_score=sil,
                                      look_ahead_frames=look)
    segments: list[tuple[float, float]] = []
    start = None
    for i, silence in enumerate(states):
        if silence and start is not None:
            segments.append((start, i * frame_s + frame_s))
            start = None
        elif not silence and start is None:
            start = i * frame_s
    if start is not None:
        segments.append((start, (len(states) - 1) * frame_s + frame_s))
    return [(round(s, 4), round(e, 4)) for s, e in
            fuse_timestamps(segments, fusion_threshold_s=fusion_threshold_s,
                            min_speech_s=min_speech_s)]
