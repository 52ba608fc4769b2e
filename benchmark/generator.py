"""The one traffic generator: a mix file's parameters and a seed → requests.

A mix (``benchmark/traffic/<name>.json``) states:

- ``sample_rate``;
- ``lengths_s``: ``{"law": "fixed", "value": s, "strata": n}`` or
  ``{"law": "log_uniform", "low": a, "high": b, "strata": n}``.  A round is
  ``n`` requests, one at each of the law's ``n`` quantiles (i + 1/2)/n, so
  every seed serves the same set of lengths; the seed draws the requests'
  content and the order of each round;
- ``voices``: how many synthetic voices each request draws;
- ``inputs``: the request's audio inputs (an echo canceller takes two), each
  a list of channels, each channel a list of terms
  ``{"voice": i, "gain": g, "delay_s": d}`` (``delay_s`` may be left out):
  the sum of voice ``i`` times ``g``, ``d`` seconds late;
- ``check``: how many completed requests the output check draws, and whether
  the longest completed one is always among them.

A voice is a gliding harmonic series under a syllable-rate envelope, with
its own white noise, as in the project's smoke tests; its pitch and
syllable rate are drawn per request.  Requests are generated once, at
set-up, and each round serves them again in a new order.  A request is a
tuple of int16 arrays, one an input: ``(n,)`` for one channel, else
``(channels, n)``.  There is one client, in a closed loop: each request is
sent when the previous one returns.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

PITCH_HZ = (100.0, 240.0)
RATE_HZ = (2.5, 4.5)


@dataclass
class Traffic:
    clips: list  # one request each: a tuple of int16 inputs, one a stratum
    order: np.ndarray  # clip indices in the order they are sent
    sample_rate: int


def samples(clip: tuple) -> int:
    """Samples a channel of the request ``clip``."""
    return max(x.shape[-1] for x in clip)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), int(seed) >> 63, *keys])


def lengths(mix: dict) -> list[int]:
    law, sr = mix["lengths_s"], mix["sample_rate"]
    n = law["strata"]
    if law["law"] == "fixed":
        secs = [law["value"]] * n
    elif law["law"] == "log_uniform":
        lo, hi = math.log(law["low"]), math.log(law["high"])
        secs = [math.exp(lo + (hi - lo) * (i + 0.5) / n) for i in range(n)]
    else:
        raise ValueError(f"no length law {law['law']!r}")
    return [int(round(s * sr)) for s in secs]


def voice(n: int, rng: np.random.Generator, sr: int, pitch: float, rate: float) -> np.ndarray:
    """A gliding harmonic voice (around ``pitch`` Hz) under a syllable-rate
    envelope (``rate`` Hz), peak 0.3, plus white noise at 0.05 (float64)."""
    t = np.arange(n) / sr
    f0 = pitch + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 11))
    voiced *= (0.5 + 0.5 * np.sin(2 * np.pi * rate * t)) ** 2
    return 0.3 * voiced / np.abs(voiced).max() + 0.05 * rng.standard_normal(n)


def _late(x: np.ndarray, d: int) -> np.ndarray:
    return np.concatenate([np.zeros(d), x[: x.shape[0] - d]]) if d else x


def clip(n: int, mix: dict, rng: np.random.Generator) -> tuple:
    sr = mix["sample_rate"]
    voices = [voice(n, rng, sr, rng.uniform(*PITCH_HZ), rng.uniform(*RATE_HZ))
              for _ in range(mix["voices"])]
    out = []
    for channels in mix["inputs"]:
        x = np.stack([sum(t["gain"] * _late(voices[t["voice"]],
                                            int(round(t.get("delay_s", 0.0) * sr)))
                          for t in terms) for terms in channels])
        x = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
        out.append(x[0] if x.shape[0] == 1 else x)
    return tuple(out)


def generate(mix: dict, seed: int, rounds: int = 64) -> Traffic:
    sizes = lengths(mix)
    clips = [clip(n, mix, _rng(seed, 1, i)) for i, n in enumerate(sizes)]
    rng = _rng(seed, 2)
    order = np.concatenate([rng.permutation(len(sizes)) for _ in range(rounds)])
    return Traffic(clips, order, mix["sample_rate"])


def check_sample(mix: dict, seed: int, completed: list[int], traffic: Traffic) -> list[int]:
    """Indices into ``completed`` (the clip index of each completed request)
    of the requests whose outputs are checked: distinct clips drawn from the
    seed, the longest completed clip among them where the mix asks, each at
    one of its requests drawn from the seed."""
    by_clip: dict = {}
    for i, c in enumerate(completed):
        by_clip.setdefault(int(c), []).append(i)
    clips = sorted(by_clip)
    rng = _rng(seed, 3)
    pick = []
    if mix["check"]["longest"]:
        pick.append(max(clips, key=lambda c: (samples(traffic.clips[c]), -c)))
    rest = [c for c in clips if c not in pick]
    need = min(len(rest), mix["check"]["requests"] - len(pick))
    pick += [rest[j] for j in rng.choice(len(rest), size=need, replace=False)]
    return sorted(by_clip[c][rng.integers(len(by_clip[c]))] for c in pick)
