"""Real-time factor of a model function, on the card or the CPU.

Counterpart of ``audiojax.utils.profiling``, with the same contract: the
passes are chained (each output feeds the next pass as its input: both are
int16 of one shape), ``settle`` extra passes run after a warm-up call before
any timing, and ``repeats`` timed loops of ``iters`` passes each report the
fastest loop (noise on a shared host only ever adds time).

On the card a loop is timed by CUDA events on the current stream, recorded
after a synchronize, so the time runs from the loop's first launch to its
last kernel's end, host gaps included; the JAX package syncs by a host
transfer, which the card does not need.  On the CPU a loop is timed by the
host clock.

:func:`span` names a stretch of host time on ``torch.profiler``'s clock:
``Session.process`` marks its phases with it, and the served models their
stages.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["measure_rtf", "span"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records a host span ``name`` while a ``torch.profiler``
    session runs, and does nothing otherwise (one flag read, the same shared
    no-op context each time).

    The span is a host-only event (``cpu_op``), on the profiler's clock
    beside the device's kernels, so an idle stretch of the device can be put
    down to the innermost span the host was in.  It is made by
    ``_RecordFunctionFast`` and not ``record_function``: the latter is a user
    annotation, which the CUDA trace mirrors by a device-side mark covering
    every kernel it launched and the gaps between them, so it would read as
    device work.  While ``torch.export`` (or ``torch.compile``) traces, the
    span is the no-op: a graph holds no profiler node."""
    if torch._C._autograd._profiler_enabled() and not torch.compiler.is_compiling():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def _chain(y):
    # a multi-output model (separation, AEC + VAD) returns a tuple whose first
    # output is audio-shaped like the input: it carries the chain
    return y[0] if isinstance(y, (tuple, list)) else y


def measure_rtf(fn, params, audio: torch.Tensor, *, sample_rate: int, iters: int = 20,
                warmup: bool = True, settle: int = 12, repeats: int = 1) -> dict:
    """Steady-state real-time factor of ``fn(params, audio) -> audio-like``.

    Returns ``latency_s`` (seconds a pass, from the fastest of ``repeats``
    loops), ``audio_s`` (the input's duration at ``sample_rate``) and
    ``rtf`` (their ratio); with ``repeats`` > 1 also ``spread_s``, the
    slowest loop's seconds a pass less the fastest's."""
    cuda = audio.device.type == "cuda"
    with torch.inference_mode():
        if warmup:
            _chain(fn(params, audio))
            x = audio
            for _ in range(settle):
                x = _chain(fn(params, x))
        loops = []
        x = audio
        for _ in range(max(repeats, 1)):
            if cuda:
                torch.cuda.synchronize(audio.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    x = _chain(fn(params, x))
                end.record()
                end.synchronize()
                elapsed = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    x = _chain(fn(params, x))
                elapsed = time.perf_counter() - t0
            loops.append(elapsed)
    latency = min(loops) / iters
    duration = audio.shape[-1] / sample_rate
    out = {"latency_s": latency, "audio_s": duration, "rtf": latency / duration}
    if len(loops) > 1:
        out["spread_s"] = (max(loops) - min(loops)) / iters
    return out
