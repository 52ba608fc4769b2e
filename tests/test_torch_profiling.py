"""The port's ``measure_rtf`` against the contract of ``audiojax.utils.profiling``,
on the CPU: chained passes (each output is the next pass's input), a warm-up
call and ``settle`` passes before any timing, ``repeats`` timed loops of which
the fastest is reported, and a tuple's first output carrying the chain.  Both
packages' functions make the same calls on the same inputs.
"""
import numpy as np
import pytest
import torch

from audiojax.utils import measure_rtf as jax_measure_rtf

from audiojax_torch.utils.profiling import measure_rtf


def _recorder(multi: bool):
    """A model that adds 1 to its input and records each input's first sample."""
    seen = []

    def fn(params, audio):
        seen.append(int(audio[0, 0]))
        out = audio + 1
        return (out, "vad") if multi else out

    return fn, seen


@pytest.mark.parametrize("settle,repeats,multi", [(0, 1, False), (12, 1, False), (2, 3, True)])
def test_measure_rtf_contract_matches_jax(settle, repeats, multi):
    audio = np.zeros((1, 8000), np.int16)
    fn, seen = _recorder(multi)
    jfn, jseen = _recorder(multi)
    out = measure_rtf(fn, {}, torch.from_numpy(audio), sample_rate=16000, iters=3,
                      settle=settle, repeats=repeats)
    jout = jax_measure_rtf(jfn, {}, audio, sample_rate=16000, iters=3, settle=settle,
                           repeats=repeats)
    # the warm-up call, the settle passes chained from the input, then the
    # timed loops chained from the input on
    assert seen == jseen == [0, *range(settle), *range(3 * repeats)]
    assert out["audio_s"] == jout["audio_s"] == 0.5
    assert out["latency_s"] > 0 and out["rtf"] == out["latency_s"] / 0.5


def test_measure_rtf_reports_the_fastest_loop(monkeypatch):
    """Three loops timed 3, 1 and 2 units by the host clock: the second's
    third of a unit a pass is reported."""
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])
    monkeypatch.setattr("audiojax_torch.utils.profiling.time.perf_counter", lambda: next(clock))
    out = measure_rtf(lambda p, a: a, {}, torch.zeros((1, 16000), dtype=torch.int16),
                      sample_rate=16000, iters=3, warmup=False, repeats=3)
    assert out["latency_s"] == pytest.approx(1.0 / 3) and out["rtf"] == pytest.approx(1.0 / 3)
