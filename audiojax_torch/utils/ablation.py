"""Stage-ablation profiling: attribute full-forward latency to stages.

Counterpart of ``audiojax.utils.ablation``.  A stage's cost alone is not its
cost inside the forward: what it hands on, and what runs beside it, change.
The method: stub one stage at a time with a shape-preserving no-op and time
the FULL forward; the latency drop is the stage's in-context cost.

Usage::

    import audiojax_torch.models.mossformer2_ss as m2ss
    report = ablate(
        make_fn=lambda: m2ss.make_mossformer2_ss(cfg),
        params=params, audio=audio, sample_rate=16000,
        stages=[Stage("flash_layers", m2ss, "flash_layer", lambda p, x, **k: x)],
    )

Each stub must keep the stage's output shape and dtype (usually
``lambda *a, **k: <identity on the main operand>``) so that the rest of the
forward runs unchanged.

``Stage.module`` must be the module whose namespace the forward READS at
call time: the models bind blocks and kernels by value at import (``from
..nn.mossformer import flash_layer``), so stub the MODEL module (``m2ss``
above), not the defining one: patching ``audiojax_torch.nn.mossformer``
would leave the model's own binding untouched and silently profile nothing.
``ablate`` holds every stage to two counts taken while it is timed: its stub
must run (else ``ValueError``), and the function it replaced must run zero
times (else ``ValueError``: another binding still reaches it).  The second
count watches the replaced function's code object through
``sys.monitoring`` (events on that code object alone).  The forward is eager,
so no trace cache needs clearing between stages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import sys
from typing import Any, Callable

import torch

from .profiling import measure_rtf

__all__ = ["Stage", "ablate", "stubbed", "calls_of", "output_specs"]


@dataclasses.dataclass(frozen=True)
class Stage:
    """One ablatable stage: ``module.attr`` is swapped for ``stub`` while the
    forward is timed."""

    name: str
    module: Any
    attr: str
    stub: Callable


@contextlib.contextmanager
def stubbed(module, attr: str, replacement):
    """Temporarily replace ``module.attr`` (restores on exit, always)."""
    original = getattr(module, attr)
    setattr(module, attr, replacement)
    try:
        yield original
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def calls_of(fn):
    """Count the calls of the Python function ``fn`` (its code object, by any
    binding) inside the block: yields a one-item list holding the count."""
    code = getattr(inspect.unwrap(fn), "__code__", None)
    if code is None:
        raise TypeError(f"{fn!r} is not a Python function: its calls cannot be counted")
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id to count calls with")
    mon.use_tool_id(tool, "audiojax_torch.utils.ablation")
    count = [0]

    def started(_code, _offset):
        count[0] += 1

    mon.register_callback(tool, mon.events.PY_START, started)
    mon.set_local_events(tool, code, mon.events.PY_START)
    try:
        yield count
    finally:
        mon.set_local_events(tool, code, mon.events.NO_EVENTS)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.free_tool_id(tool)


def _spec(out):
    if isinstance(out, (tuple, list)):
        return tuple(_spec(o) for o in out)
    return tuple(out.shape), out.dtype


def output_specs(run: Callable[[], Any], module, attrs) -> dict:
    """``{attr: (shape, dtype)}`` (a tuple of them for a tuple output) of the
    first call of each ``module.attr`` in one pass of ``run()``: where the
    JAX package asks ``jax.eval_shape``, the port records a real pass."""
    specs = {}

    def recorder(attr, fn):
        def record(*a, **kw):
            out = fn(*a, **kw)
            specs.setdefault(attr, _spec(out))
            return out
        return record

    with contextlib.ExitStack() as stack:
        for attr in attrs:
            stack.enter_context(stubbed(module, attr, recorder(attr, getattr(module, attr))))
        with torch.inference_mode():
            run()
    missing = [a for a in attrs if a not in specs]
    if missing:
        raise ValueError(f"{module.__name__}: {missing} never ran in the recorded pass")
    return specs


def ablate(*, make_fn: Callable[[], Callable], params, audio, sample_rate: int,
           stages: list[Stage], iters: int = 20, settle: int = 12, repeats: int = 1) -> dict:
    """Time the full forward with each stage stubbed out, one at a time.

    Returns ``{"baseline": {...}, "stages": [{name, rtf, latency_s,
    attributed_s, attributed_pct, stub_calls, original_calls}, ...]}`` where
    ``attributed_s`` is the latency recovered by removing the stage: its
    in-context cost.  With ``repeats`` > 1 each timing is the fastest of that
    many loops and carries ``spread_s`` (slowest less fastest, a pass).
    """
    base = measure_rtf(make_fn(), params, audio, sample_rate=sample_rate, iters=iters,
                       settle=settle, repeats=repeats)
    rows = []
    for st in stages:
        hits = 0

        def counted(*a, _stub=st.stub, **kw):
            nonlocal hits
            hits += 1
            return _stub(*a, **kw)

        with stubbed(st.module, st.attr, counted) as original, calls_of(original) as orig:
            r = measure_rtf(make_fn(), params, audio, sample_rate=sample_rate, iters=iters,
                            settle=settle, repeats=repeats)
        where = f"{st.module.__name__}.{st.attr}"
        if hits == 0:
            raise ValueError(
                f"stage {st.name!r}: stub for {where} was never called while timing the "
                f"forward — Stage.module must be the module the forward actually reads "
                f"(models bind blocks by value at import; stub the model module)")
        if orig[0]:
            raise ValueError(
                f"stage {st.name!r}: the function the stub replaced at {where} was called "
                f"{orig[0]} times while stubbed — another binding of it reaches the forward")
        saved = base["latency_s"] - r["latency_s"]
        row = {
            "name": st.name,
            "rtf": r["rtf"],
            "latency_s": r["latency_s"],
            "attributed_s": saved,
            "attributed_pct": 100.0 * saved / base["latency_s"],
            "stub_calls": hits,
            "original_calls": orig[0],
        }
        if "spread_s" in r:
            row["spread_s"] = r["spread_s"]
        rows.append(row)
    return {"baseline": base, "stages": rows}
