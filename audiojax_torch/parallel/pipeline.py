"""Pipeline parallelism for deep residual stacks.

Counterpart of ``audiojax.parallel.pipeline``.  ``pp_stack_fn`` stages a
homogeneous stack of L layers over the ``pp`` axis of a mesh: stage s holds
layers [s·L/S, (s+1)·L/S) on device s of the axis, and M microbatches flow
stage to stage in the fill/drain schedule of M + S − 1 ticks.  At each tick
every busy stage runs its layers on its microbatch, and the result moves to
the next stage's device for the next tick; the stages of a tick are
launched one after another without a host sync, so distinct cards run them
at once.
The output is the last stage's, on the axis's first device, and equals
``layer_{L-1}(… layer_0(x) …)`` up to the layers' own order of sums.

Parameters come stacked with leading (S, L/S) axes
(:func:`stack_layer_params`); each stage's slice goes to its device at the
call (a no-op where it already lies there).
"""
from __future__ import annotations

import torch

from .sharding import Mesh, _tree_map

__all__ = ["stack_layer_params", "pp_stack", "pp_stack_fn"]


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def stack_layer_params(per_layer_params, n_stages: int):
    """[L homogeneous per-layer trees] → one tree with leading (S, L/S) axes."""
    n_layers = len(per_layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    return _tree_map(lambda *ls: torch.stack(ls).reshape(
        (n_stages, n_layers // n_stages) + ls[0].shape), *per_layer_params)


def pp_stack_fn(layer_fn, mesh: Mesh, *, axis: str = "pp", microbatches: int | None = None):
    """The staged executor ``fn(stage_params, x) -> y``.

    layer_fn(layer_params, h) -> h: one layer, shape-preserving.
    stage_params: a tree with leading (S, L/S) axes; S must equal
        ``mesh.shape[axis]``.
    x: (B, ...), split into ``microbatches`` equal microbatches (default:
        one a stage); B must divide evenly."""
    n_stages = mesh.shape[axis]
    m = n_stages if microbatches is None else microbatches
    if m < 1:
        raise ValueError(f"microbatches must be >= 1, got {m}")
    devices = mesh.along(axis)

    def run(stage_params, x):
        s = _first_leaf(stage_params).shape[0]
        if s != n_stages:
            raise ValueError(
                f"stage_params has {s} stages but mesh axis {axis!r} has "
                f"{n_stages} devices — restack with "
                f"stack_layer_params(layers, {n_stages})")
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        n_local = _first_leaf(stage_params).shape[1]
        layers = [[_tree_map(lambda a, i=i, li=li, d=d: a[i, li].to(d), stage_params)
                   for li in range(n_local)] for i, d in enumerate(devices)]
        micro = torch.chunk(x, m)
        held = [None] * n_stages  # what each stage computed at the last tick
        out = [None] * m
        for tick in range(m + n_stages - 1):
            prev = held
            held = [None] * n_stages
            for i, dev in enumerate(devices):
                j = tick - i  # the microbatch stage i works on at this tick
                if not 0 <= j < m:
                    continue
                h = (micro[j] if i == 0 else prev[i - 1]).to(dev)
                for p in layers[i]:
                    h = layer_fn(p, h)
                held[i] = h
            j = tick - (n_stages - 1)
            if j >= 0:
                out[j] = held[-1].to(devices[0])
        return torch.cat(out)

    return run


def pp_stack(layer_fn, mesh: Mesh, stage_params, x, *, axis: str = "pp",
             microbatches: int | None = None):
    """One-shot wrapper around :func:`pp_stack_fn`."""
    return pp_stack_fn(layer_fn, mesh, axis=axis, microbatches=microbatches)(stage_params, x)
