"""Serving over several devices: a device mesh and data-parallel model calls.

Counterpart of ``audiojax.parallel.sharding``.  A :class:`Mesh` is an array
of ``torch.device``s with axis names; :func:`make_mesh` lays the cards out
as ``("dp", "tp")``:

  * ``dp`` splits the window batch: each row's device runs the model on its
    own windows (:func:`shard_batch`, :func:`sharded_model_fn`), and the
    outputs are gathered in order onto the mesh's first device.  Distinct
    cards are launched one after another without a host sync between them,
    so they run at once.
  * ``tp`` is accepted and replicates: every device of a row holds the
    parameters, and the row's windows run on its first device.  Splitting
    a model's tensors over cards needs collectives between them inside the
    forward, which the port does not have (ROADMAP, deliberate divergences).

A device may appear more than once (``devices=["cpu"] * 8`` in the tests,
``["cuda:0", "cuda:0"]`` on a one-card host): its rows then run one after
another on it, over one copy of the parameters.  :func:`shard_hint` is the
identity with or without a mesh; :func:`spmd_mesh` keeps the active mesh,
as in the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import threading

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_batch",
    "sharded_model_fn",
    "spmd_mesh",
    "shard_hint",
]

_ctx = threading.local()


def _device(d) -> torch.device:
    """``d`` resolved (CUDA must be present), a bare ``cuda`` given its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``devices`` (an array of devices, or of names) with one name an axis."""

    def __init__(self, devices, axis_names):
        flat = [_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in the order of first appearance."""
        return list(dict.fromkeys(self.devices.reshape(-1)))

    def along(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if k == i else 0 for k in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


@contextlib.contextmanager
def spmd_mesh(mesh: Mesh):
    """Keep ``mesh`` as the active mesh while the block runs."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def shard_hint(x, *spec):
    """The identity, with or without an active mesh: the port splits no
    tensor inside a model (the module note)."""
    return x


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A ``(dp, tp)`` mesh over ``n_devices`` of ``devices`` (default: every
    card, ``torch.cuda.device_count()``; without CUDA that raises)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} device(s) are "
                f"visible ({devices!r}); pass devices= for a mesh over fewer cards (a "
                f"device may repeat, e.g. [\"cuda:0\"] * {n_devices})")
        devices = devices[:n_devices]
    n = len(devices)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh(np.asarray([str(d) for d in devices], dtype=object).reshape(n // tp, tp),
                ("dp", "tp"))


def _tree_map(fn, *trees):
    """``fn`` over the leaves of one or more trees of dicts, lists and tuples."""
    node = trees[0]
    if isinstance(node, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def replicate(mesh: Mesh, tree) -> dict:
    """One copy of a parameter tree (or a module) on each distinct device of
    the mesh, by device.  The first device takes the module itself (moved,
    as ``Session`` moves a module), each other one a deep copy."""
    devices = mesh.distinct()
    if isinstance(tree, nn.Module):
        first = tree.to(devices[0])
        return {d: first if d == devices[0] else copy.deepcopy(first).to(d) for d in devices}
    return {d: _tree_map(lambda t, d=d: t.to(d) if isinstance(t, torch.Tensor) else t, tree)
            for d in devices}


def shard_batch(mesh: Mesh, x) -> list:
    """``x`` (a tensor or an array) split on its leading axis over ``dp``:
    one shard a row, on the row's first device."""
    rows = mesh.along("dp")
    b = x.shape[0]
    if b % len(rows):
        raise ValueError(f"batch {b} not divisible by dp={len(rows)}")
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return [s.to(dev) for s, dev in zip(torch.chunk(x, len(rows)), rows)]


def sharded_model_fn(mesh: Mesh, model_fn):
    """``fn(replicas, *shards)`` that runs ``model_fn(replicas[d], *row)`` on
    each dp row's device ``d`` and returns the outputs (a tensor or a tuple
    of them) concatenated in row order on the mesh's first device:
    ``replicas`` as :func:`replicate` returns them, one
    :func:`shard_batch` list an audio input."""
    rows = mesh.along("dp")
    first = mesh.devices.reshape(-1)[0]

    def fn(params, *shards):
        with spmd_mesh(mesh):
            outs = [model_fn(params[dev], *(s[i] for s in shards)) for i, dev in enumerate(rows)]
        if isinstance(outs[0], (tuple, list)):
            return tuple(torch.cat([o[k].to(first) for o in outs]) for k in range(len(outs[0])))
        return torch.cat([o.to(first) for o in outs])

    return fn
