"""Artifact save/load: ``params.pt`` (or the JAX package's ``params.msgpack``)
+ ``manifest.json``.

Counterpart of ``audiojax.runtime.checkpoint``.  An artifact directory that
the port writes holds the importer's tree as ``params.pt`` (``torch.save`` of
CPU tensors in the JAX package's layout, lists kept as lists) and the
manifest as JSON, whose required keys are checked at load.  The leaves are
float32, or what an optimization plan (``runtime/optimize.py``) stores:
``{'q8', 'scale'}`` nodes of int8 values and float32 scales (q8f32, q8dyn)
and bfloat16 leaves (the weight-only bf16 plan).  ``load_artifact`` reads the
tree with ``weights_only=True`` (no code runs) and converts it once, through
``params_from_numpy``, onto the serving device.

An artifact that the JAX package wrote (``save_artifact`` there, or its
``optimize`` plans) holds ``params.msgpack`` instead: ``load_tree`` reads it
with the port's own decoder (``runtime/msgpack_io.py``; no ``msgpack`` or
``flax``, which the card's machine lacks) into the same leaves, and turns
msgpack's ``{"0": …, "1": …}`` dicts back into lists as the JAX loader's
``_relist`` does.  A directory that holds both files is refused: which
weights it serves would be a guess.  ``torch.save`` keeps lists and empty
containers as they are, so the port writes no msgpack work-arounds.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..params import params_from_numpy
from .manifest import Manifest

__all__ = ["save_artifact", "load_artifact", "load_tree", "PARAMS_FILE", "JAX_PARAMS_FILE"]

PARAMS_FILE = "params.pt"
JAX_PARAMS_FILE = "params.msgpack"  # what the JAX package writes


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


# what a plan stores besides float32: int8 (a q8 node's values) and bfloat16
_STORED = (torch.float32, torch.int8, torch.bfloat16)


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous().clone()
    else:
        a = np.asarray(a)
        if a.dtype not in (np.float32, np.int8):
            raise TypeError(f"artifact leaves are float32 (or a plan's int8); got {a.dtype}")
        t = torch.from_numpy(np.array(a, order="C"))
    if t.dtype not in _STORED:
        raise TypeError(f"artifact leaves are float32, int8 or bfloat16; got {t.dtype}")
    return t


def save_artifact(path, params, manifest: Manifest) -> Path:
    """Write ``params`` (a nested dict/list tree of float32 arrays, or of a
    plan's int8 arrays and bfloat16 tensors) and ``manifest`` into the
    directory ``path``."""
    path = Path(path)
    if (path / JAX_PARAMS_FILE).is_file():
        raise ValueError(f"{path} holds the JAX package's {JAX_PARAMS_FILE}; write the port's "
                         f"{PARAMS_FILE} into another directory")
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_map(params, _to_tensor), path / PARAMS_FILE)
    manifest.save(path / "manifest.json")
    return path


def _relist(tree):
    """msgpack stores lists as {"0": …, "1": …} dicts; lists again, as
    ``audiojax.runtime.checkpoint._relist`` restores them."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            idx = sorted(tree, key=int)
            if [int(k) for k in idx] == list(range(len(idx))):
                return [_relist(tree[k]) for k in idx]
        return {k: _relist(v) for k, v in tree.items()}
    return tree


def load_tree(path) -> dict:
    """The artifact's tree in the JAX package's layout: numpy arrays (float32,
    a q8 node's int8), and bfloat16 leaves as CPU tensors (numpy has no
    bfloat16 without ``ml_dtypes``); from ``params.pt`` or, for an artifact of
    the JAX package, ``params.msgpack``."""
    path = Path(path)
    pt, mp = path / PARAMS_FILE, path / JAX_PARAMS_FILE
    if pt.is_file() and mp.is_file():
        raise ValueError(f"artifact {path} holds both {PARAMS_FILE} and {JAX_PARAMS_FILE}; "
                         "remove the one that is not to be served")
    if mp.is_file():
        from .msgpack_io import restore

        return _relist(restore(mp.read_bytes(), str(mp)))
    tree = torch.load(pt, map_location="cpu", weights_only=True)
    return _map(tree, lambda t: t if t.dtype == torch.bfloat16 else t.numpy())


def load_artifact(path, device=None):
    """Load ``(params, manifest)``: the port's tensors on ``device`` (default:
    the card; without CUDA this raises rather than fall back)."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = Manifest.load(path / "manifest.json")
    return params_from_numpy(load_tree(path), dev), manifest
