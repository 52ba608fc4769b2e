"""What the port's model modules share: parameters held as buffers, and the
numpy draws of random parameters in the JAX package's layouts."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..params import BUFFER_SEP
from ..runtime.registry import prepare_compute_params, spec_for_module

__all__ = ["ParamModule", "glorot_np", "dense_np", "conv_np"]


class ParamModule(nn.Module):
    """A model whose converted parameter tree is held as buffers.

    ``params`` is the nested view that the functional API takes, rebuilt from
    the tree's own shape (which nodes are dicts and which lists), as recorded
    when the module was made; the buffers move with ``.to(device)``.  Where
    ``cfg`` has a ``compute_dtype`` other than float32 (the bf16 plan), the
    tree's float32 leaves are cast to it here, once
    (``runtime.registry.prepare_compute_params``), or as the ``prepare_params``
    hook of the spec that builds the class casts it.  ``param_view``, where set
    (``runtime.optimize.wrap_forward``: an optimized artifact's q8f32 or
    weight-only bf16 tree), maps the view at every forward, so the buffers
    keep their stored dtype on the device.  A subclass defines ``forward``."""

    _SEP = BUFFER_SEP
    param_view = None  # tree -> tree at every forward

    def __init__(self, params: dict, cfg):
        super().__init__()
        self.cfg = cfg
        spec = spec_for_module(type(self))
        self._skeleton = self._register(prepare_compute_params(params, cfg, spec), ())

    def _register(self, node, path: tuple):
        """Hold ``node``'s leaves as buffers; return ``node`` with each leaf
        replaced by its buffer's name."""
        if isinstance(node, dict):
            return {k: self._register(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [self._register(v, path + (str(i),)) for i, v in enumerate(node)]
        name = self._SEP.join(path)
        self.register_buffer(name, node)
        return name

    @property
    def params(self) -> dict:
        tree = _fill(self._skeleton, dict(self.named_buffers()))
        return tree if self.param_view is None else self.param_view(tree)


def _fill(node, buffers: dict):
    if isinstance(node, dict):
        return {k: _fill(v, buffers) for k, v in node.items()}
    if isinstance(node, list):
        return [_fill(v, buffers) for v in node]
    return buffers[node]


def glorot_np(rng: np.random.Generator, shape) -> np.ndarray:
    """``audiojax.nn.core.glorot``'s distribution: fan-in is the product of
    all but the last axis, fan-out the last."""
    fan_in, fan_out = int(np.prod(shape[:-1])), shape[-1]
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, shape).astype(np.float32)


def dense_np(rng: np.random.Generator, din: int, dout: int, bias: bool = True) -> dict:
    p = {"w": glorot_np(rng, (din, dout))}
    if bias:
        p["b"] = np.zeros((dout,), np.float32)
    return p


def conv_np(rng: np.random.Generator, kernel: tuple, cin: int, cout: int, groups: int = 1,
            bias: bool = True) -> dict:
    """A conv1d (``kernel=(k,)``, WIO) or conv2d (``kernel=(kh, kw)``, HWIO) kernel."""
    p = {"w": glorot_np(rng, (*kernel, cin // groups, cout))}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p
