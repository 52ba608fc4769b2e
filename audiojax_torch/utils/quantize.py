"""Weight-only int8 quantization: the q8f32 and q8dyn plans' parameter trees.

Counterpart of ``audiojax.utils.quantize``.  ``quantize_tree`` works on the
tree an artifact's ``params.pt`` stores, in the JAX package's layout (numpy
float32 leaves, as ``runtime.checkpoint.load_tree`` gives them), with the
JAX package's numpy code, so its int8 values and scales equal the JAX
package's bit for bit; ``params_from_numpy`` then moves each quantized
weight into the port's layout.  ``dequantize_tree`` works on the port's
tensors, on any device.

    qtree = quantize_tree(load_tree(art))     # {'q8': int8, 'scale': f32} nodes
    params = dequantize_tree(params_from_numpy(qtree, device))
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_tree", "dequantize_tree", "quantized_bytes", "is_quant_leaf"]

_MIN_SIZE = 4096  # tiny leaves (biases, norms, slopes) stay float
_QUANT_KEYS = ("w", "w_i", "w_h")  # dense and conv weights, the RNNs' input and hidden weights


def is_quant_leaf(x) -> bool:
    """True for a ``{'q8', 'scale'}`` node."""
    return isinstance(x, dict) and set(x) == {"q8", "scale"}


def _map(tree, fn, key=None):
    """``fn(key, leaf)`` over a nested dict/list tree, ``key`` the leaf's own
    dict key (None for a list item); a q8 node is one leaf."""
    if isinstance(tree, dict) and not is_quant_leaf(tree):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(key, tree)


def quantize_tree(params, min_size: int = _MIN_SIZE):
    """float32 weight leaves (at least ``min_size`` elements and 2 dims, under
    a key in ``_QUANT_KEYS``) → ``{'q8', 'scale'}`` nodes: symmetric scales
    reduced over the contraction axis ``ndim − 2`` of the JAX layout (leading
    axes kept: stacked and grouped weights get per-group scales), values
    rounded half to even and clipped to ±127.  Other leaves pass through,
    and so does a leaf that is a list item (its path ends in an index, no
    key, as in the JAX package's walk)."""

    def q(key, leaf):
        if key not in _QUANT_KEYS or not isinstance(leaf, np.ndarray):
            return leaf
        if leaf.ndim < 2 or leaf.size < min_size or leaf.dtype != np.float32:
            return leaf
        amax = np.abs(leaf).max(axis=leaf.ndim - 2, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q8 = np.clip(np.round(leaf / scale), -127, 127).astype(np.int8)
        return {"q8": q8, "scale": scale}

    return _map(params, q)


def dequantize_tree(params):
    """Inverse of :func:`quantize_tree` on the port's tensors: every q8 node
    becomes ``q8 · scale`` in the scale's dtype, where the node lies."""
    return _map(params, lambda _, leaf: (leaf["q8"].to(leaf["scale"].dtype) * leaf["scale"]
                                         if is_quant_leaf(leaf) else leaf))


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def quantized_bytes(params) -> tuple[int, int]:
    """(bytes of the quantized tree, bytes of the float tree), as the JAX
    package counts them: 4 a float element, 1 an int8 one."""
    qb = fb = 0

    def add(_, leaf):
        nonlocal qb, fb
        if is_quant_leaf(leaf):
            qb += _numel(leaf["q8"]) + 4 * _numel(leaf["scale"])
            fb += 4 * _numel(leaf["q8"])
        else:
            qb += 4 * _numel(leaf)
            fb += 4 * _numel(leaf)
        return leaf

    _map(params, add)
    return qb, fb
