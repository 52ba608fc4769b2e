"""Parameter conversion: the JAX package's parameter tree → the port's tensors.

The input is a nested dict of numpy arrays, as ``jax.tree.map(np.asarray,
params)`` gives it; lists (MossFormer2-SS's ``mem_stack``, a list of dicts)
stay lists in the same order, and their items are converted as leaves of the
list's key; tuples (NKF-AEC's nested stream state) become lists, and 0-d
leaves (scalar gains and PReLU slopes) stay 0-d.  The output has the same
keys.  Every layout change happens here, once:

  * a 4-D ``w`` is a conv2d kernel stored HWIO ``(kh, kw, in/groups, out)``
    and becomes torch's ``(out, in/groups, kh, kw)``.
  * a 3-D ``w`` is a conv1d kernel stored WIO ``(k, in/groups, out)`` and
    becomes torch's ``(out, in/groups, k)``.
  * Transposed convs (1-D and 2-D) are stored by the JAX package as their
    equivalent forward kernel, and the port runs them as forward convs on
    the stride-dilated input, so they convert the same way.
  * a ``w`` under a top-level key in ``STACKED_DENSE`` is a stack of per-band
    dense weights ``(bands, in, out)`` (Mel-Band Roformer's ``me_hidden``),
    not a conv kernel, and keeps its layout.
  * every other leaf (dense ``(in, out)``, GRU ``(…, in, 3H)``, biases,
    PReLU slopes, LayerNorm gains) keeps its layout.

A ``w`` of any other rank has no port layout and is refused, and so is a
leaf that is not float32 (an object array among them).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "STACKED_DENSE"]

# top-level keys whose 3-D ``w`` leaves are stacked dense weights (bands, in, out)
STACKED_DENSE = ("me_hidden",)


def _leaf(path: str, key: str, a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"parameter {path!r} is {a.dtype}; the port takes float32 trees "
                        "(dicts and lists of float32 arrays)")
    if key == "w" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    elif key == "w" and a.ndim == 3 and path.split("/")[0] not in STACKED_DENSE:
        a = np.transpose(a, (2, 1, 0))
    elif key == "w" and a.ndim not in (2, 3):
        raise ValueError(f"no port layout for a {a.ndim}-D weight {a.shape} at {path!r}")
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a writable copy


def params_from_numpy(tree: dict, device=None) -> dict:
    """Convert a nested dict (and list) tree of numpy arrays to the port's
    tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(node, path: str, key: str):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}" if path else k, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}/{i}", key) for i, v in enumerate(node)]
        return _leaf(path, key, node, dev)

    return conv(tree, "", "")
