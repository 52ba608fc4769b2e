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

Two plans' leaves are carried too:
  * a ``{'q8', 'scale'}`` node (the q8f32 and q8dyn plans,
    ``utils/quantize.py``) stands where its float weight stands, int8 values
    and float32 scales; both take the weight's layout change (a conv1d scale
    ``(k, 1, out)`` becomes ``(out, 1, k)``, a conv2d one
    ``(kh, kw, 1, out)`` becomes ``(out, 1, kh, kw)``; ``me_hidden``'s stay
    ``(bands, 1, out)``).
  * a bfloat16 leaf (the weight-only bf16 plan) comes as a torch tensor,
    since numpy has no bfloat16 without ``ml_dtypes``, and takes its key's
    layout change like a float32 one.  A float32 torch tensor is taken too.

A ``w`` of any other rank has no port layout and is refused, and so is a
leaf of any other dtype (an object array among them).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "STACKED_DENSE", "BUFFER_SEP"]

# joins a leaf's path (keys, list indices) into its buffer name in a module
# (``models.base.ParamModule``, ``runtime.aot.CompiledGraph``)
BUFFER_SEP = "__"

# top-level keys whose 3-D ``w`` leaves are stacked dense weights (bands, in, out)
STACKED_DENSE = ("me_hidden",)
# a leaf's dtypes by what it is: a float leaf, and a q8 node's two parts
_FLOAT = (torch.float32, torch.bfloat16)
_Q8 = {"q8": (torch.int8,), "scale": (torch.float32,)}


def _layout(path: str, key: str, ndim: int) -> tuple | None:
    """The permutation from the JAX package's layout to the port's, or None."""
    if key != "w":
        return None
    if ndim == 4:
        return (3, 2, 0, 1)
    if ndim == 3 and path.split("/")[0] not in STACKED_DENSE:
        return (2, 1, 0)
    if ndim not in (2, 3):
        raise ValueError(f"no port layout for a {ndim}-D weight at {path!r}")
    return None


def _leaf(path: str, key: str, a, device: torch.device, dtypes=_FLOAT) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu")
    else:
        a = np.asarray(a)
        if a.dtype not in (np.float32, np.int8):
            raise TypeError(f"parameter {path!r} is {a.dtype}; the port takes float32 trees "
                            "(dicts and lists of float32 arrays), q8 nodes and bf16 tensors")
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    if t.dtype not in dtypes:
        raise TypeError(f"parameter {path!r} is {t.dtype}; expected one of {dtypes}")
    perm = _layout(path, key, t.dim())
    if perm is not None:
        t = t.permute(perm)
    return t.contiguous().to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """Convert a nested dict (and list) tree of numpy arrays to the port's
    tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(node, path: str, key: str):
        if isinstance(node, dict) and set(node) == {"q8", "scale"}:  # a quantized weight
            return {part: _leaf(f"{path}/{part}", key, node[part], dev, _Q8[part])
                    for part in ("q8", "scale")}
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}" if path else k, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}/{i}", key) for i, v in enumerate(node)]
        return _leaf(path, key, node, dev)

    return conv(tree, "", "")
