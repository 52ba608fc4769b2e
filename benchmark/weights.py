"""Model weights drawn from the seed on the device, by a reference's table.

One ``torch.rand`` call on the device draws every parameter's numbers; each
row ``(path, shape, lo, hi)`` of the table takes its slice, scaled to
[lo, hi), as a tensor of its own.  Paths are ``/``-joined keys; a run of
all-digit keys under one node becomes a list, as the models' trees hold
their stacked levels.  The same seed on the same device gives the same
tensors, so the reference draws its own copy after the program's run.
"""
from __future__ import annotations

import torch


def draw(rows: list, seed: int, device) -> dict:
    total = sum(_numel(shape) for _, shape, _, _ in rows)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    offsets = [0]
    for _, shape, _, _ in rows:
        offsets.append(offsets[-1] + _numel(shape))
    return build(rows, lambda i, shape, lo, hi: (
        u[offsets[i]: offsets[i + 1]] * (hi - lo) + lo).reshape(shape))


def build(rows: list, leaf) -> dict:
    """The tree of ``leaf(i, shape, lo, hi)`` for each row ``i``."""
    tree: dict = {}
    for i, (path, shape, lo, hi) in enumerate(rows):
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf(i, shape, lo, hi)
    return _lists(tree)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
