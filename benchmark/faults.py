"""Faults planted under the timed path, to show that the output check fails
them.  Each takes the benchmark's ``Program`` and wraps its model's forward.

- ``half_batch``: the model serves only the first half of the windows of a
  call (of the fold rows' samples where a call has one window) and the rest
  comes back silent;
- ``altered``: the first window of each call comes back scaled by 0.9, an
  answer altered where it is produced.

A cell of one card exchanges nothing between cards, and serving keeps no
state from step to step, so no fault of those kinds is planted.
"""
from __future__ import annotations

import torch


def _wrap(program, change) -> None:
    forward = program.module.forward

    def broken(*audio):
        out = forward(*audio)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        outs = tuple(change(o) for o in outs)
        return outs if isinstance(out, (tuple, list)) else outs[0]

    program.module.forward = broken


def half_batch(program) -> None:
    def change(o):
        o = o.clone()
        b = o.shape[0]
        if b > 1:
            o[(b + 1) // 2:] = 0
        else:
            o[..., o.shape[-1] // 2:] = 0
        return o

    _wrap(program, change)


def altered(program) -> None:
    def change(o):
        o = o.clone()
        o[0] = (o[0].to(torch.float32) * 0.9).to(o.dtype)
        return o

    _wrap(program, change)


FAULTS = {"half_batch": half_batch, "altered": altered}
