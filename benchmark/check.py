"""Is what the timed path returned correct?  And the reference's own work.

The requests checked are drawn from the seed among those completed in the
window (``generator.check_sample``).  For each, the reference serves the
same clip through the plain copy of the session's windowing, on weights it
draws again from the seed, and each output source is compared with the
program's:

    rel_err = ‖program − reference‖₂ / ‖reference‖₂   (int16 samples)

The number compared is the worst over the checked requests and sources,
``worst_rel_err``, against the configuration's limit.  A request that
raised, returned another number of sources or another length, or a NaN,
fails the run.

The reference computes in float32 with TF32 off whatever the program has
set: :func:`precision` sets torch's switches for its run and puts them
back after.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import weights
from .reference import common
from .reference import session as ref_session


def rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    diff = np.linalg.norm(out.astype(np.float64) - ref.astype(np.float64))
    norm = np.linalg.norm(ref.astype(np.float64))
    return float(diff / norm) if norm > 0 else (0.0 if diff == 0 else float("inf"))


REFERENCE_BLOCK = 4  # windows a reference forward; the outputs do not depend on it


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products and convolutions in full precision (``tf32`` False)
    or in TF32, inside; torch's switches as they were, after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, torch.get_float32_matmul_precision())
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def reference_outputs(cell, seed: int, clips: list, device, tf32: bool = False) -> list:
    """The reference's outputs for ``clips``, on weights drawn from ``seed``,
    in float32 with TF32 off (on, for the control that ``tf32`` asks for)."""
    params = weights.draw(cell.reference.param_table(cell.config["model"]), seed, device)
    with precision(tf32):
        return [ref_session.serve(cell.reference.forward, params, c, cell.config["model"],
                                  cell.config["serving"], device, REFERENCE_BLOCK)
                for c in clips]


def compare(outputs: list, refs: list, sources: int) -> float:
    """Worst rel_err over requests and sources; inf for a malformed output."""
    worst = 0.0
    for out, ref in zip(outputs, refs):
        if out is None or len(out) != sources:
            return float("inf")
        for o, r in zip(out, ref):
            if o.shape != r.shape or o.dtype != np.int16:
                return float("inf")
            worst = max(worst, rel_err(o, r))
    return worst


def meta_params(rows: list):
    return weights.build(rows, lambda i, shape, lo, hi: torch.empty(shape, device="meta"))


def work_at(cell, windows: int) -> tuple[list, float]:
    """The reference's kernel-shaped calls ``(kind, operations, bytes)``, and
    its FLOPs, for one forward of ``windows`` windows (shapes only: run on
    the meta device)."""
    cfg, serving = cell.config["model"], cell.config["serving"]
    params = meta_params(cell.reference.param_table(cfg))
    shape = (windows, serving["window"]) if serving["channels"] == 1 else \
        (windows, serving["channels"], serving["window"])
    audio = [torch.empty(shape, dtype=torch.int16, device="meta")
             for _ in range(serving["inputs"])]
    with common.record_calls() as calls, FlopCounterMode(display=False) as flops:
        cell.reference.forward(params, *audio, cfg)
    return list(calls), float(flops.get_total_flops())
