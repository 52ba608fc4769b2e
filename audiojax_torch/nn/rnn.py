"""GRU and LSTM layers in PyTorch (torch cell semantics).

Counterpart of ``audiojax.nn.rnn``.  The input projection for all time steps
is hoisted into one matmul before the loop; the loop carries only
``h @ w_h``.  Grouped GRUs run every group in one batched matmul over
stacked ``(G, in, 3H)`` weights, and a bidirectional layer runs both
directions as two stacked recurrences of one loop, the backward one on the
time-reversed input.

Weight layout (right-multiplication, as in the JAX package):
  GRU   w_i: (in, 3H), w_h: (H, 3H), b_i / b_h: (3H,)   gate order r|z|n
  LSTM  w_i: (in, 4H), w_h: (H, 4H), b_i / b_h: (4H,)   gate order i|f|g|o
Stacked groups add a leading G axis.  A quantized ``w_i`` or ``w_h`` (the
q8 plans) is read through ``core.as_weight``, as in the JAX package.

On the card the time loop is a Python loop of small launches; that cost is
recorded in PERF.md and is left to a later CUDA graph or fused recurrence.

While ``torch.export`` traces (``ops._build.loops_as_scan``), each time loop
runs instead as torch's scan operator (:func:`time_scan`), which the graph
records as one node over a traced step, where the Python loop would unroll
into a copy of the step a frame.  Two rules hold for every scanned step:
each initial carry is a tensor of its own (a graph started from one zeros
tensor used as both h and c returned wrong answers), and no step output is
the carry object itself (the export refuses it).  Eager forwards never
enter the operator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from .core import as_weight

__all__ = ["gru_cell", "gru", "gru_bidir", "grouped_gru", "grouped_gru_bidir", "lstm",
           "lstm_bidir", "init_lstm_numpy", "time_scan"]


def time_scan(step, init, xs, *, dim: int = 0, reverse: bool = False):
    """``step(carry, x_t) -> (carry, y_t)`` over axis ``dim`` of ``xs`` (a
    tensor or a tuple of them) as ``torch._higher_order_ops.scan.scan``;
    returns ``(last carry, ys)``, the tensor ``ys`` stacked on ``dim`` in
    input order, with ``reverse`` too.  The operator scans axis 0 forwards
    here: where it stacks the ys of another ``dim``, and how it orders a
    reversed scan's, differs between torch releases (2.11 and 2.13).
    Called only while exporting: see the module note."""
    from torch._higher_order_ops.scan import scan

    def time_major(x):
        x = x.movedim(dim, 0)
        return torch.flip(x, dims=(0,)) if reverse else x

    xs = tuple(map(time_major, xs)) if isinstance(xs, tuple) else time_major(xs)
    carry, ys = scan(step, init, xs)
    return carry, (torch.flip(ys, dims=(0,)) if reverse else ys).movedim(0, dim)


def _float(p) -> dict:
    """``p`` with its weights as float tensors (a quantized one dequantized)."""
    return {**p, "w_i": as_weight(p["w_i"]), "w_h": as_weight(p["w_h"])}


def _cell(xt: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU update from the input and hidden projections (biases added)."""
    hidden = h.shape[-1]
    rz = torch.sigmoid(xt[..., : 2 * hidden] + gh[..., : 2 * hidden])
    r, z = rz[..., :hidden], rz[..., hidden:]
    n = torch.tanh(xt[..., 2 * hidden :] + r * gh[..., 2 * hidden :])
    return (1.0 - z) * n + z * h


def gru_cell(p, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step: x (..., in), h (..., H) → h' (..., H), for models that run
    their own recurrence (NKF-AEC's Kalman scan)."""
    p = _float(p)
    return _cell(torch.matmul(x, p["w_i"]) + p["b_i"], torch.matmul(h, p["w_h"]) + p["b_h"], h)


def _scan(xp: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor, h: torch.Tensor,
          reverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Recurrence over axis -2 of ``xp (..., T, 3H)``; ``h (..., H)``."""
    if _build.loops_as_scan():
        def step(h, xt):
            h = _cell(xt, torch.matmul(h, w_h) + b_h, h)
            return h, h.clone()

        h, ys = time_scan(step, h, xp, dim=xp.ndim - 2, reverse=reverse)
        return ys, h
    n_t = xp.shape[-2]
    ys = []
    for t in (range(n_t - 1, -1, -1) if reverse else range(n_t)):
        h = _cell(xp[..., t, :], torch.matmul(h, w_h) + b_h, h)
        ys.append(h)
    if reverse:
        ys.reverse()
    return torch.stack(ys, dim=-2), h


def gru(p, x: torch.Tensor, h0: torch.Tensor | None = None, *, reverse: bool = False,
        return_state: bool = False):
    """GRU over ``x (B, T, in)`` → ``(B, T, H)``."""
    p = _float(p)
    hidden = p["w_h"].shape[0]
    xp = torch.matmul(x, p["w_i"]) + p["b_i"]
    if h0 is None:
        h0 = x.new_zeros(x.shape[:-2] + (hidden,))
    ys, h_last = _scan(xp, p["w_h"], p["b_h"], h0, reverse)
    return (ys, h_last) if return_state else ys


def gru_bidir(p_fwd, p_bwd, x: torch.Tensor, *, return_state: bool = False):
    """Bidirectional GRU over ``x (B, T, in)`` → ``[fwd ‖ bwd]`` (B, T, 2H);
    with ``return_state`` also ``(fwd state after the last step, bwd state
    after the first)``.  Both directions share one loop: the backward one
    runs on the time-reversed input as the second of two stacked recurrences."""
    p_fwd, p_bwd = _float(p_fwd), _float(p_bwd)
    both = {k: torch.stack([p_fwd[k], p_bwd[k]]) for k in ("w_i", "w_h", "b_i", "b_h")}
    y, _ = _stacked_scan(both, torch.stack([x, torch.flip(x, dims=(1,))]), None)
    yf, yb = y[0], torch.flip(y[1], dims=(1,))
    out = torch.cat([yf, yb], dim=-1)
    return (out, (yf[:, -1], yb[:, 0])) if return_state else out


def _group_split(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, groups, c // groups).permute(2, 0, 1, 3)  # (G, B, T, C/G)


def _group_merge(y: torch.Tensor) -> torch.Tensor:
    g, b, t, h = y.shape
    return y.permute(1, 2, 0, 3).reshape(b, t, g * h)


def _stacked_scan(p, xs: torch.Tensor, h0: torch.Tensor | None, reverse=False):
    """One batched recurrence for stacked params over ``xs (G, B, T, in)``."""
    p = _float(p)
    g, b = xs.shape[:2]
    hidden = p["w_h"].shape[-2]
    xp = torch.matmul(xs, p["w_i"][:, None]) + p["b_i"][:, None, None]
    if h0 is None:
        h0 = xs.new_zeros((g, b, hidden))
    return _scan(xp, p["w_h"], p["b_h"][:, None], h0, reverse)


def grouped_gru(p, x: torch.Tensor, *, groups: int, h0: torch.Tensor | None = None,
                return_state: bool = False):
    """Independent per-group GRUs over ``x (B, T, C)``; params stacked on G.

    ``h0`` (G, B, H) threads state through the groups.
    """
    y, h_last = _stacked_scan(p, _group_split(x, groups), h0)
    out = _group_merge(y)
    return (out, h_last) if return_state else out


def grouped_gru_bidir(p_fwd, p_bwd, x: torch.Tensor, *, groups: int) -> torch.Tensor:
    """Grouped bidirectional GRU.

    Per-group output is [fwd_g ‖ bwd_g]; groups concatenate after.  The
    backward direction runs on the time-reversed input, so both directions
    of every group share one loop of 2G stacked recurrences.
    """
    xs = _group_split(x, groups)
    p_fwd, p_bwd = _float(p_fwd), _float(p_bwd)
    both = {k: torch.cat([p_fwd[k], p_bwd[k]]) for k in ("w_i", "w_h", "b_i", "b_h")}
    y, _ = _stacked_scan(both, torch.cat([xs, torch.flip(xs, dims=(2,))]), None)
    yf, yb = y[:groups], torch.flip(y[groups:], dims=(2,))
    return _group_merge(torch.cat([yf, yb], dim=-1))


# ── LSTM ─────────────────────────────────────────────────────────────────────


def _lstm_loop(xp: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor):
    """Recurrence over axis 0 of the time-major ``xp (T, ..., 4H)``;
    ``w_h (..., H, 4H)``, ``b_h`` broadcast against ``h @ w_h``, ``h`` / ``c``
    ``(..., N, H)``.

    A step is eight launches: the hidden product with its bias (one
    ``addmm`` / ``baddbmm``), its sum with the step's input projection, the
    gates, and the cell and hidden updates, in the JAX package's order of
    operations."""
    ys = []
    for xt in xp:
        h, c = _lstm_step(xt, w_h, b_h, h, c)
        ys.append(h)
    return ys, h, c


def _lstm_step(xt, w_h, b_h, h, c):
    hidden = h.shape[-1]
    gh = torch.baddbmm(b_h, h, w_h) if w_h.ndim == 3 else torch.addmm(b_h, h, w_h)
    z = xt + gh
    s = torch.sigmoid(z)  # the g lanes are taken from tanh below
    c = torch.addcmul(s[..., hidden:2 * hidden] * c, s[..., :hidden],
                      torch.tanh(z[..., 2 * hidden:3 * hidden]))
    return s[..., 3 * hidden:] * torch.tanh(c), c


def _lstm_scan(xp, w_h, b_h, h, c, reverse=False):
    """:func:`_lstm_loop` as the scan operator: ``(ys (T, ..., N, H), h, c)``,
    the ys in input order."""
    def step(carry, xt):
        h, c = _lstm_step(xt, w_h, b_h, *carry)
        return (h, c), h.clone()

    (h, c), ys = time_scan(step, (h, c), xp, reverse=reverse)
    return ys, h, c


def lstm(p, x: torch.Tensor, state=None, *, reverse: bool = False, return_state: bool = False):
    """LSTM over ``x (B, T, in)`` → ``(B, T, H)``; ``state`` is ``(h, c)``, each
    (B, H); with ``return_state`` also ``(h, c)`` after the last step."""
    p = _float(p)
    hidden = p["w_h"].shape[0]
    # time-major, so that each step's slice is contiguous
    xp = torch.matmul(x.transpose(0, 1), p["w_i"]) + p["b_i"]
    if _build.loops_as_scan():
        if state is None:  # two tensors: a scan started from one aliased pair goes wrong
            state = (x.new_zeros((x.shape[0], hidden)), x.new_zeros((x.shape[0], hidden)))
        y, h, c = _lstm_scan(xp, p["w_h"], p["b_h"], *state, reverse=reverse)
        y = y.transpose(0, 1)
        return (y, (h, c)) if return_state else y
    if state is None:
        z = x.new_zeros((x.shape[0], hidden))
        state = (z, z)
    ys, h, c = _lstm_loop(torch.flip(xp, dims=(0,)) if reverse else xp, p["w_h"], p["b_h"],
                          *state)
    if reverse:
        ys.reverse()
    y = torch.stack(ys, dim=1)
    return (y, (h, c)) if return_state else y


def lstm_bidir(p_fwd, p_bwd, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM over ``x (B, T, in)`` → ``[fwd ‖ bwd]`` (B, T, 2H).

    Both directions share one loop: the backward one runs on the
    time-reversed input as the second of two stacked recurrences."""
    p_fwd, p_bwd = _float(p_fwd), _float(p_bwd)
    hidden = p_fwd["w_h"].shape[0]
    both = {k: torch.stack([p_fwd[k], p_bwd[k]]) for k in ("w_i", "w_h", "b_i", "b_h")}
    xt = x.transpose(0, 1)  # (T, B, in)
    xs = torch.stack([xt, torch.flip(xt, dims=(0,))], dim=1)  # (T, 2, B, in)
    xp = torch.matmul(xs, both["w_i"]) + both["b_i"][:, None]  # (T, 2, B, 4H)
    z = x.new_zeros((2, x.shape[0], hidden))
    if _build.loops_as_scan():
        y, _, _ = _lstm_scan(xp, both["w_h"], both["b_h"][:, None], z, torch.zeros_like(z))
    else:
        ys, _, _ = _lstm_loop(xp, both["w_h"], both["b_h"][:, None], z, z)
        y = torch.stack(ys)  # (T, 2, B, H)
    return torch.cat([y[:, 0], torch.flip(y[:, 1], dims=(0,))], dim=-1).transpose(0, 1)


def init_lstm_numpy(rng: np.random.Generator, din: int, hidden: int) -> dict:
    """``audiojax.nn.rnn.init_lstm``'s keys, shapes and distribution (uniform in
    ±1/sqrt(hidden)), drawn from ``rng``."""
    s = 1.0 / np.sqrt(hidden)

    def u(shape):
        return rng.uniform(-s, s, shape).astype(np.float32)

    return {"w_i": u((din, 4 * hidden)), "w_h": u((hidden, 4 * hidden)),
            "b_i": u((4 * hidden,)), "b_h": u((4 * hidden,))}
