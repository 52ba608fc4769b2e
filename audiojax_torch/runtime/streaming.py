"""Low-latency streaming serving: state-carry chunks instead of windows.

Counterpart of ``audiojax.runtime.streaming``.  ``Session`` serves a model
stateless per window; for a model whose spec has a ``make_stream`` hook
(GTCRN, DFSMN, UL-UNAS and the echo cancellers NKF-AEC, SDAEC, Deep-Echo
and DFSMN-AEC) ``StreamingSession`` and
``StreamingServer`` carry the model's temporal state from chunk to chunk
instead, so the latency falls from a window to one block plus the synthesis
delay (n_fft − hop; 2·hop for the DFSMN-AEC cascade).

``push`` takes int16 chunks of any length (one per model input: an echo
canceller takes (near, far)); the lane buffers them into fixed blocks of
``block_hops`` hops, every tick steps all lanes at the one ``(max_streams,
block)`` shape and keeps the new state of the lanes that had a block, and
``flush`` drains the residual and the synthesis delay, so that the total
output length equals the total input length, aligned with the input.

``jit=True`` (the default, as in the JAX package, where it compiles one
executable for the step) captures the masked step once per server as one
CUDA graph and replays it every tick.  The state lives in static device
buffers that the step writes back into inside the graph; the input blocks
and the active mask are copied into static buffers before each replay, and
the graph's own output buffer is copied to the host after it.  On the CPU
``jit=True`` raises: pass ``jit=False`` there, which steps eagerly (on the
card too, so the two can be compared).

Launch counting on the graphed path: the kernel wrappers count a launch when
they record it, so a capture adds the step's launches to the counters once
and a replay adds nothing.  The server keeps ``captured_launches`` (the
counts its capture recorded) and ``replays``; the kernel launches of a
graphed run are ``captured_launches`` × ``replays``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .checkpoint import _map

__all__ = ["StreamingSession", "StreamingServer"]

WARMUP_STEPS = 3  # eager steps on a side stream before the capture


def _flatten(tree) -> list:
    """The leaves of a nested dict/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s tree shape filled from the iterator ``leaves`` (``_flatten``'s order)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def _launch_counts() -> dict:
    from ..ops import attention_cuda, dwconv_cuda, stft_cuda

    return {k: n for mod in (stft_cuda, dwconv_cuda, attention_cuda)
            for k, n in mod.launches.items()}


class StreamingSession:
    """Chunked serving of one stream: a single-lane :class:`StreamingServer`."""

    def __init__(self, spec, params, cfg=None, *, block_hops: int = 4, jit: bool = True,
                 device=None):
        self._srv = StreamingServer(spec, params, cfg, max_streams=1, block_hops=block_hops,
                                    jit=jit, device=device)
        self._sid = self._srv.open()
        self.cfg = self._srv.cfg
        self.params = self._srv.params
        self.device = self._srv.device
        self.hop = self._srv.hop
        self.block = self._srv.block
        self.delay = self._srv.delay
        self.n_inputs = self._srv.n_inputs

    @property
    def latency_samples(self) -> int:
        """Worst-case algorithmic latency: block buffering + synthesis delay."""
        return self._srv.latency_samples

    def push(self, *chunks: np.ndarray) -> np.ndarray:
        """Feed int16 samples (one equally long chunk per model input, any
        length ≥ 0); returns whatever enhanced samples are ready."""
        return self._srv.push(self._sid, *chunks)

    def flush(self) -> np.ndarray:
        """Drain the residual buffer and the synthesis delay with zero
        padding; afterwards total output length == total input length."""
        return self._srv.flush(self._sid)


class _Lane:
    """Per-stream bookkeeping inside a StreamingServer batch lane."""

    __slots__ = ("residuals", "pushed", "raw_out", "aligned_out", "flushed")

    def __init__(self, n_inputs: int):
        self.residuals = [np.zeros(0, np.int16) for _ in range(n_inputs)]
        self.pushed = 0
        self.raw_out = 0
        self.aligned_out = 0
        self.flushed = False


class StreamingServer:
    """Serve up to ``max_streams`` concurrent independent streams of one model
    with one step shape: the lanes' states stack on the batch axis, every
    tick advances the whole batch, and a per-lane active mask keeps either
    the stepped or the previous state.

    API: ``sid = open()`` → ``push(sid, chunk[, far_chunk]) -> ready samples``
    (or ``push_many``) → ``flush(sid)`` → ``close(sid)`` (the lane is reset
    when it is opened again).  ``device`` defaults to the card.
    """

    def __init__(self, spec, params, cfg=None, *, max_streams: int = 8, block_hops: int = 4,
                 jit: bool = True, device=None):
        if spec.make_stream is None:
            raise ValueError(f"model {spec.name!r} does not support streaming serving")
        self.device = resolve_device(device)
        if jit and self.device.type != "cuda":
            raise ValueError("jit=True captures the step as a CUDA graph, which needs the "
                             "card; pass jit=False to step eagerly on the CPU")
        self.cfg = cfg if cfg is not None else spec.make_config()
        init_fn, step_fn, self.delay = spec.make_stream(self.cfg)
        self.params = _map(params, lambda t: t.to(self.device))
        self.hop = self.cfg.hop
        self.block = block_hops * self.hop
        self.max_streams = k = max_streams
        self.n_inputs = spec.make_manifest(self.cfg).num_audio_inputs
        self._init_fn = init_fn
        self._raw_step = step_fn
        self._lanes: list[_Lane | None] = [None] * max_streams

        # The state buffers: every step writes the kept state back into them.
        self._skeleton = init_fn(k, self.device)
        self._state = [t.contiguous() for t in _flatten(self._skeleton)]
        # Each leaf's lane axis, from the batch-1 and batch-K shapes.  Some
        # models fold the batch into an inner axis (GTCRN's inter-GRU states
        # (G, B·width, H)); folds are batch-major, so viewing that axis as
        # (K, sub) recovers the lane.
        self._fresh1 = _flatten(init_fn(1, self.device))
        self._bmeta = []
        for l1, lk in zip(self._fresh1, self._state):
            for j in range(lk.ndim):
                if (lk.shape[j] == k * l1.shape[j] and lk.shape[:j] == l1.shape[:j]
                        and lk.shape[j + 1:] == l1.shape[j + 1:]):
                    self._bmeta.append((j, l1.shape[j]))
                    break
            else:
                raise ValueError(
                    f"cannot locate the stream-batch axis of a state leaf: batch-1 shape "
                    f"{tuple(l1.shape)} vs batch-{k} shape {tuple(lk.shape)}")

        self.captured_launches: dict[str, int] = {}
        self.replays = 0
        self._graph = None
        if jit:
            self._capture()

    @property
    def latency_samples(self) -> int:
        return self.block + self.delay

    def _lane_shape(self, shape, axis: int, sub: int) -> tuple:
        return tuple(shape[:axis]) + (self.max_streams, sub) + tuple(shape[axis + 1:])

    def _masked_step(self, active: torch.Tensor, *blocks: torch.Tensor) -> torch.Tensor:
        """Step every lane; the lanes in ``active`` write their new state into
        the state buffers, the others keep theirs and output zeros."""
        state = _unflatten(self._skeleton, iter(self._state))
        new_state, out = self._raw_step(self.params, state, *blocks)
        kept = []
        for n, o, (axis, sub) in zip(_flatten(new_state), self._state, self._bmeta):
            if n.shape != o.shape:
                raise ValueError(f"the step changed a state leaf's shape: {tuple(o.shape)} → "
                                 f"{tuple(n.shape)}")
            shape = self._lane_shape(o.shape, axis, sub)
            mask = active.reshape((1,) * axis + (-1,) + (1,) * (len(shape) - axis - 1))
            kept.append(torch.where(mask, n.reshape(shape), o.view(shape)))
        for o, v in zip(self._state, kept):  # after every read of the old state
            o.copy_(v.reshape(o.shape))
        return torch.where(active.reshape((-1,) + (1,) * (out.ndim - 1)), out,
                           torch.zeros_like(out))

    def _capture(self) -> None:
        """One CUDA graph of the masked step at (max_streams, block), after
        eager warm-up steps on a side stream (every lane inactive, so the
        state is kept); a capture that fails raises."""
        k = self.max_streams
        self._active = torch.zeros(k, dtype=torch.bool, device=self.device)
        self._blocks = [torch.zeros((k, self.block), dtype=torch.int16, device=self.device)
                        for _ in range(self.n_inputs)]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._masked_step(self._active, *self._blocks)
            current.wait_stream(side)
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._out = self._masked_step(self._active, *self._blocks)
        self.captured_launches = {n: c - before[n] for n, c in _launch_counts().items()}
        self._graph = graph

    def verify_lane_isolation(self, seed: int = 0, rtol: float = 1e-4) -> None:
        """Prove the inferred per-leaf lane axes right for this model.

        The inference assumes every state fold is batch-major.  A model that
        folds batch-minor passes the shape comparison yet interleaves lanes.
        This steps all lanes together on distinct random blocks from a fresh
        state and requires each lane's slice of the batched new state to
        match an independent batch-1 step on the same input (to ``rtol`` of
        the leaf's scale: batch-K and batch-1 runs differ by rounding)."""
        k = self.max_streams
        rng = np.random.default_rng(seed)
        blocks = [torch.from_numpy(rng.integers(-8000, 8000, (k, self.block)).astype(np.int16))
                  .to(self.device) for _ in range(self.n_inputs)]
        with torch.no_grad():
            state_k, _ = self._raw_step(self.params, self._init_fn(k, self.device), *blocks)
            leaves_k = _flatten(state_k)
            for j in range(k):
                s1, _ = self._raw_step(self.params, self._init_fn(1, self.device),
                                       *[b[j:j + 1] for b in blocks])
                for li, (lk, l1, (axis, sub)) in enumerate(zip(leaves_k, _flatten(s1),
                                                              self._bmeta)):
                    got = lk.reshape(self._lane_shape(lk.shape, axis, sub)).select(axis, j)
                    got = got.double().cpu().numpy()
                    want = l1.double().cpu().numpy()
                    tol = rtol * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
                    if got.shape != want.shape or not np.allclose(got, want, atol=tol):
                        raise AssertionError(
                            f"lane-isolation check failed: state leaf {li} lane {j} (axis "
                            f"{axis}, sub {sub}) diverges from an independent batch-1 step: "
                            f"the state fold is not batch-major")

    def open(self) -> int:
        """Allocate a stream lane (fresh state) → stream id."""
        for i, lane in enumerate(self._lanes):
            if lane is None:
                self._reset_lane(i)
                self._lanes[i] = _Lane(self.n_inputs)
                return i
        raise RuntimeError(f"all {self.max_streams} stream lanes are busy")

    def close(self, sid: int) -> None:
        self._lanes[sid] = None

    def push(self, sid: int, *chunks: np.ndarray) -> np.ndarray:
        """Feed int16 samples for stream ``sid``; returns ready samples.

        Each full block runs one batch step with only this lane active; with
        several live streams, :meth:`push_many` advances all ready lanes in
        one step."""
        lane = self._buffer(sid, chunks)
        outs = []
        while lane.residuals[0].shape[0] >= self.block:
            outs.append(self._tick({sid: [r[: self.block] for r in lane.residuals]})[sid])
            lane.residuals = [r[self.block:] for r in lane.residuals]
        if not outs:
            return np.zeros(0, np.int16)
        return self._align(lane, np.concatenate(outs))

    def push_many(self, chunks_by_sid: dict) -> dict:
        """Feed several streams at once; all lanes with a full block advance
        together, one batched step per block round.

        ``chunks_by_sid``: {sid: chunk} for one-input models or
        {sid: (chunk, far_chunk)} for two.  Returns {sid: ready samples} for
        every lane that produced output in this call."""
        normalized = {sid: (chunks if isinstance(chunks, (tuple, list)) else (chunks,))
                      for sid, chunks in chunks_by_sid.items()}
        # validate everything before buffering anything: a failure half way
        # must not leave earlier lanes buffered for the caller's retry
        for sid, chunks in normalized.items():
            lane = self._require(sid)
            if lane.flushed:
                raise ValueError(f"stream {sid} was flushed; close() it first")
            if len(chunks) != self.n_inputs:
                raise ValueError(f"push expects {self.n_inputs} chunk(s), got {len(chunks)}")
        for sid, chunks in normalized.items():
            self._buffer(sid, chunks)
        pending: dict[int, list] = {}
        while True:
            ready = {sid: lane for sid, lane in enumerate(self._lanes)
                     if lane is not None and lane.residuals[0].shape[0] >= self.block}
            if not ready:
                break
            res = self._tick({sid: [r[: self.block] for r in lane.residuals]
                              for sid, lane in ready.items()})
            for sid, lane in ready.items():
                lane.residuals = [r[self.block:] for r in lane.residuals]
                pending.setdefault(sid, []).append(res[sid])
        return {sid: self._align(self._lanes[sid], np.concatenate(parts))
                for sid, parts in pending.items()}

    def _buffer(self, sid: int, chunks) -> _Lane:
        lane = self._require(sid)
        if lane.flushed:
            raise ValueError(
                f"stream {sid} was flushed: its state consumed the zero padding and "
                f"further pushes would be time-misaligned; close() the lane and open() "
                f"a fresh stream")
        if len(chunks) != self.n_inputs:
            raise ValueError(f"push expects {self.n_inputs} chunk(s), got {len(chunks)}")
        arrs = [np.asarray(c, np.int16).reshape(-1) for c in chunks]
        if len({a.shape[0] for a in arrs}) != 1:
            raise ValueError("all input chunks must have equal length")
        lane.pushed += arrs[0].shape[0]
        lane.residuals = [np.concatenate([r, a]) for r, a in zip(lane.residuals, arrs)]
        return lane

    def flush(self, sid: int) -> np.ndarray:
        """Drain stream ``sid`` (zero padding); total out length == total in."""
        lane = self._require(sid)
        owed = lane.pushed - lane.aligned_out
        outs = []
        while lane.raw_out < lane.pushed + self.delay:
            blocks = []
            for i, r in enumerate(lane.residuals):
                block = np.zeros(self.block, np.int16)
                take = min(r.shape[0], self.block)
                if take:
                    block[:take] = r[:take]
                    lane.residuals[i] = r[take:]
                blocks.append(block)
            outs.append(self._tick({sid: blocks})[sid])
        out = self._align(lane, np.concatenate(outs)) if outs else np.zeros(0, np.int16)
        lane.aligned_out = lane.pushed
        # the zero padding is in the lane's state now: a later push would
        # emit time-shifted audio, so the lane must be closed
        lane.flushed = True
        return out[:owed]

    # ── internals ────────────────────────────────────────────────────────

    def _require(self, sid: int) -> _Lane:
        lane = self._lanes[sid]
        if lane is None:
            raise KeyError(f"stream {sid} is not open")
        return lane

    def _reset_lane(self, i: int) -> None:
        """Write a fresh batch-1 state into lane ``i`` of the state buffers."""
        with torch.no_grad():
            for s, f, (axis, sub) in zip(self._state, self._fresh1, self._bmeta):
                lane = s.view(self._lane_shape(s.shape, axis, sub)).select(axis, i)
                lane.copy_(f.reshape(lane.shape))

    def _tick(self, ready: dict[int, list[np.ndarray]]) -> dict[int, np.ndarray]:
        """Advance the whole batch one block; only ``ready`` lanes keep state."""
        k = self.max_streams
        active = np.zeros(k, bool)
        batches = [np.zeros((k, self.block), np.int16) for _ in range(self.n_inputs)]
        for sid, blocks in ready.items():
            active[sid] = True
            for j, b in enumerate(blocks):
                batches[j][sid] = b
        with torch.no_grad():
            if self._graph is None:
                out = self._masked_step(torch.from_numpy(active).to(self.device),
                                        *[torch.from_numpy(b).to(self.device) for b in batches])
            else:
                self._active.copy_(torch.from_numpy(active))
                for static, b in zip(self._blocks, batches):
                    static.copy_(torch.from_numpy(b))
                self._graph.replay()
                self.replays += 1
                out = self._out
            out = out.cpu().numpy()
        result = {}
        for sid in ready:
            self._lanes[sid].raw_out += self.block
            result[sid] = out[sid]
        return result

    def _align(self, lane: _Lane, out: np.ndarray) -> np.ndarray:
        already = lane.raw_out - out.shape[0]
        drop = max(0, min(self.delay - already, out.shape[0]))
        out = out[drop:]
        lane.aligned_out += out.shape[0]
        return out
