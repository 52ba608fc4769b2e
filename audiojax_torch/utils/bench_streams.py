"""Multi-stream serving capacity: the device time of one StreamingServer tick.

Counterpart of ``audiojax.utils.bench_streams``.

    python -m audiojax_torch.utils.bench_streams [--model gtcrn] [--lanes 8,64,256] \
        [--block-hops 4] [--iters 30] [--device cpu]

On the card: one tick of the server's captured CUDA graph of the masked step
(``runtime/streaming.py``, ``StreamingServer._capture``), every lane active,
the input blocks already in the graph's device buffers and the state chained
from tick to tick; ``iters`` replays timed by CUDA events after 12 settling
ones.  It reports how many real-time streams one card sustains: lanes ×
block seconds / tick seconds.  The host's per-tick copies are left out, as
in the JAX package.  On the CPU (``--device cpu``) the step runs eagerly and
the host clock times it.  One JSON line a lane count, with the JAX package's
keys.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def bench_streams(model: str = "gtcrn", lanes: int = 64, block_hops: int = 4,
                  iters: int = 30, device=None) -> dict:
    import torch

    from ..device import resolve_device
    from ..runtime import registry
    from ..runtime.streaming import StreamingServer

    dev = resolve_device(device)
    spec = registry.get(model)
    cfg = spec.make_config()
    srv = StreamingServer(spec, spec.init_params(0, cfg, dev), cfg, max_streams=lanes,
                          block_hops=block_hops, jit=dev.type == "cuda", device=dev)
    rate = spec.make_manifest(cfg).in_sample_rate
    rng = np.random.default_rng(0)
    blocks = [torch.from_numpy((rng.standard_normal((lanes, srv.block)) * 6000).astype(np.int16))
              .to(dev) for _ in range(srv.n_inputs)]
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    with torch.no_grad():
        if dev.type == "cuda":
            srv._active.copy_(active)
            for static, b in zip(srv._blocks, blocks):
                static.copy_(b)
            for _ in range(12):  # settle
                srv._graph.replay()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(iters):
                srv._graph.replay()
            end.record()
            end.synchronize()
            tick = start.elapsed_time(end) / 1e3 / iters
        else:
            srv._masked_step(active, *blocks)
            t0 = time.perf_counter()
            for _ in range(iters):
                srv._masked_step(active, *blocks)
            tick = (time.perf_counter() - t0) / iters
    budget = srv.block / rate
    return {
        "model": model,
        "lanes": lanes,
        "block_ms": round(budget * 1e3, 1),
        "device_tick_ms": round(tick * 1e3, 3),
        "realtime_streams_per_chip": int(lanes * budget / tick),
        "realtime": tick < budget,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.bench_streams", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="gtcrn")
    ap.add_argument("--lanes", default="8,64,256", help="comma-separated lane counts")
    ap.add_argument("--block-hops", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for k in (int(x) for x in args.lanes.split(",")):
        print(json.dumps(bench_streams(args.model, k, args.block_hops, args.iters, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
