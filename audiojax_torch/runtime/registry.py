"""Model registry: one place mapping model names → configs, params, modules
and manifests, so the session and the CLI stay generic."""
from __future__ import annotations

import dataclasses
from typing import Callable

from torch import nn

from .manifest import Manifest

__all__ = ["ModelSpec", "register", "get", "names"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    task: str
    make_config: Callable[..., object]
    init_params: Callable[..., dict]  # (seed, cfg, device) -> params
    make_module: Callable[[dict, object], nn.Module]  # (params, cfg) -> module(*audios)
    make_manifest: Callable[[object], Manifest]  # cfg -> Manifest
    # optional state-carry streaming: cfg -> (init_fn(batch, device),
    # step_fn(params, state, *chunks) -> (state, out), delay_samples).
    # CONTRACT: every state leaf that init_fn(batch, device) returns folds the
    # batch axis BATCH-MAJOR (viewing the folded axis as (batch, sub) recovers
    # the lane), and no leaf is batch-independent: StreamingServer infers each
    # leaf's lane axis from the batch-1 and batch-K shapes and masks per-lane
    # updates on it; StreamingServer.verify_lane_isolation() checks it.
    make_stream: Callable[[object], tuple] | None = None


_REGISTRY: dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ModelSpec:
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)


def _ensure_builtin():
    from . import builtin_models  # noqa: F401  (registers on import)
