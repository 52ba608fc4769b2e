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
