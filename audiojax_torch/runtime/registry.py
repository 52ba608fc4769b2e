"""Model registry: one place mapping model names → configs, params, modules
and manifests, so the session and the CLI stay generic."""
from __future__ import annotations

import dataclasses
from typing import Callable

from torch import nn

from .manifest import Manifest

__all__ = ["ModelSpec", "register", "get", "names", "spec_for_module", "has_compute_dtype",
           "prepare_compute_params", "config_from_manifest"]


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
    # optional compute-dtype preparation (params, cfg) -> params in place of the
    # whole-tree cast: MossFormer2-SR keeps its generator float32
    prepare_params: Callable[[dict, object], dict] | None = None


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


def spec_for_module(cls) -> ModelSpec | None:
    """The registered spec whose ``make_module`` is the class ``cls`` (the
    first where two share it, as Mel-Band's mono and stereo specs do), or
    None for a class no spec builds."""
    _ensure_builtin()
    return next((s for s in _REGISTRY.values() if s.make_module is cls), None)


def has_compute_dtype(cfg) -> bool:
    """True when a model config has the activation ``compute_dtype`` knob."""
    return dataclasses.is_dataclass(cfg) and any(
        f.name == "compute_dtype" for f in dataclasses.fields(cfg))


def config_from_manifest(spec: ModelSpec, manifest: Manifest):
    """The config an artifact records (``manifest.extra["config"]``, written
    by export; JSON turned its tuples into lists), else the spec's default."""
    stored = (manifest.extra or {}).get("config")
    if stored is None:
        return spec.make_config()

    def detuple(v):
        return tuple(detuple(x) for x in v) if isinstance(v, list) else v

    return type(spec.make_config())(**{k: detuple(v) for k, v in stored.items()})


def _holds_q8(tree) -> bool:
    if isinstance(tree, dict):
        return "q8" in tree or any(_holds_q8(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_q8(v) for v in tree)
    return False


def prepare_compute_params(params, cfg, spec: ModelSpec | None = None):
    """The compute-dtype preparation of a parameter tree, once per served
    tree (``audiojax.runtime.registry.prepare_compute_params``), where the
    model's module is built (``models.base.ParamModule``, which passes the
    spec that builds its class): ``spec.prepare_params(params, cfg)`` where
    the family's spec has one, else the float32 leaves cast to
    ``cfg.compute_dtype``.  A float32
    config, a config without the knob and a quantized tree (the q8 plans
    keep float32 compute; their scales are the dequantization's contract)
    pass the tree through as it is."""
    if not has_compute_dtype(cfg) or cfg.compute_dtype == "float32" or _holds_q8(params):
        return params
    if spec is not None and spec.prepare_params is not None:
        return spec.prepare_params(params, cfg)
    from ..nn.core import cast_f32_tree, compute_dtype

    return cast_f32_tree(params, compute_dtype(cfg.compute_dtype))


def _ensure_builtin():
    from . import builtin_models  # noqa: F401  (registers on import)
