"""Artifact optimization: the parameter representation an artifact serves.

Counterpart of ``audiojax.runtime.optimize``: per-model ``Plan`` recipes,
applied to an artifact's tree with fail-closed checks, a re-validated
manifest and an ``optimize_report.json`` audit written beside the output.

- ``quantize="q8f32"``: weight-only symmetric int8 (``utils/quantize.py``);
  the weights stay int8 on the card and are dequantized at every forward
  (``wrap_forward``), activations float32.
- ``quantize="q8dyn"``: the same artifact, served as it is: ``core.dense``
  takes the dynamic int8 route (each row quantized at run time, an exact
  int32 product), the convs and RNNs dequantize their weights.
- ``compute_dtype="bf16"``: weight-only bfloat16 storage, upcast to float32
  at every forward; ``fp32_block`` path patterns keep subtrees float32.

Only ``manifest.extra["optimize"]`` decides how an artifact is served.
Unknown plan fields, block patterns that match nothing and a pass that
quantizes or casts no leaf abort before anything is written.

    python -m audiojax_torch.runtime.optimize src_art/ dst_art/ --plan q8f32
"""
from __future__ import annotations

import dataclasses
import json
import re
import warnings
from pathlib import Path

import numpy as np
import torch

from ..utils.quantize import dequantize_tree, quantize_tree, quantized_bytes

__all__ = ["Plan", "PLANS", "plan_for", "apply_plan", "materialize_params", "wrap_forward",
           "optimize_artifact", "main"]

_QUANT_MODES = ("none", "q8f32", "q8dyn")
_DTYPES = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One optimization recipe (the JAX package's ``Plan``, the same fields)."""

    name: str
    quantize: str = "none"  # "none" | "q8f32" | "q8dyn"
    compute_dtype: str = "f32"  # "f32" | "bf16" (weight-only storage)
    q8_min_size: int = 4096
    fp32_block: tuple[str, ...] = ()  # regexes over leaf paths kept float32 under bf16
    notes: str = ""
    # below the repo's 40 dB output gate somewhere, or not recommended:
    # apply_plan warns, so that no one picks it by accident
    experimental: bool = False

    def __post_init__(self):
        if self.quantize not in _QUANT_MODES:
            raise ValueError(f"plan {self.name!r}: unknown quantize {self.quantize!r}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"plan {self.name!r}: unknown compute_dtype {self.compute_dtype!r}")
        if self.quantize != "none" and self.compute_dtype != "f32":
            raise ValueError(f"plan {self.name!r}: q8 and bf16 are mutually exclusive")


# The JAX package's recommended plans, by the same names: dynamic int8 is
# recommended for Mel-Band Roformer alone, as in the reference's own recipes.
PLANS: dict[str, Plan] = {
    "f32": Plan("f32", notes="identity plan: float32 weights"),
    "q8f32": Plan("q8f32", quantize="q8f32", notes="weight-only int8, f32 activations"),
    "q8dyn": Plan(
        "q8dyn", quantize="q8dyn",
        notes="dynamic-activation int8 products (exact int32 sums, torch._int_mm); "
        "dense weights stay int8 at run time, convs and RNNs dequantize",
        # below the 40 dB gate on Mel-Band Roformer (random weights from a
        # synthetic checkpoint, H100 80GB HBM3 at 700 W, chip_smoke.py phase
        # 28): card q8dyn against card float32 35.15 dB, and 1.16× its latency
        experimental=True,
    ),
    "bf16": Plan("bf16", compute_dtype="bf16", notes="weight-only bf16 storage"),
    "melband_roformer": Plan(
        "melband_roformer", quantize="q8f32",
        notes="the one model where dynamic Q8 is recommended (the reference's README)",
    ),
}


def plan_for(model_name: str) -> Plan:
    """The recommended plan of a registered model (f32 unless it has one)."""
    return PLANS.get(model_name, PLANS["f32"])


def _map_paths(tree, fn, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree, the path in the JAX
    package's form ("a/0/w"; a q8 node's parts ".../w/q8", ".../w/scale")."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(v, fn, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _paths(tree) -> list:
    out = []
    _map_paths(tree, lambda path, _: out.append(path))
    return out


def _is_f32(leaf) -> bool:
    return leaf.dtype in (np.float32, torch.float32)


def apply_plan(params, plan: Plan):
    """An artifact's tree (``checkpoint.load_tree``'s, the JAX package's
    layout) → (optimized tree, audit dict).  Host side, no device."""
    audit = {"plan": dataclasses.asdict(plan)}
    if plan.experimental:
        warnings.warn(
            f"plan {plan.name!r} is EXPERIMENTAL: measured output SNR falls below "
            f"the 40 dB acceptance gate on at least one family ({plan.notes}); "
            f"prefer the recommended plan from plan_for(<model>)",
            stacklevel=2,
        )
        audit["experimental"] = True
    if plan.quantize in ("q8f32", "q8dyn"):  # one artifact; the serving differs
        out = quantize_tree(params, min_size=plan.q8_min_size)
        qb, fb = quantized_bytes(out)
        n_q = sum(1 for p in _paths(out) if p.endswith("/q8"))
        if n_q == 0:
            raise ValueError(
                f"plan {plan.name!r}: {plan.quantize} quantized ZERO leaves "
                f"(min_size={plan.q8_min_size}) — contract drift, aborting")
        audit.update(leaves_quantized=n_q, bytes_after=qb, bytes_before=fb,
                     compression=round(fb / max(qb, 1), 3))
        return out, audit

    if plan.compute_dtype == "bf16":
        paths = _paths(params)
        # fail-closed: every block pattern must match at least one leaf path
        matched = {pat: [p for p in paths if re.search(pat, p)] for pat in plan.fp32_block}
        dead = [pat for pat, hits in matched.items() if not hits]
        if dead:
            raise ValueError(f"plan {plan.name!r}: fp32_block patterns matched nothing: {dead} "
                             "— contract drift, aborting")
        blocked = {p for hits in matched.values() for p in hits}
        n_cast = 0

        def convert(path, leaf):
            nonlocal n_cast
            if path in blocked or leaf.ndim < 2 or not _is_f32(leaf):
                return leaf
            n_cast += 1
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
            return t.to(torch.bfloat16)  # round to nearest even, as jnp.asarray(·, bf16)

        out = _map_paths(params, convert)
        # only the leaves this pass cast count: bf16 leaves already there do not
        if n_cast == 0:
            raise ValueError(f"plan {plan.name!r}: bf16 cast ZERO leaves — contract drift, "
                             "aborting")
        audit.update(leaves_cast_bf16=n_cast, leaves_blocked_f32=len(blocked))
        return out, audit

    audit.update(identity=True)
    return params, audit


def _upcast(tree):
    return _map_paths(tree, lambda _, leaf: (leaf.float() if isinstance(leaf, torch.Tensor)
                                             and leaf.dtype == torch.bfloat16 else leaf))


def _view(manifest):
    """The tree map an optimized artifact is served through, or None."""
    opt = (manifest.extra or {}).get("optimize", {})
    if opt.get("quantize") == "q8f32":
        return dequantize_tree
    if opt.get("quantize") == "q8dyn":
        return None  # served as it is: dense takes the int8 route, convs dequantize
    if opt.get("compute_dtype") == "bf16":
        return _upcast
    return None


def materialize_params(params, manifest):
    """The served tree, once, on the host side of a path that cannot wrap
    the forward (state-carry streaming builds its step from the spec): q8f32
    dequantized, weight-only bf16 upcast, q8dyn as it is."""
    view = _view(manifest)
    return params if view is None else view(params)


def wrap_forward(module, manifest):
    """The counterpart of the JAX package's ``wrap_forward``: ``module`` (a
    ``models.base.ParamModule``) serves an optimized artifact's tree, mapped
    at every forward (q8f32 dequantized from its int8 buffers, weight-only
    bf16 upcast from its bf16 ones), so the weights stay in their stored
    dtype on the device.  A q8dyn or float32 artifact's module is returned
    as it is.  Returns ``module``."""
    module.param_view = _view(manifest)
    return module


def optimize_artifact(src, dst, plan: Plan) -> Path:
    """Artifact → optimized artifact + ``optimize_report.json`` (``dst`` may
    be ``src``: the tree is read whole before anything is written)."""
    from .checkpoint import load_tree, save_artifact
    from .manifest import Manifest, validate_manifest_dict

    params = load_tree(src)
    manifest = Manifest.load(Path(src) / "manifest.json")
    out_params, audit = apply_plan(params, plan)

    manifest.extra["optimize"] = {
        "plan": plan.name,
        "quantize": plan.quantize,
        "compute_dtype": plan.compute_dtype,
    }
    dst = save_artifact(dst, out_params, manifest)
    # the manifest's required keys must survive the pass
    validate_manifest_dict(json.loads((Path(dst) / "manifest.json").read_text()))
    (Path(dst) / "optimize_report.json").write_text(json.dumps(audit, indent=2, sort_keys=True))
    return dst


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="audiojax_torch.runtime.optimize",
                                 description="audiojax_torch artifact optimizer")
    ap.add_argument("src", nargs="?", help="source artifact dir")
    ap.add_argument("dst", nargs="?", help="destination artifact dir")
    ap.add_argument("--plan", default="f32", help="plan name (see --list-plans)")
    ap.add_argument("--list-plans", action="store_true")
    args = ap.parse_args(argv)
    if args.list_plans:
        for name, p in PLANS.items():
            print(f"{name}: quantize={p.quantize} compute_dtype={p.compute_dtype}  {p.notes}")
        return 0
    if not args.src or not args.dst:
        ap.error("src and dst artifact dirs are required")
    if args.plan not in PLANS:
        ap.error(f"unknown plan {args.plan!r}; available: {sorted(PLANS)}")
    out = optimize_artifact(args.src, args.dst, PLANS[args.plan])
    print(f"wrote optimized artifact to {out} (report: {out}/optimize_report.json)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
