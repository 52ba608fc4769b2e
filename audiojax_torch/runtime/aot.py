"""Graph artifacts: a serialized ``torch.export`` graph next to the params.

Counterpart of ``audiojax.runtime.aot``.  The artifact's served forward is
traced once with ``torch.export`` and written into the artifact as
``graph.pt2``; :func:`load_compiled` rebuilds a servable module from that file
and the artifact's parameters alone, so a serving host imports
``audiojax_torch.runtime`` and ``audiojax_torch.ops`` (whose import registers
the kernels' operators) and never ``audiojax_torch.models``:

    params, manifest = checkpoint.load_artifact(art)
    model = aot.load_compiled(art, aot.prepare_for_graph(params, art))
    Session(model, manifest).process(audio)

What is traced is the served forward: the module as ``optimize.wrap_forward``
returns it, so a plan's dequantization or upcast is inside the graph, over
the served parameter tree (after the compute-dtype preparation).  The
parameters are inputs of the graph, as ``jax.export`` takes them: the
graph stores no weight, and a host serves the artifact's own.  The kernels
appear in the graph as the registered operators
``torch.ops.audiojax_torch.*`` (``ops/_build.py``): replaying the graph on
the card launches the same hand-written kernels as eager serving, in the
same order, and counts them in the same ``launches`` dicts.

Shape policy.  The window-batch axis is exported symbolic
(``torch.export.Dim("b", max=max_batch)``, from an example batch of 2, so
that batch 1 is not specialised), and one graph serves every window batch
the ``Session`` makes up to ``max_batch``.  Where the trace of a model
cannot keep the batch symbolic, the export falls back to one graph a static
batch (default 1, 2, 4, 8, 16) and records why.  A graph holds the device it
was traced on (the factory calls inside it name it): ``graph.json`` records
the device type and loading elsewhere is refused.

Before tracing, the forward runs once eagerly on the example batch: the
model code's cached constants (windows, filterbanks, bases, keyed by
device) are then real tensors, which the graph stores, and not the tracer's
fake ones, which would stay in the caches after the export.

The time loops (the GRUs and LSTMs of ``nn.rnn``, NKF-AEC's Kalman
recurrence) are traced as torch's scan operator (``nn.rnn.time_scan``, on
while exporting: ``ops._build.loops_as_scan``): one node over a traced step
each, whatever the frame count, and ``graph.json`` records ``"loops":
"scan"`` and the graph's node count.  A scan that fails to export raises;
nothing falls back to an unrolled trace.  What still unrolls is a fixed
count of iterations: H-GTCRN's CG and WPE steps (``nn/spatial.py``).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import typing
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..ops import attention_cuda, dwconv_cuda, stft_cuda  # noqa: F401  (register the operators)
from ..params import BUFFER_SEP
from .registry import _holds_q8

__all__ = ["attach_graph", "export_graph", "load_compiled", "has_graph", "prepare_for_graph",
           "node_count", "GRAPH_FILE", "GRAPH_META", "FORMAT"]

GRAPH_FILE = "graph.pt2"
GRAPH_META = "graph.json"
FORMAT = "torch.export"
DEFAULT_STATIC_BATCHES = (1, 2, 4, 8, 16)


def flat_params(tree) -> dict[str, torch.Tensor]:
    """A parameter tree's leaves by the names ``ParamModule`` gives its
    buffers (the path's keys and list indices joined by ``__``), sorted."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[BUFFER_SEP.join(path)] = node

    walk(tree, ())
    return dict(sorted(out.items()))


def _params_fingerprint(flat: dict) -> str:
    """Digest of the parameters' structure (names, shapes, dtypes; not
    values), so that a graph refuses parameters it was not traced for."""
    h = hashlib.sha256()
    for name, t in flat.items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
    return h.hexdigest()


def _device_type(flat: dict) -> str:
    types = {t.device.type for t in flat.values()}
    if len(types) != 1:
        raise ValueError(f"parameters lie on several device types: {sorted(types)}")
    return types.pop()


class _Served(nn.Module):
    """What is traced: ``module``'s forward with its buffers replaced by the
    ``params`` input.  ``module`` is held outside the module tree, so its
    buffers are not the graph's."""

    def __init__(self, module: nn.Module):
        super().__init__()
        object.__setattr__(self, "served", module)

    def forward(self, params: dict, *audios):
        return torch.func.functional_call(self.served, params, audios)


def node_count(program) -> int:
    """Nodes of an exported program's graph and of the graphs it calls (the
    scan operators' steps)."""
    return sum(len(m.graph.nodes) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule))


def _example_audios(manifest, batch: int, device) -> tuple:
    """One (batch, W) int16 window batch per audio input ((batch, ch, W) for a
    multi-channel model), from a fixed seed."""
    cfg = manifest.runtime_config()
    w, ch = cfg["INPUT_AUDIO_LENGTH"], cfg["INPUT_CHANNELS"]
    shape = (batch, w) if ch == 1 else (batch, ch, w)
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy((rng.standard_normal(shape) * 3000).astype(np.int16)).to(device)
                 for _ in range(cfg["NUM_AUDIO_INPUTS"]))


def _compute_dtype(module, manifest) -> str | None:
    """The compute dtype the served tree was prepared to, None for float32."""
    dtype = getattr(getattr(module, "cfg", None), "compute_dtype", None)
    dtype = dtype or (manifest.extra or {}).get("activation_compute_dtype")
    return None if dtype in (None, "float32") else dtype


def export_graph(module: nn.Module, manifest, *, static_batches=None, max_batch: int = 64,
                 example_batch: int = 2):
    """Trace ``module`` (a ``ParamModule``, as ``wrap_forward`` returns it)
    over its own buffers as graph inputs.

    Returns ``(programs, meta)``: ``programs`` maps a batch tag ("poly" or
    "b<N>") to an ``ExportedProgram``; ``meta`` is the ``graph.json`` dict.
    The symbolic batch is tried first, bounded by ``max_batch``; where it
    fails, one graph a batch of ``static_batches`` (None: the defaults; an
    empty sequence is an error)."""
    module = module.eval()
    flat = dict(sorted(module.named_buffers()))
    device = next(iter(flat.values())).device
    served = _Served(module)
    example = _example_audios(manifest, max(2, example_batch), device)
    with torch.no_grad():
        module(*example)  # fills the model code's caches with real tensors
        programs = {}
        symbolic_error = None
        try:
            b = torch.export.Dim("b", min=1, max=int(max_batch))
            dynamic = ({k: None for k in flat}, tuple({0: b} for _ in example))
            programs["poly"] = torch.export.export(served, (flat, *example),
                                                   dynamic_shapes=dynamic, strict=False)
        except Exception as e:  # noqa: BLE001 — recorded; the static graphs follow
            symbolic_error = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"
            batches = DEFAULT_STATIC_BATCHES if static_batches is None else tuple(static_batches)
            for n in batches:
                audios = _example_audios(manifest, int(n), device)
                programs[f"b{int(n)}"] = torch.export.export(served, (flat, *audios),
                                                             strict=False)
    if not programs:
        raise ValueError("aot export produced no graphs: the symbolic-batch trace failed "
                         f"({symbolic_error}) and static_batches is empty")
    poly = "poly" in programs
    meta = {
        "format": FORMAT,
        "device": device.type,
        "batch_mode": "poly" if poly else "static",
        "max_batch": int(max_batch) if poly else None,
        "batches": sorted(programs),
        "admissible_batches": (f"1..{int(max_batch)}" if poly
                               else sorted(int(t[1:]) for t in programs)),
        "symbolic_fallback_error": symbolic_error,
        "loops": "scan",
        "nodes": {tag: node_count(program) for tag, program in sorted(programs.items())},
        "params_fingerprint": _params_fingerprint(flat),
        "params_compute_dtype": _compute_dtype(module, manifest),
        "torch_version": torch.__version__,
    }
    return programs, meta


def _graph_path(artifact_dir: Path, tag: str) -> Path:
    return artifact_dir / (GRAPH_FILE if tag == "poly" else f"graph.{tag}.pt2")


def attach_graph(artifact_dir, module: nn.Module, manifest, *, static_batches=None,
                 max_batch: int = 64) -> Path:
    """Export ``module``'s graph into the artifact directory; returns the
    path of ``graph.json``.  The graph files of an earlier export go first."""
    artifact_dir = Path(artifact_dir)
    programs, meta = export_graph(module, manifest, static_batches=static_batches,
                                  max_batch=max_batch)
    for old in artifact_dir.glob("graph*.pt2"):  # a static export after a poly one, or back
        old.unlink()
    for tag, program in programs.items():
        program.example_inputs = None  # they hold the parameters: the graph stores no weight
        torch.export.save(program, _graph_path(artifact_dir, tag))
    (artifact_dir / GRAPH_META).write_text(json.dumps(meta, indent=2))
    return artifact_dir / GRAPH_META


def has_graph(artifact_dir) -> bool:
    return (Path(artifact_dir) / GRAPH_META).is_file()


def _meta(artifact_dir: Path) -> dict:
    meta = json.loads((artifact_dir / GRAPH_META).read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{artifact_dir / GRAPH_META} records format {meta.get('format')!r} (the JAX "
            f"package's graph.stablehlo is 'jax.export/stablehlo'); the port serves "
            f"{FORMAT!r} graphs: re-export with python -m audiojax_torch.runtime.export --aot")
    return meta


def prepare_for_graph(params, artifact_dir):
    """The compute-dtype preparation that ``graph.json`` records, without
    the model's config: the float32 leaves cast to ``params_compute_dtype``
    (no-op where none was recorded, and for a tree holding q8 nodes, as
    ``registry.prepare_compute_params`` does).  A family whose preparation
    is not a uniform cast (MossFormer2-SR keeps its generator float32) gets
    a tree that :func:`load_compiled` refuses by its fingerprint."""
    dtype = _meta(Path(artifact_dir)).get("params_compute_dtype")
    if not dtype or _holds_q8(params):
        return params
    target = getattr(torch, dtype)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [cast(v) for v in node]
        return node.to(target) if node.dtype == torch.float32 else node

    return cast(params)


@contextlib.contextmanager
def _type_hints_cached():
    """``torch.export.load``'s deserializer asks ``typing.get_type_hints`` for
    the same few schema classes again for every node of the graph, which is
    most of a load's time (torch 2.11 and 2.13).  The answers cannot change
    while a load runs, so they are kept for its length."""
    get = typing.get_type_hints
    kept = {}

    def cached(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        try:
            return kept[key]
        except KeyError:
            kept[key] = hints = get(obj, globalns, localns, include_extras)
            return hints
        except TypeError:  # an unhashable obj
            return get(obj, globalns, localns, include_extras)

    typing.get_type_hints = cached
    try:
        yield
    finally:
        typing.get_type_hints = get


def _load(path: Path) -> nn.Module:
    with _type_hints_cached():
        return torch.export.load(path).module()


class CompiledGraph(nn.Module):
    """A loaded graph artifact: the parameters as buffers and the graph (or
    one graph a static batch), called as ``model(*audio_batches)``, as
    ``Session`` calls a model."""

    def __init__(self, params: dict, graphs: dict, max_batch: int | None):
        super().__init__()
        for name, t in params.items():
            self.register_buffer(name, t)
        object.__setattr__(self, "graphs", graphs)  # not submodules: their state is their own
        self.max_batch = max_batch

    def forward(self, *audios):
        n = audios[0].shape[0]
        if "poly" in self.graphs:
            if n > self.max_batch:
                raise ValueError(f"aot graph was exported for window batches <= "
                                 f"{self.max_batch} (got {n}); re-export with "
                                 "attach_graph(max_batch=…) for longer clips")
            graph = self.graphs["poly"]
        elif n in self.graphs:
            graph = self.graphs[n]
        else:
            raise ValueError(f"aot graph has no batch-{n} export (available: "
                             f"{sorted(self.graphs)}); re-export with static_batches "
                             f"including {n}")
        return graph(dict(self.named_buffers(recurse=False)), *audios)


def load_compiled(artifact_dir, params) -> CompiledGraph:
    """The servable module of the artifact's graph over ``params`` (the
    artifact's tree on the serving device, through :func:`prepare_for_graph`).

    Refused, fail-closed: parameters whose structure differs from the traced
    one (fingerprint), parameters on another device type than the graph's,
    a ``graph.json`` of another format (the JAX package's StableHLO).  At
    call time: a batch above ``max_batch``, a batch with no static graph."""
    artifact_dir = Path(artifact_dir)
    meta = _meta(artifact_dir)
    flat = flat_params(params)
    fp = _params_fingerprint(flat)
    if fp != meta["params_fingerprint"]:
        raise ValueError(
            "aot graph/params mismatch: the graph was traced for a different params structure "
            f"(fingerprint {meta['params_fingerprint'][:12]}… vs {fp[:12]}…); re-export with "
            "attach_graph")
    device = _device_type(flat)
    if device != meta["device"]:
        raise ValueError(f"aot graph was exported on device type {meta['device']!r} but the "
                         f"parameters lie on {device!r}; a graph holds its device: re-export "
                         "on this device")
    if meta["batch_mode"] == "poly":
        graphs = {"poly": _load(artifact_dir / GRAPH_FILE)}
    else:
        graphs = {int(tag[1:]): _load(_graph_path(artifact_dir, tag)) for tag in meta["batches"]}
    return CompiledGraph(flat, graphs, meta.get("max_batch")).eval()
