"""The time loops as scan operators in the port's graph artifacts.

While ``torch.export`` traces, the GRU and LSTM loops of ``nn/rnn.py`` and
NKF-AEC's Kalman recurrence run as ``torch._higher_order_ops.scan.scan``
(``ops._build.loops_as_scan``): the graph holds one node a loop instead of a
copy of the step a frame.  Held here, on the CPU:

* GTCRN at full width on 1 s windows: the scan graph within 1 LSB of eager
  with under a tenth of the nodes of the unrolled trace at the same config
  (the unrolled one traced once, with the switch patched off);
* SDAEC at the JAX package's graph-test config (``SdaecConfig`` has no
  ``depth``: its defaults) on 1 s windows, weights from the JAX init: the
  graph equal to eager and within 1 LSB of ``jax.jit`` of the JAX forward;
* each recurrence exported alone at a small size and equal to eager.  These
  are the witnesses of the aliased-carry trap: a scan started from one zeros
  tensor used as two carries (the eager loops' ``(z, z)``) returns wrong
  answers from the graph;
* eager forwards never enter the scan operator, and a scan that fails to
  export raises (no unrolled fallback).
"""
import dataclasses
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from audiojax.runtime import registry as jregistry
from test_torch_ckpt_builders import one_thread  # noqa: F401  (autouse)
from torch_isolation import hide_module_stubs  # noqa: F401  (autouse)

from audiojax_torch.models import nkf_aec
from audiojax_torch.nn import rnn
from audiojax_torch.ops import _build
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import aot, registry

GTCRN_WINDOW = 16000  # 1 s: 63 frames
SDAEC_WINDOW = 16000


def _windows(manifest, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, manifest.input_audio_length)
    return torch.from_numpy((rng.standard_normal(shape) * 3000).astype(np.int16))


def _lsb(a, b) -> int:
    return int(np.max(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))))


def _jax_weights(name, seed):
    """The JAX package's init for ``name``, as JAX arrays and as the port's tree."""
    jspec = jregistry.get(name)
    jparams = jspec.init_params(jax.random.PRNGKey(seed), jspec.make_config())
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def gtcrn(tmp_path_factory):
    spec = registry.get("gtcrn")
    cfg = spec.make_config()
    manifest = dataclasses.replace(spec.make_manifest(cfg), input_audio_length=GTCRN_WINDOW)
    _, params = _jax_weights("gtcrn", 0)
    model = spec.make_module(params, cfg).eval()
    path = tmp_path_factory.mktemp("gtcrn_scan")
    aot.attach_graph(path, model, manifest)
    return path, model, params, manifest


def test_gtcrn_scan_graph(gtcrn, monkeypatch):
    """Within 1 LSB of eager at batches 1 and 3, graph.json records the scan
    route and its node count, and that count is under a tenth of the
    unrolled trace's."""
    path, model, params, manifest = gtcrn
    meta = json.loads((path / aot.GRAPH_META).read_text())
    assert meta["loops"] == "scan" and meta["batch_mode"] == "poly"
    compiled = aot.load_compiled(path, params)
    with torch.inference_mode():
        for batch in (1, 3):
            audio = _windows(manifest, batch, seed=batch)
            assert _lsb(compiled(audio), model(audio)) <= 1
    monkeypatch.setattr(_build, "loops_as_scan", lambda: False)
    unrolled, _ = aot.export_graph(model, manifest)
    assert 10 * meta["nodes"]["poly"] < aot.node_count(unrolled["poly"]), (
        meta["nodes"], aot.node_count(unrolled["poly"]))


def test_sdaec_graph_matches_eager_and_jax(tmp_path):
    """SDAEC (two inputs, its LSTMs over frames and over bins) exports
    through the scan route; the graph equals eager and is within 1 LSB of
    the JAX package's jitted forward on the same weights."""
    jspec, spec = jregistry.get("sdaec"), registry.get("sdaec")
    cfg = spec.make_config()
    manifest = dataclasses.replace(spec.make_manifest(cfg), input_audio_length=SDAEC_WINDOW)
    jparams, params = _jax_weights("sdaec", 2)
    model = spec.make_module(params, cfg).eval()
    aot.attach_graph(tmp_path, model, manifest)
    meta = json.loads((tmp_path / aot.GRAPH_META).read_text())
    assert meta["loops"] == "scan" and meta["batch_mode"] == "poly"
    compiled = aot.load_compiled(tmp_path, params)
    near, far = _windows(manifest, 1, seed=3), _windows(manifest, 1, seed=4)
    with torch.inference_mode():
        got = compiled(near, far).numpy()
        np.testing.assert_array_equal(got, model(near, far).numpy())
    want = jax.jit(jspec.make_forward(jspec.make_config()))(jparams, near.numpy(), far.numpy())
    assert got.shape == np.asarray(want).shape
    assert _lsb(got, want) <= 1


# ── each recurrence alone ───────────────────────────────────────────────────


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _gru_np(rng, din, hidden, groups=None):
    lead = () if groups is None else (groups,)
    u = lambda *s: rng.uniform(-0.5, 0.5, lead + s).astype(np.float32)  # noqa: E731
    return {"w_i": u(din, 3 * hidden), "w_h": u(hidden, 3 * hidden),
            "b_i": u(3 * hidden), "b_h": u(3 * hidden)}


def _tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _cases():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 9, 6)).astype(np.float32))
    lstm = lambda: _tensors(rnn.init_lstm_numpy(rng, 6, 5))  # noqa: E731
    gru = lambda g=None: _tensors(_gru_np(rng, 6 if g is None else 3, 4, g))  # noqa: E731
    ncfg = nkf_aec.NkfConfig(filter_order=3, fc_dim=6, rnn_dim=5)
    nparams = params_from_numpy(nkf_aec.init_nkf_numpy(1, ncfg), "cpu")
    spec = lambda: torch.from_numpy(rng.standard_normal((2, 7, 5, 2)).astype(np.float32))  # noqa: E731
    return {
        "gru": (lambda p, x: rnn.gru(p, x, return_state=True), (gru(), x)),
        "gru_reverse": (lambda p, x: rnn.gru(p, x, reverse=True), (gru(), x)),
        "gru_bidir": (lambda pf, pb, x: rnn.gru_bidir(pf, pb, x, return_state=True),
                      (gru(), gru(), x)),
        "grouped_gru": (lambda p, x: rnn.grouped_gru(p, x, groups=2, return_state=True),
                        (gru(2), x)),
        "grouped_gru_bidir": (lambda pf, pb, x: rnn.grouped_gru_bidir(pf, pb, x, groups=2),
                              (gru(2), gru(2), x)),
        "lstm": (lambda p, x: rnn.lstm(p, x, return_state=True), (lstm(), x)),
        "lstm_reverse": (lambda p, x: rnn.lstm(p, x, reverse=True), (lstm(), x)),
        "lstm_bidir": (lambda pf, pb, x: rnn.lstm_bidir(pf, pb, x), (lstm(), lstm(), x)),
        "nkf_scan": (lambda p, r, m: nkf_aec.nkf_scan(p, r, m, ncfg), (nparams, spec(), spec())),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrence_exports_as_scan(name):
    """One scan node (over the step's own graph), and the graph equals eager."""
    fn, args = CASES[name]
    module = _Fn(fn)
    program = torch.export.export(module, args, strict=False)
    scans = [n for n in program.graph.nodes if n.target is torch.ops.higher_order.scan]
    assert len(scans) == 1
    want = module(*args)
    got = program.module()(*args)
    for g, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ── eager stays eager; a failed scan export raises ─────────────────────────


@pytest.fixture
def scan_forbidden(monkeypatch):
    hop = importlib.import_module("torch._higher_order_ops.scan")

    def refuse(*args, **kwargs):
        raise AssertionError("the scan operator was entered")

    monkeypatch.setattr(hop, "scan", refuse)


def test_eager_never_enters_scan(scan_forbidden):
    """Eager forwards of the loop families (offline, a stream step, inside
    ``registered_ops``) and every recurrence keep the Python loops."""
    for name in CASES:
        fn, args = CASES[name]
        fn(*args)
    rng = np.random.default_rng(1)
    for name, n in (("gtcrn", 4000), ("nkf_aec", 2560), ("sdaec", 1600)):
        spec = registry.get(name)
        cfg = spec.make_config()
        model = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg).eval()
        manifest = spec.make_manifest(cfg)
        audios = [torch.from_numpy((rng.standard_normal((1, n)) * 3000).astype(np.int16))
                  for _ in range(manifest.num_audio_inputs)]
        with torch.inference_mode():
            model(*audios)
            with _build.registered_ops():
                model(*audios)
    cfg = nkf_aec.NkfConfig()
    state = nkf_aec.nkf_stream_init(cfg, 1, "cpu")
    chunk = torch.zeros((1, 4 * cfg.hop), dtype=torch.int16)
    nkf_aec.nkf_stream_step(params_from_numpy(nkf_aec.init_nkf_numpy(0, cfg), "cpu"), state,
                            chunk, chunk, cfg)


def test_failed_scan_export_raises(scan_forbidden, tmp_path):
    """No fallback to an unrolled trace: the export raises and writes no graph."""
    spec = registry.get("nkf_aec")
    cfg = spec.make_config()
    manifest = dataclasses.replace(spec.make_manifest(cfg), input_audio_length=2560)
    model = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg).eval()
    with pytest.raises(AssertionError, match="scan operator was entered"):
        aot.attach_graph(tmp_path, model, manifest)
    assert not aot.has_graph(tmp_path)
