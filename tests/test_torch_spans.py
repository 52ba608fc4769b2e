"""The port's host spans (``utils.profiling.span``) on the CPU: the phases of
``Session.process`` and the stage spans of MossFormerGAN-SE and
MossFormer2-SS, at tiny widths and the served depths (6 GAN blocks, 24 SS
layers), on 0.1 s windows so that a request runs two of them.

A span is a host-only ``cpu_op`` on the profiler's clock; with no profiler
running it is one shared no-op context, and while ``torch.export`` traces it
records nothing and leaves nothing in the graph.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiojax_torch.models.mossformer2_ss import init_mossformer2_ss_numpy
from audiojax_torch.models.mossformergan_se import init_mossformergan_numpy
from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import registry
from audiojax_torch.runtime.session import Session
from audiojax_torch.utils import profiling

WINDOW = 1600
MODELS = {
    "mossformergan_se": (
        init_mossformergan_numpy,
        dict(emb_dim=16, emb_ks=2, uv_channels=24, dense_depth=2, lorder=4, mf_hidden=32,
             mf_vdim=16, mf_qk=16, mf_rot=8, dw_kernel=7, attn_heads=2, attn_q_ch=2,
             attn_v_ch=4, fold_window=0),
        dict(input_audio_length=WINDOW),
    ),
    "mossformer2_ss": (
        init_mossformer2_ss_numpy,
        dict(dim=32, group_size=16, qk_dim=16, vu_dim=32, fsmn_inner=16, dw_kernel=5,
             rot_dim=8, lorder=5),
        dict(input_audio_length=WINDOW, pad_head=400),
    ),
}
# each stage span, in the order of a forward, and its count a forward
STAGES = {
    "mossformergan_se": {"model.gan.stft": 1, "model.gan.encoder": 1, "model.gan.intra": 6,
                         "model.gan.inter": 6, "model.gan.attention": 6,
                         "model.gan.mask_decoder": 1, "model.gan.complex_decoder": 1,
                         "model.gan.istft": 1},
    "mossformer2_ss": {"model.ss.encoder": 1, "model.ss.flash": 24, "model.ss.fsmn": 24,
                       "model.ss.mask": 1, "model.ss.decoder": 1},
}
PHASES = ("session.condition", "session.slice", "session.to_device", "model.forward",
          "session.to_host", "session.stitch")
TIMED = ("session.to_device", "model.forward", "session.to_host")


def _port_spans(prof) -> list:
    """(name, start_ns, end_ns, activity type, is a user annotation) of every
    port span in a finished profile, in order of start."""
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
              ev.activity_type(), ev.is_user_annotation())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith(("session.", "model."))]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


@pytest.fixture(scope="module", params=list(MODELS))
def served(request):
    """(model name, module, the result of a request served with no profiler,
    the result and the port spans of the same request profiled)."""
    torch.manual_seed(0)
    name = request.param
    init, fields, geometry = MODELS[name]
    spec = registry.get(name)
    cfg = spec.make_config(**fields)
    module = spec.make_module(params_from_numpy(init(0, cfg), device="cpu"), cfg)
    manifest = dataclasses.replace(spec.make_manifest(cfg), **geometry)
    session = Session(module, manifest, device="cpu")
    rng = np.random.default_rng(1)
    clip = (rng.standard_normal(WINDOW + WINDOW // 2) * 3000).astype(np.int16)
    plain = session.process(clip)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = session.process(clip)
    return name, module, plain, traced, _port_spans(prof)


def test_session_phases_nest_in_order_with_the_stages_inside_the_forward(served):
    name, *_, spans = served
    (top,) = [s for s in spans if s[0] == "session.process"]
    phases = [s for s in spans if s[0] in PHASES]
    assert [s[0] for s in phases] == list(PHASES)
    assert top[1] <= phases[0][1] and phases[-1][2] <= top[2]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    forward = phases[PHASES.index("model.forward")]
    stages = [s for s in spans if s[0].startswith("model.") and s[0] != "model.forward"]
    assert all(forward[1] <= s[1] and s[2] <= forward[2] for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))  # none overlaps another
    counts = {}
    for s in stages:
        counts[s[0]] = counts.get(s[0], 0) + 1
    assert counts == STAGES[name]
    assert list(dict.fromkeys(s[0] for s in stages)) == list(STAGES[name])


def test_port_spans_are_host_ops_not_annotations(served):
    """A user annotation gets a device-side mark on the card that reads as
    device time; the port's spans must stay plain host ops."""
    *_, spans = served
    assert spans and all(kind == "cpu_op" and not annotation
                         for _, _, _, kind, annotation in spans)


def test_timed_phases_cover_elapsed_s(served):
    *_, traced, spans = served
    total_s = sum(e - s for name, s, e, *_ in spans if name in TIMED) * 1e-9
    assert abs(total_s - traced.elapsed_s) <= 0.05 * traced.elapsed_s + 0.5e-3


def test_spans_are_one_shared_no_op_off_and_change_no_output(served):
    *_, plain, traced, _ = served
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.span("session.process")
    assert off is profiling.span("model.forward")
    with off, off:  # reusable and re-entrant
        pass
    assert len(plain.outputs) == len(traced.outputs)
    for a, b in zip(plain.outputs, traced.outputs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_export_records_no_span_and_holds_no_profiler_node(served):
    _, module, *_ = served
    audio = torch.zeros(2, WINDOW, dtype=torch.int16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program = torch.export.export(module, (audio,), strict=False)
    assert not _port_spans(prof)
    targets = [str(node.target) for node in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
