"""The port's tools against the JAX package's (``utils/smoke.py``,
``utils/inspect_model.py``, ``utils/bench_streams.py``) on the CPU, and the
kernels' registered operators that the graphs and the FLOP count go through.
"""
import json

import pytest
import torch

from audiojax.runtime import registry as jregistry
from audiojax.utils.inspect_model import inspect_model as jinspect
from test_torch_ckpt_builders import one_thread  # noqa: F401
from torch_isolation import hide_module_stubs  # noqa: F401

from audiojax_torch.dsp.stft import StftConfig
from audiojax_torch.ops import _build, attention_cuda, dwconv_cuda, stft_cuda
from audiojax_torch.runtime import registry
from audiojax_torch.utils import bench_streams, inspect_model, smoke

# the port's operation count over the JAX package's (XLA's cost analysis
# counts elementwise work too; the port's count is the matrix products,
# convolutions and kernels): measured on the CPU
FLOP_RATIO = {"gtcrn": 0.47, "nkf_aec": 1.35}


def test_smoke(capsys):
    assert registry.names() == jregistry.names()
    assert smoke.main(["--models", "gtcrn", "dfsmn", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["gtcrn", "dfsmn"]
    assert all(" ok " in line and "stream ok" in line for line in lines)


def test_smoke_reports_a_failure(capsys):
    assert smoke.main(["--models", "no_such_model", "--device", "cpu"]) == 1
    assert "FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["gtcrn", "nkf_aec"])
def test_inspect_model_matches_jax(name, capsys):
    """The JAX report's keys; params, param_mb and the geometry equal; the
    operation count positive, at the ratio measured to XLA's."""
    want = jinspect(name)
    assert inspect_model.main(["--model", name, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    assert set(got) == set(want)
    for k in ("model", "task", "params", "param_mb", "chunk_seconds", "input_shape",
              "num_audio_inputs", "sample_rates"):
        assert got[k] == want[k], k
    if name == "gtcrn":
        assert got["params"] == 23314
    else:
        assert got["num_audio_inputs"] == 2
    assert got["gflops_per_chunk"] > 0 and got["bytes_accessed_mb"] > 0
    ratio = got["gflops_per_chunk"] / want["gflops_per_chunk"]
    assert ratio == pytest.approx(FLOP_RATIO[name], abs=0.01)


def test_bench_streams_keys():
    r = bench_streams.bench_streams("gtcrn", lanes=2, iters=2, device="cpu")
    assert list(r) == ["model", "lanes", "block_ms", "device_tick_ms",
                       "realtime_streams_per_chip", "realtime"]
    assert r["model"] == "gtcrn" and r["lanes"] == 2 and r["block_ms"] == 64.0
    assert r["device_tick_ms"] > 0


# ── the registered operators ───────────────────────────────────────────────

CFG = StftConfig(64, 16, window="hann", pad_mode="reflect")


def _cases():
    """(operator, its routing point, the plain version, their tensors, the
    operator's other arguments)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 400), generator=g)
    spec = stft_cuda.plain_stft_packed(x, CFG)
    q, v = torch.randn((2, 10, 8), generator=g), torch.randn((2, 10, 12), generator=g)
    pp, pe = torch.randn((2, 10, 16), generator=g), torch.randn((2, 4, 10, 10), generator=g)
    cfg = stft_cuda._cfg_args(CFG)
    quad = dict(scale=0.1, mask_diag=True, out_dtype=torch.float32)
    return [
        ("stft_packed", lambda x: stft_cuda.fast_stft_packed(x, CFG),
         lambda x: stft_cuda.plain_stft_packed(x, CFG), (x,), cfg),
        ("istft_packed", lambda s: stft_cuda.fast_istft_packed(s, CFG, 380),
         lambda s: stft_cuda.plain_istft_packed(s, CFG, 380), (spec,), (*cfg, 380)),
        ("dwconv1d", lambda x, w: dwconv_cuda.fast_dwconv1d(x, w, pads=(2, 3), dilation=2),
         lambda x, w: dwconv_cuda.dwconv1d_plain(x, w, pads=(2, 3), dilation=2),
         (torch.randn((3, 50, 8), generator=g), torch.randn((5, 8), generator=g)), (2, 3, 2)),
        ("dwconv1d_grouped",
         lambda x, w: dwconv_cuda.fast_dwconv1d_grouped(x, w, pads=(4, 4), dilation=2),
         lambda x, w: dwconv_cuda.dwconv1d_grouped_plain(x, w, pads=(4, 4), dilation=2),
         (torch.randn((3, 50, 16), generator=g), torch.randn((5, 2, 8), generator=g)),
         (4, 4, 2)),
        ("quad_attention", lambda q, k, v: attention_cuda.fast_quad_attention(q, k, v, **quad),
         lambda q, k, v: attention_cuda.quad_attention_plain(q, k, v, **quad),
         (q.bfloat16(), q.bfloat16(), v.bfloat16()), (0.1, True, "float32")),
        ("relpos_scores",
         lambda q, k, pp, pe: attention_cuda.fast_relpos_scores(q, k, pp, pe, num_heads=2),
         lambda q, k, pp, pe: attention_cuda.relpos_scores_plain(q, k, pp, pe, num_heads=2),
         (q, q, pp, pe), (2,)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_registered_operator(case):
    """Each routing point through its operator (``registered_ops``) equals
    its plain version on the CPU; the operator passes ``torch.library.opcheck``
    (its fake implementation's shape and dtype, no aliasing); ``torch.export``
    records the operator, not the plain version; the FLOP counter counts it
    by its own formula."""
    from torch.utils.flop_counter import FlopCounterMode

    name, fast, plain, tensors, rest = case
    op = getattr(torch.ops.audiojax_torch, name)
    want = plain(*tensors)
    assert not _build.through_ops()
    with _build.registered_ops():
        assert _build.through_ops()
        torch.testing.assert_close(fast(*tensors), want, rtol=0, atol=0)
    torch.testing.assert_close(op(*tensors, *rest), want, rtol=0, atol=0)
    torch.library.opcheck(op, (*tensors, *rest))

    class Traced(torch.nn.Module):
        def forward(self, *ts):
            return fast(*ts)

    ep = torch.export.export(Traced(), tensors, strict=False)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert targets == {f"audiojax_torch.{name}.default"}, targets
    with _build.registered_ops(), FlopCounterMode(display=False) as counter:
        fast(*tensors)
    assert counter.get_total_flops() > 0
