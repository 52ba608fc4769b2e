"""``audiojax_torch.parallel`` and ``Session(mesh=…, bucket_windows=…)`` on the
CPU, case for case with ``tests/test_parallel.py``.

The port's mesh is an array of ``torch.device``s; here it repeats the CPU
(``devices=["cpu"] * 8``), where the JAX package's tests take the virtual
8-device CPU mesh (``tests/conftest.py``).  Gates: the mesh ``Session``
equals the plain one bit for bit and the JAX mesh ``Session``; the window
geometry equals the JAX ``_window_geometry`` for the same ``dp``, with and
without bucketing; dp-sharded GTCRN at full width within 1 LSB of one
device; ``pp_stack`` within 1e-6 × max|ref| of the JAX ``pp_stack`` on the
same numpy parameters; the JAX package's errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import audiojax.parallel as jparallel
from audiojax.runtime.manifest import Manifest as JManifest
from audiojax.runtime.session import Session as JSession
from test_torch_ckpt_builders import one_thread  # noqa: F401  (autouse)

import audiojax_torch.parallel as tparallel
from audiojax_torch.parallel import (make_mesh, pp_stack, pp_stack_fn, replicate, shard_batch,
                                     shard_hint, sharded_model_fn, spmd_mesh,
                                     stack_layer_params)
from audiojax_torch.parallel.sharding import Mesh
from audiojax_torch.runtime import registry
from audiojax_torch.runtime.manifest import Manifest
from audiojax_torch.runtime.session import Session

CPU8 = ["cpu"] * 8
needs_8 = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")


def _manifest(cls, overlap=0, sources=1):
    return cls(model_name="t", task="denoise", model_family="T", in_sample_rate=16000,
               out_sample_rate=16000, model_sample_rate=16000, input_audio_length=4000,
               overlap_length=overlap, output_sources=sources)


class _Neg(nn.Module):
    def forward(self, audio):
        return (-audio).to(audio.dtype)


class _NegAndHalf(nn.Module):
    """Two output sources, as a separation model returns them."""

    def forward(self, audio):
        return (-audio).to(audio.dtype), (audio // 2).to(audio.dtype)


def test_public_names_match_jax():
    assert sorted(tparallel.__all__) == sorted(jparallel.__all__)


def test_dp_tp_mesh_shapes():
    mesh = make_mesh(8, tp=2, devices=CPU8)
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert mesh.distinct() == [torch.device("cpu")]
    assert make_mesh(devices=CPU8).shape == {"dp": 8, "tp": 1}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(7, tp=2, devices=CPU8)


def test_make_mesh_too_few_devices_fails_loudly():
    with pytest.raises(ValueError, match="requested a 64-device mesh"):
        make_mesh(64, devices=CPU8)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only error")
def test_default_mesh_needs_cuda():
    """The default mesh is the cards; without CUDA it raises, as every entry
    point's default device does, and a Session never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(_Neg(), _manifest(Manifest), mesh=make_mesh(2, devices=["cuda:0"] * 2))


def test_session_device_and_mesh_together_refused():
    with pytest.raises(ValueError, match="device= or mesh=, not both"):
        Session(_Neg(), _manifest(Manifest), device="cpu", mesh=make_mesh(devices=CPU8))


@needs_8
@pytest.mark.parametrize("overlap", [0, 1000])
def test_mesh_session_matches_plain_session(overlap):
    """Session(mesh=…) pads the window batch to a whole number a dp row and
    equals the plain Session bit for bit, for the butt-joined and the
    overlapped (super-resolution) stitch, and the JAX mesh Session."""
    x = (np.arange(10_500) % 2000 - 1000).astype(np.int16)
    ref = Session(_Neg(), _manifest(Manifest, overlap), device="cpu").process(x)
    out = Session(_Neg(), _manifest(Manifest, overlap), mesh=make_mesh(8, devices=CPU8))
    out = out.process(x)
    jout = JSession(lambda p, a: (-a).astype(a.dtype), {}, _manifest(JManifest, overlap),
                    mesh=jparallel.make_mesh(8)).process(x)
    assert out.outputs[0].shape == ref.outputs[0].shape == (10_500,)
    np.testing.assert_array_equal(out.outputs[0], ref.outputs[0])
    np.testing.assert_array_equal(out.outputs[0], jout.outputs[0])


def test_mesh_session_two_sources_and_tp():
    """Tuple outputs gather source by source; a (dp 4, tp 2) mesh replicates
    over tp and serves the same answer."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(21_000) * 3000).astype(np.int16)
    manifest = _manifest(Manifest, sources=2)
    ref = Session(_NegAndHalf(), manifest, device="cpu").process(x)
    for mesh in (make_mesh(8, devices=CPU8), make_mesh(8, tp=2, devices=CPU8)):
        out = Session(_NegAndHalf(), manifest, mesh=mesh).process(x)
        assert len(out.outputs) == 2
        for a, b in zip(out.outputs, ref.outputs):
            np.testing.assert_array_equal(a, b)


@needs_8
@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("dp", [1, 2, 8])
def test_window_geometry_matches_jax(dp, bucket):
    """(w, stride, num, num_padded) for clips of 1 to 37 windows, with and
    without bucketing, as the JAX Session computes them for the same dp."""
    for overlap in (0, 1000):
        jmesh = jparallel.make_mesh(dp) if dp > 1 else None
        tmesh = make_mesh(dp, devices=CPU8) if dp > 1 else None
        js = JSession(lambda p, a: a, {}, _manifest(JManifest, overlap), mesh=jmesh,
                      bucket_windows=bucket, jit=False)
        kw = {"mesh": tmesh} if tmesh is not None else {"device": "cpu"}
        ts = Session(_Neg(), _manifest(Manifest, overlap), bucket_windows=bucket, **kw)
        for n in (1, 3999, 4000, 4001, 10_500, 33_000, 100_000, 140_000):
            assert ts._window_geometry(n) == js._window_geometry(n), (n, overlap)


@needs_8
def test_dp_sharded_gtcrn_matches_single_device():
    """GTCRN at full width on (8, 4096): each dp row on its own device
    entry, gathered in order, within 1 LSB of one call on one device."""
    spec = registry.get("gtcrn")
    cfg = spec.make_config()
    model = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg).eval()
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((8, 4096)) * 6000).astype(np.int16))
    mesh = make_mesh(8, devices=CPU8)
    with torch.inference_mode():
        ref = model(audio).numpy()
        fn = sharded_model_fn(mesh, lambda m, a: m(a))
        out = fn(replicate(mesh, model), shard_batch(mesh, audio)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out.astype(np.int32) - ref.astype(np.int32))) <= 1


def test_shard_batch_and_hint():
    """shard_batch splits the leading axis over dp (and refuses a remainder);
    shard_hint is the identity with or without spmd_mesh."""
    mesh = make_mesh(4, devices=["cpu"] * 4)
    x = torch.arange(24.0).reshape(8, 3)
    shards = shard_batch(mesh, x)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    torch.testing.assert_close(torch.cat(shards), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        shard_batch(mesh, torch.zeros(6, 2))
    assert shard_hint(x, ("dp", "tp")) is x
    with spmd_mesh(mesh):
        assert shard_hint(x, "dp", None) is x


# ── pipeline ───────────────────────────────────────────────────────────────


def _layers_np(depth, dim, seed=7):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((dim, dim)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(dim) * 0.1).astype(np.float32)} for _ in range(depth)]


@needs_8
def test_pp_stack_matches_jax():
    """A depth-8 residual stack over S = 4 stages and M = 4 microbatches:
    the port's fill/drain schedule against the JAX ppermute schedule on the
    virtual mesh, and against the layers run in order."""
    from jax.sharding import Mesh as JMesh

    per_np = _layers_np(8, 16)
    x_np = np.random.default_rng(8).standard_normal((8, 24, 16)).astype(np.float32)

    def jlayer(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def tlayer(p, h):
        return h + torch.tanh(h @ p["w"] + p["b"])

    jmesh = JMesh(np.array(jax.devices()[:4]), ("pp",))
    jstaged = jparallel.stack_layer_params([jax.tree.map(jnp.asarray, p) for p in per_np], 4)
    ref = np.asarray(jparallel.pp_stack(jlayer, jmesh, jstaged, jnp.asarray(x_np),
                                        microbatches=4))

    per = [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_np]
    tmesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("pp",))
    out = pp_stack(tlayer, tmesh, stack_layer_params(per, 4), torch.from_numpy(x_np),
                   microbatches=4).numpy()
    seq = torch.from_numpy(x_np)
    for p in per:
        seq = tlayer(p, seq)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.max(np.abs(ref)))
    np.testing.assert_array_equal(out, seq.numpy())


def test_pp_stack_rejects_bad_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        stack_layer_params([{"w": torch.ones(2, 2)}] * 3, 2)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("pp",))
    staged = stack_layer_params([{"w": torch.ones(2, 2)}] * 4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pp_stack(lambda p, h: h, mesh, staged, torch.ones(6, 2, 2), microbatches=4)


def test_pp_stack_rejects_stage_mesh_mismatch():
    """Stage count != mesh size fails loudly, and microbatches=0 is rejected."""
    mesh = Mesh(np.array(["cpu"] * 2, dtype=object), ("pp",))
    staged4 = stack_layer_params([{"w": torch.ones(2, 2)}] * 8, 4)
    with pytest.raises(ValueError, match="4 stages but mesh"):
        pp_stack(lambda p, h: h, mesh, staged4, torch.ones(4, 2, 2))
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        pp_stack_fn(lambda p, h: h, mesh, microbatches=0)
