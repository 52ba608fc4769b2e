"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library, ``_build/<name>-<hash>.so`` inside this package, where the
hash covers the sources and the compiler flags.  A library is built at first
use: to a per-process temporary path, then renamed into place, so concurrent
processes never load a half-written file.

A failed build raises.  Nothing falls back to the plain PyTorch versions.

Each routing point (the ``fast_*`` functions of ``stft_cuda``, ``dwconv_cuda``
and ``attention_cuda``) is also a registered operator,
``torch.ops.audiojax_torch.<name>`` (``torch.library.custom_op``), which a
``torch.export`` graph records in place of the launcher: its CUDA tensors
launch the same ctypes launcher and count the same launch, its CPU tensors
take the plain version, and its fake implementation gives the output's shape
and dtype from the arguments alone (no launch plan, which branches on the
batch size).  Eager calls keep the direct launcher, and pay no dispatcher
cost: a routing point calls its operator only where :func:`through_ops` says
so, while ``torch.export`` traces or inside :func:`registered_ops`.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "DTYPES", "count", "load", "load_source", "through_ops",
           "registered_ops", "loops_as_scan"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the kernels' element types: a tensor dtype → the suffix of its C entry points
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_force_ops = contextvars.ContextVar("audiojax_torch_registered_ops", default=False)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc (CUDA toolkit)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # headers shared between sources count too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(src: Path, so: Path, what: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.build{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {what} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    so = _library_path(name)
    if not so.exists():
        _compile(CSRC / f"{name}.cu", so, f"csrc/{name}.cu")
    return ctypes.CDLL(str(so))


def load_source(name: str, text: str) -> ctypes.CDLL:
    """A library built from the CUDA source ``text`` (a variant of a source in
    ``csrc/``, or a measurement kernel), as ``_build/<name>-<hash>.so``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + text.encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{h}.so"
    if not so.exists():
        src = so.with_suffix(f".build{os.getpid()}.cu")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        try:
            _compile(src, so, f"{name} (a source text)")
        finally:
            src.unlink(missing_ok=True)
    return ctypes.CDLL(str(so))


def count(launches: dict, name: str, dtype: torch.dtype) -> None:
    """One launch of ``name``'s kernel on ``dtype`` inputs into ``launches``:
    a bf16 instance counts under ``<name>_bf16``."""
    launches[name if dtype == torch.float32 else f"{name}_bf16"] += 1


def through_ops() -> bool:
    """True where a routing point calls its registered operator: while
    ``torch.export`` traces, or inside :func:`registered_ops`."""
    return _force_ops.get() or torch.compiler.is_exporting()


def loops_as_scan() -> bool:
    """True where the model code's time loops (``nn.rnn``, NKF-AEC's Kalman
    recurrence) run as torch's scan operator: while ``torch.export`` traces,
    and only then.  Eager forwards, :func:`registered_ops` among them, keep
    the Python loops."""
    return torch.compiler.is_exporting()


@contextlib.contextmanager
def registered_ops():
    """Eager calls go through the registered operators too (the FLOP count of
    ``utils.inspect_model``, the operators' host cost in ``chip_smoke.py``)."""
    token = _force_ops.set(True)
    try:
        yield
    finally:
        _force_ops.reset(token)
