"""Device resolution for the port's entry points.

Every entry point (``Session``, ``init_gtcrn``, ``params_from_numpy``, the
CLI) takes ``device=None``, which means the card.  Without CUDA that raises
instead of falling back to the CPU: a caller who wants the CPU says
``device="cpu"``.

On the card the float32 plans run in true float32.  Matrix products already
do by default, but cuDNN convolutions default to TF32, which keeps about
three decimal digits; the JAX package runs its DFTs at
``Precision.HIGHEST``, and the int16 output contract needs full float32.
The bf16 plans' matrix products sum in float32: by default cuBLAS may reduce
a bf16 GEMM in bf16 (``allow_bf16_reduced_precision_reduction``), where the
JAX contract accumulates in float32.
"""
from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "card_line", "peak_flops"]

# published dense peaks (NVIDIA data sheets), FLOP/s by the card's name:
# float32 outside the tensor cores (TF32 is off, above) and bf16 on them
PEAK_FLOPS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12},  # SXM5
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12},
}


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run the port on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use \"cuda\" or \"cpu\"")
    return dev


def card_line(device=None) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its line for the
    device's index); ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_flops(device, dtype: str) -> float:
    """The card's peak FLOP/s for ``dtype`` ("float32" or "bfloat16"), from
    its name; an unknown card raises rather than assuming one."""
    name = torch.cuda.get_device_name(torch.device(device))
    for key, peaks in PEAK_FLOPS.items():
        if key in name:
            return peaks[dtype]
    raise ValueError(f"no peak FLOP/s known for {name!r}; known cards: {sorted(PEAK_FLOPS)}")
