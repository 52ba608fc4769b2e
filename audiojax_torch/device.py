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

import torch

__all__ = ["resolve_device"]


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
