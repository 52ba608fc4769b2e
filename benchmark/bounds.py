"""The card's published peaks, and a call's least time from its work.

A call's least work (its operations, and its bytes with each input read once
and each output written once) is counted by the reference function that
stands in for the kernel (``benchmark.reference``), which records it; its
bound is the larger of the operations at the card's peak for the dtype and
the bytes at the memory rate.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM5 (the part named "H100 80GB HBM3"), dense:
# float32 outside the tensor cores, bf16 on them, HBM3 bandwidth; at the
# card's full 700 W limit (the run prints the limit the card reports)
PEAKS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
}


def peaks(card: str) -> dict:
    """The peaks of the card named ``card``; an unknown card raises."""
    for key, value in PEAKS.items():
        if key in card:
            return value
    raise ValueError(f"no published peaks for {card!r}; known cards: {sorted(PEAKS)}")


def bound_s(ops: float, nbytes: float, peak: dict, dtype: str = "float32") -> float:
    """Least seconds of a call of ``ops`` operations and ``nbytes`` bytes on
    a card with the peaks ``peak``."""
    return max(ops / peak[dtype], nbytes / peak["bytes"])
