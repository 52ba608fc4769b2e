"""The STFT kernels' (B1 and B2) share of their roofline, in percent: Σ of
each call's least time over Σ of their device time, in the traced slice;
nothing where their launches are not the reference's calls (a model without
an STFT launches neither)."""
from benchmark.trace import roofline_share

KERNELS = ("stft_kernel", "istft_kernel")
CALLS = ("stft", "istft")


def read(record):
    return roofline_share(record["slice"], KERNELS, CALLS)
