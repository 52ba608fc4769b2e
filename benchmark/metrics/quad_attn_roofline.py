"""The relu² attention kernel's (B6, float32) share of its roofline, in
percent: Σ of each call's least time over Σ of its device time, in the
traced slice; nothing where its launches are not the reference's calls."""
from benchmark.trace import roofline_share

KERNELS = ("quad_attention_kernel",)
CALLS = ("quad_attention",)


def read(record):
    return roofline_share(record["slice"], KERNELS, CALLS)
