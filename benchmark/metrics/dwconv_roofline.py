"""The depthwise kernels' share of their roofline, in percent: Σ of each
call's least time (``benchmark.bounds``) over Σ of the device time of the
kernels named here, in the traced slice.  B4 (depthwise) and B5 (two lanes a
group, one output) in float32.  Nothing is read where the trace's launches
of these kernels are not the calls the reference made at the same batches."""
from benchmark.trace import roofline_share

KERNELS = ("dwconv_kernel", "dwconv_grouped_kernel")
CALLS = ("dwconv", "dwconv_grouped")


def read(record):
    return roofline_share(record["slice"], KERNELS, CALLS)
