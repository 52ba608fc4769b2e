"""Device time in kernels that are not the port's own (cuBLAS products,
cuDNN convolutions, ATen's elementwise and reductions) over the device's
busy time, in the traced slice."""
from benchmark.trace import PORT


def read(record):
    s = record["slice"]
    if not s or not s["busy_s"] or not s["kernels"]:
        return None
    lib = sum(sec for name, (_, sec) in s["kernels"].items() if not PORT.search(name))
    return lib / s["busy_s"]
