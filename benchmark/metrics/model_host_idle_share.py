"""The device's idle seconds in the traced slice while the host was in the
model's Python, over the slice's wall time: the idle gaps named by a port
span ``model.*`` (a stage of the forward, or the model call around them).
Gaps under a torch or CUDA runtime op stay unattributed.  None as for
``session_idle_share``."""
from benchmark.metrics.session_idle_share import share


def read(record):
    return share(record, "model.")
