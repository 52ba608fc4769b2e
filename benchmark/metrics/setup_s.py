"""Set-up seconds: from the process's start to the first timed request
(imports, the kernels' builds or loads, the weights drawn on the card, the
session built and every window bucket of the traffic served twice)."""


def read(record):
    return record["setup_s"]
