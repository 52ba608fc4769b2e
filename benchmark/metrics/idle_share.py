"""1 − the device's busy time (the union of every kernel, copy and fill)
over the traced slice's wall time."""


def read(record):
    s = record["slice"]
    if not s or not s["wall_s"] or not s["busy_s"]:
        return None
    return 1.0 - s["busy_s"] / s["wall_s"]
