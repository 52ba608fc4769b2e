"""The device's idle seconds in the traced slice while the host was in the
session's own work, over the slice's wall time: the idle gaps named by a
port span ``session.*`` (conditioning, slicing, the copies to and from the
card, the stitch).  None where there is no slice, and where no gap is named
by a ``session.`` span: a program that carries no spans."""


def share(record, prefix: str):
    """Idle seconds of the gaps whose label starts with ``prefix`` over the
    slice's wall time, under the conditions above."""
    s = record["slice"]
    if not s or not s["wall_s"] or not any(k.startswith("session.") for k in s["gaps"]):
        return None
    return sum(sec for k, sec in s["gaps"].items() if k.startswith(prefix)) / s["wall_s"]


def read(record):
    return share(record, "session.")
