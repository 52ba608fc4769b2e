"""Median over requests of the wall time of ``Session.process`` less its own
``elapsed_s`` (the model call, its copies and the synchronisation): the
session's slicing, padding, stitching and trimming on the host, over the
window's requests."""
import numpy as np


def read(record):
    host = [r["wall_s"] - r["elapsed_s"] for r in record["requests"]
            if r["ok"] and not r["in_slice"]]
    return float(np.median(host)) * 1e3 if host else None
