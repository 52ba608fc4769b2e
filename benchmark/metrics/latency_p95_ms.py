"""95th percentile (numpy's linear interpolation) of the wall time of every
``Session.process`` call in the window, int16 in to int16 out: what a user
of short clips waits."""
import numpy as np


def read(record):
    walls = [r["wall_s"] for r in record["requests"] if not r["in_slice"]]
    return float(np.percentile(walls, 95)) * 1e3
