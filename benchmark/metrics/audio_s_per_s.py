"""Seconds of input audio completed in the window over the window's seconds:
a service's throughput per card (its cost).  The window runs from the first
request's start to the end of the last one, so every request counts whole
and all the time counts."""


def read(record):
    reqs = [r for r in record["requests"] if not r["in_slice"]]
    return sum(r["n"] for r in reqs) / record["sample_rate"] / record["window_s"]
