"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GiB."""


def read(record):
    return record["window_peak_bytes"] / 2**30 if record["window_peak_bytes"] else None
