"""Device kernel launches in the traced slice over the model windows run
there (copies and fills are not kernels)."""


def read(record):
    s = record["slice"]
    if not s or not s["launches"] or not s["windows_run"]:
        return None
    return s["launches"] / s["windows_run"]
