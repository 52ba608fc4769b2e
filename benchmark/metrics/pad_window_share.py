"""Windows the model ran that were bucket pads, over the windows it ran.
The windows run are counted by a forward pre-hook on the model; the windows
a clip needs follow from its length and the serving geometry."""


def read(record):
    run = sum(r["windows_run"] for r in record["requests"] if r["ok"])
    need = sum(r["windows_needed"] for r in record["requests"] if r["ok"])
    return (run - need) / run if run else None
