"""The model step's share of the card's float32 peak, in percent: the FLOPs
of the windows the traffic needed (pad windows count no work), counted by
``FlopCounterMode`` over the reference at one window, over the window's
seconds times the peak."""


def read(record):
    if not record.get("peak_flops") or not record.get("flops_per_window"):
        return None
    reqs = [r for r in record["requests"] if r["ok"] and not r["in_slice"]]
    flops = record["flops_per_window"] * sum(r["windows_needed"] for r in reqs)
    return 100.0 * flops / (record["window_s"] * record["peak_flops"])
