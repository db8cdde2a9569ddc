"""The device's idle share of the window: 1 - (device busy seconds a
step, or an extraction batch, from the traced stretch) x (the window's
steps or batches) / (the window's seconds)."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "probe" or tr is None or not tr["busy_s"]:
        return None
    win = rec["window"]
    n = win["batches"] if rec["mode"] == "frozen" else win["steps"]
    return 1.0 - tr["busy_s"] / rec["trace_steps"] * n / win["seconds"]
