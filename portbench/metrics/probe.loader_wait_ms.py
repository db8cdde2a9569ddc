"""The host's wait for each batch from the trainer's loader (the span
around taking it), mean over the window's steps, in ms."""


def read(rec):
    if rec.get("kind") != "probe" or rec["mode"] != "multi":
        return None
    f = rec["window"]["fetch_s"]
    return 1e3 * sum(f) / len(f) if f else None
