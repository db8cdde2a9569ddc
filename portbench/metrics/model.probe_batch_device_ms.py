"""Device ms of the kernels a training step (multi) or an extraction
batch (frozen) runs, in the traced stretch."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "probe" or tr is None or not tr["kernels"]:
        return None
    t = sum(e - s for _, s, e in tr["kernels"])
    return 1e3 * t / rec["trace_steps"]
