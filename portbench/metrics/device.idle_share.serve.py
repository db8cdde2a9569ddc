"""The device's idle share of the window: 1 - the device seconds of the
window's work / the window's seconds. The work is the window's
admissions and dispatched decode steps (the batcher's counts), each at the
device seconds a call of it took in the traced stretch (the kernels inside
the spans around ``VLMModule.prefill`` and ``decode_step``; the rest of an
admission, its rows' copy into the cache, is about 1 % of it and left
out). The profiler slows the host, so the traced stretch's own wall is
never the base."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or tr is None:
        return None
    sp, st = tr["spans"], rec["window"]["stats"]
    per = {}
    for name in ("prefill", "decode_step"):
        s = sp[f"portbench.{name}"]
        if not s["calls"] or not s["device_s"]:
            return None
        per[name] = s["device_s"] / s["calls"]
    busy = st["admits"] * per["prefill"] + \
        (st["steps"] + st["guarded_steps"]) * per["decode_step"]
    return 1.0 - busy / rec["window"]["seconds"]
