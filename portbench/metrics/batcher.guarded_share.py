"""The share of dispatched decode steps that took no effect (the batcher's
``guarded_steps`` over ``steps + guarded_steps``), over the window."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["window"]["stats"]
    n = s["steps"] + s["guarded_steps"]
    return s["guarded_steps"] / n if n else None
