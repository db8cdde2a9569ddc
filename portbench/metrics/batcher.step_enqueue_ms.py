"""The host's seconds to enqueue one dispatched decode step (the batcher's
``step_enqueue_s``, a chunk's dispatch less its blocking flag waits, over
``steps + guarded_steps``), over the window, in ms, to set beside
``model.step_device_ms``. None where the program keeps no such counter."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["window"]["stats"]
    n = s["steps"] + s["guarded_steps"]
    if "step_enqueue_s" not in s or not n:
        return None
    return 1e3 * s["step_enqueue_s"] / n
