"""The host's seconds to enqueue one admission (the batcher's ``admit_s``
over its ``admits``), over the window, in ms."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["window"]["stats"]
    return 1e3 * s["admit_s"] / s["admits"] if s["admits"] else None
