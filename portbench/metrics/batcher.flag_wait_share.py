"""The share of the window the host spent blocked on a decode step's flag
(the batcher's ``flag_wait_s`` over the window's seconds): a host blocked
there enqueues no admission. None where the program keeps no such
counter."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s, secs = rec["window"]["stats"], rec["window"]["seconds"]
    if "flag_wait_s" not in s or not secs:
        return None
    return s["flag_wait_s"] / secs
