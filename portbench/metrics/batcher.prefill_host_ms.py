"""The host's seconds in the model's prefill inside an admission (the
batcher's ``prefill_s`` over its ``admits``), over the window, in ms: its
enqueue of the tower, the Q-Former and the decoder's prefill, to set
beside ``model.admit_device_ms`` times the admission block. None where the
program keeps no such counter."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["window"]["stats"]
    if "prefill_s" not in s or not s["admits"]:
        return None
    return 1e3 * s["prefill_s"] / s["admits"]
