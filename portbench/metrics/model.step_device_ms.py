"""Device ms of the kernels that ran inside the spans around
``VLMModule.decode_step``, per dispatched step, in the traced stretch."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or tr is None:
        return None
    sp = tr["spans"]["portbench.decode_step"]
    if not sp["calls"] or not sp["device_s"]:
        return None
    return 1e3 * sp["device_s"] / sp["calls"]
