"""Device ms of the kernels that ran inside the spans around
``VLMModule.prefill`` (the tower, the Q-Former and OPT's prefill), per
image admitted, in the traced stretch."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or tr is None:
        return None
    sp = tr["spans"]["portbench.prefill"]
    if not sp["calls"] or not sp["device_s"]:
        return None
    return 1e3 * sp["device_s"] / (sp["calls"] * rec["admit_block"])
