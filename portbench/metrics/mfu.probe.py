"""The FLOPs the window's steps need over the window's seconds times the
fp32 peak (three TF32 products a product: 164.9 TFLOP/s), in %: the
forward, the activation gradients of every block the gradient crosses,
the weight gradients of the trained products only (none when frozen)."""

from portbench.counts.work import PEAKS, probe_step


def read(rec):
    if rec.get("kind") != "probe":
        return None
    win = rec["window"]
    if not win["seconds"]:
        return None
    per_batch = probe_step(rec["widths"], rec["batch"],
                           rec["trained_blocks"], rec["patch_trained"])
    flops = per_batch * win["images"] / rec["batch"]
    return 100.0 * flops / (win["seconds"] *
                            PEAKS["ops_per_s"]["fp32_3xtf32"])
