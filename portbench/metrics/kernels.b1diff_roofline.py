"""B1-diff's share of its roofline in a training step: the bound of the
forward and of the backward at the tower's shape (every block the
gradient crosses; fp32, three TF32 products each) over the profiled time
of the fp32 forward kernel and the three backward kernels, in %."""

import re

from portbench.counts.work import attention_diff, bound_s

KERNELS = re.compile(r"(?<![A-Za-z0-9_])(flash_fp32_kernel|delta_kernel|"
                     r"dkv_kernel|dq_kernel)(?![A-Za-z0-9_])")


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "probe" or rec["mode"] != "multi" or tr is None:
        return None
    t = sum(e - s for n, s, e in tr["kernels"] if KERNELS.search(n))
    if not t:
        return None
    vis = rec["widths"]["vision"]
    s = (vis["image_size"] // vis["patch_size"]) ** 2 + 1
    w = attention_diff(rec["batch"], vis["heads"], vis["heads"], s, s,
                       vis["hidden"] // vis["heads"])
    crossed = vis["layers"] if rec["patch_trained"] else rec["trained_blocks"]
    per_step = crossed * sum(bound_s(*w[k], "fp32_3xtf32")
                             for k in ("fwd", "bwd"))
    return 100.0 * per_step * rec["trace_steps"] / t
