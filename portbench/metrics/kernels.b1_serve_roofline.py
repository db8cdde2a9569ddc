"""B1's share of its roofline at an admission's shapes: the bound of its
calls (EVA's 39 over the image tokens, the Q-Former's self- and
cross-attention, OPT's causal prefill over the prompt rows) for every
admission traced, over the profiled time of B1's kernels, in %."""

import re

from portbench.counts.work import attention, bound_s

B1 = re.compile(r"(?<![A-Za-z0-9_])flash_kernel(_small)?(?![A-Za-z0-9_])")


def admission_bound_s(w: dict, images: int, prompt_rows: int) -> float:
    vis, qf, dec = w["vision"], w["qformer"], w["decoder"]
    s = (vis["image_size"] // vis["patch_size"]) ** 2 + 1
    q = qf["num_query_tokens"]
    calls = [(vis["layers"], attention(images, vis["heads"], vis["heads"],
                                       s, s, vis["hidden"] // vis["heads"])),
             (qf["layers"], attention(images, qf["heads"], qf["heads"], q, q,
                                      qf["hidden"] // qf["heads"])),
             (-(-qf["layers"] // qf["cross_attention_frequency"]),
              attention(images, qf["heads"], qf["heads"], q, s,
                        qf["hidden"] // qf["heads"])),
             (dec["layers"], attention(images, dec["heads"], dec["kv_heads"],
                                       prompt_rows, prompt_rows,
                                       dec["head_dim"], causal=True))]
    return sum(n * bound_s(ops, nb, "bf16") for n, (ops, nb) in calls)


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or tr is None:
        return None
    t = sum(e - s for n, s, e in tr["kernels"] if B1.search(n))
    calls = tr["spans"]["portbench.prefill"]["calls"]
    if not t or not calls:
        return None
    bound = calls * admission_bound_s(rec["widths"], rec["admit_block"],
                                      rec["prompt_rows"])
    return 100.0 * bound / t
