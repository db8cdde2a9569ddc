"""The model FLOPs of the window's work over the window's seconds times
the bf16 peak, in %: for every image completed in the window its
admission (tower, Q-Former, prefill, the head at its last row) and each
decoded token that took effect (the layers, attention over its live rows,
the head). Guarded steps and idle slots count nothing."""

from portbench.counts.work import PEAKS, serve_admission, serve_token


def read(rec):
    if rec.get("kind") != "serve":
        return None
    w, win, p = rec["widths"], rec["window"], rec["prompt_rows"]
    per_image = serve_admission(w, 1, p)
    flops = 0.0
    for g in win["generated"]:
        flops += per_image + sum(serve_token(w, p + j) for j in range(1, g))
    if not win["seconds"]:
        return None
    return 100.0 * flops / (win["seconds"] * PEAKS["ops_per_s"]["bf16"])
