"""What the probing cells on EVA ViT-g in fp32 share: the spans and the
window. The cells' drivers are ``probe_multi.py`` (the multi-task trainer)
and ``probe_frozen.py`` (the frozen tower's feature extraction).

The window opens after set-up and closes at the end of the first step (a
training step, or an extraction call) that ends ``--seconds`` after it
opened. A traced run then profiles further steps."""

from __future__ import annotations

import time

SPANS = ("portbench.loader_next", "portbench.train_step",
         "portbench.extract_call")


def window(ctx, fetch, step):
    """Steps from now until the first that ends ``ctx.seconds`` after the
    first began. ``step(item)`` ends with its results on the host."""
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0
    fetch_s, images, n, failed = [], 0, 0, 0
    while True:
        a = time.perf_counter()
        item = fetch()
        fetch_s.append(time.perf_counter() - a)
        ok, rows = step(item), rows_of(item)
        n += 1
        images += rows
        failed += 0 if ok else 1
        end = time.perf_counter()
        if end - t_open >= ctx.seconds:
            break
    return ({"setup_s": setup_s, "seconds": end - t_open, "steps": n,
             "images": images, "fetch_s": fetch_s}, failed)


def rows_of(item) -> int:
    if isinstance(item, list):          # an extraction call's file list
        return len(item)
    return len(item.targets)
