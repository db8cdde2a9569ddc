"""Probing (``vlm_tpu/probing``): heads over a vision backbone's pooled
features, the single-task trainer (feature cache or end to end) and
tester."""
