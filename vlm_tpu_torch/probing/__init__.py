"""Probing (``vlm_tpu/probing``): heads over a vision backbone's pooled
features, the single-task trainer (feature cache or end to end), the
multi-task trainer, LoRA adapters on the tower, and both testers."""
