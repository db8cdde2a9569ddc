"""VLM model factory (``vlm_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional

from .base_model import BLIP2OptModel, LLaVAModel, PaLIGemmaModel, VLMModel

_REGISTRY = {"blip2": BLIP2OptModel, "llava": LLaVAModel,
             "paligemma": PaLIGemmaModel}


def create_model(model_name: str, model_id: Optional[str] = None,
                 device=None, quantization: str = "fp32",
                 **kwargs) -> VLMModel:
    """Instantiate a VLM by name ("blip2", "llava" or "paligemma")."""
    name = model_name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"Model '{model_name}' not found. Available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](model_id, device, quantization, **kwargs)
