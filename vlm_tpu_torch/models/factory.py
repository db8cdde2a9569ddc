"""VLM model factory (``vlm_tpu/models/factory.py``)."""

from __future__ import annotations

from typing import Optional

from .base_model import LLaVAModel, PaLIGemmaModel, VLMModel

_REGISTRY = {"llava": LLaVAModel, "paligemma": PaLIGemmaModel}
_LATER = {"blip2": "ROADMAP A13"}


def create_model(model_name: str, model_id: Optional[str] = None,
                 device=None, quantization: str = "fp32",
                 **kwargs) -> VLMModel:
    """Instantiate a VLM by name ("llava" or "paligemma"; "blip2" is not
    ported yet)."""
    name = model_name.lower()
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"({_LATER[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"Model '{model_name}' not found. Available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](model_id, device, quantization, **kwargs)
