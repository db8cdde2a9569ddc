"""The architecture configurations, shared with ``vlm_tpu``.

``vlm_tpu/models/configs.py`` is pure dataclasses, but its package's
``__init__`` imports flax, so the file is loaded here by path: the port
uses the very same ``ViTConfig``/``DecoderConfig``/``VLMConfig`` values
without importing JAX.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "vlm_tpu_torch.models._shared_configs"
_PATH = Path(__file__).resolve().parents[2] / "vlm_tpu" / "models" / "configs.py"

if _NAME in sys.modules:
    _shared = sys.modules[_NAME]
else:
    _spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    _shared = importlib.util.module_from_spec(_spec)
    sys.modules[_NAME] = _shared      # dataclasses resolve their module
    _spec.loader.exec_module(_shared)

ViTConfig = _shared.ViTConfig
DecoderConfig = _shared.DecoderConfig
QFormerConfig = _shared.QFormerConfig
VLMConfig = _shared.VLMConfig
VLM_CONFIGS = _shared.VLM_CONFIGS
paligemma_config = _shared.paligemma_config
llava_config = _shared.llava_config
blip2_config = _shared.blip2_config

__all__ = ["ViTConfig", "DecoderConfig", "QFormerConfig", "VLMConfig",
           "VLM_CONFIGS", "paligemma_config", "llava_config", "blip2_config"]
