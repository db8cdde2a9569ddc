"""The config helpers the port's CLI uses: the port's own copy of
``project_root`` and ``load_config`` from ``vlm_tpu/core/config.py``.
PyYAML is imported only when a config is read or written."""

from __future__ import annotations

import os
from pathlib import Path


def load_config(path) -> dict:
    import yaml
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def save_config(cfg: dict, path) -> None:
    import yaml
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, sort_keys=False, allow_unicode=True)


def project_root() -> Path:
    """Project root from ``VLM_TPU_ROOT``/``PYTHONPATH`` env, else cwd.
    Multi-entry PYTHONPATH uses its first entry."""
    root = os.getenv("VLM_TPU_ROOT")
    if not root:
        root = (os.getenv("PYTHONPATH") or "").split(os.pathsep)[0]
    return Path(root or ".")
