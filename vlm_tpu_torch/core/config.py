"""The config helpers the port's CLIs use: the port's own copy of
``vlm_tpu/core/config.py`` (``project_root``, ``load_config``, the
``common`` + profile deep merge of the probing configs, and their run
names). PyYAML is imported only when a config is read or written."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict


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


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive merge: ``override`` values replace/extend ``base``
    (reference: scripts/train_probe.py:14-24)."""
    if not isinstance(base, dict) or not isinstance(override, dict):
        return override
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def build_cfg_from_profile(yaml_cfg: dict, profile: str, cfg_path,
                           *, require_eval: bool = False) -> dict:
    """``deep_merge(common, yaml_cfg[profile])`` with the reference's minimal
    constraint checks (scripts/train_probe.py:26-41, test_probe.py:25-34)."""
    if profile not in ("single", "multi"):
        raise ValueError("profile must be 'single' or 'multi'")
    common = yaml_cfg.get("common", {})
    branch = yaml_cfg.get(profile, {})
    cfg = deep_merge(common, branch)
    if require_eval:
        if "eval" not in cfg:
            raise ValueError(
                "the selected section must define 'eval' "
                "(ckpt_from, dataset_name)")
    else:
        if profile == "single":
            if "task" not in cfg:
                raise ValueError("section 'single' must define 'task'")
        else:
            if "tasks" not in cfg or not cfg["tasks"]:
                raise ValueError("section 'multi' must define 'tasks' (list)")
            cfg["tasks"] = [str(t).lower() for t in cfg["tasks"]]
    cfg["_cfg_path"] = str(cfg_path)
    return cfg


def make_run_name(cfg: Dict[str, Any], trainer_name: str) -> str:
    """``<model>_<quant>_<task(s)>_<linear|deeper>[_uw]``
    (reference: scripts/train_probe.py:43-57)."""
    m = cfg["model"]
    model_name = m["name"]
    quantization = m.get("quantization")
    head_tag = "deeper" if bool(m.get("deeper_head", False)) else "linear"
    if trainer_name == "multi":
        tasks = [t.lower() for t in cfg["tasks"]]
        uw_cfg = (cfg["train"].get("uncertainty_weighting") or {})
        uw_flag = "_uw" if bool(uw_cfg.get("enabled", False)) else ""
        return (f"{model_name}_{quantization}_{'-'.join(tasks)}_{head_tag}"
                f"{uw_flag}")
    task = str(cfg.get("task", "task")).lower()
    return f"{model_name}_{quantization}_{task}_{head_tag}"
