"""Probe-training utilities (``vlm_tpu/probing/train/utils.py``): seeds,
class counts and weights, the masked cross-entropy, and the port's probe
checkpoint.

A checkpoint directory holds ``model.safetensors`` (the head's parameters
and running statistics under ``head.``, and the backbone's trainable
parameters under ``backbone.`` when the backbone trains),
``training_state.safetensors`` (AdamW's moments and step per parameter,
by the same names, and the dropout generator's state) and
``training_state.yaml`` (next epoch, best monitor, ``lr_scale``, the
plateau scheduler, run metadata), all written by
:mod:`...utils.safetensors_io` and PyYAML. ``vlm_tpu``'s flax msgpack
files are not read.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

MISSING_LABEL = -1
MODEL_FILE = "model.safetensors"
STATE_FILE = "training_state.safetensors"
STATE_YAML = "training_state.yaml"
GENERATOR_KEY = "_dropout_generator"


def set_seed(seed: int = 42) -> None:
    """Seed python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_num_classes_for_task(task: str) -> int:
    """Task class counts (reference ``utils.py:19-25``)."""
    t = task.lower()
    if t == "gender":
        return 2
    if t == "emotion":
        return 7
    if t == "ethnicity":
        return 4
    if t == "age":
        return 9
    raise ValueError(f"Unrecognized task: {task}")


def targets_to_arrays(targets_list: List[dict],
                      tasks: List[str]) -> Dict[str, np.ndarray]:
    """Target dicts -> int64 arrays, -1 where a label is missing."""
    out = {}
    for task in tasks:
        ys = []
        for t in targets_list:
            v = t.get(task, None) if isinstance(t, dict) else None
            try:
                ys.append(int(v) if v is not None else MISSING_LABEL)
            except (TypeError, ValueError):
                ys.append(MISSING_LABEL)
        out[task] = np.asarray(ys, dtype=np.int64)
    return out


def counts_to_weights(counts: np.ndarray) -> np.ndarray:
    """``w_i = (1/max(c_i,1)) * (C / sum_j 1/max(c_j,1))``: mean 1."""
    counts = np.maximum(counts.astype(np.float64), 1.0)
    inv = 1.0 / counts
    return inv * (len(counts) / inv.sum())


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         class_weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy over targets != -1, class-weighted as
    ``nn.CrossEntropyLoss(weight=w, ignore_index=-1)`` (sum w_y ce / sum
    w_y), computed in fp32. A batch with no valid target gives 0.0, where
    ``F.cross_entropy`` gives NaN."""
    valid = targets != MISSING_LABEL
    safe_t = targets.clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, safe_t[:, None])[:, 0]
    w = class_weights[safe_t] if class_weights is not None \
        else torch.ones_like(ce)
    w = torch.where(valid, w, torch.zeros_like(w))
    denom = w.sum()
    return torch.where(denom > 0, (ce * w).sum() / denom.clamp_min(1e-9),
                       torch.zeros_like(denom))


# ---------------- checkpoint ----------------
def refuse_msgpack(ckpt_dir: Path) -> None:
    """A directory of ``vlm_tpu``'s probe checkpoint cannot be read."""
    for name in ("model.msgpack", "classifier.msgpack",
                 "training_state.msgpack"):
        if (Path(ckpt_dir) / name).exists():
            raise ValueError(
                f"{Path(ckpt_dir) / name} is a vlm_tpu probe checkpoint (flax "
                f"msgpack), which the port does not read; the port's "
                f"checkpoint is {MODEL_FILE} + {STATE_FILE} + {STATE_YAML}")


def save_tensors(path: Path, tensors: Mapping[str, torch.Tensor]) -> None:
    from ...utils.safetensors_io import save_file
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    save_file(dict(tensors), tmp)
    tmp.replace(path)


def load_tensors(path: Path) -> Optional[Dict[str, torch.Tensor]]:
    """Every tensor of one safetensors file on the CPU (None without the
    file)."""
    from ...utils.safetensors_io import open_file
    path = Path(path)
    if not path.exists():
        return None
    return {k: ref.load().clone() for k, ref in open_file(path).items()}


def optimizer_tensors(opt: torch.optim.Optimizer,
                      names: Mapping[torch.nn.Parameter, str]
                      ) -> Dict[str, torch.Tensor]:
    """AdamW's state by parameter name: ``<name>.step``, ``.exp_avg``,
    ``.exp_avg_sq``."""
    out = {}
    for p, st in opt.state.items():
        for k, v in st.items():
            out[f"{names[p]}.{k}"] = torch.as_tensor(v)
    return out


def load_optimizer_tensors(opt: torch.optim.Optimizer,
                           params: Mapping[str, torch.nn.Parameter],
                           blob: Mapping[str, torch.Tensor]) -> None:
    """Fill AdamW's state from :func:`optimizer_tensors`'s names; a
    parameter the blob does not hold starts fresh."""
    for name, p in params.items():
        st = {k: blob[f"{name}.{k}"] for k in ("step", "exp_avg",
                                               "exp_avg_sq")
              if f"{name}.{k}" in blob}
        if not st:
            continue
        opt.state[p] = {k: v.to(p.device) if k != "step" else v.float()
                        for k, v in st.items()}


def save_training_state(ckpt_dir: Path, tensors: Mapping[str, torch.Tensor],
                        next_epoch: int, best_val: float, meta: dict,
                        cfg_path: str, lr_scale: float = 1.0,
                        plateau: Optional[dict] = None) -> None:
    """The ``training_state.pth`` analogue: optimizer (and generator)
    tensors, and the progress in YAML."""
    import yaml
    save_tensors(Path(ckpt_dir) / STATE_FILE, tensors)
    (Path(ckpt_dir) / STATE_YAML).write_text(yaml.safe_dump({
        "epoch": int(next_epoch), "best_val": float(best_val),
        "meta": meta, "config_path": str(cfg_path),
        "lr_scale": float(lr_scale),
        "plateau": {k: float(v) for k, v in (plateau or {}).items()},
    }, sort_keys=False), encoding="utf-8")


def try_resume_training(ckpt_dir: Path):
    """(tensors or None, start_epoch, best_val, lr_scale, plateau)."""
    import yaml
    p = Path(ckpt_dir) / STATE_YAML
    if not p.exists():
        return None, 0, float("inf"), 1.0, {}
    blob = yaml.safe_load(p.read_text(encoding="utf-8")) or {}
    start_epoch = int(blob.get("epoch", 0))
    best_val = float(blob.get("best_val", float("inf")))
    print(f"[RESUME] training state from {p} | start_epoch={start_epoch} "
          f"| best_val={best_val:.6f}")
    return (load_tensors(Path(ckpt_dir) / STATE_FILE), start_epoch, best_val,
            float(blob.get("lr_scale", 1.0)), blob.get("plateau") or {})
