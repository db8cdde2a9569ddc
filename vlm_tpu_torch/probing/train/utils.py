"""Probe-training utilities (``vlm_tpu/probing/train/utils.py``): seeds,
class counts and weights, the per-sample weighted sampler, the masked
cross-entropy, and the port's probe checkpoint.

A checkpoint directory holds ``model.safetensors`` (the head's parameters
and running statistics under ``head.``, and the backbone's trainable
parameters under ``backbone.`` when the backbone trains),
``training_state.safetensors`` (AdamW's moments and step per parameter,
by the same names, and the dropout generator's state) and
``training_state.yaml`` (next epoch, best monitor, ``lr_scale``, the
plateau scheduler, run metadata), all written by
:mod:`...utils.safetensors_io` and PyYAML; a trainer's extra state (the
multi-task trainer's loss EMAs, uncertainty log-variances and
augmentation generator) goes into ``extra_state.json`` beside the model
file. ``vlm_tpu``'s flax msgpack files are not read.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

MISSING_LABEL = -1
MODEL_FILE = "model.safetensors"
STATE_FILE = "training_state.safetensors"
STATE_YAML = "training_state.yaml"
EXTRA_FILE = "extra_state.json"
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


# ---------------- class / sample weights ----------------
def build_per_sample_weights(dataset, tasks: List[str], agg_counts,
                             beta: float = 1.0,
                             eps: float = 1e-8) -> np.ndarray:
    """``w_i ∝ sum_t 1[y_{i,t} != -1] * (1/freq_t)^beta``, normalised to mean
    ~1 (reference utils.py:53-80), from the labels' metadata (no image
    decoded)."""
    tasks = [t.lower() for t in tasks]
    freq = {t: float(max(1, int(np.sum(
        agg_counts.get(t, []) if isinstance(agg_counts, dict) else []))))
        for t in tasks}
    inv_pow = {t: (1.0 / freq[t]) ** beta for t in tasks}
    labels = {t: _labels_for(dataset, t) for t in tasks}
    w = np.zeros(len(dataset), dtype=np.float32)
    for t in tasks:
        w += np.where(labels[t] != MISSING_LABEL, inv_pow[t], 0.0)
    fallback = min(inv_pow.values()) if inv_pow else 1.0
    w = np.where(w <= 0.0, fallback, w)
    return w / (float(np.mean(w)) + eps)


def _labels_for(dataset, task: str) -> np.ndarray:
    """``task``'s labels of every sample: the dataset's metadata
    (``get_all_labels``) where it has it, else each sample's label dict."""
    if hasattr(dataset, "get_all_labels"):
        try:
            arr = np.asarray(dataset.get_all_labels(task),
                             dtype=np.int64).reshape(-1)
            if arr.shape[0] == len(dataset):
                return arr
        except (KeyError, TypeError, ValueError):
            pass
    out = np.full(len(dataset), MISSING_LABEL, dtype=np.int64)
    for i in range(len(dataset)):
        sample = dataset[i]
        lab = sample[1] if isinstance(sample, (tuple, list)) else \
            sample.get("labels", {}) if isinstance(sample, dict) else {}
        try:
            out[i] = int(lab.get(task, MISSING_LABEL)) \
                if isinstance(lab, dict) else MISSING_LABEL
        except (TypeError, ValueError):
            out[i] = MISSING_LABEL
    return out


def build_weighted_sampler(
    dataset,
    task_class_weights: Dict[str, Optional[np.ndarray]],
    *,
    combine: str = "mean",
    min_weight: float = 1e-4,
    normalize: bool = True,
    replacement: bool = True,
    seed: int = 0,
) -> Tuple["WeightedSampler", np.ndarray]:
    """A per-sample weighted sampler from per-task class weights
    (reference utils.py:122-215): a sample's weight is the mean (or max)
    of its valid labels' class weights, ``min_weight`` without one.
    Returns ``(sampler, weights)``."""
    tasks = list(task_class_weights.keys())
    n = len(dataset)
    labels_per_task = {t: _labels_for(dataset, t) for t in tasks}
    weights = np.zeros(n, dtype=np.float32)
    n_parts = np.zeros(n, dtype=np.int32)
    for t in tasks:
        table = task_class_weights.get(t)
        if table is None:
            continue
        table = np.asarray(table, dtype=np.float32).ravel()
        lab = labels_per_task[t]
        valid = (lab != MISSING_LABEL) & (lab >= 0) & (lab < len(table))
        w_t = np.where(valid, table[np.clip(lab, 0, len(table) - 1)], 0.0)
        if combine == "max":
            weights = np.maximum(weights, w_t)
        else:
            weights += w_t
        n_parts += valid.astype(np.int32)
    if combine == "mean":
        weights = np.where(n_parts > 0, weights / np.maximum(n_parts, 1),
                           weights)
    weights = np.where(n_parts == 0, min_weight, weights)
    if normalize:
        weights = weights / max(float(weights.mean()), 1e-8)
    return WeightedSampler(weights, num_samples=n, replacement=replacement,
                           seed=seed), weights


class WeightedSampler:
    """``WeightedRandomSampler`` in numpy: each iteration draws
    ``num_samples`` indices in proportion to ``weights`` from
    ``numpy.random.default_rng(seed)``, draw for draw as ``vlm_tpu``'s."""

    def __init__(self, weights: np.ndarray, num_samples: int,
                 replacement: bool = True, seed: int = 0):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.p = self.weights / self.weights.sum()
        self.num_samples = num_samples
        self.replacement = replacement
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = self._rng.choice(len(self.p), size=self.num_samples,
                               replace=self.replacement, p=self.p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         class_weights: Optional[torch.Tensor] = None,
                         mesh=None) -> torch.Tensor:
    """Mean cross-entropy over targets != -1, class-weighted as
    ``nn.CrossEntropyLoss(weight=w, ignore_index=-1)`` (sum w_y ce / sum
    w_y), computed in fp32. A batch with no valid target gives 0.0, where
    ``F.cross_entropy`` gives NaN. With ``mesh`` (this data rank's rows of
    the batch) both sums are summed over ``data``: every rank gets the
    whole batch's loss."""
    valid = targets != MISSING_LABEL
    safe_t = targets.clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, safe_t[:, None])[:, 0]
    w = class_weights[safe_t] if class_weights is not None \
        else torch.ones_like(ce)
    w = torch.where(valid, w, torch.zeros_like(w))
    num, denom = (ce * w).sum(), w.sum()
    if mesh is not None and mesh.data > 1:
        from ...core.mesh import DATA_AXIS
        num, denom = mesh.sum(torch.stack([num, denom]), DATA_AXIS)
    return torch.where(denom > 0, num / denom.clamp_min(1e-9),
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
