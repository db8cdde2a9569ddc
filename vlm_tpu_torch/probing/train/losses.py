"""Multi-task loss balancing (``vlm_tpu/probing/train/losses.py``):
homoscedastic uncertainty weighting and per-task loss EMAs."""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional

import torch


class UncertaintyWeighter:
    """Kendall's homoscedastic weighting, ``L = sum_t exp(-s_t) * L_t +
    0.5 * s_t`` with learnable ``s_t = log sigma_t^2`` (reference
    losses.py:7-31): :meth:`init_params` gives the fp32 scalars, which
    train with the heads."""

    def __init__(self, task_names, init_log_var: float = 0.0):
        self.task_names = list(task_names)
        self.init_log_var = float(init_log_var)

    def init_params(self, device=None) -> Dict[str, torch.Tensor]:
        return {t: torch.tensor(self.init_log_var, dtype=torch.float32,
                                device=device, requires_grad=True)
                for t in self.task_names}

    @staticmethod
    def combine(log_vars: Mapping[str, torch.Tensor],
                loss_dict: Mapping[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for t, loss in loss_dict.items():
            s_t = log_vars[t]
            total = total + torch.exp(-s_t) * loss.mean() + 0.5 * s_t
        return total

    @staticmethod
    def current_weights(log_vars: Mapping[str, torch.Tensor]
                        ) -> Dict[str, float]:
        return {t: float(torch.exp(-v.detach().double()))
                for t, v in log_vars.items()}


class RunningMeans:
    """Per-task EMA of loss values with its history, a plot and JSON
    persistence (reference losses.py:33-122)."""

    def __init__(self, task_names, alpha: float = 0.99):
        self.task_names = list(task_names)
        self.alpha = float(alpha)
        self.values: Dict[str, Optional[float]] = {
            t: None for t in self.task_names}
        self.history: Dict[str, List[float]] = {
            t: [] for t in self.task_names}

    def update(self, losses):
        for idx in range(len(self.task_names)):
            self.update_by_idx(losses[idx], idx)

    def update_by_idx(self, loss_value: float, task_idx: int):
        task = self.task_names[task_idx]
        v = self.values[task]
        new_v = loss_value if v is None else \
            self.alpha * v + (1 - self.alpha) * loss_value
        self.values[task] = new_v
        self.history[task].append(new_v)

    def get(self, task_name: str):
        return self.values.get(task_name, None)

    def get_by_index(self, idx: int):
        return self.values[self.task_names[idx]]

    def plot(self, output_path=None):
        """The history per task as a 1000 x 600 PNG, drawn with Pillow
        (``vlm_tpu`` draws it with matplotlib); nothing without a path."""
        if not output_path:
            return
        from .base_trainer import draw_curves
        draw_curves({t: self.history[t] for t in self.task_names},
                    output_path, title="Running Means per Task Over Time",
                    xlabel="Epoch / Iterations", ylabel="Running Mean Loss",
                    size=(1000, 600))

    def save_history(self, filepath):
        with open(filepath, "w") as f:
            json.dump(self.history, f, indent=2)

    def load_history(self, filepath):
        with open(filepath, "r") as f:
            self.history = json.load(f)
        for task in self.task_names:
            if self.history.get(task):
                self.values[task] = self.history[task][-1]
            else:
                self.values[task] = None
