"""Evaluation: accuracy / MAE / confusion-matrix artifacts and the
zero-shot driver (the port's copies of ``vlm_tpu/evaluation``)."""

from .evaluator import Evaluator
from .zero_shot import evaluate_outputs, run_zero_shot

__all__ = ["Evaluator", "evaluate_outputs", "run_zero_shot"]
