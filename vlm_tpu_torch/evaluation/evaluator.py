"""Metrics subsystem: accuracy / MAE / confusion matrices + JSON/PNG artifacts.

The port's own copy of ``vlm_tpu/evaluation/evaluator.py``. Where that
module calls scikit-learn, this one computes the same metrics in numpy
(:func:`accuracy_score`, :func:`confusion_matrix`,
:func:`mean_absolute_error`), and where it draws the confusion matrices
with matplotlib this one draws them with Pillow (:func:`draw_confusion_png`,
imported when a PNG is written), so the port needs neither.
``tests/test_torch_shared_layers.py`` holds the artifacts equal to
``vlm_tpu``'s.

Produces the same artifact schema as the reference Evaluator
(`reference/datasets_vlm/evaluate_dataset.py`):

- ``preds.json`` / ``gts.json``: full per-sample label dumps (indent=4);
- ``metrics.json``: ``{task: {"accuracy", "labels"}}``, age as
  ``{"mode": "classification", "accuracy", "labels": AGE_CLASS_NAMES}`` or
  ``{"mode": "regression", "mae"}``, plus ``average_accuracy``;
- ``confusion_matrix_<task>.png`` with per-cell counts.

Semantics preserved: ground-truth ``-1`` rows are skipped per task
(evaluate_dataset.py:80-84); label sets are ``sorted(set(y_true + y_pred))``;
age mode "auto" infers classification iff every value is an integer in 0..8
(evaluate_dataset.py:100-114).

Deviation (documented): relative ``output_dir`` resolves against the project
root (``VLM_TPU_ROOT``/``PYTHONPATH``/cwd) rather than the evaluator package
directory (`evaluate_dataset.py:29` resolves against ``Path(__file__).parent``,
an artifact of the reference's layout). Absolute paths behave identically.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..data.face_dataset import FaceDataset
from ..data.parsers import AGE_CLASS_NAMES


def accuracy_score(y_true: Sequence, y_pred: Sequence) -> float:
    """Share of equal pairs (``sklearn.metrics.accuracy_score``)."""
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def confusion_matrix(y_true: Sequence, y_pred: Sequence,
                     labels: Optional[Sequence] = None) -> np.ndarray:
    """Counts of (true, predicted) pairs over ``labels`` (default: the
    sorted union of both), rows true, columns predicted
    (``sklearn.metrics.confusion_matrix``); pairs outside ``labels`` are
    not counted."""
    labels = sorted(set(y_true) | set(y_pred)) if labels is None else labels
    index = {lab: i for i, lab in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def mean_absolute_error(y_true: Sequence, y_pred: Sequence) -> float:
    """Mean of ``|true - predicted|`` (``sklearn.metrics.mean_absolute_error``)."""
    return float(np.average(np.abs(np.asarray(y_true, dtype=np.float64)
                                   - np.asarray(y_pred, dtype=np.float64))))


# matplotlib's "Blues" colormap at 9 evenly spaced stops (ColorBrewer)
_BLUES = ((247, 251, 255), (222, 235, 247), (198, 219, 239), (158, 202, 225),
          (107, 174, 214), (66, 146, 198), (33, 113, 181), (8, 81, 156),
          (8, 48, 107))


def _blues(frac: float) -> tuple:
    """The colour of ``frac`` in [0, 1] on the Blues ramp."""
    x = min(max(frac, 0.0), 1.0) * (len(_BLUES) - 1)
    i = min(int(x), len(_BLUES) - 2)
    f = x - i
    return tuple(int(round(a + (b - a) * f))
                 for a, b in zip(_BLUES[i], _BLUES[i + 1]))


def draw_confusion_png(cm, labels, title: str, output_path) -> None:
    """A 600 x 500 PNG of the confusion matrix with Pillow: the recipe of
    ``vlm_tpu``'s matplotlib figure (reference
    ``evaluate_dataset.py:52-68``): a Blues heat map with a colour bar,
    predicted labels along x rotated 45 degrees, true labels along y, each
    cell's count in white above half the largest count and black below,
    and the title ``"<TASK> - Acc: <acc>"``."""
    from PIL import Image, ImageDraw, ImageFont

    cm = np.asarray(cm)
    n = max(cm.shape[0], 1)
    font = ImageFont.load_default()
    img = Image.new("RGB", (600, 500), "white")
    draw = ImageDraw.Draw(img)
    left, top, side = 150, 40, 330
    cell = side / n
    vmax = float(cm.max()) if cm.size else 0.0
    thresh = vmax / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            v = float(cm[i, j])
            box = (left + j * cell, top + i * cell,
                   left + (j + 1) * cell, top + (i + 1) * cell)
            draw.rectangle(box, fill=_blues(v / vmax if vmax else 0.0))
            draw.text(((box[0] + box[2]) / 2, (box[1] + box[3]) / 2),
                      str(cm[i, j]), anchor="mm", font=font,
                      fill="white" if v > thresh else "black")
    draw.rectangle((left, top, left + side, top + side), outline="black")
    for i, lab in enumerate(labels):
        mid = top + (i + 0.5) * cell
        draw.text((left - 6, mid), str(lab), anchor="rm", font=font,
                  fill="black")
        # x labels: drawn on their own strip, rotated 45 degrees
        w = int(draw.textlength(str(lab), font=font)) + 4
        strip = Image.new("RGBA", (w, 14), (255, 255, 255, 0))
        ImageDraw.Draw(strip).text((0, 1), str(lab), font=font,
                                   fill="black")
        rot = strip.rotate(45, expand=True)
        x = int(left + (i + 0.5) * cell) - rot.width
        img.paste(rot, (x, top + side + 4), rot)
    draw.text((left + side / 2, 490), "Predicted", anchor="ms", font=font,
              fill="black")
    ylab = Image.new("RGBA", (60, 14), (255, 255, 255, 0))
    ImageDraw.Draw(ylab).text((0, 1), "True", font=font, fill="black")
    ylab = ylab.rotate(90, expand=True)
    img.paste(ylab, (10, int(top + side / 2 - ylab.height / 2)), ylab)
    draw.text((left + side / 2, 20), title, anchor="mm", font=font,
              fill="black")
    # the colour bar, 0 to the largest count
    bx = left + side + 30
    for y in range(side):
        draw.line((bx, top + side - 1 - y, bx + 18, top + side - 1 - y),
                  fill=_blues(y / max(side - 1, 1)))
    draw.rectangle((bx, top, bx + 18, top + side), outline="black")
    for frac in (0.0, 0.5, 1.0):
        draw.text((bx + 24, top + side - frac * side),
                  f"{vmax * frac:g}", anchor="lm", font=font, fill="black")
    img.save(output_path, format="PNG")


def _resolve_output_dir(output_dir) -> Path:
    from ..core.config import project_root
    p = Path(output_dir)
    if p.is_absolute():
        return p
    return project_root() / p


class Evaluator:
    """Static evaluator dispatching on dataset name (MiviaPar vs face)."""

    @staticmethod
    def evaluate(preds: List[Dict[str, Any]], gts: List[Dict[str, Any]],
                 output_dir, dataset_name: str, age_mode: str = "auto"):
        """Evaluate predictions and write artifacts.

        Args:
            preds: per-sample prediction dicts.
            gts: matching ground-truth dicts.
            output_dir: artifact directory (see module docstring for
                relative-path resolution).
            dataset_name: "MiviaPar" or one of ``FaceDataset`` names.
            age_mode: "auto" | "classification" | "regression".
        """
        output_dir = _resolve_output_dir(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

        Evaluator._save_json(preds, output_dir / "preds.json")
        Evaluator._save_json(gts, output_dir / "gts.json")

        if dataset_name == "MiviaPar":
            Evaluator._evaluate_mivia_par(preds, gts, output_dir)
            print(f"[MIVIA PAR] Results saved in {output_dir}")
        elif dataset_name in FaceDataset.get_available_datasets():
            Evaluator._evaluate_face_dataset(preds, gts, output_dir,
                                             age_mode=age_mode)
            print(f"[FACE DATASET] Results saved in {output_dir}")
        else:
            raise ValueError(f"Unknown dataset name: {dataset_name}")

    # ------------------------- helpers -------------------------
    @staticmethod
    def _save_json(data, path: Path):
        try:
            with open(path, "w") as f:
                json.dump(data, f, indent=4)
        except Exception as e:
            # Swallow-and-warn like the reference (evaluate_dataset.py:44-49).
            print(f"[Error] JSON save failed at {path}: {e}")

    @staticmethod
    def _collect_task(preds, gts, task):
        """Pairs where the prediction has the task and gt != -1
        (evaluate_dataset.py:80-84)."""
        y_true, y_pred = [], []
        for p, g in zip(preds, gts):
            if task in p and g.get(task, -1) != -1:
                y_true.append(g[task])
                y_pred.append(p[task])
        return y_true, y_pred

    @staticmethod
    def _plot_confusion_matrix(cm, labels, task, acc, output_path):
        draw_confusion_png(cm, labels, f"{task.upper()} - Acc: {acc:.4f}",
                           output_path)

    # ------------------------- MiviaPar -------------------------
    @staticmethod
    def _evaluate_mivia_par(preds, gts, output_dir: Path):
        metrics: Dict[str, Any] = {}
        accuracies = []
        tasks = preds[0].keys() if preds else []
        for task in tasks:
            y_true, y_pred = Evaluator._collect_task(preds, gts, task)
            if not y_true:
                continue
            acc = accuracy_score(y_true, y_pred)
            cm = confusion_matrix(y_true, y_pred)
            labels = sorted(set(y_true + y_pred))
            accuracies.append(acc)
            metrics[task] = {"accuracy": acc, "labels": labels}
            Evaluator._plot_confusion_matrix(
                cm, labels, task, acc,
                output_dir / f"confusion_matrix_{task}.png")
        metrics["average_accuracy"] = (
            sum(accuracies) / len(accuracies) if accuracies else None)
        Evaluator._save_json(metrics, output_dir / "metrics.json")

    # ------------------------- face datasets -------------------------
    @staticmethod
    def _infer_age_mode_from_values(y_true_age, y_pred_age) -> str:
        """classification iff all valid values are integers in 0..8
        (evaluate_dataset.py:100-114)."""
        vals = [v for v in (y_true_age + y_pred_age) if v is not None]
        if not vals:
            return "regression"
        try:
            as_int = [int(v) for v in vals]
        except (TypeError, ValueError):
            return "regression"
        if all(0 <= v <= 8 for v in as_int) and \
                all(float(v).is_integer() for v in vals):
            return "classification"
        return "regression"

    @staticmethod
    def _evaluate_face_dataset(preds, gts, output_dir: Path,
                               age_mode: str = "auto"):
        metrics: Dict[str, Any] = {}
        accuracies = []
        for task in ["gender", "ethnicity", "emotion"]:
            y_true, y_pred = Evaluator._collect_task(preds, gts, task)
            if y_true:
                acc = accuracy_score(y_true, y_pred)
                cm = confusion_matrix(y_true, y_pred)
                labels = sorted(set(y_true + y_pred))
                metrics[task] = {"accuracy": acc, "labels": labels}
                accuracies.append(acc)
                Evaluator._plot_confusion_matrix(
                    cm, labels, task, acc,
                    output_dir / f"confusion_matrix_{task}.png")

        y_true_age, y_pred_age = [], []
        for p, g in zip(preds, gts):
            if "age" in p and g.get("age", -1) != -1:
                y_true_age.append(g["age"])
                y_pred_age.append(p["age"])

        if y_true_age:
            if age_mode == "auto":
                decided = Evaluator._infer_age_mode_from_values(
                    y_true_age, y_pred_age)
            else:
                decided = age_mode.lower()
                if decided not in {"classification", "regression"}:
                    decided = "regression"

            if decided == "classification":
                y_true_cls = [int(v) for v in y_true_age]
                y_pred_cls = [int(v) for v in y_pred_age]
                acc = accuracy_score(y_true_cls, y_pred_cls)
                cm = confusion_matrix(y_true_cls, y_pred_cls,
                                      labels=list(range(9)))
                metrics["age"] = {"mode": "classification",
                                  "accuracy": acc,
                                  "labels": AGE_CLASS_NAMES}
                accuracies.append(acc)
                Evaluator._plot_confusion_matrix(
                    cm, AGE_CLASS_NAMES, "age", acc,
                    output_dir / "confusion_matrix_age.png")
            else:
                mae = mean_absolute_error(
                    [float(v) for v in y_true_age],
                    [float(v) for v in y_pred_age])
                metrics["age"] = {"mode": "regression", "mae": mae}

        metrics["average_accuracy"] = (
            sum(accuracies) / len(accuracies) if accuracies else None)
        Evaluator._save_json(metrics, output_dir / "metrics.json")
