"""Zero-shot run driver: one (model, dataset, prompt) inference +
evaluation pass (generate → parse → evaluate), the port's own copy of
``vlm_tpu/evaluation/zero_shot.py``, used by
``vlm_tpu_torch/scripts/prompt_inference.py``."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from .evaluator import Evaluator, _resolve_output_dir


def run_zero_shot(model, dataset, prompt: str, output_dir, *,
                  max_tokens: int = 100,
                  batch_size: Optional[int] = None,
                  limit: Optional[int] = None,
                  progress=None,
                  generation: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Run continuous-batched zero-shot inference over ``dataset`` and write
    evaluator artifacts to ``output_dir`` (None: no artifacts and no
    metrics, as on a mesh's ranks other than 0).

    ``generation`` optionally carries the decoding knobs of the reference's
    ``model.generate`` kwargs surface
    (`reference/models/base_model.py:68-69`): ``num_beams``,
    ``temperature``, ``top_k``, ``top_p``, ``seed`` — forwarded to
    :meth:`VLMModel.generate_dataset`.

    Returns a summary dict with ``metrics``, ``images_requested``,
    ``images_completed``, ``elapsed_sec``, ``images_per_sec`` and
    ``partial`` (True when a KeyboardInterrupt stopped generation early —
    only completed images are evaluated, reference partial-eval semantics).
    """
    n = len(dataset) if limit is None else min(limit, len(dataset))
    paths = dataset.image_paths()[:n]

    gen = dict(generation or {})
    allowed = {"num_beams", "temperature", "top_k", "top_p", "seed"}
    unknown = set(gen) - allowed
    if unknown:
        raise ValueError(f"unknown generation knobs: {sorted(unknown)} "
                         f"(allowed: {sorted(allowed)})")

    t0 = time.perf_counter()
    outputs = model.generate_dataset(paths, prompt, max_tokens=max_tokens,
                                     batch_size=batch_size,
                                     progress=progress, **gen)
    return evaluate_outputs(outputs, dataset, output_dir,
                            time.perf_counter() - t0)


def evaluate_outputs(outputs, dataset, output_dir, elapsed: float
                     ) -> Dict[str, Any]:
    """Parse the texts generated for the first ``len(outputs)`` images of
    ``dataset`` (None: not generated), evaluate the parsed ones into
    ``output_dir`` and return :func:`run_zero_shot`'s summary."""
    n = len(outputs)
    labels = dataset.labels_list()[:n]
    preds, gts = [], []
    for out, label in zip(outputs, labels):
        if out is None:
            continue
        preds.append(dataset.get_labels_from_text_output(out))
        gts.append(label)

    metrics = {}
    if preds and output_dir is not None:
        Evaluator.evaluate(preds, gts, output_dir,
                           dataset_name=dataset.name)
        mfile = _resolve_output_dir(output_dir) / "metrics.json"
        if mfile.exists():
            metrics = json.loads(mfile.read_text())

    done = len(preds)
    return {
        "metrics": metrics,
        "images_requested": n,
        "images_completed": done,
        "elapsed_sec": round(elapsed, 3),
        "images_per_sec": round(done / elapsed, 3) if elapsed > 0 else 0.0,
        "partial": done < n,
    }
