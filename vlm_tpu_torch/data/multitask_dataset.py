"""Multi-task dataset composition: the port's own copy of
``MultiTaskDataset`` from ``vlm_tpu/data/multitask_dataset.py`` (a
concatenation of datasets with per-task label and class-count metadata
read without decoding images), which the single-task trainer builds its
data through. ``BalancedMultiTaskDataset`` waits for the multi-task
trainer (ROADMAP A16b).
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

MISSING_LABEL = -1


def _labels_from_raw_sample(sample: Any) -> Optional[Dict[str, Any]]:
    """Labels dict from a *raw* sample without opening images
    (reference: multitask_dataset.py:14-25)."""
    if isinstance(sample, dict) and "labels" in sample:
        return sample["labels"]
    if isinstance(sample, (tuple, list)) and len(sample) >= 2:
        return sample[1]
    return None


def _extract_label(labels: Any, task: str) -> int:
    """Integer label for ``task``; floats (regression age) count as valid iff
    >= 0 and are truncated; anything else missing → -1
    (reference: multitask_dataset.py:28-51)."""
    missing = MISSING_LABEL
    if isinstance(labels, dict):
        v = labels.get(task, missing)
    else:
        order = ["gender", "age", "ethnicity", "emotion"]
        if isinstance(labels, (list, tuple)) and task in order:
            idx = order.index(task)
            v = labels[idx] if idx < len(labels) else missing
        else:
            v = missing
    try:
        if isinstance(v, float):
            return missing if v < 0 else int(v)
        return int(v)
    except (TypeError, ValueError, OverflowError):
        return missing


class MultiTaskDataset:
    """Concatenation of several :class:`BaseDataset` with per-task utilities:

    - ``get_all_labels(task)``: per-sample labels read from ``ds.samples``
      metadata — no image decoding (reference: multitask_dataset.py:77-106);
    - ``get_train_class_counts(task)``: aggregated per-class counts with
      pad/truncate alignment (reference: multitask_dataset.py:108-132).

    Dataset dedup across tasks is handled by the factory.
    """

    def __init__(self, datasets: List[Any], *, tasks: Iterable[str]) -> None:
        if not datasets:
            raise ValueError("datasets must be a non-empty list")
        self.datasets = list(datasets)
        self.tasks: List[str] = [t.lower().strip() for t in tasks]
        self.dataset_names: List[str] = [
            getattr(d, "name", type(d).__name__) for d in self.datasets]
        self._cum: List[int] = list(np.cumsum([len(d) for d in self.datasets]))
        self._labels_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return self._cum[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if not (0 <= idx < len(self)):
            raise IndexError(idx)
        ds_idx = bisect.bisect_right(self._cum, idx)
        inner = idx if ds_idx == 0 else idx - self._cum[ds_idx - 1]
        return self.datasets[ds_idx][inner]

    # ----------------------- bulk metadata -----------------------
    def _locate(self, idx: int) -> Tuple[int, int]:
        ds_idx = bisect.bisect_right(self._cum, idx)
        inner = idx if ds_idx == 0 else idx - self._cum[ds_idx - 1]
        return ds_idx, inner

    def resolve_image_path(self, idx: int):
        ds_idx, inner = self._locate(idx)
        return self.datasets[ds_idx].resolve_image_path(inner)

    def image_paths(self) -> List[Any]:
        out: List[Any] = []
        for ds in self.datasets:
            out.extend(ds.image_paths())
        return out

    def labels_list(self) -> List[Any]:
        out: List[Any] = []
        for ds in self.datasets:
            if hasattr(ds, "labels_list"):
                out.extend(ds.labels_list())
            else:
                out.extend(_labels_from_raw_sample(s) for s in ds.samples)
        return out

    def get_all_labels(self, task: str) -> np.ndarray:
        t = task.lower().strip()
        if t in self._labels_cache:
            return self._labels_cache[t]
        arrays: List[np.ndarray] = []
        for ds in self.datasets:
            if hasattr(ds, "samples"):
                raw_list = ds.samples
                labels = np.fromiter(
                    (_extract_label(_labels_from_raw_sample(s) or {}, t)
                     for s in raw_list),
                    dtype=np.int64, count=len(raw_list))
                arrays.append(labels)
            else:
                arr = np.full(len(ds), MISSING_LABEL, dtype=np.int64)
                for i in range(len(ds)):
                    lbls = _labels_from_raw_sample(ds[i]) or {}
                    arr[i] = _extract_label(lbls, t)
                arrays.append(arr)
        out = np.concatenate(arrays) if arrays else np.zeros(0, dtype=np.int64)
        self._labels_cache[t] = out
        return out

    def get_train_class_counts(self, task: str) -> Optional[np.ndarray]:
        agg: Optional[np.ndarray] = None
        for ds in self.datasets:
            raw = (ds.get_train_class_counts(task)
                   if hasattr(ds, "get_train_class_counts") else None)
            if raw is None:
                continue
            arr = np.asarray(raw, dtype=np.int64).ravel()
            if agg is None:
                agg = np.zeros_like(arr, dtype=np.int64)
            if arr.size > agg.size:
                tmp = np.zeros(arr.size, dtype=np.int64)
                tmp[:agg.size] = agg
                agg = tmp
            elif arr.size < agg.size:
                tmp = np.zeros(agg.size, dtype=np.int64)
                tmp[:arr.size] = arr
                arr = tmp
            agg += arr
        return agg
