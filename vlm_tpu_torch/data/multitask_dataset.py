"""Multi-task dataset composition: the port's own copy of
``vlm_tpu/data/multitask_dataset.py``: ``MultiTaskDataset`` (a
concatenation of datasets with per-task label and class-count metadata
read without decoding images), which both trainers build their data
through, and ``BalancedMultiTaskDataset``, the multi-task trainer's
training set (samples with a task's label duplicated up to a fraction).
"""

from __future__ import annotations

import bisect
import random
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

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


class BalancedMultiTaskDataset:
    """Wraps a base dataset and *duplicates* samples with a valid label per
    task until a desired valid fraction is met
    (reference: multitask_dataset.py:139-241).

    The extended index is ``[(base_idx, is_dup)]``; ``duplicate_transform``
    applies to duplicated samples only. ``to_add = round((d·N − c)/(1 − d))``
    (reference: multitask_dataset.py:235). The draws come from an instance
    ``random.Random(random_seed)``, so a seed gives ``vlm_tpu``'s index.
    """

    def __init__(
        self,
        base_dataset: Any,
        *,
        tasks: Iterable[str],
        desired_fractions: Dict[str, float],
        duplicate_transform: Optional[Callable[[Any], Any]] = None,
        random_seed: Optional[int] = 0,
    ) -> None:
        self.base = base_dataset
        self.tasks = [t.lower().strip() for t in tasks]
        self.desired = {k.lower().strip(): float(v)
                        for k, v in desired_fractions.items()}
        self._dup_tf = duplicate_transform
        self._rng = random.Random(int(random_seed)) \
            if random_seed is not None else random.Random()
        self._labels_cache: Dict[str, np.ndarray] = {
            t: self._compute_labels(t) for t in self.tasks}
        self._index: List[Tuple[int, bool]] = [
            (i, False) for i in range(len(self.base))]
        self._apply_balancing()

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int):
        idx, is_dup = self._index[i]
        sample = self.base[idx]
        if is_dup and self._dup_tf is not None:
            if isinstance(sample, (tuple, list)) and len(sample) >= 2:
                return (self._dup_tf(sample[0]), sample[1])
            return self._dup_tf(sample)
        return sample

    # --------- bulk metadata (extended index order) ---------
    def extended_index(self) -> List[Tuple[int, bool]]:
        return list(self._index)

    def get_all_labels(self, task: str) -> np.ndarray:
        t = task.lower().strip()
        base = self._labels_cache.get(t)
        if base is None:
            base = self._compute_labels(t)
        return np.asarray([base[i] for i, _ in self._index], dtype=np.int64)

    def labels_list(self) -> List[Any]:
        base = self.base.labels_list() if hasattr(self.base, "labels_list") \
            else [_labels_from_raw_sample(self.base[i])
                  for i in range(len(self.base))]
        return [base[i] for i, _ in self._index]

    def image_paths(self) -> List[Any]:
        base = self.base.image_paths()
        return [base[i] for i, _ in self._index]

    # ------------------------------ internals ------------------------------
    def _compute_labels(self, t: str) -> np.ndarray:
        if hasattr(self.base, "get_all_labels"):
            arr = np.asarray(self.base.get_all_labels(t), dtype=np.int64)
        else:
            arr = np.asarray([_extract_label(
                _labels_from_raw_sample(self.base[i]) or {}, t)
                for i in range(len(self.base))], dtype=np.int64)
        if arr.ndim != 1 or len(arr) != len(self.base):
            raise ValueError(f"{t}: {arr.shape} labels for "
                             f"{len(self.base)} samples")
        return arr

    def _apply_balancing(self) -> None:
        original_len = len(self._index)
        for t, desired in self.desired.items():
            if not (0.0 < desired < 1.0):
                raise ValueError(
                    f"desired_fractions['{t}'] must be in (0,1), got "
                    f"{desired}")
            if t not in self.tasks:
                # the multi-task trainer always asks for emotion balancing;
                # a run without that task has nothing to balance
                continue
            labels = self._labels_cache[t]
            valid_idx = [i for i, v in enumerate(labels)
                         if int(v) != MISSING_LABEL]
            c = len(valid_idx)
            frac = c / float(original_len) if original_len > 0 else 0.0
            if frac >= desired or original_len == 0:
                continue
            to_add = int(round((desired * original_len - c)
                               / max(1e-8, 1.0 - desired)))
            if to_add <= 0:
                continue
            chosen = self._rng.choices(valid_idx, k=to_add)
            self._index.extend((j, True) for j in chosen)
        self._rng.shuffle(self._index)
