"""Dataset registry and task-to-datasets map: the port's own copy of
``vlm_tpu/data/dataset_factory.py``.

``DatasetFactory.create_dataset(name, split, base_path, transform)``
builds a registered face or MiviaPar dataset, with the same registry, the
same duplicate-registration check and the same error for an unknown name.
``load_task_map`` reads the mandatory ``configs/task_datasets.yaml`` under
the project root (cached per resolved path, with the same validation);
``create_multi_task_dataset`` instantiates the datasets a list of tasks
needs once each, concatenated, with per-task class counts
(:func:`aggregate_counts_from_datasets`);
``create_balanced_multi_task_dataset`` wraps that in the duplication
balancer (the base dataset's counts returned).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Type

import numpy as np

from .face_dataset import FaceDataset
from .mivia_par_dataset import MiviaParDataset
from .multitask_dataset import BalancedMultiTaskDataset, MultiTaskDataset


def aggregate_counts_from_datasets(
    ds, task: str, num_classes: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Sum per-class counts for ``task`` over all sub-datasets of ``ds``.

    No defaults: nothing found → ``None``. If ``num_classes`` is given the
    result is padded/truncated to that length; an all-zero aggregate → ``None``
    (reference: dataset_factory.py:12-65).
    """
    agg: Optional[np.ndarray] = None

    def add_counts(one_ds):
        nonlocal agg
        if not hasattr(one_ds, "get_train_class_counts"):
            return
        raw = one_ds.get_train_class_counts(task)
        if raw is None:
            return
        arr = np.asarray(raw, dtype=np.int64)
        if arr.ndim != 1:
            return
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

    # MultiTaskDataset.get_train_class_counts already pad-and-sums over its
    # sub-datasets, so one call covers both shapes (no special-casing —
    # keeps the alignment logic in one place).
    add_counts(ds)

    if agg is None:
        return None
    if isinstance(num_classes, int) and num_classes > 0:
        if agg.size < num_classes:
            tmp = np.zeros(num_classes, dtype=np.int64)
            tmp[:agg.size] = agg
            agg = tmp
        elif agg.size > num_classes:
            agg = agg[:num_classes]
    return None if int(agg.sum()) == 0 else agg


class DatasetFactory:
    """Factory for concrete datasets and task-to-datasets composition."""

    _task_datasets: Optional[Dict[str, Dict[str, List[str]]]] = None
    _task_map_path: Optional[Path] = None
    TASK_TO_DATASETS_TRAIN: Dict[str, List[str]] = {}
    TASK_TO_DATASETS_VAL: Dict[str, List[str]] = {}
    TASK_TO_DATASETS_TEST: Dict[str, List[str]] = {}

    _dataset_registry: Dict[str, Type] = {}
    _registered_dataset_classes = [MiviaParDataset, FaceDataset]

    @classmethod
    def register_dataset_class(cls, dataset_cls: Type) -> None:
        if not hasattr(dataset_cls, "get_available_datasets"):
            raise ValueError(
                f"{dataset_cls.__name__} does not expose get_available_datasets()")
        for name in dataset_cls.get_available_datasets():
            if name in cls._dataset_registry:
                prev = cls._dataset_registry[name]
                raise ValueError(
                    f"Dataset '{name}' already registered by {prev.__name__}. "
                    f"Duplicate registration attempt by {dataset_cls.__name__}.")
            cls._dataset_registry[name] = dataset_cls

    # ---------------- YAML loader (mandatory) ----------------
    @classmethod
    def _yaml_path(cls) -> Path:
        """``<project root>/configs/task_datasets.yaml``. Project root comes
        from ``VLM_TPU_ROOT`` or ``PYTHONPATH`` (the reference uses
        ``PYTHONPATH``, dataset_factory.py:103-110), else cwd."""
        from ..core.config import project_root
        return project_root() / "configs" / "task_datasets.yaml"

    @classmethod
    def load_task_map(cls, *, force: bool = False) -> None:
        path = cls._yaml_path()
        # The cache is keyed on the resolved path: a process that changes
        # VLM_TPU_ROOT must not keep serving the previous root's task map.
        if (cls._task_datasets is not None and not force
                and cls._task_map_path == path):
            return
        if not path.exists():
            raise FileNotFoundError(
                f"task/datasets YAML not found: {path}. "
                f"Create configs/task_datasets.yaml.")
        import yaml
        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f)
        if not isinstance(data, dict):
            raise ValueError(f"Invalid YAML in {path}: root must be a dict.")

        task_datasets: Dict[str, Dict[str, List[str]]] = {}
        for split, mapping in data.items():
            if split not in ("train", "val", "test"):
                raise ValueError(
                    f"Invalid split '{split}' in {path}. "
                    f"Allowed: train, val, test.")
            if not isinstance(mapping, dict):
                raise ValueError(
                    f"Section '{split}' must map task -> [datasets].")
            task_map_norm: Dict[str, List[str]] = {}
            for task, lst in mapping.items():
                if not isinstance(lst, list) or \
                        not all(isinstance(x, str) for x in lst):
                    raise ValueError(
                        f"tasks['{split}']['{task}'] must be a list of strings.")
                seen, ordered = set(), []
                for name in lst:
                    if name not in seen:
                        seen.add(name)
                        ordered.append(name)
                task_map_norm[str(task).lower()] = ordered
            task_datasets[split] = task_map_norm

        cls._task_datasets = task_datasets
        cls._task_map_path = path
        cls.TASK_TO_DATASETS_TRAIN = task_datasets.get("train", {})
        cls.TASK_TO_DATASETS_VAL = task_datasets.get("val", {})
        cls.TASK_TO_DATASETS_TEST = task_datasets.get("test", {})

    @classmethod
    def _task_map_for_split(cls, split: str) -> Dict[str, List[str]]:
        cls.load_task_map()
        s = split.lower().strip()
        if s not in cls._task_datasets:
            raise ValueError(
                f"Split '{split}' not defined in configs/task_datasets.yaml. "
                f"Add it explicitly (no defaults).")
        return cls._task_datasets[s]

    @staticmethod
    def get_available_datasets() -> List[str]:
        return list(DatasetFactory._dataset_registry.keys())

    @staticmethod
    def create_dataset(dataset_name: str, split: str = "train",
                       base_path=None, transform=None, **kwargs):
        if dataset_name not in DatasetFactory._dataset_registry:
            available = DatasetFactory.get_available_datasets()
            raise ValueError(
                f"Dataset '{dataset_name}' not registered. Available: "
                f"{sorted(available)}")
        dataset_class = DatasetFactory._dataset_registry[dataset_name]
        return dataset_class(dataset_name=dataset_name, split=split,
                             base_path=base_path, transform=transform,
                             **kwargs)

    @staticmethod
    def create_multi_task_dataset(
        tasks: Iterable[str],
        split: str = "train",
        base_path=None,
        transform=None,
        num_classes: Optional[Dict[str, int]] = None,
        **kwargs,
    ) -> Tuple[MultiTaskDataset, Dict[str, Optional[np.ndarray]]]:
        """Union of the datasets required by ``tasks`` instantiated ONCE
        (dedup across tasks) + aggregated counts per task
        (reference: dataset_factory.py:209-270)."""
        factory = DatasetFactory
        tasks = [t.lower().strip() for t in tasks]
        task_map = factory._task_map_for_split(split)

        unknown = sorted(set(tasks) - set(task_map.keys()))
        if unknown:
            raise ValueError(
                f"Unsupported tasks for split '{split}': {unknown}. "
                f"Define them in configs/task_datasets.yaml.")

        seen, selected_names = set(), []
        for t in tasks:
            for name in task_map[t]:
                if name not in seen:
                    seen.add(name)
                    selected_names.append(name)
        if not selected_names:
            raise ValueError(
                f"No dataset selected for tasks={tasks} in split '{split}'")

        instantiated = []
        for name in selected_names:
            if name not in factory._dataset_registry:
                available = factory.get_available_datasets()
                raise ValueError(
                    f"Dataset '{name}' is not registered in the factory. "
                    f"Available: {sorted(available)}")
            instantiated.append(factory.create_dataset(
                dataset_name=name, split=split, base_path=base_path,
                transform=transform, **kwargs))

        mtd = MultiTaskDataset(instantiated, tasks=tasks)

        num_classes = num_classes or {}
        counts_per_task: Dict[str, Optional[np.ndarray]] = {}
        for t in tasks:
            counts_per_task[t] = aggregate_counts_from_datasets(
                mtd, t, num_classes=num_classes.get(t))
        return mtd, counts_per_task


    @staticmethod
    def create_balanced_multi_task_dataset(
        tasks: Iterable[str],
        split: str = "train",
        *,
        desired_fractions: Dict[str, float],
        base_path=None,
        transform=None,
        num_classes: Optional[Dict[str, int]] = None,
        duplicate_transform=None,
        random_seed: Optional[int] = 0,
        **kwargs,
    ) -> Tuple[BalancedMultiTaskDataset, Dict[str, Optional[np.ndarray]]]:
        """Deduped multi-task dataset wrapped in a duplication-based balancer;
        the returned counts are those of the *base* (pre-duplication) dataset
        (reference: dataset_factory.py:272-307)."""
        mtd, counts = DatasetFactory.create_multi_task_dataset(
            tasks=tasks, split=split, base_path=base_path,
            transform=transform, num_classes=num_classes, **kwargs)
        btd = BalancedMultiTaskDataset(
            base_dataset=mtd,
            tasks=[t.lower().strip() for t in tasks],
            desired_fractions={k.lower().strip(): float(v)
                               for k, v in desired_fractions.items()},
            duplicate_transform=duplicate_transform,
            random_seed=random_seed,
        )
        return btd, counts


for _cls in DatasetFactory._registered_dataset_classes:
    DatasetFactory.register_dataset_class(_cls)
