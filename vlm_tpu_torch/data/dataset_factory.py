"""Dataset registry for the zero-shot path: the port's own copy of the
registry half of ``vlm_tpu/data/dataset_factory.py``.

``DatasetFactory.create_dataset(name, split, base_path, transform)``
builds a registered face or MiviaPar dataset, with the same registry, the
same duplicate-registration check and the same error for an unknown name.
The task-to-datasets YAML and the multi-task and balanced datasets serve
probing and are not copied until probing is ported.
"""

from __future__ import annotations

from typing import Dict, List, Type

from .face_dataset import FaceDataset
from .mivia_par_dataset import MiviaParDataset


class DatasetFactory:
    """Factory for the concrete datasets."""

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


for _cls in DatasetFactory._registered_dataset_classes:
    DatasetFactory.register_dataset_class(_cls)
