"""Abstract on-disk image+label dataset with the reference layout contract.

The port's own copy of ``vlm_tpu/data/base_dataset.py``, held equal to it by
``tests/test_torch_shared_layers.py``.
PIL is imported only where an image is opened.

Disk layout (reference: `reference/datasets_vlm/base_dataset.py:9-68`):

    base_path/
    └── dataset_name/
        ├── train/ {images/, labels.csv}
        ├── val/   {images/, labels.csv}
        └── test/  {images/, labels.csv}

Unlike the reference (a ``torch.utils.data.Dataset`` yielding per-item PIL
images), this class is framework-free Python. It keeps the per-item PIL API
for compatibility (``__getitem__`` → ``(PIL.Image RGB, labels)``) but also
exposes the metadata the serving path consumes in bulk:
``image_paths()`` and ``labels_list()`` let the batcher decode and
preprocess batches host-side without touching ``__getitem__`` at all.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BASE_PATH = Path("~/datasets_with_standard_labels/").expanduser()
IMAGES_DIR = "images"
LABELS_FILE = "labels.csv"


class BaseDataset(ABC):
    """Abstract base for image+label datasets on disk.

    Subclasses MUST implement:
      - ``_load_labels()`` → ``list[{"image_path": Path, "labels": Any}]``
      - ``get_labels_from_text_output(output)`` → labels dict
        (reference: base_dataset.py:78-86)
    """

    def __init__(
        self,
        dataset_name: str,
        split: str = "train",
        base_path: Optional[Path] = None,
        transform: Optional[Callable] = None,
    ):
        split = split.lower()
        if split not in {"train", "val", "test"}:
            raise ValueError(
                f"invalid split: {split!r}. Allowed: 'train'|'val'|'test'.")

        self.name: str = dataset_name
        self.split: str = split
        self.transform = transform
        self.base_path = Path(base_path).expanduser() if base_path else BASE_PATH

        self.dataset_path = self.base_path / self.name / self.split
        self.image_folder = self.dataset_path / IMAGES_DIR
        self.label_file = self.dataset_path / LABELS_FILE

        # Same essential checks as the reference (base_dataset.py:63-75).
        if not self.dataset_path.exists():
            raise FileNotFoundError(
                f"[{type(self).__name__}] split '{self.split}' not found: "
                f"{self.dataset_path}")
        if not self.image_folder.exists():
            raise FileNotFoundError(
                f"[{type(self).__name__}] missing images folder: "
                f"{self.image_folder}")
        if not self.label_file.exists():
            raise FileNotFoundError(
                f"[{type(self).__name__}] missing labels file: "
                f"{self.label_file}")

        self.samples: List[Dict[str, Any]] = self._load_labels()
        if not isinstance(self.samples, list):
            raise TypeError(
                f"[{type(self).__name__}] _load_labels() must return "
                f"list[dict], got: {type(self.samples)}")
        if len(self.samples) == 0:
            raise RuntimeError(
                f"[{type(self).__name__}] no samples found in {self.label_file}")

    # ---------- subclass API ----------
    @abstractmethod
    def _load_labels(self) -> List[Dict[str, Any]]:
        """Return ``list[{'image_path': Path, 'labels': Any}]`` for this split."""
        ...

    @abstractmethod
    def get_labels_from_text_output(self, output: Any) -> Any:
        """Normalize a VLM text answer into this dataset's label dict."""
        ...

    # ---------- sequence protocol (reference: base_dataset.py:88-119) ----------
    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image
        item = self.samples[idx]
        image_path = self.resolve_image_path(idx)
        try:
            image = Image.open(image_path).convert("RGB")
        except Exception as e:
            raise RuntimeError(
                f"[{type(self).__name__}] failed to open image "
                f"({image_path}): {e}")
        if self.transform is not None:
            image = self.transform(image)
        return image, item.get("labels")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---------- bulk metadata accessors for the serving path ----------
    def resolve_image_path(self, idx: int) -> Path:
        """Absolute path for sample ``idx`` with the reference's relative-path
        fallback against ``images/`` (base_dataset.py:100-108)."""
        image_path = self.samples[idx].get("image_path")
        if not isinstance(image_path, Path):
            image_path = Path(image_path)
        if not image_path.exists():
            alt = self.image_folder / image_path
            if alt.exists():
                return alt
            raise FileNotFoundError(
                f"[{type(self).__name__}] image not found: {image_path}")
        return image_path

    def image_paths(self) -> List[Path]:
        """All resolved image paths, in dataset order (no image decoding)."""
        return [self.resolve_image_path(i) for i in range(len(self))]

    def labels_list(self) -> List[Any]:
        """All label dicts, in dataset order (no image decoding)."""
        return [s.get("labels") for s in self.samples]

    # ---------- utilities ----------
    @staticmethod
    def get_available_datasets() -> List[str]:
        return []

    def get_train_class_counts(self, task: str) -> Optional[List[int]]:
        """Per-class train counts from ``train/class_counts.json``.

        Rules (reference: base_dataset.py:127-167): keys are stringified class
        ids; "-1" (unknown) is ignored; returns a dense list of length
        ``max_class + 1`` padded with zeros; any failure → ``None``.
        """
        counts_path = self.base_path / self.name / "train" / "class_counts.json"
        if not counts_path.exists():
            return None
        try:
            data = json.loads(counts_path.read_text(encoding="utf-8"))
        except Exception:
            return None
        raw = data.get(task.lower())
        if not isinstance(raw, dict) or not raw:
            return None
        items = []
        for k, v in raw.items():
            try:
                idx = int(k)
                if idx >= 0:
                    items.append((idx, int(v)))
            except Exception:
                continue
        if not items:
            return None
        counts = [0] * (max(i for i, _ in items) + 1)
        for i, c in items:
            counts[i] = int(c)
        return counts

    @property
    def samples_count(self) -> int:
        return len(self.samples)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"split={self.split!r}, N={len(self)})")
