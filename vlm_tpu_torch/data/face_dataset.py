"""Unified face-attribute dataset (CelebA_HQ, FairFace, LFW, RAF-DB, UTKFace,

The port's own copy of ``vlm_tpu/data/face_dataset.py``, held equal to it by
``tests/test_torch_shared_layers.py``.
VggFace2, Lagenda, TestDataset).

Behavioral mirror of `reference/datasets_vlm/face_dataset.py` on the same
disk layout, re-implemented framework-free (csv module instead of pandas — the
host here has one core, so the lighter parser is also the faster one):

- ``labels.csv`` header: ``Path,Gender,Age,Ethnicity,Facial Emotion,Identity``
  (face_dataset.py:62-124);
- ``Path`` entries may be extension-less: ``.jpg/.jpeg/.png`` are probed in
  that order (face_dataset.py:84-91);
- a redundant leading path component equal to ``base_path.name`` is stripped
  (face_dataset.py:80-82);
- age is a float; stored as class 0..8 unless ``age_is_regression``
  (face_dataset.py:100);
- malformed rows are skipped with a warning (face_dataset.py:120-122).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import parsers
from .base_dataset import BaseDataset
from .parsers import (AGE_LABELS, EMOTION_LABELS, ETHNICITY_LABELS,  # noqa: F401  (public API parity)
                      age_float_to_class, to_float_safe, to_int_safe)

_EXTENSIONS = [".jpg", ".jpeg", ".png"]
_EXPECTED_COLUMNS = ["Path", "Gender", "Age", "Ethnicity",
                     "Facial Emotion", "Identity"]


class FaceDataset(BaseDataset):
    """Face dataset with standardized labels: gender, age, ethnicity, emotion,
    identity."""

    SUPPORTED_DATASETS = [
        "CelebA_HQ", "FairFace", "LFW", "RAF-DB", "TestDataset", "UTKFace",
        "VggFace2-Test", "VggFace2-Train", "Lagenda",
    ]

    ETHNICITY_LABELS = ETHNICITY_LABELS
    EMOTION_LABELS = EMOTION_LABELS
    AGE_LABELS = AGE_LABELS

    def __init__(self, dataset_name: str, split: str = "train",
                 base_path=None, transform=None,
                 age_is_regression: bool = False):
        if dataset_name not in self.SUPPORTED_DATASETS:
            raise ValueError(
                f"Dataset '{dataset_name}' not supported. Supported: "
                f"{sorted(self.SUPPORTED_DATASETS)}")
        self.age_is_regression = age_is_regression
        super().__init__(dataset_name=dataset_name, split=split,
                         base_path=base_path, transform=transform)

    @staticmethod
    def get_available_datasets() -> List[str]:
        return FaceDataset.SUPPORTED_DATASETS

    # ------------------------- label loading -------------------------
    def _find_image(self, relative_path: Path) -> Optional[Path]:
        """Probe ``.jpg/.jpeg/.png`` for an extension-less CSV path
        (reference: face_dataset.py:84-91, which uses ``with_suffix`` — i.e.
        any existing suffix is replaced, not appended to)."""
        for ext in _EXTENSIONS:
            p = (self.base_path / relative_path).with_suffix(ext)
            if p.exists():
                return p
        return None

    def _load_labels(self) -> List[Dict[str, Any]]:
        samples: List[Dict[str, Any]] = []
        with open(self.label_file, "r", encoding="utf-8", newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames:
                # Tolerate stray whitespace in headers (face_dataset.py:75).
                reader.fieldnames = [c.strip() for c in reader.fieldnames]
            for idx, row in enumerate(reader):
                try:
                    relative_path = Path(str(row["Path"]).replace("\\", "/"))
                    if (relative_path.parts
                            and relative_path.parts[0] == self.base_path.name):
                        relative_path = Path(*relative_path.parts[1:])

                    image_path = self._find_image(relative_path)
                    if image_path is None:
                        raise FileNotFoundError(
                            f"image not found: {relative_path} ({_EXTENSIONS})")

                    gender = to_int_safe(_csv_val(row, "Gender"))
                    age_val = to_float_safe(_csv_val(row, "Age"), default=-1.0)
                    age_label = (age_val if self.age_is_regression
                                 else age_float_to_class(age_val))
                    ethnicity = to_int_safe(_csv_val(row, "Ethnicity"))
                    emotion = to_int_safe(_csv_val(row, "Facial Emotion"))
                    ident_raw = _csv_val(row, "Identity")
                    identity = (str(ident_raw).strip()
                                if ident_raw not in (None, "") else "-1")

                    samples.append({
                        "image_path": image_path,
                        "labels": {
                            "gender": gender,
                            "age": age_label,
                            "ethnicity": ethnicity,
                            "emotion": emotion,
                            "identity": identity,
                        },
                    })
                except Exception as e:
                    # Skip-and-warn semantics (face_dataset.py:120-122); the
                    # row number matches the reference's 1-based-data+header.
                    print(f"[WARN] CSV row {idx + 2}: skipping sample → {e}")
                    continue
        return samples

    # ------------------------- VLM output parsing -------------------------
    def get_labels_from_text_output(self, output: str) -> Dict[str, Any]:
        """Parse "Gender, Age, Ethnicity, Emotion" (see
        :func:`.parsers.parse_face_output`)."""
        return parsers.parse_face_output(
            output, age_is_regression=self.age_is_regression)

    # Kept as methods for API parity with the reference helpers.
    _to_int_safe = staticmethod(to_int_safe)
    _to_float_safe = staticmethod(to_float_safe)

    def _age_float_to_class(self, age_val: float) -> int:
        return age_float_to_class(age_val)


def _csv_val(row: Dict[str, str], key: str):
    """Empty CSV fields behave like pandas NaN → handled as missing."""
    v = row.get(key)
    if v is None or str(v).strip() == "":
        return None
    return v
