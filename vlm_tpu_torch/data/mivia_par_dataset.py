"""MIVIA Person Attribute Recognition (PAR) dataset.

The port's own copy of ``vlm_tpu/data/mivia_par_dataset.py``, held equal to it by
``tests/test_torch_shared_layers.py``.

Behavioral mirror of `reference/datasets_vlm/mivia_par_dataset.py`:

- per-sample labels: ``upper``/``lower`` clothing color (1..11, see
  ``parsers.COLOR_LABELS``), ``gender`` (0=male, 1=female), ``bag``/``hat``
  (0/1); ``-1`` everywhere for unknown;
- headerless ``labels.csv`` with columns ``[path, upper, lower, gender, bag,
  hat]`` (mivia_par_dataset.py:60-90);
- malformed rows are skipped with a warning.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import parsers
from .base_dataset import BaseDataset
from .parsers import COLOR_LABELS, color_to_id, to_bin_safe, to_int_safe  # noqa: F401


class MiviaParDataset(BaseDataset):
    SUPPORTED_DATASETS = ["MiviaPar"]

    COLOR_LABELS = COLOR_LABELS

    def __init__(self, dataset_name: str, split: str = "train",
                 base_path: Optional[Path] = None, transform=None):
        if dataset_name not in self.SUPPORTED_DATASETS:
            raise ValueError(
                f"Dataset '{dataset_name}' not supported. Allowed: "
                f"{self.SUPPORTED_DATASETS}")
        super().__init__(dataset_name=dataset_name, split=split,
                         base_path=base_path, transform=transform)

    @staticmethod
    def get_available_datasets() -> List[str]:
        return MiviaParDataset.SUPPORTED_DATASETS

    # ------------------------- label loading -------------------------
    def _load_labels(self) -> List[Dict[str, Any]]:
        samples: List[Dict[str, Any]] = []
        with open(self.label_file, "r", encoding="utf-8", newline="") as f:
            for i, row in enumerate(csv.reader(f)):
                try:
                    if not row:
                        continue
                    rel = str(row[0]).strip().replace("\\", "/")
                    image_path = self._resolve_csv_image_path(rel)
                    get = lambda j: row[j] if j < len(row) else None
                    labels = {
                        "upper": color_to_id(get(1)),
                        "lower": color_to_id(get(2)),
                        "gender": to_int_safe(get(3), default=-1),
                        "bag": to_bin_safe(get(4)),
                        "hat": to_bin_safe(get(5)),
                    }
                    samples.append({"image_path": image_path, "labels": labels})
                except Exception as e:
                    print(f"[WARN] CSV row {i + 1}: skipping → {e}")
                    continue
        if not samples:
            raise RuntimeError(f"No valid samples in {self.label_file}")
        return samples

    def _resolve_csv_image_path(self, rel_or_abs: str) -> Path:
        """Resolve a CSV image path: relative paths are resolved against
        ``images/``; existence is validated
        (reference: mivia_par_dataset.py:117-127)."""
        p = Path(rel_or_abs)
        if p.is_absolute():
            if not p.exists():
                raise FileNotFoundError(f"image not found: {p}")
            return p
        candidate = self.image_folder / p
        if not candidate.exists():
            raise FileNotFoundError(f"image not found (relative): {candidate}")
        return candidate

    # ------------------------- VLM output parsing -------------------------
    def get_labels_from_text_output(self, output: str) -> Dict[str, int]:
        """Parse "Upper, Lower, Gender, Bag, Hat" (see
        :func:`.parsers.parse_mivia_par_output`, which also fixes
        the reference's undefined ``_parse_yesno``)."""
        return parsers.parse_mivia_par_output(output)

    # Helper parity with the reference.
    _to_int_safe = staticmethod(to_int_safe)
    _to_bin_safe = staticmethod(to_bin_safe)

    def _color_to_id(self, v) -> int:
        return color_to_id(v)

    def _match_color(self, s: str) -> int:
        return parsers.match_color(s)
