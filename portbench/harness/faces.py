"""Synthetic face datasets in the port's reader layouts, written from the
seed under the run's temporary directory: ``<root>/data/<dataset>/<split>/
images/*.jpg`` with ``labels.csv`` (``Path,Gender,Age,Ethnicity,Facial
Emotion,Identity``; a column a dataset lacks left empty) and
``<root>/configs/task_datasets.yaml``, the task map the readers look up
under the project root."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .weights import seed_of

COLUMNS = ("Gender", "Age", "Ethnicity", "Facial Emotion")
#: the labels' ranges: gender 0-1, age in years, ethnicity 0-6, emotion 0-6
RANGES = {"Gender": (0, 2), "Age": (1, 80), "Ethnicity": (0, 7),
          "Facial Emotion": (0, 7)}


def write(root: Path, spec: dict, seed: int, size: int) -> dict:
    """Write the datasets of ``spec`` (the traffic's ``datasets``: name ->
    {"columns", "train", "val"}) and the task map; returns the image
    paths by (dataset, split)."""
    from PIL import Image

    rng = np.random.default_rng(seed_of(seed, 11))
    paths = {}
    for name, d in spec["datasets"].items():
        for split in ("train", "val"):
            folder = root / "data" / name / split
            (folder / "images").mkdir(parents=True, exist_ok=True)
            lines = ["Path," + ",".join(COLUMNS) + ",Identity"]
            out = []
            for i in range(d[split]):
                rel = f"{name}/{split}/images/{i:05d}.jpg"
                # smooth colour fields with noise: a face crop's spectrum
                # is nearer this than white noise
                base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                img = Image.fromarray(base).resize((size, size),
                                                   Image.BILINEAR)
                arr = np.asarray(img, np.int16) + rng.integers(
                    -24, 25, (size, size, 3))
                Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
                    root / "data" / rel, quality=90)
                vals = [str(int(rng.integers(*RANGES[c])))
                        if c in d["columns"] else "" for c in COLUMNS]
                lines.append(",".join([rel] + vals + [str(i)]))
                out.append(root / "data" / rel)
            (folder / "labels.csv").write_text("\n".join(lines) + "\n",
                                               encoding="utf-8")
            paths[(name, split)] = out
    (root / "configs").mkdir(parents=True, exist_ok=True)
    # YAML is a superset of JSON: the map needs no YAML writer
    (root / "configs" / "task_datasets.yaml").write_text(
        json.dumps(spec["task_datasets"]), encoding="utf-8")
    return paths
