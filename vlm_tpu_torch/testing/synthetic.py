"""Synthetic datasets in the standard disk layout
(``<base>/<name>/<split>/{images/, labels.csv}``): the port's own copy of
``vlm_tpu/testing/synthetic.py``'s face-dataset builder, with the image
side as an argument (``chip_smoke.py`` writes 336 px JPEGs for LLaVA's
tower)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_image(path: Path, seed: int, size=(32, 32)) -> None:
    from PIL import Image
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, size=(*size, 3), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def make_face_dataset(base: Path, name: str, split: str, rows, *,
                      size=(32, 32)) -> Path:
    """A face-layout dataset: ``rows`` are dicts with keys gender, age,
    ethnicity, emotion and identity (a missing key: an empty CSV field);
    image ``i`` is noise from seed ``i`` of ``size``."""
    droot = Path(base) / name / split
    (droot / "images").mkdir(parents=True, exist_ok=True)
    lines = ["Path,Gender,Age,Ethnicity,Facial Emotion,Identity"]
    for i, r in enumerate(rows):
        img_name = f"img_{i:04d}.jpg"
        write_image(droot / "images" / img_name, seed=i, size=size)
        vals = [str(r.get(k, "")) for k in
                ("gender", "age", "ethnicity", "emotion")]
        lines.append(",".join([f"{name}/{split}/images/{img_name}"] + vals
                              + [str(r.get("identity", ""))]))
    (droot / "labels.csv").write_text("\n".join(lines) + "\n")
    return droot
