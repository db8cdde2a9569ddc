#!/usr/bin/env python
"""Offline face-dataset preparation, the port's own copy of
``vlm_tpu/data/preprocess_face_datasets.py`` (the same CLI, moves, CSV
bytes and counts for the same tree and seed):

1) **Create a missing ``val/`` split**: move-only, 80/20 by row; for
   ``VggFace2-Train`` with an ``Identity`` column the split is grouped by
   identity so that no identity straddles train and val. The rewritten
   CSVs store ``Path`` without its extension, backslash-separated and
   prefixed ``datasets_with_standard_labels\\<Dataset>\\<split>\\images\\...``
   (the loaders depend on that form).

2) **Per-class train counts** for gender (0/1), ethnicity (0..3), emotion
   (0..6) and age (binned 0..8; string bins such as "3-9" accepted),
   ``-1`` excluded, written to ``train/class_counts.json`` (the weighted
   sampler and the loss balancing of the probing trainers read it).

Run over every dataset under a base folder:

    python -m vlm_tpu_torch.data.preprocess_face_datasets --base DIR \\
        [--seed 42] [--verbose]

The csv module and numpy only, no pandas.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .parsers import AGE_LABELS, age_float_to_class

BASE_DIR = Path("~/datasets_with_standard_labels/").expanduser()
IMAGES_DIR = "images"
LABELS_FILE = "labels.csv"
VAL_RATIO = 0.2


# ------------------------- path helpers -------------------------

def extract_rel_inside_images(raw_path: str) -> Path:
    """The part of a free-form CSV ``Path`` value relative to ``images/``.

    Handles the logical ``datasets_with_standard_labels/...`` prefix,
    absolute paths containing ``/images/``, already-relative paths, and
    mixed slashes.
    """
    s = str(raw_path).strip().replace("\\", "/")
    if "datasets_with_standard_labels/" in s:
        parts = s.split("/")
        if "images" in parts:
            return Path(*parts[parts.index("images") + 1:])
        return Path(parts[-1])
    if "/images/" in s:
        return Path(s.split("/images/", 1)[1])
    p = Path(s)
    if p.is_absolute():
        parts_lower = [pp.lower() for pp in p.parts]
        if "images" in parts_lower:
            return Path(*p.parts[parts_lower.index("images") + 1:])
        return Path(p.name)
    return Path(s)


def resolve_src_from_train_images(train_images_dir: Path,
                                  rel: Path) -> Optional[Path]:
    """Locate a file under train/images, probing .jpg/.jpeg/.png when the
    relative path has no suffix."""
    candidate = train_images_dir / rel
    if candidate.exists():
        return candidate
    if candidate.suffix == "":
        for ext in (".jpg", ".jpeg", ".png"):
            c = candidate.with_suffix(ext)
            if c.exists():
                return c
    return None


def build_csv_path_for_split(dataset_name: str, split: str,
                             rel_noext: Path) -> str:
    """CSV ``Path`` string: backslashes, no extension, logical prefix."""
    rel_norm = str(rel_noext).replace("/", "\\")
    return (f"datasets_with_standard_labels\\{dataset_name}\\{split}"
            f"\\images\\{rel_norm}")


# ------------------------- split helpers -------------------------

def random_row_split(n_rows: int, val_ratio: float,
                     seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = np.arange(n_rows)
    rng.shuffle(idx)
    k = max(1, int(round(n_rows * val_ratio)))
    val_mask = np.zeros(n_rows, dtype=bool)
    val_mask[idx[:k]] = True
    return ~val_mask, val_mask


def groupwise_split(groups: np.ndarray, val_ratio: float,
                    seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """~val_ratio of the *groups* (identities) go entirely to val."""
    rng = np.random.default_rng(seed)
    uniq = np.unique(groups)
    rng.shuffle(uniq)
    k = max(1, int(round(len(uniq) * val_ratio)))
    val_groups = set(uniq[:k].tolist())
    val_mask = np.asarray([g in val_groups for g in groups], dtype=bool)
    return ~val_mask, val_mask


# ------------------------- csv helpers -------------------------

def load_csv_with_header(csv_path: Path):
    """Returns (header list, rows list-of-dicts, path_col, identity_col|None)."""
    with open(csv_path, "r", encoding="utf-8", newline="") as f:
        reader = csv.DictReader(f)
        header = [c.strip() for c in (reader.fieldnames or [])]
        reader.fieldnames = header
        rows = list(reader)
    lower = [c.lower() for c in header]
    if "path" not in lower:
        raise ValueError(f"CSV '{csv_path}' lacks a 'Path' column (header).")
    path_col = header[lower.index("path")]
    ident_col = header[lower.index("identity")] if "identity" in lower \
        else None
    return header, rows, path_col, ident_col


def write_csv(header: List[str], rows: List[dict], out_csv: Path) -> None:
    with open(out_csv, "w", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=header)
        writer.writeheader()
        writer.writerows(rows)


# ------------------------- feature 1: val split -------------------------

def create_val_split_if_missing(dataset_dir: Path, seed: int,
                                verbose: bool = False) -> bool:
    """Create val/ (80/20, move-only) if missing; returns True if the
    dataset was considered."""
    dataset_name = dataset_dir.name
    train_dir = dataset_dir / "train"
    val_dir = dataset_dir / "val"
    train_images = train_dir / IMAGES_DIR
    train_labels = train_dir / LABELS_FILE
    if not train_images.exists() or not train_labels.exists():
        return False
    if val_dir.exists():
        if verbose:
            print(f"[SKIP] {dataset_name}: 'val/' exists → no changes")
        return True

    header, rows, path_col, ident_col = load_csv_with_header(train_labels)

    split_mode = "row"
    if dataset_name == "VggFace2-Train" and ident_col is not None:
        split_mode = "identity"

    if split_mode == "identity":
        groups = np.asarray([str(r[ident_col]).strip() for r in rows])
        tr_mask, va_mask = groupwise_split(groups, VAL_RATIO, seed)
    else:
        tr_mask, va_mask = random_row_split(len(rows), VAL_RATIO, seed)

    rows_train = [r for r, m in zip(rows, tr_mask) if m]
    rows_val = [r for r, m in zip(rows, va_mask) if m]

    val_images = val_dir / IMAGES_DIR
    val_images.mkdir(parents=True, exist_ok=True)

    moved = 0
    for row in rows_val:
        rel_inside = extract_rel_inside_images(row[path_col])
        src = resolve_src_from_train_images(train_images, rel_inside)
        if src is None:
            raise FileNotFoundError(
                f"File not found in train/images: "
                f"{train_images / rel_inside} (tried .jpg/.jpeg/.png)")
        rel_fs = rel_inside if rel_inside.suffix != "" else \
            rel_inside.with_suffix(src.suffix)
        dst = val_images / rel_fs
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(src), str(dst))
        moved += 1

    def remap(split_rows: List[dict], split_name: str) -> List[dict]:
        out = []
        for r in split_rows:
            r = dict(r)
            rel_inside = extract_rel_inside_images(r[path_col])
            r[path_col] = build_csv_path_for_split(
                dataset_name, split_name, rel_inside.with_suffix(""))
            out.append(r)
        return out

    write_csv(header, remap(rows_train, "train"), train_dir / LABELS_FILE)
    write_csv(header, remap(rows_val, "val"), val_dir / LABELS_FILE)

    if verbose:
        print(f"[OK] {dataset_name}: split={split_mode}, "
              f"train->{len(rows_train)}, val->{len(rows_val)} "
              f"(moved: {moved})")
    return True


# ------------------------- feature 2: class counts -------------------------

def age_to_class(v) -> int:
    """Age value → class 0..8: accepts bin labels ("3-9") or numerics
    (always float-binned: "7" means seven *years*, not class 7)."""
    if isinstance(v, str):
        s = v.strip()
        if s in AGE_LABELS:
            return AGE_LABELS[s]
        try:
            f = float(s)
        except Exception:
            return -1
        return age_float_to_class(f)
    try:
        return age_float_to_class(float(v))
    except Exception:
        return -1


def _numeric_counts(values) -> Dict[str, int]:
    counts: Dict[int, int] = {}
    for v in values:
        try:
            i = int(float(v))
        except Exception:
            continue
        if i >= 0:
            counts[i] = counts.get(i, 0) + 1
    return {str(k): counts[k] for k in sorted(counts)}


def count_classes_for_train(dataset_dir: Path,
                            verbose: bool = False) -> Optional[Dict]:
    """Per-class counts for the standard columns; ``-1`` excluded; saved to
    ``train/class_counts.json``."""
    train_dir = dataset_dir / "train"
    labels_csv = train_dir / LABELS_FILE
    if not train_dir.exists() or not labels_csv.exists():
        return None

    header, rows, _, _ = load_csv_with_header(labels_csv)
    cols_lower = {c.lower(): c for c in header}
    counts: Dict[str, Dict[str, int]] = {}

    for task, col_name in (("gender", "gender"), ("ethnicity", "ethnicity"),
                           ("emotion", "facial emotion")):
        if col_name in cols_lower:
            col = cols_lower[col_name]
            counts[task] = _numeric_counts(r.get(col, "") for r in rows)

    if "age" in cols_lower:
        col = cols_lower["age"]
        age_counts: Dict[int, int] = {}
        for r in rows:
            c = age_to_class(r.get(col, ""))
            if c >= 0:
                age_counts[c] = age_counts.get(c, 0) + 1
        counts["age"] = {str(k): age_counts[k] for k in sorted(age_counts)}

    out_path = train_dir / "class_counts.json"
    out_path.write_text(json.dumps(counts, indent=2), encoding="utf-8")
    if verbose:
        print(f"[OK] {dataset_dir.name}: saved {out_path}")
    return counts


# ------------------------- main -------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Dataset preprocess: create missing 80/20 val split "
                    "(move-only) and compute train class counts. Output "
                    "CSVs store extension-less 'Path' values.")
    parser.add_argument("--base", type=str, default=str(BASE_DIR),
                        help="base folder "
                             "(default: ~/datasets_with_standard_labels/)")
    parser.add_argument("--seed", type=int, default=42,
                        help="RNG seed for the split")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    base = Path(args.base).expanduser()
    if not base.exists():
        raise FileNotFoundError(f"Base not found: {base}")

    processed_split = 0
    processed_counts = 0
    for ds_dir in sorted(d for d in base.iterdir() if d.is_dir()):
        if not (ds_dir / "train").exists():
            continue
        try:
            if create_val_split_if_missing(ds_dir, seed=args.seed,
                                           verbose=args.verbose):
                processed_split += 1
        except Exception as e:
            print(f"[ERR] split {ds_dir.name}: {e}")
        try:
            if count_classes_for_train(ds_dir,
                                       verbose=args.verbose) is not None:
                processed_counts += 1
        except Exception as e:
            print(f"[ERR] counts {ds_dir.name}: {e}")

    print(f"[DONE] Splits created/verified: {processed_split} | "
          f"Counts computed: {processed_counts}")


if __name__ == "__main__":
    main()
