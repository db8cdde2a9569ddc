"""The port's face-dataset preparation
(``vlm_tpu_torch/data/preprocess_face_datasets.py``) against vlm_tpu's, on
two copies of the same tree built by ``tests/test_preprocess_datasets.py``'s
fixtures: the same files moved, the same CSV bytes, the same
``class_counts.json`` and the same printed lines, for the row split, the
identity-grouped split of VggFace2-Train, an existing ``val/`` and
extension-less CSV paths; and the helpers' values."""

import shutil

import pytest

from tests.conftest import make_face_dataset
from vlm_tpu.data import preprocess_face_datasets as jprep
from vlm_tpu_torch.data import preprocess_face_datasets as tprep


def _rows(n, identities=None, blanks=()):
    return [{"gender": i % 2, "age": 10 + 3 * i, "ethnicity": i % 4,
             "emotion": i % 7,
             "identity": identities[i] if identities else f"id{i}"}
            if i not in blanks else {} for i in range(n)]


def _tree(base):
    """Three datasets: a train-only TestDataset (a blank row among 20),
    VggFace2-Train with 6 identities of 4 rows and extension-less paths,
    and a dataset whose ``val/`` already exists."""
    make_face_dataset(base, "TestDataset", "train", _rows(20, blanks=(7,)))
    make_face_dataset(base, "VggFace2-Train", "train",
                      _rows(24, [f"person{i // 4}" for i in range(24)]),
                      extensionless=True)
    make_face_dataset(base, "UTKFace", "train", _rows(10))
    make_face_dataset(base, "UTKFace", "val", _rows(2))
    return base


def _files(base):
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed", [0, 42])
def test_main_writes_vlm_tpus_tree(tmp_path, capsys, seed):
    trees = {}
    out = {}
    for name, prep in (("jax", jprep), ("port", tprep)):
        base = _tree(tmp_path / name / "datasets_with_standard_labels")
        prep.main(["--base", str(base), "--seed", str(seed), "--verbose"])
        out[name] = capsys.readouterr().out.replace(str(base), "<base>")
        trees[name] = _files(base)
    assert trees["port"].keys() == trees["jax"].keys()
    for f, data in trees["jax"].items():
        assert trees["port"][f] == data, f
    assert out["port"] == out["jax"]
    assert "Splits created/verified: 3 | Counts computed: 3" in out["port"]
    vgg = [f for f in trees["port"] if f.startswith("VggFace2-Train/val/")
           and f.endswith(".jpg")]
    assert len(vgg) == 4            # one identity of 6, all of its rows


def test_identity_grouped_split_keeps_identities_whole(tmp_path):
    import csv
    base = tmp_path / "ds"
    make_face_dataset(base, "VggFace2-Train", "train",
                      _rows(20, [f"person{i // 4}" for i in range(20)]))
    assert tprep.create_val_split_if_missing(base / "VggFace2-Train", seed=1)
    sides = {}
    for split in ("train", "val"):
        with open(base / "VggFace2-Train" / split / "labels.csv") as f:
            for row in csv.DictReader(f):
                assert sides.setdefault(row["Identity"], split) == split
    assert set(sides.values()) == {"train", "val"}


def test_missing_image_is_an_error_line_in_both(tmp_path, capsys):
    out = {}
    for name, prep in (("jax", jprep), ("port", tprep)):
        base = tmp_path / name
        make_face_dataset(base, "TestDataset", "train", _rows(10))
        shutil.rmtree(base / "TestDataset" / "train" / "images")
        (base / "TestDataset" / "train" / "images").mkdir()
        prep.main(["--base", str(base), "--seed", "3"])
        out[name] = capsys.readouterr().out.replace(str(base), "<base>")
    assert out["port"] == out["jax"]
    assert "[ERR] split TestDataset" in out["port"]


@pytest.mark.parametrize("value", ["3-9", "70+", "7", 25.0, "garbage", "",
                                   "41.5", -3, None])
def test_age_to_class_is_vlm_tpus(value):
    assert tprep.age_to_class(value) == jprep.age_to_class(value)


@pytest.mark.parametrize("raw", [
    "datasets_with_standard_labels\\X\\train\\images\\a\\b",
    "datasets_with_standard_labels/X/train/b.jpg", "/abs/images/sub/i.jpg",
    "/abs/IMAGES/i.png", "/abs/other/i.png", "sub/img", "img.jpg"])
def test_path_helpers_are_vlm_tpus(raw):
    rel = tprep.extract_rel_inside_images(raw)
    assert rel == jprep.extract_rel_inside_images(raw)
    assert tprep.build_csv_path_for_split("DS", "val", rel) == \
        jprep.build_csv_path_for_split("DS", "val", rel)
