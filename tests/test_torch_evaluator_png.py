"""The port's evaluator draws every confusion matrix with Pillow, so the
card machine (no matplotlib) writes ``vlm_tpu``'s PNG files too: with
matplotlib made unimportable, the port writes the files ``vlm_tpu`` writes
(under the same names) and Pillow opens each as a 600 x 500 PNG."""

import sys

import numpy as np
import pytest
from PIL import Image

from vlm_tpu.evaluation import Evaluator as JEvaluator
from vlm_tpu_torch.evaluation import Evaluator as TEvaluator
from vlm_tpu_torch.evaluation.evaluator import _blues, draw_confusion_png


def _labels(rng, n, case):
    if case == "mivia":
        keys = ("upper", "lower", "gender", "bag", "hat")
        return [{k: int(rng.integers(-1, 12)) for k in keys} for _ in range(n)]
    return [{"gender": int(rng.integers(-1, 2)),
             "age": int(rng.integers(0, 9)) if case == "face_age"
             else float(rng.integers(1, 90)),
             "ethnicity": int(rng.integers(-1, 4)),
             "emotion": int(rng.integers(-1, 7))} for _ in range(n)]


@pytest.mark.parametrize("case", ["mivia", "face_age", "face_regression"])
def test_pngs_without_matplotlib(case, tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    preds, gts = _labels(rng, 40, case), _labels(rng, 40, case)
    name = "MiviaPar" if case == "mivia" else "TestDataset"
    mode = "regression" if case == "face_regression" else "auto"
    JEvaluator.evaluate(preds, gts, tmp_path / "ref", dataset_name=name,
                        age_mode=mode)
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    TEvaluator.evaluate(preds, gts, tmp_path / "port", dataset_name=name,
                        age_mode=mode)
    ref = sorted(p.name for p in (tmp_path / "ref").glob("*.png"))
    port = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert port == ref and port
    assert ("confusion_matrix_age.png" in port) == (case == "face_age")
    for f in port:
        with Image.open(tmp_path / "port" / f) as im:
            im.verify()
        with Image.open(tmp_path / "port" / f) as im:
            assert (im.format, im.size) == ("PNG", (600, 500))


def test_png_cells_follow_the_counts(tmp_path):
    """A cell's colour darkens with its count (Blues: 0 the palest, the
    largest count the darkest)."""
    path = tmp_path / "cm.png"
    draw_confusion_png(np.array([[0, 4], [2, 8]]), ["a", "b"], "T - Acc: 1",
                       path)
    with Image.open(path) as im:
        rgb = im.convert("RGB")
        # cell centres minus a margin from the count text
        px = [rgb.getpixel((150 + int((j + 0.25) * 165),
                            40 + int((i + 0.25) * 165)))
              for i in range(2) for j in range(2)]
    assert px[0] == _blues(0.0) and px[3] == _blues(1.0)
    assert sum(px[0]) > sum(px[2]) > sum(px[1]) > sum(px[3])
