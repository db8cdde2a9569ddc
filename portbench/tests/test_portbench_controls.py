"""The controls on the card, at each cell's own widths and load, on three
seeds: the program passes every number compared, and each stand-in (the
reference one precision below the configuration's; the training cell's
half batch) fails one of them. Run on the card with
``python -m pytest --noconftest portbench/tests -m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import controls  # noqa: E402
from portbench.harness import env  # noqa: E402

CELLS = [w["name"] for w in env.benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def torch_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls run at the cells' "
                    "own widths")
    env.set_cache_env()
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, torch_on_card):
    for seed in SEEDS:
        r = controls.readings(cell, seed, 2.0, torch_on_card, "cuda")
        assert r["correct"], r
        for name, numbers in r["stand_ins"].items():
            assert any(v > r["limits"][k] for k, v in numbers.items()), \
                (cell, seed, name, numbers, r["limits"])
