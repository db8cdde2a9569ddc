"""The probing CLIs under a mesh: ``vlm_tpu_torch.scripts.train_probe``
and ``test_probe`` launched under ``torchrun --nproc_per_node 4`` with
``mesh: {data: 2, model: 2}`` on the CPU (gloo, ``VLM_TPU_PLATFORM=cpu``)
write the artifacts of the same CLIs on one device: ``history.csv`` to its
6 decimals (each value within one unit of the last), ``preds.json``,
``gts.json`` and ``metrics.json`` identical; global rank 0 alone writes.
The single profile trains the last block's attention and the embeddings
end to end (LLaVA's "test" tower, random weights from the model's seed;
its MLP stays frozen: the last fc2 bias's gradient is rounding noise, see
``tests/test_torch_probing.py``), 13 samples a split: a batch of 8 split
over ``data`` and a ragged tail of 5.
"""

import json

import pytest
import yaml

from tests.test_torch_mesh_probing import face_root, run_root
from tests.torch_mesh_common import assert_history_equal, torchrun
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.scripts import test_probe as probe_tester_cli
from vlm_tpu_torch.scripts import train_probe as probe_trainer_cli

RUN = "llava_fp32_gender_linear"
CKPT = f"probing/linear_probing/checkpoints/{RUN}"
EVAL = "probing/linear_probing/eval/llava_fp32_linear/gender/TestDataset"


def _configs(root, base, mesh):
    train = {
        "profile": "single",
        "common": {
            "model": {"name": "llava", "quantization": "fp32",
                      "size": "test", "dropout_p": 0.0, "hidden_dim": 16,
                      "backbone": {"freeze": True, "unfreeze_last_k": 1,
                                   "unfreeze_parts": "attn"}},
            "data": {"base_path": str(base), "batch_size": 8},
            "train": {"seed": 0, "epochs": 2, "lr": 1e-2,
                      "backbone_lr": 1e-3, "weight_decay": 1e-4,
                      "patience": 4, "eval_every": 1},
            "mesh": mesh},
        "single": {"task": "gender"}, "multi": {"tasks": ["gender"]}}
    test = {"profile": "single",
            "common": {"mesh": mesh, "data": {"base_path": str(base),
                                              "batch_size": 5}},
            "single": {"eval": {"ckpt_from": CKPT, "dataset_name": "auto"}}}
    paths = root / "train.yaml", root / "test.yaml"
    for p, c in zip(paths, (train, test)):
        p.write_text(yaml.safe_dump(c))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    root, base = face_root(tmp)
    one = run_root(tmp, "one", root)
    mesh = run_root(tmp, "mesh", root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VLM_TPU_ROOT", str(one))
        mp.setenv("VLM_TPU_PLATFORM", "cpu")
        TFactory.load_task_map(force=True)
        train_yaml, test_yaml = _configs(one, base, {"data": 1, "model": 1})
        probe_trainer_cli.main(["--config", str(train_yaml)])
        probe_tester_cli.main(["--config", str(test_yaml)])
    TFactory._task_datasets = None
    train_yaml, test_yaml = _configs(mesh, base, {"data": 2, "model": 2})
    logs = [torchrun(4, f"vlm_tpu_torch.scripts.{name}",
                     ["--config", str(cfg)], VLM_TPU_ROOT=str(mesh),
                     VLM_TPU_PLATFORM="cpu")
            for name, cfg in (("train_probe", train_yaml),
                              ("test_probe", test_yaml))]
    return one, mesh, logs


def test_train_probe_under_torchrun_writes_the_one_device_history(runs):
    one, mesh, logs = runs
    assert_history_equal((mesh / CKPT / "history.csv").read_text(),
                         (one / CKPT / "history.csv").read_text())
    assert "[mesh] rank 3/4: backend gloo" in logs[0]
    for name in ("model.safetensors", "training_state.safetensors",
                 "head_config.yaml", "loss_curve.png"):
        assert (mesh / CKPT / name).exists(), name


def test_test_probe_under_torchrun_writes_the_one_device_files(runs):
    one, mesh, _ = runs
    for name in ("preds.json", "gts.json", "metrics.json"):
        assert json.loads((mesh / EVAL / name).read_text()) == \
            json.loads((one / EVAL / name).read_text()), name
    # rank 0 alone reported the results
    assert runs[2][1].count("[OK] gender @ TestDataset") == 1
