"""Single-task probe tester (``vlm_tpu/probing/test/singletask_tester.py``).

Reads ``head_config.yaml`` (or ``run_config.yaml``; the nested or the old
flat layout) from the checkpoint directory, rebuilds the tower through the
factory, loads the port's ``model.safetensors`` (:mod:`..train.utils`; a
``vlm_tpu`` msgpack checkpoint raises) and evaluates on ``dataset_name``,
or with ``auto`` on the test datasets ``configs/task_datasets.yaml`` maps
the task to. Results go to ``probing/linear_probing/eval/<model>_<quant>_
<linear|deeper>/<task>/<dataset>`` under the project root. A LoRA
checkpoint's adapters are merged into the tower at load.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import yaml

from ...core.config import project_root
from ...data.dataset_factory import DatasetFactory
from ...models.factory import create_model
from ..probes import LinearProbe
from ..train.utils import (MODEL_FILE, get_num_classes_for_task,
                           load_tensors, refuse_msgpack)
from .base_tester import BaseTester


class SingleTaskTester(BaseTester):
    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.ckpt_from = Path(cfg["eval"]["ckpt_from"])
        if not self.ckpt_from.is_absolute():
            self.ckpt_from = project_root() / self.ckpt_from
        self.ckpt_from = self.ckpt_from.resolve()
        refuse_msgpack(self.ckpt_from)
        self.head_cfg = self._load_head_config(self.ckpt_from)
        m = self.head_cfg.get("model")
        if m is None:          # the legacy flat layout
            m, bb = self.head_cfg, {}
            self.model_name = m.get("model_name")
        else:
            bb = m.get("backbone") or {}
            self.model_name = m["name"]
        self.lora_cfg = m.get("lora")
        self.quantization = m.get("quantization", "fp32")
        self.deeper_head = bool(m.get("deeper_head", False))
        self.freeze_bb = bool(bb.get("freeze", m.get("freeze_backbone",
                                                     True)))
        self.dropout_p = float(m.get("dropout_p", 0.3))
        self.hidden_dim = int(m.get("hidden_dim", 512))
        self.model_size = m.get("size")
        self.model_id = m.get("model_id")
        self.quantize_vision = m.get("quantize_vision")
        self.task = str(self.head_cfg.get("task")).lower()

    @staticmethod
    def _load_head_config(ckpt_dir: Path) -> dict:
        for fname in ("head_config.yaml", "run_config.yaml"):
            p = ckpt_dir / fname
            if p.exists():
                return yaml.safe_load(p.read_text(encoding="utf-8"))
        raise FileNotFoundError(f"config not found in {ckpt_dir}")

    def load_backbone(self):
        vlm = create_model(
            self.model_name, model_id=self.model_id,
            quantization=self.quantization or "fp32", size=self.model_size,
            mesh=self.cfg.get("mesh"), quantize_vision=self.quantize_vision)
        return vlm.get_vision_backbone()

    def load_ckpt_and_build_model(self, backbone):
        probe = LinearProbe(
            backbone=backbone,
            n_out_classes=get_num_classes_for_task(self.task),
            freeze_backbone=self.freeze_bb, deeper_head=self.deeper_head,
            dropout_p=self.dropout_p, hidden_dim=self.hidden_dim)
        blob = load_tensors(self.ckpt_from / MODEL_FILE)
        if blob is None:
            raise FileNotFoundError(
                f"No checkpoint found in {self.ckpt_from} ({MODEL_FILE})")
        probe.load_state_tensors(blob)
        self._apply_lora(probe, blob, self.lora_cfg)
        return probe

    def iter_tasks(self) -> List[str]:
        return [self.task]

    def datasets_for_task(self, task: str) -> List[str]:
        ecfg = self.cfg["eval"]
        name = (ecfg.get("dataset_name", "auto") or "auto").lower()
        if name != "auto":
            return [ecfg["dataset_name"]]
        DatasetFactory.load_task_map()
        if task not in DatasetFactory.TASK_TO_DATASETS_TEST:
            raise RuntimeError(
                f"TASK_TO_DATASETS_TEST unavailable for {task}")
        return DatasetFactory.TASK_TO_DATASETS_TEST[task]

    def predict_step(self, model, batch, task: str) -> List[int]:
        images_list, _ = batch
        return model.predict(images_list).cpu().tolist()

    def build_eval_dir(self, task: str, dataset_name: str) -> str:
        head_type = "deeper" if self.deeper_head else "linear"
        return str(project_root() / "probing" / "linear_probing" / "eval" /
                   f"{self.model_name}_{self.quantization}_{head_type}" /
                   task / dataset_name)

    def dataset_obj(self, dataset_name: str):
        return DatasetFactory.create_dataset(
            dataset_name, base_path=self.base_path, split="test",
            transform=None)
