"""Multi-task probe tester (``vlm_tpu/probing/test/multitask_tester.py``).

The tasks come from the checkpoint's ``head_config.yaml``; the tower is
rebuilt through the factory, the heads (and a trained tower's parameters,
and LoRA's adapters, merged at load) come from the port's
``model.safetensors``. Each task is evaluated on ``dataset_name``, or with
``auto`` on the test datasets ``configs/task_datasets.yaml`` maps it to;
preds are the task head's argmax. Results go to
``probing/multitask_probing/eval/<run>/<task>/<dataset>`` under the
project root.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import yaml

from ...core.config import project_root
from ...data.dataset_factory import DatasetFactory
from ...models.factory import create_model
from ..probes import MultiTaskProbe
from ..train.utils import (MODEL_FILE, get_num_classes_for_task,
                           load_tensors, refuse_msgpack)
from .base_tester import BaseTester


class MultiTaskTester(BaseTester):
    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.ckpt_from = Path(cfg["eval"]["ckpt_from"])
        if not self.ckpt_from.is_absolute():
            self.ckpt_from = project_root() / self.ckpt_from
        self.ckpt_from = self.ckpt_from.resolve()
        refuse_msgpack(self.ckpt_from)
        p = self.ckpt_from / "head_config.yaml"
        if not p.exists():
            raise FileNotFoundError(f"head_config.yaml not found in "
                                    f"{self.ckpt_from}")
        self.head_cfg = yaml.safe_load(p.read_text(encoding="utf-8"))

        hc = self.head_cfg
        m = hc.get("model") or {}
        self.model_name = m.get("name", hc.get("model_name"))
        self.quantization = m.get("quantization",
                                  hc.get("quantization", "fp32"))
        self.deeper_head = bool(m.get("deeper_head",
                                      hc.get("deeper_heads", False)))
        bb = m.get("backbone") or {}
        self.freeze_bb = bool(bb.get("freeze", m.get(
            "freeze_backbone", hc.get("freeze_backbone", True))))
        self.dropout_p = float(m.get("dropout_p", hc.get("dropout_p", 0.3)))
        self.hidden_dim = int(m.get("hidden_dim", hc.get("hidden_dim", 512)))
        self.model_size = m.get("size")
        self.model_id = m.get("model_id")
        self.quantize_vision = m.get("quantize_vision")
        self.lora_cfg = m.get("lora")
        if "tasks" in hc:
            self.tasks = [t.lower() for t in hc["tasks"]]
        elif "tasks" in (hc.get("train") or {}):
            self.tasks = [t.lower() for t in hc["train"]["tasks"]]
        else:
            raise ValueError(
                "Cannot determine tasks from the checkpoint config.")
        self.run_name = self.ckpt_from.name

    def load_backbone(self):
        vlm = create_model(
            self.model_name, model_id=self.model_id,
            quantization=self.quantization or "fp32", size=self.model_size,
            mesh=self.cfg.get("mesh"), quantize_vision=self.quantize_vision)
        return vlm.get_vision_backbone()

    def load_ckpt_and_build_model(self, backbone):
        probe = MultiTaskProbe(
            backbone=backbone,
            tasks={t: get_num_classes_for_task(t) for t in self.tasks},
            freeze_backbone=self.freeze_bb, dropout_p=self.dropout_p,
            deeper_heads=self.deeper_head, hidden_dim=self.hidden_dim)
        blob = load_tensors(self.ckpt_from / MODEL_FILE)
        if blob is None:
            raise FileNotFoundError(f"{MODEL_FILE} not found in "
                                    f"{self.ckpt_from}")
        probe.load_state_tensors(blob)
        self._apply_lora(probe, blob, self.lora_cfg)
        return probe

    def iter_tasks(self) -> List[str]:
        return self.tasks

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
        return model.forward(images_list)["logits"][task] \
            .argmax(dim=-1).cpu().tolist()

    def build_eval_dir(self, task: str, dataset_name: str) -> str:
        return str(project_root() / "probing" / "multitask_probing" /
                   "eval" / self.run_name / task / dataset_name)

    def dataset_obj(self, dataset_name: str):
        return DatasetFactory.create_dataset(
            dataset_name, base_path=self.base_path, split="test",
            transform=None)
