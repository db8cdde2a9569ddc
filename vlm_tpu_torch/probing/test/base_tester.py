"""Probe evaluation loop (``vlm_tpu/probing/test/base_tester.py``): tasks x
datasets, a batched forward and argmax per batch, per-sample ``{task:
int}`` preds and gts, then ``Evaluator.evaluate(age_mode=
"classification")``, which writes preds, gts, metrics and the confusion
PNGs."""

from __future__ import annotations

import os
from typing import List

from ...evaluation import Evaluator
from ..train.data import ImageBatchLoader


class BaseTester:
    """Subclasses implement ``load_backbone``, ``load_ckpt_and_build_model``,
    ``iter_tasks``, ``datasets_for_task``, ``predict_step``,
    ``build_eval_dir`` and ``dataset_obj``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        dcfg = cfg["data"]
        self.base_path = dcfg.get("base_path", None)
        self.batch_size = int(dcfg.get("batch_size", 128))
        self.model = None

    def load_backbone(self):
        raise NotImplementedError

    def load_ckpt_and_build_model(self, backbone):
        raise NotImplementedError

    def iter_tasks(self) -> List[str]:
        raise NotImplementedError

    def datasets_for_task(self, task: str) -> List[str]:
        raise NotImplementedError

    def predict_step(self, model, batch, task: str) -> List[int]:
        raise NotImplementedError

    def build_eval_dir(self, task: str, dataset_name: str) -> str:
        raise NotImplementedError

    def dataset_obj(self, dataset_name: str):
        raise NotImplementedError

    def run_one(self, model, task: str, dataset_name: str):
        loader = ImageBatchLoader(self.dataset_obj(dataset_name),
                                  self.batch_size)
        preds, gts = [], []
        for images_list, targets_list in loader:
            pred_idxs = self.predict_step(model, (images_list, targets_list),
                                          task)
            for i, tgt in enumerate(targets_list):
                preds.append({task: int(pred_idxs[i])})
                gts.append({task: int(tgt.get(task, -1))})
        out_dir = self.build_eval_dir(task, dataset_name)
        os.makedirs(out_dir, exist_ok=True)
        Evaluator.evaluate(preds, gts, output_dir=out_dir,
                           dataset_name=dataset_name,
                           age_mode="classification")
        print(f"[OK] {task} @ {dataset_name}: results saved in {out_dir}")

    def run(self):
        self.model = self.load_ckpt_and_build_model(self.load_backbone())
        for task in self.iter_tasks():
            for ds in self.datasets_for_task(task):
                self.run_one(self.model, task, ds)
