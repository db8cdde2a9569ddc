"""Probe evaluation loop (``vlm_tpu/probing/test/base_tester.py``): tasks x
datasets, a batched forward and argmax per batch, per-sample ``{task:
int}`` preds and gts, then ``Evaluator.evaluate(age_mode=
"classification")``, which writes preds, gts, metrics and the confusion
PNGs. A checkpoint trained with LoRA has its adapters merged into the
tower once, in place, at load (:meth:`BaseTester._apply_lora`), so
inference runs at the base model's speed.

Under a mesh (``mesh:``, the model's) every rank reads every batch; the
backbone runs this data rank's rows and gathers the features over
``data``, so every rank holds every prediction in dataset order, and
global rank 0 alone writes the files."""

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

    @staticmethod
    def _apply_lora(probe, blob, lora_cfg) -> None:
        """Merge the checkpoint's adapters (``lora.<layer>.A`` / ``.B``)
        into the tower when the run used LoRA: the targets and shapes from
        the trainers' own :func:`..lora.resolve_lora`, the values from the
        checkpoint."""
        from ..lora import load_lora_tensors, merge_lora_, resolve_lora
        spec, lora = resolve_lora({"lora": lora_cfg}, probe.backbone, seed=0)
        if not spec:
            return
        if not any(k.startswith("lora.") for k in blob):
            raise KeyError("head_config declares LoRA but the checkpoint "
                           "has no lora.* tensors")
        load_lora_tensors(lora, blob)
        merge_lora_(probe.backbone.module, lora, spec["alpha"])

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
        mesh = model.backbone.mesh
        if mesh is None or mesh.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            Evaluator.evaluate(preds, gts, output_dir=out_dir,
                               dataset_name=dataset_name,
                               age_mode="classification")
            print(f"[OK] {task} @ {dataset_name}: results saved in "
                  f"{out_dir}")
        if mesh is not None:
            mesh.barrier()

    def run(self):
        self.model = self.load_ckpt_and_build_model(self.load_backbone())
        for task in self.iter_tasks():
            for ds in self.datasets_for_task(task):
                self.run_one(self.model, task, ds)
