#!/usr/bin/env python
"""Model-comparison sweep with the PyTorch/CUDA port: zero-shot inference
for every (model, quantization, dataset) of a YAML config, one model built
at a time, the per-run ``metrics.json`` and the throughput gathered into
``eval/comparison/summary.json`` and ``summary.csv``:

    python vlm_tpu_torch/scripts/compare_models.py \\
        --config configs/compare_models.yaml [--limit N]

The YAML is ``scripts/compare_models.py``'s (``models``,
``quantizations``, ``datasets``, ``max_tokens``, ``batch_size``,
``model_size``, ``model_id``, ``model_ids``, ``kv_cache``,
``quantize_vision``, ``mesh``, ``dataset.base_path``, ``prompts``), and so
are the rows and the run directories
``eval/comparison/<model>_<quant>/<dataset>/``. The summary is written
after every row. A model that fails to build, or a dataset that fails,
becomes a row with ``error`` and the sweep goes on; an interrupt stops it
after evaluating what completed. After each (model, quantization) the
model's device memory goes back to the card before the next is built.

``VLM_TPU_PLATFORM=cpu`` runs it on the CPU (``model_size: test``);
without it and without a CUDA device every model refuses to build.

A ``mesh`` block of more than one device runs under ``torchrun
--nproc_per_node N`` (one process a rank): every model is built at its
rank's shard, rank 0 alone writes the summary and the run directories, and
a failure raises on every rank instead of becoming a row (a rank that went
on alone would wait for its peers in the next collective).
"""

import argparse
import csv
import gc
import json
import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from vlm_tpu_torch.models.factory import create_model  # noqa: E402


def release(model) -> None:
    """Return ``model``'s device memory: its module and cached engines
    dropped, the garbage collected (the engines and the module refer to
    each other) and the allocator's cached blocks handed back."""
    device = model.device
    model.module = None
    model._engines.clear()
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Model comparison sweep")
    ap.add_argument("--config", type=str,
                    default="configs/compare_models.yaml")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("VLM_TPU_ROOT", str(REPO_ROOT))

    from vlm_tpu_torch.core.config import load_config, project_root
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.evaluation import run_zero_shot

    cfg_path = Path(args.config)
    if not cfg_path.is_absolute():
        cfg_path = project_root() / cfg_path
    cfg = load_config(cfg_path)
    mesh = mesh_from_config(cfg.get("mesh"))
    lead = mesh is None or mesh.rank == 0

    models = cfg.get("models", ["llava", "paligemma", "blip2"])
    quants = cfg.get("quantizations", ["bf16"])
    datasets = cfg["datasets"]
    max_tokens = int(cfg.get("max_tokens", 100))
    batch_size = int(cfg.get("batch_size", 32))
    prompts = cfg.get("prompts", {}) or {}
    base_path = (cfg.get("dataset", {}) or {}).get("base_path")

    out_root = project_root() / "eval" / "comparison"
    if lead:
        out_root.mkdir(parents=True, exist_ok=True)
    rows = []

    def flush():
        if not lead:
            return
        # after every row: an interrupt or a failure keeps what completed
        (out_root / "summary.json").write_text(json.dumps(rows, indent=2))
        fieldnames = sorted({k for r in rows for k in r})
        with open(out_root / "summary.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            writer.writerows(rows)

    interrupted = False
    for model_name in models:
        if interrupted:
            break
        for quant in quants:
            if interrupted:
                break
            # one model a (model, quantization); its datasets share it
            model_id = (cfg.get("model_ids") or {}).get(
                model_name, cfg.get("model_id"))
            try:
                model = create_model(
                    model_name, model_id=model_id, quantization=quant,
                    size=cfg.get("model_size"), mesh=mesh,
                    kv_cache=cfg.get("kv_cache"),
                    quantize_vision=cfg.get("quantize_vision"))
            except Exception as e:    # noqa: BLE001 — one row a failure
                if mesh is not None:
                    raise
                print(f"[sweep][ERR] {model_name}/{quant}: {e}")
                rows.append({"model": model_name, "quantization": quant,
                             "error": f"create_model: {e}"})
                flush()
                continue
            for ds_name in datasets:
                row = {"model": model_name, "quantization": quant,
                       "dataset": ds_name}
                try:
                    dataset = DatasetFactory.create_dataset(
                        ds_name, base_path=base_path, split="test",
                        transform=None)
                    prompt = prompts.get(
                        ds_name, prompts.get("face_dataset", ""))
                    if not prompt:
                        raise ValueError(f"no prompt for dataset {ds_name}")
                    print(f"[sweep] {model_name}/{quant}/{ds_name}")
                    summary = run_zero_shot(
                        model, dataset, prompt,
                        out_root / f"{model_name}_{quant}" / ds_name
                        if lead else None,
                        max_tokens=max_tokens, batch_size=batch_size,
                        limit=args.limit)
                    metrics = summary["metrics"]
                    row.update({
                        "images": summary["images_completed"],
                        "images_per_sec": summary["images_per_sec"],
                        "partial": summary["partial"],
                        "average_accuracy": metrics.get("average_accuracy"),
                        **{f"acc_{k}": v.get("accuracy")
                           for k, v in metrics.items()
                           if isinstance(v, dict) and "accuracy" in v},
                    })
                    # the batcher returns what completed on an interrupt:
                    # the sweep stops too
                    interrupted = summary["partial"]
                except Exception as e:     # noqa: BLE001 — one row a failure
                    if mesh is not None:
                        raise
                    print(f"[sweep][ERR] {model_name}/{quant}/{ds_name}: {e}")
                    row["error"] = str(e)
                rows.append(row)
                flush()
                if interrupted:
                    break
            release(model)
            del model

    print(f"[sweep] summary written to {out_root}/summary.{{json,csv}}"
          + (" (interrupted)" if interrupted else ""))
    return rows


if __name__ == "__main__":
    main()
