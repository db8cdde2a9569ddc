#!/usr/bin/env python
"""Zero-shot prompt inference over a dataset with the PyTorch/CUDA port.

Same YAML surface as ``scripts/prompt_inference.py``; runs the port's model
on the card through the port's ``run_zero_shot`` (the continuous batcher),
or with ``continuous_batching: false`` in waves of ``batch_size`` images
through ``generate_batch`` (beam search with ``num_beams > 1``):

    python vlm_tpu_torch/scripts/prompt_inference.py \\
        --config configs/prompt_inference.yaml [--limit N] [--profile DIR]

It prints the throughput meter's ``[THROUGHPUT]`` line (the first image
left out of the steady rate), "Interrupted: evaluated k/n images." after
an interrupt and "Nothing to evaluate." when no image completed, then the
JSON summary. ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
of the run (host and card) to ``DIR/trace.json``, also when the run
raises. ``VLM_TPU_PLATFORM=cpu`` runs it on the CPU instead (fp32 or a
"test" size); without it and without a CUDA device the model refuses to
build.

With a ``mesh: {data, model}`` block of more than one device, launch one
process a rank:

    torchrun --nproc_per_node N -m vlm_tpu_torch.scripts.prompt_inference \\
        --config <yaml>

Rank 0 alone writes the artifacts and prints the meter and the summary;
every rank takes part in every collective, and an interrupt on any rank
stops them all at the same chunk boundary.
Imports only the port (dataset readers, tokenizer, evaluator and config
helpers are its own copies); reading the YAML config needs PyYAML and
reading images needs Pillow.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def run_waves(model, dataset, prompt: str, output_dir, *, max_tokens: int,
              batch_size: int, limit=None, progress=None,
              generation=None) -> dict:
    """``continuous_batching: false``: waves of ``batch_size`` images
    through ``model.generate_waves``, then the evaluator on what completed
    (all of it, unless interrupted). Returns ``run_zero_shot``'s
    summary."""
    from vlm_tpu_torch.evaluation import evaluate_outputs
    n = len(dataset) if limit is None else min(limit, len(dataset))
    t0 = time.perf_counter()
    outputs = model.generate_waves(dataset.image_paths()[:n], prompt,
                                   batch_size, progress,
                                   max_tokens=max_tokens,
                                   **(generation or {}))
    return evaluate_outputs(outputs, dataset, output_dir,
                            time.perf_counter() - t0)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Zero-shot inference with the PyTorch port (YAML config)")
    parser.add_argument("--config", type=str,
                        default="configs/prompt_inference.yaml")
    parser.add_argument("--limit", type=int, default=None,
                        help="optional cap on the number of images")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace of the inference "
                             "run to DIR/trace.json (view with Perfetto)")
    args = parser.parse_args(argv)
    os.environ.setdefault("VLM_TPU_ROOT", str(REPO_ROOT))

    from vlm_tpu_torch.core.config import load_config, save_config
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.evaluation import run_zero_shot
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.utils.profiling import ThroughputMeter, profile_trace

    root = os.environ["VLM_TPU_ROOT"]
    cfg_path = args.config if os.path.isabs(args.config) \
        else os.path.join(root, args.config)
    cfg = load_config(cfg_path)
    continuous = bool(cfg.get("continuous_batching", True))

    mesh = mesh_from_config(cfg.get("mesh"))   # under torchrun: the group
    lead = mesh is None or mesh.rank == 0
    model_name = cfg["model_name"]
    quantization = cfg["quantization"]
    dataset_name = cfg["dataset_name"]
    output_dir = os.path.join(
        root, f"eval/prompt_inference/{model_name}_{quantization}/"
        f"{dataset_name}")
    if lead:
        os.makedirs(output_dir, exist_ok=True)
        print("Output directory:", output_dir)

    if cfg.get("int8_prefill"):
        # the int8 prefill product (dequant | dynamic | dynamic_noout), read
        # and validated when the model's int8 layers are built
        os.environ["VLM_TPU_INT8_PREFILL"] = str(cfg["int8_prefill"]).lower()
    model = create_model(
        model_name, model_id=cfg.get("model_id"), quantization=quantization,
        size=cfg.get("model_size"), mesh=mesh,
        kv_cache=cfg.get("kv_cache"),
        quantize_vision=cfg.get("quantize_vision"))
    ds_cfg = cfg.get("dataset", {}) or {}
    dataset = DatasetFactory.create_dataset(
        dataset_name, base_path=ds_cfg.get("base_path", None), split="test",
        transform=None)
    prompts = cfg.get("prompts", {}) or {}
    prompt = prompts.get(dataset_name) or prompts.get("face_dataset", "")
    if not prompt:
        raise ValueError("No prompt found in config (section 'prompts').")
    if lead:
        save_config(cfg, os.path.join(output_dir, "used_config.yaml"))

    gen = {k: cfg[k] for k in
           ("num_beams", "temperature", "top_k", "top_p", "seed")
           if cfg.get(k) is not None}
    n = len(dataset) if args.limit is None else min(args.limit, len(dataset))
    batch_size = int(cfg.get("batch_size", 32))
    if lead:
        print(f"Running inference on dataset: {dataset_name} ({n} images, "
              f"batch={batch_size}, continuous={continuous}) on "
              f"{model.device}" + (f", {mesh}" if mesh is not None else ""))
    meter = ThroughputMeter()
    run = run_zero_shot if continuous else run_waves
    try:
        # the trace covers the whole run and is written even if it raises
        with profile_trace(args.profile if lead else None):
            summary = run(model, dataset, prompt,
                          output_dir if lead else None,
                          max_tokens=int(cfg.get("max_tokens", 100)),
                          batch_size=batch_size, limit=args.limit,
                          progress=meter.update, generation=gen)
            if lead:
                meter.report("prompt_inference")
                if summary["partial"]:
                    print(f"Interrupted: evaluated "
                          f"{summary['images_completed']}/{n} images.")
                elif summary["images_completed"] == 0:
                    print("Nothing to evaluate.")
    finally:
        if args.profile and lead:
            print(f"Profiler trace written to {args.profile}")
    if lead:
        print(json.dumps({k: v for k, v in summary.items()
                          if k != "metrics"}))
    return summary


if __name__ == "__main__":
    main()
