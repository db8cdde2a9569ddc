#!/usr/bin/env python
"""Probe training with the PyTorch/CUDA port.

Same arguments and YAML as ``scripts/train_probe.py``: ``--config`` (a
``common`` section deep-merged with the ``single`` or ``multi`` profile)
and ``--profile single|multi``:

    python vlm_tpu_torch/scripts/train_probe.py \\
        --config configs/train_probe.yaml [--profile single]

Checkpoints go to ``probing/linear_probing/checkpoints/<run name>``
(single) or ``probing/multitask_probing/checkpoints/<run name>`` (multi)
under the project root (``VLM_TPU_ROOT``, by default the repository).
``model.lora.enabled: true`` trains LoRA adapters in either profile. Runs
on the card; ``VLM_TPU_PLATFORM=cpu`` runs it on the CPU.

Under a ``mesh: {data, model}`` block, one process a rank:

    torchrun --nproc_per_node 4 -m vlm_tpu_torch.scripts.train_probe \\
        --config <yaml with mesh: {data: 2, model: 2}>

(with ``VLM_TPU_PLATFORM=cpu`` on the CPU, over gloo); global rank 0
writes the files.
"""

import argparse
import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def build_trainer(argv=None):
    """The trainer the command line asks for, built (its data loaded and,
    with a frozen backbone, its features extracted) but not yet fitted."""
    ap = argparse.ArgumentParser(
        description="Unified training entrypoint (single/multi profile)")
    ap.add_argument("--config", type=str, default="configs/train_probe.yaml")
    ap.add_argument("--profile", type=str, choices=["single", "multi"],
                    help="Override the YAML 'profile' (single|multi)")
    args = ap.parse_args(argv)
    os.environ.setdefault("VLM_TPU_ROOT", str(REPO_ROOT))

    from vlm_tpu_torch.core.config import (build_cfg_from_profile,
                                           load_config, make_run_name,
                                           project_root)
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        MultiTaskTrainer
    from vlm_tpu_torch.probing.train.singletask_trainer import \
        SingleTaskTrainer

    cfg_path = Path(args.config)
    if not cfg_path.is_absolute():
        cfg_path = project_root() / cfg_path
    raw = load_config(cfg_path)
    profile = (args.profile or str(raw.get("profile", ""))).lower()
    if profile not in ("single", "multi"):
        raise ValueError("Specify the profile: --profile single|multi or "
                         "profile: single|multi in the YAML")
    cfg = build_cfg_from_profile(raw, profile, cfg_path)
    # forms the process group under torchrun; a block of more than one
    # device without a group of data x model ranks raises with the line
    mesh_from_config(cfg.get("mesh"), script="train_probe")
    run_name = make_run_name(cfg, profile)
    if profile == "multi":
        return MultiTaskTrainer(cfg, run_name, project_root() / "probing" /
                                "multitask_probing" / "checkpoints")
    return SingleTaskTrainer(cfg, run_name, project_root() / "probing" /
                             "linear_probing" / "checkpoints")


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
