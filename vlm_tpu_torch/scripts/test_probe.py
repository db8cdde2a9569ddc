#!/usr/bin/env python
"""Probe testing with the PyTorch/CUDA port.

Same arguments and YAML as ``scripts/test_probe.py``:

    python vlm_tpu_torch/scripts/test_probe.py \\
        --config configs/test_probe.yaml [--profile single]

Reads the port's checkpoint (``eval.ckpt_from``, relative to the project
root) and writes preds, gts and metrics under
``probing/linear_probing/eval/`` (single) or
``probing/multitask_probing/eval/`` (multi); a LoRA checkpoint's adapters
are merged into the tower at load. Runs on the card;
``VLM_TPU_PLATFORM=cpu`` runs it on the CPU.

Under a ``mesh: {data, model}`` block, one process a rank:

    torchrun --nproc_per_node 4 -m vlm_tpu_torch.scripts.test_probe \\
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Unified testing entrypoint (single/multi profile)")
    ap.add_argument("--config", type=str, default="configs/test_probe.yaml")
    ap.add_argument("--profile", type=str, choices=["single", "multi"],
                    help="Override the YAML 'profile' (single|multi)")
    args = ap.parse_args(argv)
    os.environ.setdefault("VLM_TPU_ROOT", str(REPO_ROOT))

    from vlm_tpu_torch.core.config import (build_cfg_from_profile,
                                           load_config, project_root)
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.probing.test.multitask_tester import MultiTaskTester
    from vlm_tpu_torch.probing.test.singletask_tester import \
        SingleTaskTester

    cfg_path = Path(args.config)
    if not cfg_path.is_absolute():
        cfg_path = project_root() / cfg_path
    raw = load_config(cfg_path)
    profile = (args.profile or str(raw.get("profile", ""))).lower()
    if profile not in ("single", "multi"):
        raise ValueError("Specify the profile: --profile single|multi or "
                         "profile: single|multi in the YAML")
    cfg = build_cfg_from_profile(raw, profile, cfg_path, require_eval=True)
    # forms the process group under torchrun; a block of more than one
    # device without a group of data x model ranks raises with the line
    mesh_from_config(cfg.get("mesh"), script="test_probe")
    tester = MultiTaskTester(cfg) if profile == "multi" \
        else SingleTaskTester(cfg)
    tester.run()
    return tester


if __name__ == "__main__":
    main()
