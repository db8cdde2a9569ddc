"""Where the probing path's time goes on the card: LLaVA-1.5-7B's
CLIP-L/336 tower in fp32 (random weights, built alone: no decoder), a
linear head over its mean-pooled features.

    python vlm_tpu_torch/testing/profile_probe.py [--steps N] [--batch B]
        [--root DIR]

``--root``: the repository whose ``vlm_tpu_torch`` to import (default this
one), e.g. a parent commit unpacked with ``git archive`` under
``_checkout/``, so that two trees are profiled in one call on one card.

Two phases, each timed by the host clock around synchronised work and
profiled under ``torch.profiler`` (the kernels' own device time by name):

- extraction: batches of 8 uint8 images through B4 and the frozen tower
  under ``inference_mode`` (the feature cache's loop);
- end to end: training steps at ``--batch`` images with the last 4 blocks
  and the embeddings unfrozen (the multi profile's backbone block), the
  single-task trainer's loss (:func:`probe_loss`) and its AdamW
  (``optax.adamw``'s settings, two param groups); B1's differentiable form
  in every block (its backward the fp32 kernel, where the tree has one,
  else a recompute). The forward alone (the loss, synchronised) is timed
  too; the rest of a step is the backward and AdamW.

Prints one JSON line: the card's name and power limit, per phase the wall
ms, the device ms (the kernels' own times summed) and the top kernels by
device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def _top(prof, n=12):
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), [
        {"kernel": k[:90], "ms": round(ms, 3), "launches": c}
        for k, ms, c in rows[:n]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--root", default=str(REPO_ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vlm_tpu_torch.models.backbone import VisionBackbone
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vit import ViTEncoder
    from vlm_tpu_torch.ops.preprocess import RECIPES
    from vlm_tpu_torch.probing.probes import LinearProbe
    from vlm_tpu_torch.probing.train.singletask_trainer import probe_loss

    if not torch.cuda.is_available():
        raise SystemExit("profile_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cfg = VLM_CONFIGS["llava"]("7b")
    tower = init_random_(ViTEncoder(cfg.vision, dtype=torch.float32,
                                    device="cuda"), seed=0)
    bb = VisionBackbone(cfg, tower, torch.float32, RECIPES["llava"],
                        batch_size=8)
    probe = LinearProbe(bb, 9, dropout_p=0.3, seed=0)
    rng = np.random.default_rng(0)
    side = cfg.vision.image_size
    out = {"gpu": gpu, "root": args.root}

    # extraction: batches of 8, frozen
    u8 = torch.from_numpy(rng.integers(0, 256, (4, 8, side, side, 3),
                                       dtype=np.uint8)).cuda()
    with torch.inference_mode():
        bb.forward(u8[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in u8:
            bb.forward(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(u8) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in u8:
                bb.forward(x)
            torch.cuda.synchronize()
    dev, top = _top(prof)
    out["extract_batch8"] = {"wall_ms": wall, "device_ms": dev / len(u8),
                             "top": top}

    # end to end
    probe.unfreeze_last_backbone_k_layers(4)
    trainable = [p for p in tower.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(
        [{"params": list(probe.classifier.parameters()), "lr": 1e-4},
         {"params": trainable, "lr": 1e-5}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    imgs = torch.from_numpy(rng.integers(0, 256, (args.batch, side, side, 3),
                                         dtype=np.uint8)).cuda()
    y = rng.integers(0, 9, args.batch)
    cw = torch.ones(9, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def forward():
        return probe_loss(probe, imgs, y, cw, train=True, generator=gen)

    def step():
        opt.zero_grad(set_to_none=True)
        forward().backward()
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.steps * 1e3

    step()
    torch.cuda.reset_peak_memory_stats()
    wall = timed(step)
    peak = torch.cuda.max_memory_allocated()
    fwd = timed(forward)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev, top = _top(prof, 16)
    out["e2e_step"] = {"batch": args.batch, "wall_ms": wall,
                       "forward_wall_ms": fwd,
                       "images_per_s": args.batch / wall * 1e3,
                       "device_ms": dev, "peak_gib": peak / 2**30,
                       "top": top}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
