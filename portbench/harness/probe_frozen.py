"""The frozen probing cell: the backbone the single-task trainer builds
(EVA ViT-g in fp32), whose feature extraction (``extract_features_dataset``)
runs over JPEG files at the batch the trainer gives it; the window repeats
it over one file list, each call ending with the features on the host.
The check holds a sample of the last call's features against the plain
reference on the same files."""

from __future__ import annotations

import numpy as np

from . import faces
from . import trace as tr
from .probe import SPANS, window
from .weights import draw, seed_of

#: the stand-ins ``controls.py`` puts in the program's place
CONTROLS = ("tf32",)


def run(ctx) -> dict:
    torch = ctx.torch
    t, dev = ctx.traffic, ctx.device
    vis = ctx.widths["vision"]
    work = ctx.workdir()
    paths = faces.write(work, t, ctx.seed, vis["image_size"])
    files = [str(p) for p in paths[(t["files_from"], "train")]]
    from vlm_tpu_torch.models.factory import create_model

    port = ctx.config["port"]
    vlm = create_model(port["family"], quantization=port["quantization"],
                       size=ctx.size_name(port["size"]), device=dev)
    backbone = vlm.get_vision_backbone()
    del vlm
    ctx.check_widths(backbone.cfg)
    prog = {f"vision.{n}": p for n, p in backbone.module.named_parameters()}
    W = draw([(n, tuple(p.shape)) for n, p in prog.items()], torch.float32,
             dev, ctx.seed, torch)
    with torch.no_grad():
        for n, p in prog.items():
            p.copy_(W[n])
    bs = backbone.batch_size

    def call(fl):
        return backbone.extract_features_dataset(fl, progress=False)

    call(files[:bs])                              # the one shape, warmed
    last = {}

    def step(fl):
        last["feats"] = call(fl)
        return bool(np.isfinite(last["feats"]).all())

    steps, failed = window(ctx, lambda: files, step)
    steps["batches"] = steps["steps"] * -(-len(files) // bs)
    dtr = None
    if ctx.trace:
        dtr = tr.DeviceTrace(torch, SPANS)
        dtr.start()
        for _ in range(t["trace_steps"]):
            tr.record(torch, SPANS[2], call)(files)
        dtr.stop()
    memory_peak = ctx.memory_peak()
    feats = last["feats"]
    del backbone, prog
    ctx.free()
    checks = check(ctx, W, files, feats, t)
    rec = {"kind": "probe", "mode": "frozen", "window": steps, "batch": bs,
           "widths": ctx.widths,
           "trace": dtr.read() if dtr is not None else None,
           "trace_steps": t["trace_steps"] * -(-len(files) // bs),
           "trained_blocks": 0, "patch_trained": False}
    return {"setup_s": steps["setup_s"],
            "e2e": {"probe_images_per_s": steps["images"] /
                    steps["seconds"]},
            "record": rec, "attempted": steps["images"],
            "failed": failed * len(files), "checks": checks,
            "memory_peak": memory_peak}


def check(ctx, W, files, feats, t) -> list:
    """A sample of the last call's features, drawn from the seed, against
    the reference tower on the same files decoded by PIL: the worst row's
    relative distance. With ``ctx.controls`` (``"tf32"``), the reference
    in that precision stands in for the program (``ctx.readings``)."""
    torch = ctx.torch
    from PIL import Image

    from portbench.reference.blip2 import eva
    from portbench.reference.precision import Precision, strict_fp32

    strict_fp32()
    rng = np.random.default_rng(seed_of(ctx.seed, 14))
    k = min(t["check_images"], len(files))
    pick = sorted(rng.choice(len(files), k, replace=False).tolist())
    w = ctx.widths
    worst, ctrl = 0.0, {c: 0.0 for c in ctx.controls}
    with torch.no_grad():
        for j in range(0, k, t["check_rows_per_block"]):
            ids = pick[j:j + t["check_rows_per_block"]]
            u8 = torch.from_numpy(np.stack([np.asarray(
                Image.open(files[i]).convert("RGB"), np.uint8)
                for i in ids])).to(ctx.device)

            def pooled(mode):
                return eva(Precision(mode), W, w["vision"], u8,
                           w["image_mean"], w["image_std"])[1]

            ref = pooled("fp32")

            def rel(got):
                return float(((got - ref).norm(dim=-1) /
                              ref.norm(dim=-1)).max())

            worst = max(worst, rel(torch.from_numpy(feats[ids]).to(
                ctx.device)))
            for c in ctx.controls:
                ctrl[c] = max(ctrl[c], rel(pooled(c)))
    for c, v in ctrl.items():
        ctx.readings[c] = {"feature_gap": v}
    lim = ctx.limits["feature_gap"]
    return [{"name": "feature_gap", "value": worst, "limit": lim,
             "ok": bool(worst <= lim)}]
