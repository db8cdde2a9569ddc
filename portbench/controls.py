"""Readings that the limits are set from: one process runs a cell on several
seeds, each with its window, and prints for each seed the numbers the
check compared (the program's: the lower readings) and the same numbers
with a stand-in in the program's place (the upper readings): the
reference in the precision below the configuration's (``fp8`` for bf16,
``tf32`` for fp32), or with half of each batch left out
(``half_batch``, the training cell).

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --controls fp8 [--size test]

One JSON line a seed; the chip run of it is the control's record, the
CPU run at ``--size test`` its rehearsal."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.harness import env  # noqa: E402

def readings(cell: str, seed: int, seconds: float, torch, device,
             size: str = "full", controls=None) -> dict:
    """One run of ``cell`` with the stand-ins of its kind: the program's
    numbers and each stand-in's."""
    run = R.Run(cell, seed, seconds, False, torch, device, size=size,
                t0=time.perf_counter())
    run.controls = tuple(controls or
                         R.driver(run.traffic["kind"]).CONTROLS)
    out = R.execute(run)
    run.free()
    return {"cell": cell, "seed": seed, "correct": out["correct"],
            "program": {c["name"]: c["value"] for c in out["checks"]},
            "limits": {c["name"]: c["limit"] for c in out["checks"]},
            "stand_ins": run.readings,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", default=None)
    ap.add_argument("--size", choices=("full", "test"), default="full")
    args = ap.parse_args(argv)
    env.set_cache_env()
    import torch
    device = "cuda" if args.size == "full" else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        print("controls: needs a CUDA device at the full size",
              file=sys.stderr)
        return 3
    controls = args.controls.split(",") if args.controls else None
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, torch,
                                  device, args.size, controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
