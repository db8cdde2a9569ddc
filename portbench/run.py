"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the driver,
``portbench/harness/<kind>.py``);
its limits are ``portbench/limits/<cell>.json`` and each per-layer metric
is read by ``portbench/metrics/<metric>.py``. A run makes its weights and
inputs from ``--seed``, sets up, measures for ``--seconds`` seconds, checks
what the timed path produced against the plain reference in
``portbench/reference/``, prints each number compared beside its limit as
the last lines of standard error, and prints one JSON line last on
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch after the
window. It needs an NVIDIA GPU and exits non-zero without one.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import env  # noqa: E402

KIND = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


class Run:
    """What a driver needs of one run: the cell's files, the seed and the
    window, the device, and the size (``"full"``: the configuration's
    widths and the traffic as written; ``"test"``: the configuration's
    ``test_widths`` and the traffic's ``test`` overrides, for the CPU
    tests)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 torch, device, size: str = "full", bench: dict = None,
                 t0: float = None):
        self.torch = torch
        self.device = torch.device(device)
        if self.device.type == "cpu":
            # the port's trainers build their model where this names
            os.environ["VLM_TPU_PLATFORM"] = "cpu"
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.size = size
        self.t0 = T0 if t0 is None else t0
        bench = bench or env.benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise SystemExit(f"unknown workload {cell!r}; the cells: "
                             f"{sorted(cells)}")
        self.cell = cells[cell]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = env.load_json(ROOT / configs[self.cell["config"]]
                                    ["file"])
        self.traffic = env.load_json(env.BENCH_DIR / "traffic" /
                                     f"{self.cell['traffic']}.json")
        self.limits = env.load_json(env.BENCH_DIR / "limits" /
                                    f"{cell}.json")
        self.widths = self.config["widths"]
        if size == "test":
            self.widths = self.config["test_widths"]
            self.traffic = merged(self.traffic, self.traffic.get("test", {}))
        self.bench = bench
        self._dirs = []
        #: stand-ins put in the program's place (a lower precision, a
        #: planted fault) whose numbers a control run reads, and their
        #: readings by stand-in
        self.controls = ()
        self.readings = {}

    def size_name(self, full: str) -> str:
        return "test" if self.size == "test" else full

    def check_widths(self, vcfg) -> None:
        """The port's configuration has the widths the file states."""
        import dataclasses
        got = dataclasses.asdict(vcfg)
        for part in ("vision", "qformer", "decoder"):
            have = got.get(part) or {}
            diff = {k: (v, have.get(k)) for k, v in
                    self.widths.get(part, {}).items() if have.get(k) != v}
            if diff:
                raise SystemExit(f"the port's {part} differs from the "
                                 f"configuration file: {diff}")

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def workdir(self) -> Path:
        import tempfile
        d = Path(tempfile.mkdtemp(prefix="portbench-"))
        self._dirs.append(d)
        return d

    def cleanup(self) -> None:
        for d in self._dirs:
            shutil.rmtree(d, ignore_errors=True)


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports: end-to-end without the trace,
    per-layer with it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, record: dict):
    """The per-layer metric ``name`` from ``metrics/<name>.py``'s
    ``read(record)``; None where it found nothing to read."""
    path = env.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def driver(kind: str):
    """The driver of a traffic's ``kind``: the module
    ``portbench/harness/<kind>.py``, whose ``run(ctx)`` makes one run and
    whose ``CONTROLS`` names the stand-ins ``controls.py`` puts in the
    program's place."""
    if not KIND.match(kind) or not \
            (env.BENCH_DIR / "harness" / f"{kind}.py").is_file():
        raise SystemExit(f"no driver portbench/harness/{kind}.py for the "
                         f"traffic's kind {kind!r}")
    return importlib.import_module(f"portbench.harness.{kind}")


def execute(run: Run) -> dict:
    """The driver's result, with ``metrics`` and ``correct`` added."""
    drive = driver(run.traffic["kind"]).run
    try:
        out = drive(run)
    finally:
        run.cleanup()
    cell = run.cell["name"]
    metrics = {}
    for m in metrics_for(run.bench, cell, run.trace):
        if run.trace:
            v = read_metric(m["name"], out["record"])
        elif m["name"] == "setup_s":
            v = out["setup_s"]
        else:
            v = out["e2e"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["correct"] = all(c["ok"] for c in out["checks"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.set_cache_env()
    bench = env.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload, 1)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch, "cuda", bench=bench)
    out = execute(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": out["memory_peak"]}
    breakdown = None
    tr_rec = out["record"].get("trace")
    if tr_rec is not None:
        from portbench.harness.trace import breakdown as bd
        device["busy_s"] = tr_rec["busy_s"]
        device["window_s"] = tr_rec["wall_s"]
        breakdown = bd(tr_rec)
    bad = env.forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    env.print_checks(out["checks"])
    print(env.result_line(correct=out["correct"],
                          attempted=out["attempted"], failed=out["failed"],
                          metrics=out["metrics"], device=device,
                          checks=out["checks"], breakdown=breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
