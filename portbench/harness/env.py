"""What every run shares: the checkout's paths, the cache directories, the
device record, the import guard and the result line."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: fixed directories inside the checkout, so that only a checkout's first
#: run builds or compiles anything
CACHE_DIR = ROOT / ".portbench_cache"

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vlm_tpu")


def set_cache_env() -> None:
    """Point every build and kernel cache a library might use at the
    checkout (the port's own kernel library lives in
    ``vlm_tpu_torch/_build/``, inside the checkout already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE_DIR / sub)
    # a library that could pull JAX in by itself is kept from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), compared whole: ``vlm_tpu_torch`` is not
    ``vlm_tpu``."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(n for n in FORBIDDEN if n in names)


def load_json(path: Path):
    return json.loads(Path(path).read_text(encoding="utf-8"))


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def print_checks(checks: list) -> None:
    """Every number compared, beside its limit, as the last lines of
    standard error."""
    for c in checks:
        at = f", at {c['at']}" if c.get("at") else ""
        print(f"[check] {c['name']} = {c['value']!r} (limit {c['limit']!r}"
              f", {'ok' if c['ok'] else 'FAILED'}{at})", file=sys.stderr)
    sys.stderr.flush()


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown=None) -> str:
    """The last line of standard output; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
