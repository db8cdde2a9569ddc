"""``BENCHMARK.json`` against the benchmark's contract, and the files each
entry names."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path.insert(0, str(ROOT))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|expansion|experts_per_tok|mlp)", re.I)
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    b = load()
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(b["command"]) <= 32
    assert all(line_ok(w) for w in b["command"])
    assert (ROOT / b["command"][1]).is_file()
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    b = load()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and line_ok(e["why"])
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_what_it_must():
    b = load()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        mine = [m for m in b["end_to_end"] if has(m)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = [m for m in b["per_layer"] if has(m)]
        assert layer
        for m in layer:
            assert has(e2e[m["moves"]])
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_files_each_entry_names():
    b = load()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and NAME.match(
            Path(c["file"]).stem)
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_use_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("path", sorted(
    str(p) for p in (BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("vlm_tpu", "vlm_tpu_torch", "jax",
                                           "flax", "optax"), (path, m)
