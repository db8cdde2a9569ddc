"""The rank pool of ``vlm_tpu_torch/testing/mesh_pool.py`` on the CPU over
gloo: two ranks, launched once, take runs of different meshes in turn,
and each run gives what a fresh launch gives (PaliGemma at the "test"
size in fp32 against ``vlm_tpu`` on one device: logits within 1e-4,
greedy tokens identical). A run that fails on one rank ends the launch
and raises, and no process of it is left."""

import os
import signal

import pytest

from tests.torch_mesh_common import (MESHES, REPO, Case, check_engine,
                                     check_logits)
from vlm_tpu_torch.testing.mesh_pool import MeshPool

TASKS = [["logits", {"n": 2, "steps": 3}], ["engine", {"n": 4, "new": 6}]]
ORDER = ("model2", "data2")


def _env():
    env = dict(os.environ, VLM_TPU_DIST_TIMEOUT="60", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    case = Case("paligemma")
    tmp = tmp_path_factory.mktemp("mesh_pool")
    spec = dict(case.write(tmp), tasks=TASKS)
    pool = MeshPool(2, tmp / "queue", 180, "cpu", env=_env())
    try:
        recs = {m: pool.run("mesh_serve", dict(spec, mesh=MESHES[m]),
                            tmp / m) for m in ORDER}
    finally:
        pool.close()
    return dict(case=case, recs=recs, rc=pool.proc.returncode,
                log=pool.log())


@pytest.mark.parametrize("mesh", ORDER)
def test_each_run_matches_vlm_tpu(runs, mesh):
    case, recs = runs["case"], runs["recs"][mesh]
    assert [r["rank"] for r in recs] == [0, 1]
    assert {(r["data_rank"], r["model_rank"]) for r in recs} == (
        {(0, 0), (0, 1)} if mesh == "model2" else {(0, 0), (1, 0)})
    check_logits(recs, case.logits(2, 3))
    check_engine(recs, [case.engine(4, 6)])


def test_the_pool_forms_its_group_once_and_ends_cleanly(runs):
    assert runs["rc"] == 0, runs["log"][-4000:]
    # each rank prints its ``[mesh]`` line where it forms the group
    assert runs["log"].count("[mesh] rank ") == 2


def test_a_failing_run_ends_every_rank_and_raises(tmp_path):
    pool = MeshPool(2, tmp_path / "queue", 180, "cpu", env=_env())
    try:
        with pytest.raises(RuntimeError, match="no_such_task"):
            pool.run("mesh_serve", dict(
                family="paligemma", size="test", dtype="float32", bits=0,
                device="cpu", mesh=MESHES["data2"], pre_ids=[],
                post_ids=[1], threads=1, tasks=[["no_such_task", {}]]),
                tmp_path / "out")
    finally:
        pool.close()
    assert pool.proc.returncode is not None
    with pytest.raises(ProcessLookupError):
        os.killpg(pool.proc.pid, signal.SIGKILL)
