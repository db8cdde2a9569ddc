"""LLaVA (MHA: its KV heads split over the model ranks, pad id 0 as the
port's contract with vlm_tpu's "test" config says) and BLIP-2 (OPT:
learned positions, biased projections, the Q-Former whole on every rank
and its ``language_projection`` column-parallel) served by the port under
a mesh on the CPU over gloo, against vlm_tpu on one device and on its
``{data: 2, model: 2}`` mesh, at the "test" size in fp32: the checks of
``tests/test_torch_mesh_serving.py`` at ``model=2``, ``data=2`` and
``2 x 2``."""

import pytest

from tests.torch_mesh_common import (MESHES, Case, check_batcher, check_engine,
                                     check_logits, check_ranks, jax_mesh_2x2,
                                     launch)

CAPS = [5, 2, 6, 1, 4, 6]
TASKS = [["logits", {"n": 2, "steps": 2}], ["engine", {"n": 4, "new": 5}],
         ["batcher", {"n": len(CAPS), "slots": 4, "new": 6, "admit": 2,
                      "caps": CAPS}]]
FAMILIES = ["llava", "blip2"]
_REFS, _RUNS = {}, {}


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_families")


def ref(family, tmp):
    if family not in _REFS:
        case = Case(family)
        d = tmp / family
        d.mkdir()
        jmesh = jax_mesh_2x2()
        _REFS[family] = dict(
            tmp=d, spec=dict(case.write(d), tasks=TASKS),
            logits=case.logits(2, 2),
            engine=[case.engine(4, 5), case.engine(4, 5, jmesh)],
            batcher=[case.batcher(len(CAPS), 4, 6, 2, CAPS),
                     case.batcher(len(CAPS), 4, 6, 2, CAPS, jmesh)])
    return _REFS[family]


def records(family, mesh, tmp):
    if (family, mesh) not in _RUNS:
        r = ref(family, tmp)
        _RUNS[family, mesh] = launch(r["spec"], r["tmp"], MESHES[mesh], mesh)
    return _RUNS[family, mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_vlm_tpu(family, mesh, tmp):
    check_logits(records(family, mesh, tmp), ref(family, tmp)["logits"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_wave_engine_tokens_identical_to_vlm_tpu(family, mesh, tmp):
    check_engine(records(family, mesh, tmp), ref(family, tmp)["engine"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_batcher_tokens_and_counts_identical_to_vlm_tpu(family, mesh, tmp):
    check_batcher(records(family, mesh, tmp), ref(family, tmp)["batcher"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_agree_and_cover_every_image(family, mesh, tmp):
    check_ranks(records(family, mesh, tmp), MESHES[mesh])
