"""PaliGemma (MQA: one KV head, replicated on every rank) served by the
port under a mesh, on the CPU over gloo, against vlm_tpu on one device and
on its ``{data: 2, model: 2}`` mesh, at the "test" size in fp32, on the
same weights carried across by the bridge.

At ``model=2``, ``data=2`` and ``2 x 2``: prefill and decode logits within
rtol = atol = 1e-4; greedy tokens through the wave engine and the
continuous batcher identical to both of vlm_tpu's runs; the batcher's
``admits`` and ``chunks`` identical; every rank's results the same; under
``data=2`` the data ranks' slots serve every image exactly once; the
collectives of each axis run, and no kernel's CUDA form (the CPU takes the
plain versions).
"""

import numpy as np
import pytest
import torch

from tests.torch_mesh_common import (MESHES, Case, check_batcher, check_engine,
                                      check_logits, check_ranks, jax_mesh_2x2,
                                      launch, task)

CAPS = [6, 1, 3, 6, 2, 5, 4]
TASKS = [["logits", {"n": 2, "steps": 3}], ["engine", {"n": 4, "new": 6}],
         ["batcher", {"n": len(CAPS), "slots": 4, "new": 6, "admit": 2,
                      "caps": CAPS}],
         ["row_parallel", {"k": 256, "n": 128, "rows": [4, 512]}]]
_RUNS = {}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    case = Case("paligemma")
    tmp = tmp_path_factory.mktemp("mesh_paligemma")
    spec = dict(case.write(tmp), tasks=TASKS)
    jmesh = jax_mesh_2x2()
    return dict(
        case=case, tmp=tmp, spec=spec, logits=case.logits(2, 3),
        engine=[case.engine(4, 6), case.engine(4, 6, jmesh)],
        batcher=[case.batcher(len(CAPS), 4, 6, 2, CAPS),
                 case.batcher(len(CAPS), 4, 6, 2, CAPS, jmesh)])


def records(ref, mesh):
    if mesh not in _RUNS:
        _RUNS[mesh] = launch(ref["spec"], ref["tmp"], MESHES[mesh], mesh)
    return _RUNS[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_and_decode_logits_match_vlm_tpu(ref, mesh):
    check_logits(records(ref, mesh), ref["logits"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_wave_engine_tokens_identical_to_vlm_tpu(ref, mesh):
    check_engine(records(ref, mesh), ref["engine"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batcher_tokens_and_counts_identical_to_vlm_tpu(ref, mesh):
    check_batcher(records(ref, mesh), ref["batcher"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_agree_and_cover_every_image(ref, mesh):
    check_ranks(records(ref, mesh), MESHES[mesh])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_bf16_row_parallel_layer_rounds_once(ref, mesh):
    """A row-parallel bf16 layer (float, int8 and int4 weights; B5/B7's
    plain versions at 4 rows, llm.int8 and the dequantized product at
    512) within one of its output's bf16 steps of the same layer whole,
    on inputs whose halves of K nearly cancel; the partials rounded to
    bf16 before the all-reduce would miss by several."""
    for rec in records(ref, mesh):
        cases = task(rec, "row_parallel")["cases"]
        assert len(cases) == 6
        for c in cases:
            assert c["err_steps"] <= 1, c
            if MESHES[mesh]["model"] > 1:
                assert c["partial_over_out"] > 8 and c["naive_steps"] > 2, c
            else:
                assert c["err_steps"] == 0, c


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_shard(ref, mesh):
    """``param_bytes`` over the model ways is what a rank's parameters
    hold; MQA's K/V are whole on every rank, so a rank holds more than
    1/model of the weights."""
    recs = records(ref, mesh)
    full = records(ref, "data2")[0]["held_bytes"]
    for rec in recs:
        assert rec["held_bytes"] == rec["param_bytes"]
        if MESHES[mesh]["model"] > 1:
            assert full / 2 < rec["held_bytes"] < full
        else:
            assert rec["held_bytes"] == full


def test_a_stop_from_any_rank_ends_every_rank_at_a_chunk_boundary(ref):
    """Under a mesh an interrupt does not raise where it lands: each chunk's
    dispatch asks every rank (one all-reduce) whether one was stopped, and
    all raise there together. Here a one-rank stand-in mesh answers "yes"
    at the third chunk: the batcher returns what the chunks before it
    completed, as vlm_tpu's loop does on Ctrl-C, and the images after stay
    None."""
    from vlm_tpu_torch.core.mesh import Mesh
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher

    class Stopping(Mesh):
        asked = 0

        def any(self, flag):
            Stopping.asked += 1
            return Stopping.asked >= 3

    case = ref["case"]
    module = case.port()
    module.mesh = Stopping(1, 1, groups=False)
    b = ContinuousBatcher(module, case.cfg, batch_size=4,
                          max_prompt_len=case.plen, max_new_tokens=6,
                          admit_block=2)
    out = b.run(lambda idxs: torch.from_numpy(case.pixels[idxs]),
                pre_ids_row=np.asarray(case.pre, np.int32),
                post_ids_row=np.asarray(case.post, np.int32),
                prompt_len_scalar=case.plen, n_images=len(CAPS),
                max_new_per_image=CAPS)
    full = ref["batcher"][0][0]
    done = [i for i, o in enumerate(out) if o is not None]
    assert Stopping.asked == 3 and 0 < len(done) < len(CAPS)
    assert all(out[i] == full[i] for i in done)
    assert b.last_stats["chunks"] == 2
