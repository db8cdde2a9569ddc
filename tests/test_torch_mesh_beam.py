"""Beam search under a mesh with a data axis (``data=2`` and ``2 x 2``):
PaliGemma at the "test" size in fp32, served by the port's ranks on the
CPU over gloo (``vlm_tpu_torch/testing/mesh_serve.py``), against vlm_tpu's
``BeamSearchEngine`` on one device and on its ``{data: 2, model: 2}``
mesh, on the same weights carried across by the bridge.

- The engine: each data rank runs the K beams of its own images; the best
  tokens and lengths are identical to both of vlm_tpu's runs, the scores
  within rtol 1e-5, every rank holding every image's result; the EOS id
  is one the model emits (EOS candidates enter the hypothesis pool).
- The user's entry points: ``generate_batch`` over 3 images and
  ``generate_dataset``'s beam waves over 5 files in waves of 4 (odd
  counts: the batch padded to a multiple of ``data`` with its last image,
  the extras dropped) give the texts of the port on one device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from tests.torch_mesh_common import Case, jax_mesh_2x2, launch, task
from vlm_tpu.core.mesh import maybe_mesh
from vlm_tpu.generate.beam import BeamSearchEngine as JaxBeam
from vlm_tpu.parallel.sharding import shard_batch
from vlm_tpu_torch.models.factory import create_model

MESHES = {"data2": {"data": 2, "model": 1}, "2x2": {"data": 2, "model": 2}}
N, NEW, K = 4, 6, 2
PROMPT = "describe"
SCORE_RTOL = 1e-5
_RUNS = {}


def jax_beam(case, eos, mesh=None):
    pre = np.zeros((N, 0), np.int32)
    post = np.asarray([case.post] * N, np.int32)
    args = [jnp.asarray(a) for a in (case.pixels[:N], pre, post,
                                     np.full((N,), case.plen, np.int32))]
    eng = JaxBeam(case.jmod, case.jcfg, batch_size=N,
                  max_prompt_len=case.plen, num_beams=K, max_new_tokens=NEW,
                  cache_dtype=jnp.float32, eos_id=eos)
    params = case.params
    if mesh is not None:
        params = case._sharded(mesh)
        args = list(shard_batch(tuple(args), mesh))
    with maybe_mesh(mesh):
        res = eng.generate(params, *args)
    return (np.asarray(res.tokens), np.asarray(res.lengths),
            np.asarray(res.scores))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_beam")
    case = Case("paligemma")
    spec = case.write(tmp)
    spec.pop("bits")               # the model, for its entry points
    # an EOS id the model emits: the second token of image 0's best
    eos = int(jax_beam(case, None)[0][0, 1])
    want = [jax_beam(case, eos), jax_beam(case, eos, jax_mesh_2x2())]
    rng = np.random.default_rng(5)
    paths = []
    for i in range(5):
        p = tmp / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(p)
        paths.append(str(p))
    model = create_model("paligemma", size="test", device="cpu")
    model.module.load_state_dict(case.port().state_dict())
    images = [Image.open(p).convert("RGB") for p in paths[:3]]
    texts = dict(
        batch_texts=model.generate_batch(images, PROMPT, max_tokens=NEW,
                                         num_beams=K),
        texts=model.generate_dataset(paths, PROMPT, max_tokens=NEW,
                                     batch_size=4, num_beams=K))
    spec["tasks"] = [["beam", dict(n=N, new=NEW, k=K, eos=eos)],
                     ["beam_texts", dict(paths=paths, prompt=PROMPT, new=NEW,
                                         k=K, batch=3, wave=4)]]
    return dict(tmp=tmp, spec=spec, want=want, texts=texts)


def records(ref, mesh):
    if mesh not in _RUNS:
        _RUNS[mesh] = launch(ref["spec"], ref["tmp"], MESHES[mesh], mesh)
    return _RUNS[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_beam_tokens_identical_to_vlm_tpu(ref, mesh):
    for rec in records(ref, mesh):
        got = task(rec, "beam")
        toks, lens = np.asarray(got["tokens"]), np.asarray(got["lengths"])
        scores = np.asarray(got["scores"])
        assert toks.shape == (N, NEW)
        for rtoks, rlens, rscores in ref["want"]:
            np.testing.assert_array_equal(lens, rlens)
            for i in range(N):
                np.testing.assert_array_equal(toks[i, :lens[i]],
                                              rtoks[i, :lens[i]])
            np.testing.assert_allclose(scores, rscores, rtol=SCORE_RTOL,
                                       atol=0)
        # the three results were all-gathered over the data axis once, at
        # the end
        assert got["stats"]["steps"] >= 1
        assert got["collectives"].get("all_gather_data", 0) == 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_beam_entry_points_give_the_one_device_texts(ref, mesh):
    recs = records(ref, mesh)
    for rec in recs:
        got = task(rec, "beam_texts")
        assert got["batch_texts"] == ref["texts"]["batch_texts"]
        assert got["texts"] == ref["texts"]["texts"]
        assert len(got["texts"]) == 5 and None not in got["texts"]
        assert any(got["texts"]) and any(got["batch_texts"])
        for t in rec["tasks"]:
            assert not t["launches"] and t["plain_calls"]
    assert {(r["data_rank"], r["model_rank"]) for r in recs} == {
        (d, m) for d in range(2) for m in range(MESHES[mesh]["model"])}
