"""A quantized SigLIP tower whose MLP width does not split into 16s over
two ranks, served under ``model=2`` on the CPU over gloo against vlm_tpu on
one device (fp32 compute over int8 or grouped int4 weights, tower and
decoder).

PaliGemma at the "test" size with the tower's ``mlp_dim`` set to 144 = 16
x 9, the small form of SigLIP's 4304 = 16 x 269: an even split leaves 72
inputs a rank, not a multiple of 16 (B5's and B6's K) and, in int4
(groups of 16), groups of 8. The port splits fc2's inputs and fc1's
outputs at a multiple of 16 (int4: of max(16, group)): 64 on rank 0 and
80 on rank 1. The prefill's and a decode step's logits agree with
vlm_tpu's within rtol = atol = 1e-4, on every rank, at 2 images (the
weight-only products); in 8bit at 32 images (512 tower rows: llm.int8,
whose outlier columns come from maxima gathered over the ranks' uneven
parts of K) the prefill's logits agree with the port's on one device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_mesh_common import Case, check_logits, launch, task
from vlm_tpu_torch.core.mesh import Mesh
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.decoder import init_kv_cache
from vlm_tpu_torch.models.vit import ViTEncoder

MLP = 144
_RUNS = {}


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_siglip_quant")


def run(bits, tmp, n=2):
    """Launches at 2 images (B5's and B7's rows) and, in 8bit, at 32
    (512 tower rows: llm.int8, whose column maxima the row-parallel fc2
    gathers from the ranks' uneven parts of K)."""
    if (bits, n) not in _RUNS:
        case = Case("paligemma", bits=bits, vision={"mlp_dim": MLP},
                    n_images=max(n, 16))
        d = tmp / f"int{bits}_n{n}"
        d.mkdir()
        spec = dict(case.write(d), tasks=[["logits", {"n": n, "steps": 1}]])
        recs = launch(spec, d, {"data": 1, "model": 2}, "model2")
        _RUNS[(bits, n)] = (case, recs)
    return _RUNS[(bits, n)]


@pytest.mark.parametrize("bits", [8, 4])
def test_uneven_split_at_a_group_boundary(bits):
    vcfg = dataclasses.replace(VLM_CONFIGS["paligemma"]("test").vision,
                               mlp_dim=MLP)
    for rank, k in ((0, 64), (1, 80)):
        tower = ViTEncoder(vcfg, device="meta", quant_bits=bits,
                           mesh=Mesh(1, 2, model_rank=rank, groups=False))
        fc1, fc2 = tower.blocks[0].fc1, tower.blocks[0].fc2
        assert (fc2.in_dim, fc2.comm.k_lo, fc1.out_dim) == (k, 64 * rank, k)
        if bits == 4:
            assert fc2.group_size == 16
            assert tuple(fc2.scale.shape) == (vcfg.hidden, k // 16)
        else:
            assert tuple(fc2.q.shape) == (vcfg.hidden, k)


@pytest.mark.parametrize("bits", [8, 4])
def test_logits_match_vlm_tpu_on_one_device(bits, tmp):
    case, recs = run(bits, tmp)
    check_logits(recs, case.logits(2, 1))
    for rec in recs:
        t = task(rec, "logits")
        assert t["collectives"].get("all_reduce_model", 0) > 0
        assert not t["launches"] and t["plain_calls"]
        assert torch.device(rec["device"]).type == "cpu"


def test_llm_int8_over_uneven_parts_matches_one_device(tmp):
    """32 images: 512 tower rows, so every int8 product of the tower takes
    llm.int8, whose outlier columns come from the column maxima of all of
    K, gathered from the ranks' uneven parts (64 and 80 of fc2's 144).
    Held to the port's prefill on one device, as the card's 8bit
    references are held (max |mesh - one| / max |one|, here within 1e-2)
    and with 90 % of the logits within 1e-4: llm.int8 rounds each row's
    activations to int8, and the model group's sums, in another fp32
    order, flip a few of those roundings (as on the port's one device
    against vlm_tpu's eager run, ~8e-3 apart at 512 tower rows); a
    layout fault would move every logit."""
    case, recs = run(8, tmp, 32)
    mod = case.port()
    pre = torch.zeros((32, 0), dtype=torch.int32)
    post = torch.tensor([case.post] * 32, dtype=torch.int32)
    pl = torch.full((32,), case.plen, dtype=torch.int32)
    cache = init_kv_cache(case.cfg.decoder, 32, case.plen + 1,
                          torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        want = mod.prefill(torch.from_numpy(case.pixels), pre, post, cache,
                           pl).float().numpy()
    for rec in recs:
        got = np.load(task(rec, "logits")["logits_file"])[0]
        err = np.abs(got - want)
        assert float(err.max()) <= 1e-2 * float(np.abs(want).max())
        assert float((err <= 1e-4 + 1e-4 * np.abs(want)).mean()) >= 0.9
        coll = task(rec, "logits")["collectives"]
        # fc2's column maxima: one gather a layer and an outlier sum
        assert coll["all_gather_model"] >= 2 * case.cfg.vision.layers
