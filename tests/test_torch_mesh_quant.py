"""PaliGemma with quantized weights served by the port under a mesh on the
CPU over gloo, against vlm_tpu on one device and on its ``{data: 2,
model: 2}`` mesh (fp32 compute, as the port's 8bit and 4bit parity tests
hold vlm_tpu's), at ``model=2``, ``data=2`` and ``2 x 2``:

- 8bit weights (decoder and tower) with the int8 KV cache, a prompt of 64
  and admissions of 8 images: 512 rows, so every admission, the wave's
  prefill of 8 and the logits' prefill take llm.int8's outlier path, whose
  row abs-max a row-parallel rank takes over the model group and whose
  outlier columns come from the maxima over every data rank's rows and all
  of K;
- 4bit weights: B7's plain version at every row count here (a prefill of 2,
  the decode steps, the wave's prefill of 8 at 512 rows, where vlm_tpu
  takes its dequantized product: the same numbers); the row-parallel
  layers' groups (64 inputs) straddle the two model ranks' 32, each rank
  taking the group's scale.

Greedy tokens of the wave engine and the batcher identical to vlm_tpu's,
the batcher's ``admits`` and ``chunks`` identical, the ranks in
agreement. vlm_tpu's jitted llm.int8 outlier product cannot run on
XLA:CPU (a BF16 x BF16 = F32 dot its runtime refuses), so at 8bit
vlm_tpu runs op by op: the wave's tokens come from an eager greedy loop
over its prefill and decode steps, and the batcher's from its own
batcher under ``jax.disable_jit``, on one device and on its (2, 2) mesh.
"""

import jax

import numpy as np
import pytest

from tests.torch_mesh_common import (MESHES, Case, check_batcher, check_engine,
                                     check_ranks, jax_mesh_2x2, launch, task)

CAPS = [4, 2, 4, 1, 3, 4, 2, 4, 3, 4]
MODES = {8: dict(cache="int8", logits_n=8),
         4: dict(cache="fp32", logits_n=2)}
_REFS, _RUNS = {}, {}


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_quant")


def ref(bits, tmp):
    if bits not in _REFS:
        mode = MODES[bits]
        case = Case("paligemma", bits=bits, cache=mode["cache"], n_post=48)
        assert case.plen * 8 == 512
        d = tmp / f"int{bits}"
        d.mkdir()
        n = mode["logits_n"]
        tasks = [["logits", {"n": n, "steps": 2}],
                 ["engine", {"n": 8, "new": 4}],
                 ["batcher", {"n": len(CAPS), "slots": 8, "new": 4,
                              "admit": 8, "caps": CAPS}]]
        jmesh = jax_mesh_2x2()
        if bits == 8:
            # vlm_tpu's jitted llm.int8 product fails on XLA:CPU (see
            # Case.greedy): its eager loop gives the wave's tokens, and its
            # batcher runs op by op
            engine = [case.greedy(8, 4)]
            with jax.disable_jit():
                batcher = [case.batcher(len(CAPS), 8, 4, 8, CAPS),
                           case.batcher(len(CAPS), 8, 4, 8, CAPS, jmesh)]
        else:
            engine = [case.engine(8, 4), case.engine(8, 4, jmesh)]
            batcher = [case.batcher(len(CAPS), 8, 4, 8, CAPS),
                       case.batcher(len(CAPS), 8, 4, 8, CAPS, jmesh)]
        _REFS[bits] = dict(
            tmp=d, spec=dict(case.write(d), tasks=tasks),
            logits=case.logits(n, 2), engine=engine, batcher=batcher)
    return _REFS[bits]


def records(bits, mesh, tmp):
    if (bits, mesh) not in _RUNS:
        r = ref(bits, tmp)
        _RUNS[bits, mesh] = launch(r["spec"], r["tmp"], MESHES[mesh], mesh)
    return _RUNS[bits, mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("bits", [8, 4])
def test_logits_match_vlm_tpu(bits, mesh, tmp):
    """Within two int8 steps of the output's scale for 8bit (an fp32
    activation one ulp off XLA's can cross an int8 rounding boundary where
    a product quantizes it: ``tests/test_torch_quant.py``); 4bit within
    rtol = atol = 1e-4."""
    want = ref(bits, tmp)["logits"]
    for rec in records(bits, mesh, tmp):
        for g, w in zip(np.load(task(rec, "logits")["logits_file"]), want):
            if bits == 8:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=2 / 127 * np.abs(w).max())
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("bits", [8, 4])
def test_wave_engine_tokens_identical_to_vlm_tpu(bits, mesh, tmp):
    check_engine(records(bits, mesh, tmp), ref(bits, tmp)["engine"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("bits", [8, 4])
def test_batcher_tokens_and_counts_identical_to_vlm_tpu(bits, mesh, tmp):
    check_batcher(records(bits, mesh, tmp), ref(bits, tmp)["batcher"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("bits", [8, 4])
def test_ranks_agree_and_the_quantized_paths_ran(bits, mesh, tmp):
    recs = records(bits, mesh, tmp)
    check_ranks(recs, MESHES[mesh])
    for rec in recs:
        plain = task(rec, "batcher")["plain_calls"]
        if bits == 8:
            # the outlier path's B6 at every admission, B5 at decode, the
            # int8 cache's writes and attention
            assert min(plain[k] for k in (
                "int8xint8_matmul", "int8_matmul", "kv_write_int8",
                "decode_attention_int8")) > 0
        else:
            assert plain["int4_matmul"] > 0
