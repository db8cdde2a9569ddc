"""The yardstick's operation and byte counts against hand counts at small
shapes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.counts import work  # noqa: E402


def test_live_keys_by_hand():
    assert work.live_keys(1, 3, 3, False) == 9
    # rows 0, 1, 2 see 1, 2, 3 keys
    assert work.live_keys(2, 3, 3, True) == 2 * 6
    # the causal diagonal at the end of a longer key axis: 3, 4 keys
    assert work.live_keys(1, 2, 4, True) == 7


def test_attention_by_hand():
    ops, nbytes = work.attention(2, 4, 2, 3, 5, 8)
    assert ops == 4 * 8 * 4 * (2 * 3 * 5)
    assert nbytes == 2 * 8 * (2 * 2 * 4 * 3 + 2 * 2 * 2 * 5)
    d = work.attention_diff(1, 1, 1, 2, 2, 4, elem=4)
    assert d["fwd"] == (4 * 4 * 4, 4 * 4 * (2 * 2 + 2 * 2))
    assert d["bwd"] == (2.5 * 64, 3 * 4 * 4 * 2 + 4 * 4 * 4 * 2)


def test_bound_takes_the_larger():
    peak = work.PEAKS["ops_per_s"]["bf16"]
    hbm = work.PEAKS["hbm_bytes_per_s"]
    assert work.bound_s(peak, 0, "bf16") == pytest.approx(1.0)
    assert work.bound_s(1, hbm * 2, "bf16") == pytest.approx(2.0)


VIS = {"image_size": 28, "patch_size": 14, "hidden": 8, "layers": 2,
       "heads": 2, "mlp_dim": 16}


def test_vit_by_hand():
    # 4 patches + CLS = 5 tokens
    f = work.vit_forward(VIS, 3)
    assert f["patch"] == 2 * 3 * 4 * 588 * 8
    assert f["dense"] == 3 * 5 * (4 * 2 * 8 * 8 + 2 * 2 * 8 * 16)
    assert f["attn"] == 4 * 4 * 2 * 3 * 25
    assert work.vit_total(VIS, 3) == f["patch"] + 2 * (f["dense"] + f["attn"])


def test_probe_step_by_hand():
    f = work.vit_forward(VIS, 2)
    fwd = work.vit_total(VIS, 2)
    # frozen: the forward alone
    assert work.probe_step({"vision": VIS}, 2, 0, False) == fwd
    # the last block and the patch embedding trained: every block crossed
    both = work.probe_step({"vision": VIS}, 2, 1, True)
    assert both == fwd + 2 * (f["dense"] + 2.5 * f["attn"]) + f["dense"] + \
        f["patch"]


def test_serve_counts_by_hand():
    w = {"vision": VIS,
         "qformer": {"hidden": 4, "layers": 2, "heads": 2, "mlp_dim": 8,
                     "num_query_tokens": 2, "cross_attention_frequency": 2,
                     "encoder_hidden": 8},
         "decoder": {"hidden": 4, "layers": 1, "heads": 2, "mlp_dim": 8,
                     "vocab_size": 10}}
    tok = work.serve_token(w, 7)
    assert tok == (4 * 2 * 4 * 4 + 2 * 2 * 4 * 8) + 4 * 4 * 7 + 2 * 4 * 10
    q = work.qformer(w["qformer"], 4, 1, 5)
    self_attn = 4 * 2 * 2 * 4 * 4 + 4 * 4 * 2 * 2
    cross = 2 * 2 * 2 * 4 * 4 + 2 * 2 * 5 * 8 * 4 + 4 * 4 * 2 * 5
    ffn = 2 * 2 * 2 * 4 * 8
    assert q == 2 * (self_attn + ffn) + 1 * cross + 2 * 2 * 4 * 4
    adm = work.serve_admission(w, 1, 3)
    prefill = (4 * 2 * 3 * 4 * 4 + 2 * 2 * 3 * 4 * 8) + 4 * 4 * 6
    assert adm == work.vit_total(VIS, 1) + work.qformer(
        w["qformer"], 4, 1, 5) + prefill + 2 * 4 * 10
