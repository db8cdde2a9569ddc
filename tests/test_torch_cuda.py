"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips without CUDA. Imports no JAX,
so on a machine without it run the file without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_every_kernel_matches_plain(card):
    from vlm_tpu_torch.testing import kernel_checks
    records = kernel_checks.run(card, iters=2)
    assert {r["kernel"] for r in records} == {"B1", "B2", "B3", "B4", "B5",
                                              "B6", "B7"}
    bad = [r for r in records if not r["ok"]]
    assert not bad, bad


# B1 at the shapes of later slices and the layouts the serving path does
# not give it (kernel_checks builds them)
B1_LATER = ("clip_l336_g4_h16_s577_d64", "eva_g4_h16_s257_d88",
            "causal_mha_sq100_sk356_d128", "gqa_g4_contiguous_d64",
            "causal_sq80_sk48_dead_rows", "d42_padded")


@pytest.fixture(scope="module")
def b1_cases(card):
    from vlm_tpu_torch.testing import kernel_checks
    return {c.case: c for c in kernel_checks.cases(card) if c.kernel == "B1"}


@pytest.mark.parametrize("case", B1_LATER)
def test_b1_shapes_of_later_slices(b1_cases, case):
    c = b1_cases[case]
    got, want = c.kernel_fn(), c.plain_fn()
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= c.tol


def test_b1_row_without_keys_is_mean_of_v(card):
    """kv_len = 0 skips no tile: the reference's uniform weights over all
    Sk keys, for every head of the MQA group."""
    from vlm_tpu_torch.ops.attention import flash_attention
    g = torch.Generator(device=card)
    g.manual_seed(3)
    q = torch.randn(2, 8, 70, 256, generator=g, device=card).bfloat16()
    k = torch.randn(2, 1, 200, 256, generator=g, device=card).bfloat16()
    v = torch.randn(2, 1, 200, 256, generator=g, device=card).bfloat16()
    o = flash_attention(q, k, v, kv_len=torch.tensor([0, 130], device=card))
    mean = v[0, 0].float().mean(dim=0)
    assert float((o[0].float() - mean).abs().max()) <= 2e-2


def test_wrappers_launch_on_cuda_and_never_fall_back(card):
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images
    _lib.reset_counts()
    q = torch.randn(1, 2, 8, 64, device=card, dtype=torch.bfloat16)
    flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert _lib.launches["flash_attention"] == 1
    assert _lib.plain_calls["flash_attention"] == 0
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), q.float(), q.float())
    u8 = torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device=card)
    with pytest.raises(TypeError, match="bfloat16"):
        normalize_images(u8, recipe=RECIPES["paligemma"],
                         compute_dtype=torch.float32)


def test_int8_wrappers_launch_on_cuda_and_raise_on_wrong_types(card):
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (int8_matmul, int8xint8_matmul,
                                         quantize_activations)
    _lib.reset_counts()
    x = torch.randn(4, 64, device=card, dtype=torch.bfloat16)
    q = torch.randint(-127, 128, (32, 64), device=card).to(torch.int8)
    s = torch.rand(32, device=card)
    int8_matmul(x, q, s)
    qx, sx = quantize_activations(x)
    int8xint8_matmul(qx, sx, q, s)
    torch.cuda.synchronize()
    assert _lib.launches["int8_matmul"] == 1
    assert _lib.launches["int8xint8_matmul"] == 1
    assert _lib.plain_calls["int8_matmul"] == 0
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x, q.float(), s)
    with pytest.raises(TypeError, match="bfloat16"):
        int8_matmul(x.float(), q, s)
    with pytest.raises(ValueError, match="K % 16"):
        int8_matmul(x[:, :40], q[:, :40].contiguous(), s)


def test_int4_wrapper_launches_on_cuda_and_raises_on_wrong_types(card):
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import int4_matmul
    _lib.reset_counts()
    x = torch.randn(4, 64, device=card, dtype=torch.bfloat16)
    q = torch.randint(-128, 128, (32, 32), device=card).to(torch.int8)
    s = torch.rand(32, 2, device=card)
    y = int4_matmul(x, q, s, 32)
    torch.cuda.synchronize()
    assert y.shape == (4, 32) and y.dtype == torch.bfloat16
    assert _lib.launches["int4_matmul"] == 1
    assert _lib.plain_calls["int4_matmul"] == 0
    with pytest.raises(TypeError, match="bfloat16"):
        int4_matmul(x.float(), q, s, 32)
    with pytest.raises(TypeError, match="int8"):
        int4_matmul(x, q.to(torch.uint8), s, 32)
    with pytest.raises(TypeError, match="float32"):
        int4_matmul(x, q, s.to(torch.bfloat16), 32)
    with pytest.raises(ValueError, match="group_size % 16"):
        int4_matmul(x, q, torch.rand(32, 8, device=card), 8)
    assert _lib.launches["int4_matmul"] == 1


def test_b6_and_b2_wrappers_raise_on_what_the_kernels_do_not_take(card):
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.decode_attention import decode_attention
    from vlm_tpu_torch.ops.quant import int8xint8_matmul
    _lib.reset_counts()
    qx = torch.randint(-127, 128, (4, 48), device=card).to(torch.int8)
    qw = torch.randint(-127, 128, (32, 48), device=card).to(torch.int8)
    sx, sw = torch.rand(4, 1, device=card), torch.rand(32, device=card)
    with pytest.raises(ValueError, match="K % 16"):
        int8xint8_matmul(qx[:, :40].contiguous(), sx, qw[:, :40].contiguous(),
                         sw)
    with pytest.raises(TypeError, match="int8"):
        int8xint8_matmul(qx.float(), sx, qw, sw)
    q = torch.randn(2, 8, 1, 64, device=card, dtype=torch.bfloat16)
    c8 = torch.zeros(2, 10, 1, 64, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention(q, c8, c8)
    with pytest.raises(ValueError, match="unsupported shapes"):
        decode_attention(q, c8.bfloat16()[..., :30], c8.bfloat16()[..., :30])
    assert _lib.launches["int8xint8_matmul"] == 0
    assert _lib.launches["decode_attention"] == 0
