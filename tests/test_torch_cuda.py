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
    flash_attention(q.float(), q.float(), q.float())     # the fp32 form
    torch.cuda.synchronize()
    assert _lib.launches["flash_attention_fp32"] == 1
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.float(), q, q)
    # B2's fp32 form over a cache long enough to be cut into splits (the
    # workspace and counters path): its own counter only
    from vlm_tpu_torch.ops.decode_attention import (TILE_ROWS_FP32,
                                                    decode_attention,
                                                    split_plan)
    qd = torch.randn(2, 8, 1, 256, device=card)
    kc = torch.randn(2, 348, 1, 256, device=card)
    assert split_plan(348, 2, _lib.sm_count(card), TILE_ROWS_FP32)[0] > 1
    before = dict(_lib.launches)
    decode_attention(qd, kc, kc, kv_len=torch.tensor([348, 100], device=card))
    torch.cuda.synchronize()
    moved = {k for k in _lib.launches if _lib.launches[k] != before[k]}
    assert moved == {"decode_attention_fp32"}
    assert _lib.launches["decode_attention_fp32"] == 1
    u8 = torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device=card)
    normalize_images(u8, recipe=RECIPES["paligemma"],
                     compute_dtype=torch.float32)
    assert _lib.launches["normalize_fp32"] == 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        normalize_images(u8, recipe=RECIPES["paligemma"],
                         compute_dtype=torch.float16)
    assert sum(_lib.plain_calls.values()) == 0


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
    with pytest.raises(ValueError, match="group_size 16, 32, 64 or 128"):
        int4_matmul(x, q, torch.rand(32, 8, device=card), 8)
    assert _lib.launches["int4_matmul"] == 1


def test_b5_and_b7_write_fp32_partials(card):
    """A row-parallel rank's partial product: B5 and B7 write their fp32
    accumulators unrounded (the plain versions' numbers), and refuse
    another output type."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (int4_matmul, int4_matmul_plain,
                                         int8_matmul, int8_matmul_plain,
                                         matmul_fp32)
    _lib.reset_counts()
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(32, 1024, device=card, generator=g).to(torch.bfloat16)
    q8 = torch.randint(-127, 128, (2048, 1024), device=card,
                       generator=g).to(torch.int8)
    s8 = torch.rand(2048, device=card, generator=g) / 1024
    q4 = torch.randint(-128, 128, (2048, 512), device=card,
                       generator=g).to(torch.int8)
    s4 = torch.rand(2048, 8, device=card, generator=g) / 1024
    for got, want in ((int8_matmul(x, q8, s8, torch.float32),
                       int8_matmul_plain(x, q8, s8, torch.float32)),
                      (int4_matmul(x, q4, s4, 128, torch.float32),
                       int4_matmul_plain(x, q4, s4, 128, torch.float32))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        # fp32 sums in another order: far inside one bf16 step
        assert float((got - want).abs().max()) <= \
            2.0 ** -16 * float(want.abs().max())
    assert _lib.launches["int8_matmul"] == _lib.launches["int4_matmul"] == 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        int8_matmul(x, q8, s8, torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        int4_matmul(x, q4, s4, 128, torch.float16)
    w = q8.to(torch.bfloat16)
    y = matmul_fp32(x, w)
    ref = x.float() @ w.float().T
    assert y.dtype == torch.float32
    assert float((y - ref).abs().max()) <= 2.0 ** -16 * float(
        ref.abs().max())


# the fp32 forms and B5 / B7 at every shape kernel_checks holds (names as
# kernel_checks.cases builds them)
FP32_CASES = ("fp32_siglip_g4_h16_s256_d72", "fp32_gemma_prefill_g4_s316_kvlen",
              "fp32_prefix_kvlen_gqa_s64", "fp32_causal_sq80_sk48_dead_rows",
              "fp32_clip_l336_g4_h16_s577_d64", "fp32_eva_g4_h16_s257_d88",
              "fp32_window_32slots_cold", "fp32_window_32slots",
              "fp32_kv_len_32slots", "fp32_kv_valid_32slots", "fp32_u8_g4_224")
GEMMA = ((2048, 16384), (2048, 2048), (16384, 2048), (2048, 256))
STREAM_CASES = tuple(
    [f"B5 m{m}_k{k}_n{n}" for m in (32, 316, 1) for k, n in GEMMA]
    + ["B5 m256_k1152_n4304", "B5 m256_k4304_n1152"]
    + [f"B7 m{m}_k{k}_n{n}_gs128" for m in (32, 316, 1, 1264)
       for k, n in GEMMA]
    + ["B7 m256_k1152_n4304_gs128", "B7 m256_k4304_n1152_gs16",
       "B7 m9_k128_n100_gs32"])


@pytest.fixture(scope="module")
def all_cases(card):
    from vlm_tpu_torch.testing import kernel_checks
    return {f"{c.kernel} {c.case}": c for c in kernel_checks.cases(card)}


def _check(c):
    got, want = c.kernel_fn(), c.plain_fn()
    torch.cuda.synchronize()
    tol = c.tol * (float(want.float().abs().max()) if c.rel else 1.0)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("case", FP32_CASES)
def test_fp32_forms_match_plain(all_cases, case):
    c = next(v for k, v in all_cases.items() if k.split(" ")[1] == case)
    _check(c)


@pytest.mark.parametrize("case", STREAM_CASES)
def test_b5_b7_weight_stream_at_every_shape(all_cases, case):
    _check(all_cases[case])


# B6's tiles and forms through its C entry: a Gemma admission's k/v (20
# tiles of 128 x 128), a ragged K (4304 = 33 x 128 + 80) and M, and
# SigLIP's fc2 over model=2 at 8 images (fp32 partials)
B6_TILE_SHAPES = ((1264, 2048, 256), (300, 4304, 1152), (2048, 2144, 1152))


@pytest.mark.parametrize("m,k,n", B6_TILE_SHAPES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n in B6_TILE_SHAPES])
@pytest.mark.parametrize("out", ["fp32", "bf16"])
def test_b6_every_tile_and_form(card, m, k, n, out):
    """Every tile (64 or 128 rows by 64 or 128 columns) and form (staged
    through a TMA store, one block an SM; direct, two) the C entry takes,
    with a block a tile and with fewer persistent blocks than tiles: fp32
    bitwise to the plain version, bf16 within one ulp of the largest
    output; and the plan's pick through the wrapper."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (B6_TILES, int8xint8_matmul,
                                         int8xint8_matmul_plain)
    g = torch.Generator(device=card).manual_seed(m + n)
    qx = torch.randint(-127, 128, (m, k), device=card, generator=g).to(
        torch.int8)
    qw = torch.randint(-127, 128, (n, k), device=card, generator=g).to(
        torch.int8)
    sx = torch.rand(m, 1, device=card, generator=g) * (4 / 127)
    sw = torch.rand(n, device=card, generator=g) / 64
    dt = torch.float32 if out == "fp32" else torch.bfloat16
    want = int8xint8_matmul_plain(qx, sx, qw, sw, dt).float()
    tol = 0.0 if out == "fp32" else 2.0 ** -8 * float(want.abs().max())
    y = torch.empty(m, n, dtype=dt, device=card)
    lib, st = _lib.lib(), _lib.stream_ptr(qx)
    for c, bn in B6_TILES:
        tiles = -(-m // (64 * c)) * -(-n // bn)
        for staged in (True, False):
            for grid in (tiles, max(1, tiles // 3)):
                y.fill_(float("nan"))
                rc = lib.vlm_int8xint8_matmul(
                    qx.data_ptr(), sx.data_ptr(), qw.data_ptr(),
                    sw.data_ptr(), y.data_ptr(), m, n, k, int(out == "bf16"),
                    c, bn, int(staged), grid, st)
                assert rc == 0, (c, bn, staged, grid)
                torch.cuda.synchronize()
                err = float((y.float() - want).abs().max())
                assert err <= tol, (c, bn, staged, grid, err)
    _lib.reset_counts()
    got = int8xint8_matmul(qx, sx, qw, sw, dt)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= tol
    assert _lib.launches["int8xint8_matmul"] == 1


@pytest.mark.parametrize("m", [256, 368, 1264])
def test_b7_prefill_form_at_admission_rows(card, m):
    """B7's prefill form (wgmma over weights dequantized once a block) at
    an int4 tower's one image (256 rows), BLIP-2's admission of 4 x 92 and
    PaliGemma's of 4 x 316: every consumer count and split of K the C
    entry takes, and the plan's pick through the wrapper (counted under
    ``int4_matmul_prefill``), within GEMM_REL_TOL of the largest output;
    group 128 and group 32, bf16 and fp32 out."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (PREFILL_STEP, int4_matmul,
                                         int4_matmul_plain)
    from vlm_tpu_torch.testing.kernel_checks import GEMM_REL_TOL
    g = torch.Generator(device=card).manual_seed(m)
    lib = _lib.lib()
    for k, n, gs, dt in ((2048, 2048, 128, torch.bfloat16),
                         (1152, 4304, 32, torch.float32)):
        x = torch.randn(m, k, device=card, generator=g).to(torch.bfloat16)
        q = torch.randint(-128, 128, (n, k // 2), device=card,
                          generator=g).to(torch.int8)
        s = (0.5 + torch.rand(n, k // gs, device=card, generator=g)) / (
            4 * k ** 0.5)
        want = int4_matmul_plain(x, q, s, gs, dt).float()
        tol = GEMM_REL_TOL * float(want.abs().max())
        y = torch.empty(m, n, dtype=dt, device=card)
        stages = -(-k // PREFILL_STEP)
        for c in (2, 3):
            for splits in (1, 2, 3, 8):
                per = -(-stages // splits)
                if -(-stages // per) != splits:
                    continue
                y.fill_(float("nan"))
                rc = lib.vlm_int4_matmul_prefill(
                    x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                    m, n, k, gs, c, splits, per, int(dt == torch.float32),
                    _lib.stream_ptr(x))
                assert rc == 0, (c, splits)
                torch.cuda.synchronize()
                err = float((y.float() - want).abs().max())
                assert err <= tol, (k, n, c, splits, err)
        _lib.reset_counts()
        got = int4_matmul(x, q, s, gs, dt)
        torch.cuda.synchronize()
        assert float((got.float() - want).abs().max()) <= tol
        assert _lib.launches["int4_matmul_prefill"] == 1
        assert _lib.launches["int4_matmul"] == 0


@pytest.mark.parametrize("m,k", [(1535, 4304), (1536, 4304), (2048, 2160),
                                 (2048, 2144)])
def test_dense_int4_gate_on_the_card(card, m, k):
    """``dense_int4`` on the card: B7 (its decode form at K % 32 != 0, its
    prefill form at 2,144 inputs), or from 1,536 rows at K % 32 != 0 the
    dequantized product (no B7 launch, no plain call); within GEMM_REL_TOL
    of B7's plain version either way."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (QuantizedWeight, dense_int4,
                                         int4_dequant_gate,
                                         int4_matmul_plain)
    from vlm_tpu_torch.testing.kernel_checks import GEMM_REL_TOL
    g = torch.Generator(device=card).manual_seed(m + k)
    n, gs = 1152, 16
    x = torch.randn(m, k, device=card, generator=g).to(torch.bfloat16)
    q = torch.randint(-128, 128, (n, k // 2), device=card,
                      generator=g).to(torch.int8)
    s = (0.5 + torch.rand(n, k // gs, device=card, generator=g)) / (
        4 * k ** 0.5)
    want = int4_matmul_plain(x, q, s, gs, torch.float32)
    _lib.reset_counts()
    got = dense_int4(x, QuantizedWeight(q, s, gs), torch.float32)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= (
        GEMM_REL_TOL * float(want.abs().max()))
    gated = int4_dequant_gate(m, k)
    assert gated == (k % 32 != 0 and m >= 1536)
    assert (_lib.launches["int4_matmul"]
            + _lib.launches["int4_matmul_prefill"]) == (0 if gated else 1)
    assert not any(_lib.plain_calls.values())


def test_default_fp32_model_serves_a_prompt(card):
    """``create_model`` with no quantization is fp32 and runs on the card
    through the fp32 forms, no plain version."""
    import numpy as np

    from vlm_tpu_torch.generate.batcher import ContinuousBatcher
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import normalize_images
    model = create_model("paligemma", size="test")
    assert model.dtype == torch.float32 and model.device.type == "cuda"
    s = model.cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (3, s, s, 3),
                                           dtype=np.uint8)
    post = np.asarray([2, 9, 11], np.int32)
    plen = num_image_tokens(model.cfg) + len(post)
    _lib.reset_counts()
    out = ContinuousBatcher(model.module, model.cfg, batch_size=2,
                            max_prompt_len=plen, max_new_tokens=4,
                            cache_dtype=model.cache_dtype).run(
        lambda idxs: normalize_images(torch.from_numpy(u8[idxs]).to(card),
                                      recipe=model.recipe,
                                      compute_dtype=model.dtype),
        pre_ids_row=np.zeros((0,), np.int32), post_ids_row=post,
        prompt_len_scalar=plen, n_images=3)
    torch.cuda.synchronize()
    assert all(o is not None and 0 < len(o) <= 4 for o in out)
    for k in ("flash_attention_fp32", "decode_attention_fp32",
              "normalize_fp32", "kv_write_fused"):
        assert _lib.launches[k] > 0, k
    assert sum(_lib.plain_calls.values()) == 0


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


# B3's write inside B2's launch, each form, uniform and scatter, columns on
# tile and split edges and outside the cache (names as kernel_checks builds
# them), and B4 written straight into the patch embedding's layout
FUSED_CASES = tuple(f"{tag}fused_{case}" for tag in ("", "int8_", "fp32_")
                    for case in ("window_32slots", "window_32slots_cold",
                                 "scatter_kv_len_32slots", "uniform_outside"))
PATCH_CASES = ("patch14_u8_g4_224", "fp32_patch14_u8_g4_224")


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_write_is_b3_then_b2_bitwise(all_cases, case):
    """Output, caches and int8 scales bitwise those of B3's kernel followed
    by B2's; within B2's tolerance of the plain versions."""
    c = all_cases[f"B3 {case}"]
    got, exact = c.kernel_fn(), c.exact_fn()
    torch.cuda.synchronize()
    assert torch.equal(got, exact)
    _check(c)


@pytest.mark.parametrize("case", PATCH_CASES)
def test_patch_layout_normalize_is_bitwise(all_cases, case):
    c = all_cases[f"B4 {case}"]
    got, want = c.kernel_fn(), c.plain_fn()
    torch.cuda.synchronize()
    assert got.shape == (4, 256, 588) and torch.equal(got, want)


# each model's size and prompt length (PaliGemma 316, LLaVA 5 + 576 + 60)
PROMPTS = {"paligemma": ("3b", 316), "llava": ("7b", 641),
           "blip2": ("6.7b", 92)}


def _depth_cut(card, quantization, model="paligemma", slots=32):
    """The model at full width with 2 decoder layers (1 vision layer),
    random weights, and the slots' cache of its prompt and 32 new rows
    (PaliGemma-3B: 348; LLaVA-1.5-7B: 673)."""
    import dataclasses

    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule
    size, prompt = PROMPTS[model]
    full = VLM_CONFIGS[model](size)
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=1),
        decoder=dataclasses.replace(full.decoder, layers=2))
    bits = 8 if quantization == "8bit" else 0
    dtype = torch.float32 if quantization == "fp32" else torch.bfloat16
    # BLIP-2's 8bit recipe quantizes the tower too
    mod = init_random_(VLMModule(cfg, dtype=dtype, device=card,
                                 quant_bits=bits,
                                 vision_quant_bits=bits if model == "blip2"
                                 else 0), seed=0)
    cache = init_kv_cache(cfg.decoder, slots, prompt + 32,
                          "int8" if bits else dtype, card)
    return mod, cfg, cache


def _decode_step(mod, cache, card, model="paligemma", slots=32):
    """One rotating-window decode step, as the batcher makes it."""
    prompt = PROMPTS[model][1]
    i32 = dict(dtype=torch.int32, device=card)
    g = torch.Generator(device=card)
    g.manual_seed(0)
    tok = torch.randint(3, 1000, (slots, 1), generator=g, device=card,
                        dtype=torch.int32)
    acol = torch.randint(0, 32, (slots,), generator=g, device=card,
                         dtype=torch.int32)
    gcnt = torch.randint(1, 32, (slots,), generator=g, device=card,
                         dtype=torch.int32)
    pos = torch.full((slots,), prompt + 8, **i32)
    return lambda: mod.decode_step(
        tok, pos, cache, write_col=torch.tensor(prompt + 7, **i32),
        kv_window=(torch.tensor(prompt, **i32), 32, acol, gcnt))


@pytest.mark.parametrize("quantization", ["bf16", "8bit", "fp32"])
def test_decode_step_writes_only_inside_b2(card, quantization):
    """A decode step launches no standalone B3: one fused write a layer,
    beside B2's launch."""
    from vlm_tpu_torch.ops import _lib
    mod, cfg, cache = _depth_cut(card, quantization)
    step = _decode_step(mod, cache, card)
    _lib.reset_counts()
    with torch.inference_mode():
        logits = step()
    torch.cuda.synchronize()
    layers = cfg.decoder.layers
    b2, fused = {"bf16": ("decode_attention", "kv_write_fused"),
                 "8bit": ("decode_attention_int8", "kv_write_int8_fused"),
                 "fp32": ("decode_attention_fp32", "kv_write_fused")
                 }[quantization]
    assert _lib.launches[b2] == layers and _lib.launches[fused] == layers
    assert _lib.launches["kv_write"] == _lib.launches["kv_write_int8"] == 0
    assert sum(_lib.plain_calls.values()) == 0
    assert torch.isfinite(logits).all()


def test_decode_step_makes_no_copy_of_the_write_column(card):
    """The write column reaches B2 as one int32 offset: under the profiler,
    one bf16 decode step of the depth-cut model launches no copy kernel
    for the offsets (no aten copy of a [slots] tensor launches a kernel),
    no standalone B3 kernel, and one B2 kernel a layer."""
    from torch.profiler import ProfilerActivity, profile
    mod, cfg, cache = _depth_cut(card, "bf16")
    step = _decode_step(mod, cache, card)
    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step()
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")]
    counts = {e.key: e.count for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")}
    assert not [n for n in names if "kv_write" in n]
    assert sum(c for n, c in counts.items()
               if "decode_kernel" in n) == cfg.decoder.layers
    offset_copies = [
        e for e in prof.events()
        if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")
        and e.input_shapes and e.input_shapes[0] == [32]
        and (e.kernels or any(c.kernels for c in e.cpu_children))]
    assert not offset_copies, [(e.name, e.input_shapes)
                               for e in offset_copies]


# LLaVA-1.5-7B's serving shapes (kernel_checks' LLaVA block): B1 at CLIP-L
# and Vicuna's causal MHA prefill, B2 at G = 1, D = 128 over the 32-slot
# bf16 and 16-slot int8 windows, the standalone int8 prefill rows at KV =
# 32, B4 at 336 px, B5 at m = 16 and B6 at m = 4 x 641 on Vicuna's three
# products
LLAVA_CASES = (
    "B1 clip_l336_g4_h16_s577_d64", "B1 vicuna_prefill_g4_h32_s641_d128_kvlen",
    "B1 fp32_vicuna_prefill_g2_h32_s641_d128_kvlen",
    "B2 llava_window_32slots_cold", "B2 llava_window_32slots",
    "B2 llava_window_16slots_int8_cold", "B2 llava_window_16slots_int8",
    "B2 fp32_llava_window_4slots", "B3 llava_int8_prefill_g4_s641_kv32",
    "B4 patch14_u8_g4_336", "B4 fp32_patch14_u8_g4_336",
    *(f"B5 m16_k{k}_n{n}" for k, n in ((4096, 4096), (4096, 11008),
                                       (11008, 4096))),
    *(f"B6 m2564_k{k}_n{n}_bf16" for k, n in ((4096, 4096), (4096, 11008),
                                              (11008, 4096))))
# B3 inside B2 at KV = 32: every slot's row into its own head of K and V
LLAVA_FUSED = ("llava_fused_window_32slots", "llava_fused_window_32slots_cold",
               "llava_fused_scatter_kv_len_32slots",
               "llava_int8_fused_window_16slots",
               "llava_int8_fused_window_16slots_cold",
               "llava_int8_fused_scatter_kv_len_16slots",
               "llava_fp32_fused_window_4slots",
               "llava_fp32_fused_scatter_kv_len_4slots")


@pytest.mark.parametrize("case", LLAVA_CASES)
def test_llava_shapes_match_plain(all_cases, case):
    _check(all_cases[case])


@pytest.mark.parametrize("case", LLAVA_FUSED)
def test_llava_fused_write_is_b3_then_b2_bitwise(all_cases, case):
    c = all_cases[f"B3 {case}"]
    got, exact = c.kernel_fn(), c.exact_fn()
    torch.cuda.synchronize()
    assert torch.equal(got, exact)
    _check(c)


@pytest.mark.parametrize("form", ["bf16", "int8", "fp32"])
def test_fused_write_lands_in_every_kv_head(card, form):
    """With 32 KV heads (G = 1) every head's block group 0 writes its own
    head's row: each (slot, head) row at the column equals the new row
    (int8: its quantized values and scale), and no other row changes."""
    from vlm_tpu_torch.ops.decode_attention import decode_attention
    from vlm_tpu_torch.ops.quant import quantize_activations
    g = torch.Generator(device=card)
    g.manual_seed(5)
    b, s, kvh, d, col = 6, 200, 32, 128, 131
    dtype = torch.float32 if form == "fp32" else torch.bfloat16
    q = torch.randn(b, kvh, 1, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kvh, d, generator=g, device=card).to(dtype)
    kn = torch.randn(b, 1, kvh, d, generator=g, device=card).to(dtype)
    vn = torch.randn(b, 1, kvh, d, generator=g, device=card).to(dtype)
    start = torch.full((1,), col, dtype=torch.int32, device=card)
    kv_len = torch.full((b,), col + 1, dtype=torch.int32, device=card)
    if form == "int8":
        (kq, ks), (vq, vs) = quantize_activations(k), quantize_activations(v)
        caches = [kq, vq, ks, vs]
        before = [t.clone() for t in caches]
        decode_attention(q, kq, vq, k_scale=ks, v_scale=vs, kv_len=kv_len,
                         k_new=kn, v_new=vn, write_start=start, uniform=True)
        want = [*quantize_activations(kn), *quantize_activations(vn)]
        got = [kq[:, col:col + 1], ks[:, col:col + 1], vq[:, col:col + 1],
               vs[:, col:col + 1]]
        for w, x in zip(want, got):
            assert torch.equal(w, x)
    else:
        caches = [k, v]
        before = [t.clone() for t in caches]
        decode_attention(q, k, v, kv_len=kv_len, k_new=kn, v_new=vn,
                         write_start=start, uniform=True)
        assert torch.equal(k[:, col:col + 1], kn)
        assert torch.equal(v[:, col:col + 1], vn)
    torch.cuda.synchronize()
    rows = torch.arange(s, device=card) != col
    for t, t0 in zip(caches, before):
        assert torch.equal(t[:, rows], t0[:, rows])


@pytest.mark.parametrize("quantization", ["bf16", "8bit"])
def test_llava_decode_step_writes_only_inside_b2(card, quantization):
    """A LLaVA decode step (MHA, 32 KV heads) launches no standalone B3
    and no copy of the write column: one B2 launch and one fused write a
    layer, under the profiler no kv_write kernel and no copy kernel of a
    [slots] tensor."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_tpu_torch.ops import _lib
    slots = 16 if quantization == "8bit" else 32
    mod, cfg, cache = _depth_cut(card, quantization, "llava", slots)
    step = _decode_step(mod, cache, card, "llava", slots)
    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        _lib.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            logits = step()
            torch.cuda.synchronize()
    layers = cfg.decoder.layers
    b2, fused = (("decode_attention_int8", "kv_write_int8_fused")
                 if quantization == "8bit"
                 else ("decode_attention", "kv_write_fused"))
    assert _lib.launches[b2] == layers and _lib.launches[fused] == layers
    assert _lib.launches["kv_write"] == _lib.launches["kv_write_int8"] == 0
    assert sum(_lib.plain_calls.values()) == 0
    assert logits.shape == (slots, 32064) and torch.isfinite(logits).all()
    names = [e.key for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")]
    assert not [n for n in names if "kv_write" in n]
    offset_copies = [
        e for e in prof.events()
        if e.name in ("aten::copy_", "aten::clone", "aten::contiguous")
        and e.input_shapes and e.input_shapes[0] == [slots]
        and (e.kernels or any(c.kernels for c in e.cpu_children))]
    assert not offset_copies


def test_depth_cut_llava_matches_the_cpu(card):
    """LLaVA at full width (1 CLIP and 2 Vicuna layers), bf16 on the card
    against the same weights in fp32 on the CPU: prefill of two images
    with BOS + 4 ids before the image and 8 after, then two rotating-window
    decode steps; max |card - cpu| / max |cpu| <= 5e-2 (chip_smoke.py's
    REF_TOL)."""
    import numpy as np

    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.vlm import VLMModule
    from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images
    mod, cfg, _ = _depth_cut(card, "bf16", "llava", slots=1)
    cpu = VLMModule(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in mod.state_dict().items()})
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 336, 336, 3),
                                       dtype=np.uint8))
    pre = torch.from_numpy(np.concatenate(
        [np.ones((2, 1)), rng.integers(3, 1000, (2, 4))], 1).astype(np.int32))
    post = torch.from_numpy(rng.integers(3, 1000, (2, 8), dtype=np.int32))
    plen, steps = 5 + 576 + 8, 2
    logits = {}
    with torch.inference_mode():
        for dev, m, dtype in (("cuda", mod, torch.bfloat16),
                              ("cpu", cpu, torch.float32)):
            i32 = dict(dtype=torch.int32, device=dev)
            cache = init_kv_cache(cfg.decoder, 2, plen + steps, dtype, dev)
            px = normalize_images(u8.to(dev), recipe=RECIPES["llava"],
                                  compute_dtype=dtype, patch_size=14)
            pl = torch.full((2,), plen, **i32)
            out = [m.prefill(px, pre.to(dev), post.to(dev), cache,
                             pl).float().cpu()]
            for step in range(steps):
                tok = logits["cuda"][step].argmax(-1) if dev == "cpu" else \
                    out[-1].argmax(-1)
                window = (torch.tensor(plen, **i32), steps,
                          torch.zeros(2, **i32),
                          torch.full((2,), step + 1, **i32))
                out.append(m.decode_step(
                    tok.to(dev, torch.int32)[:, None], pl + step, cache,
                    write_col=torch.tensor(plen + step, **i32),
                    kv_window=window).float().cpu())
            logits[dev] = out
    for got, ref in zip(logits["cuda"], logits["cpu"]):
        assert got.shape == (2, 32064) and torch.isfinite(got).all()
        assert float((got - ref).abs().max() / ref.abs().max()) <= 5e-2


# BLIP-2 OPT-6.7B's serving shapes (kernel_checks' BLIP-2 block): B1 at the
# Q-Former's self- and cross-attention and at EVA's D = 88, in bf16 and
# fp32, and at OPT's causal prefill; B2 and B3 fused over OPT's 124-row MHA
# cache at 32 bf16 and 64 int8 slots; the standalone int8 prefill rows of
# 8; B4 into EVA's patches; B5 at m = 64 (down: K = 16384); B6 at 8 x 92
# OPT rows and 8 x 257 EVA rows (K = N = 1408: 11 tiles of 128)
BLIP2_CASES = (
    "B1 qformer_self_g4_h12_s32_d64", "B1 qformer_cross_g4_h12_sq32_sk257_d64",
    "B1 eva_g4_h16_s257_d88", "B1 eva_g8_h16_s257_d88",
    "B1 opt_prefill_g4_h32_s92_d128_kvlen",
    "B1 fp32_qformer_self_g2_h12_s32_d64",
    "B1 fp32_qformer_cross_g2_h12_sq32_sk257_d64",
    "B1 fp32_eva_g4_h16_s257_d88", "B1 fp32_opt_prefill_g2_h32_s92_d128_kvlen",
    "B2 blip2_window_32slots", "B2 blip2_window_64slots_int8_cold",
    "B2 fp32_blip2_window_4slots", "B3 blip2_int8_prefill_g8_s92_kv32",
    "B4 blip2_patch14_u8_g8_224",
    *(f"B5 m64_k{k}_n{n}" for k, n in ((4096, 4096), (4096, 16384),
                                       (16384, 4096))),
    *(f"B5 m257_k{k}_n{n}" for k, n in ((1408, 1408), (1408, 6144),
                                        (6144, 1408))),
    *(f"B6 m736_k{k}_n{n}_bf16" for k, n in ((4096, 4096), (4096, 16384),
                                             (16384, 4096))),
    *(f"B6 m2056_k{k}_n{n}_bf16" for k, n in ((1408, 1408), (1408, 6144),
                                              (6144, 1408))))
BLIP2_FUSED = ("blip2_fused_window_32slots", "blip2_fused_window_32slots_cold",
               "blip2_int8_fused_window_64slots",
               "blip2_int8_fused_window_64slots_cold",
               "blip2_fp32_fused_window_4slots")


@pytest.mark.parametrize("case", BLIP2_CASES)
def test_blip2_shapes_match_plain(all_cases, case):
    _check(all_cases[case])


@pytest.mark.parametrize("case", BLIP2_FUSED)
def test_blip2_fused_write_is_b3_then_b2_bitwise(all_cases, case):
    c = all_cases[f"B3 {case}"]
    got, exact = c.kernel_fn(), c.exact_fn()
    torch.cuda.synchronize()
    assert torch.equal(got, exact)
    _check(c)


@pytest.mark.parametrize("quantization", ["bf16", "8bit"])
def test_blip2_decode_step_writes_only_inside_b2(card, quantization):
    """A BLIP-2 decode step (OPT: learned positions, MHA) at 32 bf16 or 64
    int8 slots: one B2 launch and one fused write a layer, no standalone
    B3, no plain version, finite logits over OPT's 50272 tokens."""
    from vlm_tpu_torch.ops import _lib
    slots = 64 if quantization == "8bit" else 32
    mod, cfg, cache = _depth_cut(card, quantization, "blip2", slots)
    step = _decode_step(mod, cache, card, "blip2", slots)
    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        _lib.reset_counts()
        logits = step()
        torch.cuda.synchronize()
    layers = cfg.decoder.layers
    b2, fused = (("decode_attention_int8", "kv_write_int8_fused")
                 if quantization == "8bit"
                 else ("decode_attention", "kv_write_fused"))
    assert _lib.launches[b2] == layers and _lib.launches[fused] == layers
    assert _lib.launches["kv_write"] == _lib.launches["kv_write_int8"] == 0
    assert sum(_lib.plain_calls.values()) == 0
    assert logits.shape == (slots, 50272) and torch.isfinite(logits).all()


@pytest.mark.parametrize("quantization", ["bf16", "8bit"])
def test_depth_cut_blip2_matches_the_cpu(card, quantization):
    """BLIP-2 at full width (1 EVA and 2 OPT layers, the Q-Former at its
    full 12), on the card against the same weights in fp32 on the CPU:
    prefill of two images (the 32 query tokens, BOS + 7 ids), then two
    rotating-window decode steps; 8bit: int8 decoder and tower weights and
    the int8 cache on both sides; max |card - cpu| / max |cpu| <= 5e-2
    (chip_smoke.py's REF_TOL). Every path kernel launches, no plain
    version runs on the card."""
    import numpy as np

    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.vlm import VLMModule
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images
    mod, cfg, _ = _depth_cut(card, quantization, "blip2", slots=1)
    bits = 8 if quantization == "8bit" else 0
    cpu = VLMModule(cfg, dtype=torch.float32, device="cpu", quant_bits=bits,
                    vision_quant_bits=bits)
    cpu.load_state_dict({k: (v.float() if v.is_floating_point() else v).cpu()
                         for k, v in mod.state_dict().items()})
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3),
                                       dtype=np.uint8))
    pre = torch.zeros((2, 0), dtype=torch.int32)
    post = torch.from_numpy(np.concatenate(
        [np.full((2, 1), 2), rng.integers(3, 1000, (2, 7))], 1).astype(
            np.int32))
    plen, steps = 32 + 8, 2
    cache_dtype = {"cuda": "int8" if bits else torch.bfloat16,
                   "cpu": "int8" if bits else torch.float32}
    logits = {}
    _lib.reset_counts()
    with torch.inference_mode():
        for dev, m, dtype in (("cuda", mod, torch.bfloat16),
                              ("cpu", cpu, torch.float32)):
            i32 = dict(dtype=torch.int32, device=dev)
            cache = init_kv_cache(cfg.decoder, 2, plen + steps,
                                  cache_dtype[dev], dev)
            px = normalize_images(u8.to(dev), recipe=RECIPES["blip2"],
                                  compute_dtype=dtype, patch_size=14)
            pl = torch.full((2,), plen, **i32)
            out = [m.prefill(px, pre.to(dev), post.to(dev), cache,
                             pl).float().cpu()]
            for step in range(steps):
                tok = logits["cuda"][step].argmax(-1) if dev == "cpu" else \
                    out[-1].argmax(-1)
                window = (torch.tensor(plen, **i32), steps,
                          torch.zeros(2, **i32),
                          torch.full((2,), step + 1, **i32))
                out.append(m.decode_step(
                    tok.to(dev, torch.int32)[:, None], pl + step, cache,
                    write_col=torch.tensor(plen + step, **i32),
                    kv_window=window).float().cpu())
            logits[dev] = out
            if dev == "cuda":
                torch.cuda.synchronize()
                card_launches = dict(_lib.launches)
                card_plain = sum(_lib.plain_calls.values())
    assert card_plain == 0
    b2 = "decode_attention_int8" if bits else "decode_attention"
    assert min(card_launches[k] for k in ("flash_attention", "normalize",
                                          b2)) > 0
    if bits:
        # the 2 x 257 EVA rows take B6 (512 and more), the decoder's B5
        assert card_launches["int8xint8_matmul"] > 0
        assert card_launches["int8_matmul"] > 0
    for got, ref in zip(logits["cuda"], logits["cpu"]):
        assert got.shape == (2, 50272) and torch.isfinite(got).all()
        assert float((got - ref).abs().max() / ref.abs().max()) <= 5e-2


# ------------- B1's differentiable form (probing, end to end) -------------

def test_b1_kernel_output_alone_carries_no_gradient_and_the_form_repairs_it(
        card):
    """The fault: B1's launch fills a fresh tensor through ctypes, which
    autograd cannot see, so a tower's q/k/v lost their gradient on the
    card (the CPU's plain version hid it). Through ``flash_attention`` the
    gradient reaches ``q_proj`` and equals autograd through the plain
    version on the card."""
    from vlm_tpu_torch.models import vit
    from vlm_tpu_torch.models.configs import llava_config
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import _flash_forward, attention_plain
    q = torch.randn(1, 2, 17, 32, device=card, requires_grad=True)
    assert not _flash_forward(q, q, q).requires_grad
    cfg = llava_config("7b").vision
    attn = init_random_(vit.ViTAttention(cfg, dict(dtype=torch.float32,
                                                   device=card)), seed=0)
    attn.q_proj.weight.requires_grad_(True)
    g = torch.Generator(device=card)
    g.manual_seed(1)
    x = torch.randn(2, 577, cfg.hidden, generator=g, device=card)
    w = torch.randn(2, 577, cfg.hidden, generator=g, device=card)
    _lib.reset_counts()
    (attn(x) * w).sum().backward()
    got = attn.q_proj.weight.grad.clone()
    assert _lib.launches["flash_attention_diff_fp32"] == 1
    # the backward is the kernel: no recompute on the card
    assert _lib.launches["flash_attention_diff_fp32_bwd"] == 1
    assert sum(_lib.recomputes.values()) == 0
    assert sum(_lib.plain_calls.values()) == 0
    attn.q_proj.weight.grad = None
    orig = vit.flash_attention
    vit.flash_attention = attention_plain
    try:
        (attn(x) * w).sum().backward()
    finally:
        vit.flash_attention = orig
    want = attn.q_proj.weight.grad
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


def test_b1_diff_matches_plain_in_fp32_and_bf16(card):
    from vlm_tpu_torch.testing import kernel_checks
    records = kernel_checks.run_diff(card, iters=2, shape=(4, 16, 577, 64))
    assert [r["form"] for r in records] == [
        "flash_attention_diff_fp32", "flash_attention_diff_fp32_bwd",
        "flash_attention_diff"]
    for r in records:
        assert r["ok"] and r["exact_err"] == 0.0, r


def test_b1_diff_backward_kernel_cases(card):
    """The fp32 backward kernel at small copies of its cases (CLIP-L's,
    SigLIP's, EVA's and Vicuna's head dims, causal with rows that see no
    key and with more keys than rows, G = 2): dq, dk, dv within FP32_TOL
    of the recompute and of the float64 formulation, bitwise on a second
    run, lse as the plain one's."""
    from vlm_tpu_torch.testing import kernel_checks
    cases = (("clip", 2, 16, 16, 577, 577, 64, False),
             ("siglip", 2, 16, 16, 256, 256, 72, False),
             ("eva", 2, 16, 16, 257, 257, 88, False),
             ("causal_d128", 2, 8, 8, 300, 300, 128, True),
             ("causal_dead_rows_g2", 2, 8, 4, 80, 48, 64, True),
             ("causal_sk_gt_sq", 2, 4, 4, 40, 100, 88, True),
             ("gqa2", 2, 16, 8, 577, 577, 64, False))
    records = kernel_checks.run_diff_bwd(card, iters=2, cases=cases)
    for r in records:
        assert r["form"] == "flash_attention_diff_fp32_bwd"
        assert r["ok"] and r["exact_err"] == 0.0, r


def test_b1_diff_backward_kernel_refuses_unbuilt_head_dims(card):
    """The backward kernel raises on a head dim it was not built for;
    nothing falls back to the recompute on the card."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    q = torch.randn(1, 2, 8, 80, device=card, requires_grad=True)
    _lib.reset_counts()
    o = flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        o.sum().backward()
    assert sum(_lib.recomputes.values()) == 0


def test_b1_diff_bf16_keeps_its_recompute_on_the_card(card):
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    q = torch.randn(1, 2, 33, 64, device=card).bfloat16().requires_grad_()
    _lib.reset_counts()
    flash_attention(q, q, q).float().sum().backward()
    assert _lib.recomputes["flash_attention_diff"] == 1
    assert _lib.launches["flash_attention_diff_fp32_bwd"] == 0


def test_b1_diff_refuses_masks_on_the_card(card):
    from vlm_tpu_torch.ops.attention import flash_attention
    q = torch.randn(1, 2, 8, 64, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="differentiable form"):
        flash_attention(q, q, q, kv_len=torch.tensor([5], device=card))


def test_serving_launches_unchanged_by_the_differentiable_form(card):
    """A serving decode step and tower pass launch the same kernels with
    grad mode on as under ``inference_mode``: no parameter needs a
    gradient, so B1 never takes its differentiable form."""
    import contextlib
    from vlm_tpu_torch.ops import _lib
    mod, cfg, cache = _depth_cut(card, "bf16")
    step = _decode_step(mod, cache, card)
    v = cfg.vision
    px = torch.randn(2, (v.image_size // v.patch_size) ** 2,
                     v.patch_size ** 2 * 3, device=card).bfloat16()
    counts = []
    for ctx in (torch.inference_mode, contextlib.nullcontext):
        _lib.reset_counts()
        with ctx():
            outs = (step(), mod.encode_images(px))
        torch.cuda.synchronize()
        counts.append(dict(_lib.launches))
        assert all(o.grad_fn is None for o in outs)
    assert counts[0] == counts[1]
    assert counts[1]["flash_attention"] > 0
    assert counts[1]["flash_attention_diff"] == 0
    assert sum(_lib.recomputes.values()) == 0


def test_lora_step_takes_b1_diff_only_in_the_adapted_blocks(card):
    """A LoRA step on a depth-cut CLIP-L/336 (3 blocks, full width, fp32),
    adapters on the last 2 blocks with B drawn nonzero: B1's
    differentiable form launches (forward and backward kernels) in those 2
    blocks only,
    its no-grad form in block 0; the gradient reaches A of every adapted
    q_proj through the kernel's forward; the base weights get none and
    stay as built."""
    import dataclasses
    from vlm_tpu_torch.models.backbone import VisionBackbone
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vit import ViTEncoder
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES
    from vlm_tpu_torch.probing.lora import lora_features, resolve_lora
    full = VLM_CONFIGS["llava"]("7b")
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=3))
    tower = init_random_(ViTEncoder(cfg.vision, dtype=torch.float32,
                                    device=card), seed=1)
    bb = VisionBackbone(cfg, tower, torch.float32, RECIPES["llava"])
    spec, lora = resolve_lora({"lora": {"enabled": True, "last_k": 2}}, bb,
                              seed=0)
    assert sorted({n.split(".")[1] for n in lora}) == ["1", "2"]
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for ab in lora.values():
            ab["B"].copy_(0.02 * torch.randn(ab["B"].shape, generator=gen))
    base = {n: p.detach().clone() for n, p in tower.named_parameters()}
    u8 = torch.randint(0, 256, (2, 336, 336, 3), dtype=torch.uint8,
                       generator=gen).to(card)
    _lib.reset_counts()
    feats = lora_features(bb, spec, lora)(bb.to_pixels(u8))
    feats.square().mean().backward()
    torch.cuda.synchronize()
    assert _lib.launches["flash_attention_diff_fp32"] == 2
    assert _lib.launches["flash_attention_diff_fp32_bwd"] == 2
    assert sum(_lib.recomputes.values()) == 0
    assert _lib.launches["flash_attention_fp32"] == 3
    assert sum(_lib.plain_calls.values()) == 0
    for i in (1, 2):
        for k in ("A", "B"):
            g = lora[f"blocks.{i}.attn.q_proj"][k].grad
            assert g is not None and float(g.abs().max()) > 0
    for n, p in tower.named_parameters():
        assert p.grad is None and torch.equal(p, base[n]), n


# B3 inside B2 in its uniform form at a live column under kv_len: the wave
# and beam engines' decode step (32 rows: 32 images, or 8 images x 4 beams)
WAVE_FUSED = ("fused_uniform_kv_len_32slots",
              "int8_fused_uniform_kv_len_32slots",
              "llava_fused_uniform_kv_len_32slots")


@pytest.mark.parametrize("case", WAVE_FUSED)
def test_uniform_fused_write_at_a_live_column_is_b3_then_b2_bitwise(
        all_cases, case):
    c = all_cases[f"B3 {case}"]
    got, exact = c.kernel_fn(), c.exact_fn()
    torch.cuda.synchronize()
    assert torch.equal(got, exact)
    _check(c)


# the wave and beam engines' prefills at their batches: 32 PaliGemma
# images (the wave), 8 (the 8bit beams: B6 at 8 x 316 rows, the int8 prompt
# rows), 8 LLaVA images (the bf16 beams)
WAVE_PREFILL = (
    "B1 siglip_g32_h16_s256_d72", "B1 gemma_prefill_g32_s316_kvlen",
    "B4 patch14_u8_g32_224", "B1 siglip_g8_h16_s256_d72",
    "B1 gemma_prefill_g8_s316_kvlen", "B4 patch14_u8_g8_224",
    *(f"B6 m2528_k{k}_n{n}_fp32" for k, n in GEMMA),
    "B3 int8_prefill_g8_s316", "B1 clip_l336_g8_h16_s577_d64",
    "B1 vicuna_prefill_g8_h32_s641_d128_kvlen", "B4 patch14_u8_g8_336")


@pytest.mark.parametrize("case", WAVE_PREFILL)
def test_wave_and_beam_prefill_shapes_match_plain(all_cases, case):
    assert all_cases[case].on_path
    _check(all_cases[case])


@pytest.mark.parametrize("num_beams", [1, 2])
def test_wave_and_beams_run_on_the_card_with_no_plain_call(card, num_beams):
    """``generate_batch`` at the "test" size in fp32 (B1, B2 and B4's fp32
    forms), greedy and with beams: texts for every image, every decode
    step's write inside B2, no plain version."""
    import numpy as np
    from PIL import Image

    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops import _lib
    model = create_model("paligemma", size="test")
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 256, (40, 50, 3),
                                           dtype=np.uint8)) for _ in range(3)]
    _lib.reset_counts()
    texts = model.generate_batch(images, "colours?", max_tokens=5,
                                 num_beams=num_beams)
    torch.cuda.synchronize()
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    for k in ("flash_attention_fp32", "decode_attention_fp32",
              "normalize_fp32", "kv_write_fused"):
        assert _lib.launches[k] > 0, k
    assert _lib.launches["kv_write_fused"] == \
        _lib.launches["decode_attention_fp32"]
    assert _lib.launches["kv_write"] == 0
    assert sum(_lib.plain_calls.values()) == 0


# the 4bit slices of LLaVA and BLIP-2: B7 at group 128 at Vicuna's and
# OPT's decode products (32 slots), BLIP-2's admissions of 4 x 92 rows
# and EVA's int4 tower (one image, 257 rows)
B7_SLICE_CASES = tuple(
    f"B7 m{m}_k{k}_n{n}_gs128"
    for m, k, n in ((32, 4096, 4096), (32, 4096, 11008), (32, 11008, 4096),
                    (32, 4096, 16384), (32, 16384, 4096), (257, 1408, 1408),
                    (257, 1408, 6144), (257, 6144, 1408), (368, 4096, 4096),
                    (368, 4096, 16384), (368, 16384, 4096)))


@pytest.mark.parametrize("case", B7_SLICE_CASES)
def test_b7_at_the_4bit_slices_shapes(all_cases, case):
    _check(all_cases[case])


# LLaVA's fp32 slice at full depth: Vicuna's fp32 prefill of 4 images, the
# fp32 decode window of 16 slots over 641 + 8 rows
LLAVA_FP32_CASES = ("B1 fp32_vicuna_prefill_g4_h32_s641_d128_kvlen",
                    "B2 fp32_llava_window_16slots_cold")


@pytest.mark.parametrize("case", LLAVA_FP32_CASES)
def test_fp32_llava_slice_shapes_match_plain(all_cases, case):
    assert all_cases[case].on_path
    _check(all_cases[case])


@pytest.mark.parametrize("family,size,quantization,qv", [
    ("paligemma", "test", "fp32", False), ("llava", "test", "8bit", True),
    ("blip2", "test", "4bit", True), ("blip2", "6.7b", "4bit", True)])
def test_param_bytes_is_what_a_built_model_allocates(card, family, size,
                                                     quantization, qv):
    """The fit check's ``param_bytes`` (the module on ``meta``) against the
    device memory ``create_model`` asks the allocator for when it builds
    the same model (its requested bytes: the blocks round each tensor
    up), within 1 %; all of it back once the model is gone."""
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import param_bytes

    def requested():
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.empty_cache()
    before = requested()
    model = create_model(family, size=size, quantization=quantization,
                         quantize_vision=qv)
    built = requested() - before
    bits = {"8bit": 8, "4bit": 4}.get(quantization, 0)
    want = param_bytes(model.cfg, dtype=model.dtype, quant_bits=bits,
                       vision_quant_bits=bits if qv else 0)
    assert abs(built - want) <= want / 100, (want, built)
    del model
    assert requested() == before


# chip_smoke.py's sweep: each decoder's prefill of its admission block
# of MiviaPar prompts, the decode window of its slots (B2, and B3 inside
# it), B5 and B7 at the decode step's rows, B6 at the 8bit admission's
# rows (names as kernel_checks.cases builds them)
def _sweep_cases():
    from vlm_tpu_torch.testing import kernel_checks as kc
    slots, group, new = kc.SWEEP_SLOTS, kc.SWEEP_GROUP, kc.SWEEP_NEW
    for model, (dec, h, d, kns) in {
            "paligemma": ("gemma", 8, 256, kc.GEMMA_KN),
            "llava": ("vicuna", 32, 128, kc.VICUNA_KN),
            "blip2": ("opt", 32, 128, kc.OPT_KN)}.items():
        p = kc.SWEEP_PROMPTS[model]
        yield f"B1 {dec}_prefill_g{group}_h{h}_s{p}_d{d}_kvlen"
        yield f"B2 {dec}_window_{slots}slots_s{p + new}_cold"
        yield f"B3 {dec}_fused_window_{slots}slots_s{p + new}_cold"
        for k, n in kns:
            yield f"B5 m{slots}_k{k}_n{n}"
            yield f"B6 m{group * p}_k{k}_n{n}_fp32"
            yield f"B7 m{slots}_k{k}_n{n}_gs128"


SWEEP_CASES = tuple(dict.fromkeys(_sweep_cases()))


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_sweep_shapes_match_plain(all_cases, case):
    c = all_cases[case]
    assert c.on_path
    if c.kernel == "B3":
        got, exact = c.kernel_fn(), c.exact_fn()
        torch.cuda.synchronize()
        assert torch.equal(got, exact)
    _check(c)


# chip_smoke.py's mesh phases: PaliGemma-3B at one rank's shard shapes
# (model=2: 8 tower heads, 4 query heads over the whole KV head, half of
# each block product's split axis; data=2: 16 slots; the depth-cut
# references' 4 rows), names as kernel_checks.cases builds them
def _mesh_cases():
    from vlm_tpu_torch.testing import kernel_checks as kc
    yield from ("B1 tp_siglip_g4_h8_s256_d72",
                "B1 tp_gemma_prefill_g4_q4_s316_kvlen",
                "B1 fp32_tp_siglip_g4_h8_s256_d72",
                "B1 fp32_tp_gemma_prefill_g4_q4_s316_kvlen")
    for name in ("tp_window_32slots_h4", "tp_window_32slots_h4_int8",
                 "dp_window_16slots_h8"):
        yield f"B2 {name}_cold"
    for name in ("tp_fused_window_32slots_h4_cold",
                 "tp_int8_fused_window_32slots_h4_cold",
                 "dp_fused_window_16slots_h8_cold",
                 "tp_ref_fused_scatter_kv_len_4rows_h4",
                 "tp_ref_int8_fused_scatter_kv_len_4rows_h4",
                 "tp_ref_fp32_fused_scatter_kv_len_4rows_h4"):
        yield f"B3 {name}"
    for k, n in kc.GEMMA_TP_KN:
        if (k, n) in kc.GEMMA_KN:
            continue
        f32 = "_fp32" if (k, n) in kc.GEMMA_TP_ROW else ""
        yield f"B5 m{kc.MESH_SLOTS}_k{k}_n{n}{f32}"
        yield f"B6 m{kc.GROUP * kc.PROMPT}_k{k}_n{n}_fp32"
        yield f"B7 m{kc.MESH_SLOTS}_k{k}_n{n}_gs128{f32}"


MESH_CASES = tuple(_mesh_cases())


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_shard_shapes_match_plain(all_cases, case):
    """Each kernel at a mesh rank's shapes against its plain version at
    the tolerance its other cases take; B3's write inside B2 bitwise the
    unfused B3 then B2."""
    c = all_cases[case]
    assert c.on_path == (c.kernel != "B7")
    if c.kernel == "B3":
        got, exact = c.kernel_fn(), c.exact_fn()
        torch.cuda.synchronize()
        assert torch.equal(got, exact)
    _check(c)


# ---- B1's form for head dims <= 96 and B2's for G < 8 ----
# (card tests: -k "b1_small or b2_few")

B1_SMALL_SHAPES = [
    # (B, H, KV, Sq, Sk, D, mask keywords)
    (4, 16, 16, 577, 577, 64, {}),
    (2, 16, 16, 256, 256, 72, {}),
    (2, 16, 16, 257, 257, 88, {}),
    (2, 12, 12, 32, 257, 64, {}),
    (2, 4, 4, 150, 150, 96, dict(causal=True)),
    (2, 8, 1, 70, 200, 80, dict(kv_len=[0, 130])),
    (2, 8, 2, 60, 60, 64, dict(causal=True, prefix_len=[20, 5],
                               kv_len=[60, 50])),
    (2, 4, 4, 80, 48, 72, dict(causal=True)),
    (2, 2, 2, 33, 33, 42, dict(kv_len=[0, 20])),
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,kw", B1_SMALL_SHAPES)
def test_b1_small_form_matches_plain(card, b, h, kvh, sq, sk, d, kw):
    """flash_kernel_small (D <= 96) within ATTN_TOL of the plain version
    under every mask, one launch, no plain call; a row without a live key
    gives the mean of V."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import attention_plain, flash_attention
    from vlm_tpu_torch.testing.kernel_checks import ATTN_TOL
    g = torch.Generator(device=card)
    g.manual_seed(d + sq)
    q = torch.randn(b, sq, h, d, generator=g, device=card).bfloat16(
        ).transpose(1, 2)
    k = torch.randn(b, sk, kvh, d, generator=g, device=card).bfloat16(
        ).transpose(1, 2)
    v = torch.randn(b, sk, kvh, d, generator=g, device=card).bfloat16(
        ).transpose(1, 2)
    kw = {key: torch.tensor(val, dtype=torch.int32, device=card)
          if isinstance(val, list) else val for key, val in kw.items()}
    _lib.reset_counts()
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["flash_attention"] == 1
    assert _lib.plain_calls["flash_attention"] == 0
    want = attention_plain(q, k, v, **kw)
    assert float((o.float() - want.float()).abs().max()) <= ATTN_TOL
    if "kv_len" in kw and int(kw["kv_len"][0]) == 0:
        mean = v[0].float().mean(dim=1)                      # [KV, D]
        rep = mean.repeat_interleave(h // kvh, dim=0)[:, None]
        assert float((o[0].float() - rep).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("d", [64, 72, 88])
def test_b1_small_form_diff_forward_is_the_kernel_bitwise(card, d):
    """B1-diff's bf16 forward is the no-gradient call, bit for bit."""
    from vlm_tpu_torch.ops.attention import flash_attention
    g = torch.Generator(device=card)
    g.manual_seed(d)
    q, k, v = (torch.randn(2, 257, 16, d, generator=g, device=card).bfloat16(
        ).transpose(1, 2) for _ in range(3))
    with torch.no_grad():
        plain = flash_attention(q, k, v, causal=True)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    diff = flash_attention(qq, kk, vv, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(diff.detach(), plain)


# B2 at G < 8: (slots, S, KV, G, D, int8)
B2_FEW_SHAPES = [(32, 673, 32, 1, 128, False), (16, 673, 32, 1, 128, True),
                 (8, 1313, 32, 1, 128, False), (64, 124, 32, 1, 128, True),
                 (32, 332, 1, 4, 256, False), (32, 332, 1, 4, 256, True),
                 (4, 100, 2, 4, 64, False), (4, 100, 2, 4, 64, True),
                 (3, 70, 4, 2, 72, False), (3, 70, 4, 3, 96, True)]


def _few_inputs(card, slots, s, kvh, heads, d, int8, seed):
    from vlm_tpu_torch.ops.quant import quantize_activations
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q = torch.randn(slots, 1, kvh * heads, d, generator=g,
                    device=card).bfloat16().transpose(1, 2)
    k = torch.randn(slots, s, kvh, d, generator=g, device=card).bfloat16()
    v = torch.randn(slots, s, kvh, d, generator=g, device=card).bfloat16()
    kn = torch.randn(slots, 1, kvh, d, generator=g, device=card).bfloat16()
    vn = torch.randn(slots, 1, kvh, d, generator=g, device=card).bfloat16()
    caches = [k, v]
    if int8:
        (kq, ks), (vq, vs) = quantize_activations(k), quantize_activations(v)
        caches = [kq, vq, ks, vs]
    acol = torch.randint(0, 16, (slots,), generator=g, device=card).int()
    gcnt = torch.randint(0, 17, (slots,), generator=g, device=card).int()
    window = (torch.tensor(s - 16, dtype=torch.int32, device=card), 16, acol,
              gcnt)
    return q, caches, kn, vn, window


def _masks(card, slots, s, window, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    kv_len = torch.randint(0, s + 1, (slots,), generator=g,
                           device=card).int()
    kv_len[0] = 0
    valid = torch.rand(slots, s, generator=g, device=card) < 0.5
    valid[-1] = False
    return {"window": dict(kv_window=window), "kv_len": dict(kv_len=kv_len),
            "kv_valid": dict(kv_valid=valid),
            "window_kv_len": dict(kv_window=window, kv_len=kv_len)}


@pytest.mark.parametrize("slots,s,kvh,heads,d,int8", B2_FEW_SHAPES)
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid",
                                  "window_kv_len"])
def test_b2_few_form_matches_plain(card, slots, s, kvh, heads, d, int8,
                                   mode):
    """decode_kernel_few within ATTN_TOL of the plain version; a fully
    masked row returns 0."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                    decode_attention_plain)
    from vlm_tpu_torch.testing.kernel_checks import ATTN_TOL
    q, caches, _, _, window = _few_inputs(card, slots, s, kvh, heads, d,
                                          int8, 7)
    kw = _masks(card, slots, s, window, 8)[mode]
    if int8:
        kw.update(k_scale=caches[2], v_scale=caches[3])
    _lib.reset_counts()
    o = decode_attention(q, caches[0], caches[1], **kw)
    torch.cuda.synchronize()
    form = "decode_attention_int8" if int8 else "decode_attention"
    assert _lib.launches[form] == 1 and _lib.plain_calls[form] == 0
    want = decode_attention_plain(q, caches[0], caches[1], **kw)
    assert float((o.float() - want.float()).abs().max()) <= ATTN_TOL
    if mode in ("kv_len", "window_kv_len"):
        assert (o[0] == 0).all()


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("tiles_a_split", [1, 3, 11])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_b2_few_every_ring_and_split(card, monkeypatch, stages,
                                     tiles_a_split, int8):
    """Every ring depth the form takes, at one, several and many tiles a
    split (LLaVA's 673 rows), against the plain version; and the fused
    write bitwise B3 then B2 at each."""
    from vlm_tpu_torch.ops import decode_attention as da
    from vlm_tpu_torch.ops.kvcache import kv_quantized_write, kv_uniform_write
    from vlm_tpu_torch.testing.kernel_checks import ATTN_TOL
    if stages > tiles_a_split:
        pytest.skip("the ring is at most a split's tiles")
    slots, s, kvh, d = 6, 673, 32, 128
    if da._lib.few_blocks(card, int8, d, stages, True) < 1:
        pytest.skip("this ring does not fit an SM")
    rows = tiles_a_split * da.TILE_ROWS
    monkeypatch.setattr(da, "few_plan", lambda *a: (-(-s // rows), rows,
                                                    stages))
    q, caches, kn, vn, window = _few_inputs(card, slots, s, kvh, 1, d, int8,
                                            11)
    col = torch.full((1,), s - 9, dtype=torch.int32, device=card)

    def scales(c):
        return dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
    fused = [t.clone() for t in caches]
    o1 = da.decode_attention(q, fused[0], fused[1], kv_window=window,
                             **scales(fused), k_new=kn, v_new=vn,
                             write_start=col, uniform=True)
    alone = [t.clone() for t in caches]
    if int8:
        kv_quantized_write((alone[0], alone[2]), (alone[1], alone[3]), kn, vn,
                           col, True)
    else:
        kv_uniform_write(alone[0], alone[1], kn, vn, col)
    o2 = da.decode_attention(q, alone[0], alone[1], kv_window=window,
                             **scales(alone))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    for a, b in zip(fused, alone):
        assert torch.equal(a, b)
    want = da.decode_attention_plain(q, alone[0], alone[1], kv_window=window,
                                     **scales(alone))
    assert float((o2.float() - want.float()).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("slots,s,kvh,heads,d,int8", B2_FEW_SHAPES)
def test_b2_few_fused_write_is_b3_then_b2_bitwise(card, slots, s, kvh,
                                                  heads, d, int8):
    """The row write inside decode_kernel_few: output and caches bitwise
    B3's kernel then B2's, scatter at columns on tile edges and outside
    the cache."""
    from vlm_tpu_torch.ops.decode_attention import decode_attention
    from vlm_tpu_torch.ops.kvcache import (kv_quantized_write,
                                           kv_scatter_write)
    q, caches, kn, vn, _ = _few_inputs(card, slots, s, kvh, heads, d, int8,
                                       13)
    edges = [0, 63, 64, s - 1, -1, s, 127, s // 2]
    start = torch.tensor([edges[i % len(edges)] for i in range(slots)],
                         dtype=torch.int32, device=card)
    kv_len = (start + 1).clamp(0, s).int()

    def scales(c):
        return dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
    fused = [t.clone() for t in caches]
    o1 = decode_attention(q, fused[0], fused[1], kv_len=kv_len,
                          **scales(fused), k_new=kn, v_new=vn,
                          write_start=start)
    alone = [t.clone() for t in caches]
    if int8:
        kv_quantized_write((alone[0], alone[2]), (alone[1], alone[3]), kn, vn,
                           start, False)
    else:
        kv_scatter_write(alone[0], alone[1], kn, vn, start)
    o2 = decode_attention(q, alone[0], alone[1], kv_len=kv_len,
                          **scales(alone))
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    for a, b in zip(fused, alone):
        assert torch.equal(a, b)


def test_b2_few_plan_fits_the_card(card):
    """few_plan's ring fits an SM at every path shape of the form."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.decode_attention import TILE_ROWS, few_plan
    for slots, s, kvh, d, int8 in ((32, 673, 32, 128, False),
                                   (16, 673, 32, 128, True),
                                   (64, 124, 32, 128, True),
                                   (8, 1313, 32, 128, False),
                                   (32, 332, 1, 256, False),
                                   (32, 332, 1, 256, True)):
        splits, rows, stages = few_plan(
            s, kvh * slots, _lib.sm_count(card),
            lambda st: _lib.few_blocks(card, int8, d, st, True))
        assert _lib.few_blocks(card, int8, d, stages, True) >= 1
        assert splits * rows >= s and rows % TILE_ROWS == 0
