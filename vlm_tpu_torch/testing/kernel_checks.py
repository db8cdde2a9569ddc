"""Each CUDA kernel against its plain PyTorch version, on the card, at the
shapes the PaliGemma-3B serving paths give it (32 slots, 224 px images,
prompt length 316, 32 new tokens, admission groups of 4; bf16, 8bit with
the int8 KV cache, and 4bit) and the LLaVA-1.5-7B paths give it (336 px
images, prompt length 641, MHA with 32 heads of 128; 32 slots in bf16,
16 in 8bit with the int8 KV cache) and the BLIP-2 OPT-6.7B paths give it
(EVA ViT-g, 16 heads of 88 over 257 tokens; the Q-Former, 12 heads of 64,
32 queries over themselves and over the 257 image tokens; OPT-6.7B, MHA
with 32 heads of 128, a prompt of 32 + 60 ids; bf16 at 32 slots and
admissions of 4, 8bit at 64 slots and admissions of 8 with the int8 KV
cache and the int8 tower), plus cases for the mask modes and shapes the
paths do not reach.

Used by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``. Attention
outputs are bf16 and both versions accumulate in fp32 from the same bf16
inputs, but round at other places: B1's plain version rounds the
normalised probabilities to bf16 before the P.V product (as the JAX
reference does) and B2's keeps them in fp32, while both kernels round the
unnormalised ones to bf16 (their tensor-core operands, as the TPU kernels
round theirs) and B2 rounds the query scaled by D^-1/2 to bf16. So they
agree within ``ATTN_TOL``, a few bf16 ulps at 1. B2 is timed with the L2
cache flushed (``_cold``: the decode step reads each layer's cache from
device memory) and warm. The KV write must be bitwise, its int8 form too
(values and scales); normalisation within one bf16 ulp, its patch layout
bitwise. B3's write inside B2's launch (the fused forms) must give
bitwise the output and the caches of B3's kernel followed by B2's
(``exact_fn``), and B2's tolerance against the plain versions.

B5 (weight-only int8 GEMM) accumulates the same fp32 products as its plain
version in another order, then both scale and round once to bf16: they
agree within ``GEMM_REL_TOL`` (two bf16 ulps) of the largest output. B6
(int8 x int8) sums exactly in int32 and applies the scales in the plain
version's order, so its fp32 output is bitwise equal; its bf16 output may
differ by one bf16 ulp (``GEMM_REL_TOL / 2``, stated relative to the
largest output). B6's cases below 17 rows compare with the plain version
on CPU copies (``torch._int_mm`` on the card takes more than 16 rows),
whose time is then not measured. B7 (grouped int4) forms the same bf16
weights as its plain version (``nibble * scale`` in fp32, rounded once)
and accumulates them in fp32 in another order: ``GEMM_REL_TOL`` of the
largest output. The GEMMs are timed with the L2 cache flushed before each
launch: the serving path streams every weight once per step, cold.

Beside its times, each case carries its work: the operations and the bytes
its function needs (each input read once, each output written once;
attention counts the keys each row's result depends on), computed from its
shapes by :func:`attention_work`, :func:`decode_work` and
:func:`gemm_work`, and from them :func:`bound_ms`, the least time the card
could take: the larger of bytes over the HBM rate and operations over the
dense tensor-core peak of their type (:data:`HBM_BYTES_PER_S`,
:data:`PEAK_OPS_PER_S`; NVIDIA's H100 SXM data sheet, at its 700 W power
limit). And, where one PyTorch call computes the same function, that call
(``library_fn``), timed the same way and compared once with the plain
version; the port never calls it. Where there is none, ``library_note``
says why. Kernel and library call are timed twice: with CUDA events
(``ms``, ``library_ms``: device time plus a floor of a few µs a call) and
under the profiler (``device_ms``, ``library_device_ms``: their kernels'
own time), which compares short kernels without the floor. A redesign
that takes another kernel's work into its launch also profiles what it
replaces (``baseline_fn``: B2 alone beside the fused write, the NHWC
normalisation and the unfold copy beside the patch layout), in
alternating rounds whose medians are reported.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _lib
from ..ops.attention import attention_plain, flash_attention
from ..ops.decode_attention import (decode_attention, decode_attention_plain,
                                    live_rows)
from ..ops.kvcache import (kv_masked_write, kv_quantized_write,
                           kv_quantized_write_plain, kv_scatter_write,
                           kv_uniform_write, kv_write_plain)
from ..ops.preprocess import (RECIPES, normalize_images, normalize_plain,
                              unfold_patches)
from ..ops.quant import (int4_matmul, int4_matmul_plain, int4_prefill_form,
                         int8_matmul, int8_matmul_plain, int8xint8_matmul,
                         int8xint8_matmul_plain, quantize_activations)

ATTN_TOL = 2e-2
NORM_TOL = 2.0 ** -7
GEMM_REL_TOL = 2.0 ** -7
# the fp32 forms against their fp32 plain versions, relative to the largest
# output: the same fp32 arithmetic, its sums (up to 348 keys of 256 dims)
# and its softmax normalisation taken in another order
FP32_TOL = 2e-5

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: bf16 and
# int8 on the tensor cores, fp32 on the CUDA cores, and fp32-accurate
# products on the tensor cores as three TF32 products each (494.7 TFLOP/s
# TF32 / 3), the rate of B1's and B2's fp32 forms
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
                  "fp32_3xtf32": 494.7e12 / 3}

# "forms": the launch counter of each form of the kernel (_lib.KERNELS),
# the main path's own first
KERNELS = {
    "B1": dict(name="flash_attention", source="vlm_tpu_torch/csrc/flash_attention.cu",
               replaces="vlm_tpu/ops/attention.py:112",
               forms=("flash_attention", "flash_attention_fp32")),
    "B2": dict(name="decode_attention", source="vlm_tpu_torch/csrc/decode_attention.cu",
               replaces="vlm_tpu/ops/decode_attention.py:72",
               forms=("decode_attention", "decode_attention_int8",
                      "decode_attention_fp32")),
    "B3": dict(name="kv_write", source="vlm_tpu_torch/csrc/kv_write.cu",
               replaces="vlm_tpu/ops/kvcache.py:34",
               # the decode step's write (inside B2's launch) first
               forms=("kv_write_fused", "kv_write_int8_fused", "kv_write",
                      "kv_write_int8")),
    "B4": dict(name="normalize", source="vlm_tpu_torch/csrc/normalize.cu",
               replaces="vlm_tpu/ops/preprocess.py:119",
               forms=("normalize", "normalize_fp32")),
    "B5": dict(name="int8_matmul", source="vlm_tpu_torch/csrc/int8_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:252",
               forms=("int8_matmul",)),
    "B6": dict(name="int8xint8_matmul",
               source="vlm_tpu_torch/csrc/int8xint8_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:110",
               forms=("int8xint8_matmul",)),
    # B7: the decode form (up to 64 rows) and the prefill form (wgmma)
    "B7": dict(name="int4_matmul", source="vlm_tpu_torch/csrc/int4_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:300",
               forms=("int4_matmul", "int4_matmul_prefill")),
    # B1's differentiable form (ops/attention.py FlashAttentionFn): B1's
    # kernel as its forward; as its backward the fp32 kernel of
    # flash_attention_fp32_bwd.cu (its own form) for fp32, a recompute
    # through plain tensor operations for bf16, as vlm_tpu's custom VJP
    # (checked by run_diff and run_diff_bwd)
    "B1-diff": dict(name="flash_attention_diff",
                    source="vlm_tpu_torch/csrc/flash_attention.cu",
                    replaces="vlm_tpu/ops/attention.py:250",
                    forms=("flash_attention_diff_fp32",
                           "flash_attention_diff_fp32_bwd",
                           "flash_attention_diff")),
}
# forms whose source is not their kernel's
FORM_SOURCES = {"flash_attention_fp32":
                "vlm_tpu_torch/csrc/flash_attention_fp32.cu",
                "flash_attention_diff_fp32":
                "vlm_tpu_torch/csrc/flash_attention_fp32.cu",
                "flash_attention_diff_fp32_bwd":
                "vlm_tpu_torch/csrc/flash_attention_fp32_bwd.cu",
                "kv_write_fused": "vlm_tpu_torch/csrc/decode_attention.cu",
                "kv_write_int8_fused":
                "vlm_tpu_torch/csrc/decode_attention.cu",
                "int4_matmul_prefill": "vlm_tpu_torch/csrc/int4_prefill.cu"}
# Gemma-2B block products (K, N): q/o, k/v, gate/up, down; SigLIP fc1/fc2
GEMMA_KN = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
SIGLIP_KN = ((1152, 4304), (4304, 1152))

# the serving path's shapes (PaliGemma-3B)
SLOTS, PROMPT, NEW, GROUP = 32, 316, 32, 4
CACHE = PROMPT + NEW
# LLaVA-1.5-7B's: Vicuna-7B is MHA (32 heads of 128, G = 1), 32 slots in
# bf16 and 16 in 8bit, a prompt of 5 + 576 + 60 ids, CLIP-L/336 (577
# tokens of 16 heads of 64); Vicuna's block products (K, N): q/k/v/o,
# gate/up, down (K = 11008 = 86 x 128)
LLAVA_SLOTS, LLAVA_SLOTS_8BIT, LLAVA_PROMPT = 32, 16, 641
LLAVA_CACHE = LLAVA_PROMPT + NEW
# the fp32 slice: 16 slots, up to 8 new tokens
LLAVA_SLOTS_FP32, LLAVA_FP32_NEW = 16, 8
VICUNA_KN = ((4096, 4096), (4096, 11008), (11008, 4096))
# BLIP-2 OPT-6.7B's: 32 query tokens + BOS + 59 ids, 32 slots in bf16 and
# 64 in 8bit (admissions of 8); OPT's block products (K, N): q/k/v/o, fc1,
# down (K = 16384 = 128 x 128); EVA ViT-g's (int8 with quantize_vision):
# q/v/out, fc1, fc2
BLIP2_SLOTS, BLIP2_SLOTS_8BIT, BLIP2_PROMPT, BLIP2_GROUP_8BIT = 32, 64, 92, 8
BLIP2_CACHE = BLIP2_PROMPT + NEW
# the wave and beam engines' batches: one prefill of 32 PaliGemma images
# (the wave), of 8 images (4 beams each, 8bit PaliGemma and bf16 LLaVA)
WAVE_IMAGES, BEAM_IMAGES = 32, 8
OPT_KN = ((4096, 4096), (4096, 16384), (16384, 4096))
EVA_KN = ((1408, 1408), (1408, 6144), (6144, 1408))
# chip_smoke.py's sweep (compare_models.yaml, batch_size 8, max_tokens
# 16): 8 slots, the batcher's admissions of 4, and each model's prompt:
# the MiviaPar prompt in byte ids (no tokenizer files) after the image
# tokens (PaliGemma 256 + 704, LLaVA 7 + 576 + 714, BLIP-2 32 + 722)
SWEEP_SLOTS, SWEEP_GROUP, SWEEP_NEW = 8, 4, 16
SWEEP_PROMPTS = {"paligemma": 960, "llava": 1297, "blip2": 754}
# chip_smoke.py's mesh phases (PaliGemma-3B, ranks sharing one GPU): 32
# slots, admissions of 4, up to 16 new tokens; under model=2 each rank
# holds 8 of SigLIP's 16 heads, 4 of Gemma's 8 query heads over its one KV
# head (whole on every rank) and half of each block product's split axis;
# under data=2 each rank holds 16 slots (admissions whole on every rank);
# the depth-cut references prefill 4 images and take 2 decode steps
MESH_SLOTS, MESH_NEW, MESH_REF_STEPS = 32, 16, 2
MESH_CACHE = PROMPT + MESH_NEW
# Gemma's block products (K, N) on one of model=2 ranks: q, k/v (whole),
# o, gate/up, down
GEMMA_TP_KN = ((2048, 1024), (2048, 256), (1024, 2048), (2048, 8192),
               (8192, 2048))
# the row-parallel ones: o and down
GEMMA_TP_ROW = ((1024, 2048), (8192, 2048))
# the probing steps under a mesh (a step's images), and SigLIP's MLP width
# 4304 over model=2 at a multiple of 16: each rank's part
PMESH_BATCH = 16
SIGLIP_TP_MLP = (2144, 2160)
MESH_DIFF_SHAPE = (PMESH_BATCH, 8, 577, 64)


@dataclasses.dataclass
class Case:
    kernel: str                 # B1..B7
    case: str
    kernel_fn: Callable[[], torch.Tensor]
    plain_fn: Callable[[], torch.Tensor]
    tol: float
    on_path: bool               # a serving path's own shape
    # what to time, where it differs from the compared call
    time_kernel: Optional[Callable[[], object]] = None
    time_plain: Optional[Callable[[], object]] = None
    form: str = ""              # the launch counter; default: the kernel's
    rel: bool = False           # tol is relative to max |plain|
    cold: bool = False          # flush the L2 cache before each timed call
    plain_timed: bool = True    # False: the plain version runs on the CPU
    # (operations, bytes, peak): the work the function needs
    work: Tuple[float, float, str] = (0.0, 0.0, "bf16")
    # one PyTorch call for the same function, its output as compared with
    # the plain version (None: compare its return), whether to compare, and
    # a note: why there is no call, or what the call leaves out
    library_fn: Optional[Callable[[], object]] = None
    library_out: Optional[Callable[[object], torch.Tensor]] = None
    library_compare: bool = True
    library_note: str = ""
    # the unfused kernels the case must equal bitwise (None: no such check)
    exact_fn: Optional[Callable[[], torch.Tensor]] = None
    # what the redesign replaces, profiled beside it (None: nothing)
    baseline_fn: Optional[Callable[[], object]] = None


def bound_ms(ops: float, nbytes: float, peak: str) -> Tuple[float, str]:
    """The least time the card could take for ``ops`` operations of type
    ``peak`` that move ``nbytes``: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ints(t) -> Optional[List[int]]:
    return None if t is None else [int(x) for x in torch.as_tensor(t).cpu()]


def row_limits(positions: np.ndarray, sq: int, sk: int, causal: bool,
               kv_len: Optional[int], prefix_len: Optional[int]) -> np.ndarray:
    """Keys ``kj < lim`` are live for a row at each position: ``kv_len``,
    narrowed by the causal limit (diagonal at the end of the kv axis) and
    widened by the prefix, as in ``attention_plain`` and B1."""
    kvl = sk if kv_len is None else min(int(kv_len), sk)
    pos = np.asarray(positions)
    if not causal:
        return np.full(pos.shape, kvl)
    pfx = 0 if prefix_len is None else int(prefix_len)
    return np.minimum(np.maximum(pos + sk - sq + 1, pfx), kvl)


def attention_limits(b: int, sq: int, sk: int, causal: bool = False,
                     kv_len=None, prefix_len=None) -> np.ndarray:
    """[b, sq] live keys of each row (keys kj < limit are live)."""
    kvl, pfx = _ints(kv_len), _ints(prefix_len)
    return np.stack([row_limits(np.arange(sq), sq, sk, causal,
                                None if kvl is None else kvl[i],
                                None if pfx is None else pfx[i])
                     for i in range(b)])


def attention_work(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
                   causal: bool = False, kv_len=None, prefix_len=None,
                   elem: int = 2, peak: str = "bf16"
                   ) -> Tuple[float, float, str]:
    """B1: 4 d FLOPs per (row, key) over the keys each row's result depends
    on (a row with no live key: all sk, the mean of V), for every head;
    q, k, v read and o written once (``elem`` bytes each: 4 in fp32)."""
    lim = attention_limits(b, sq, sk, causal, kv_len, prefix_len)
    keys = np.where(lim <= 0, sk, np.minimum(lim, sk)).sum()
    return (4.0 * d * h * float(keys),
            float(elem * d * (2 * b * h * sq + 2 * b * kvh * sk)), peak)


def decode_work(h: int, kvh: int, d: int, live: Sequence[int], kv_elem: int,
                scales: bool, q_elem: int = 2, peak: str = "bf16"
                ) -> Tuple[float, float, str]:
    """B2: one query row a slot over its live cache rows (``live``, per
    slot): q read, o written (``q_elem`` bytes each), the live K and V rows
    (and their fp32 scales in the int8 form) read once."""
    rows = float(sum(live))
    row_bytes = kvh * (d * kv_elem + (4 if scales else 0))
    return (4.0 * d * h * rows,
            float(2 * q_elem * len(live) * h * d) + 2 * rows * row_bytes,
            peak)


def gemm_work(m: int, k: int, n: int, x_bytes: float, w_bytes: float,
              s_bytes: float, y_elem: int, peak: str
              ) -> Tuple[float, float, str]:
    """B5-B7: 2 m k n operations; activations, weights and scales read
    once, the [m, n] output written once."""
    return (2.0 * m * k * n, float(x_bytes + w_bytes + s_bytes + m * n * y_elem),
            peak)


def _library(build: Callable[[], Callable[[], object]]
             ) -> Tuple[Optional[Callable], str]:
    """(fn, "") for the call ``build()`` returns (its set-up done there,
    outside the timed span) if it runs once, else (None, the refusal): a
    library call that does not exist for the card or refuses the shape."""
    try:
        fn = build()
        fn()
        return fn, ""
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, str(e).strip().splitlines()[0][:160]


def _bhsd(gen, b, s, h, d, dev):
    """[B, H, S, D] view of a [B, S, H, D] tensor, as the models pass it."""
    return torch.randn(b, s, h, d, generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)


def cases(device) -> List[Case]:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    out = []

    def b1(case, q, k, v, on_path=False, **kw):
        b, h, sq, d = q.shape
        kvh, sk = k.shape[1], k.shape[2]
        fp32 = q.dtype == torch.float32
        causal = kw.get("causal", False)
        mask_kw = dict(causal=causal, kv_len=kw.get("kv_len"),
                       prefix_len=kw.get("prefix_len"))
        # SDPA's boolean mask, built outside the timed span
        lim = attention_limits(b, sq, sk, **mask_kw)
        mask = None
        if causal or kw.get("kv_len") is not None:
            mask = (torch.arange(sk, device=dev)[None, None, :] <
                    torch.as_tensor(lim, device=dev)[:, :, None])[:, None]
        out.append(Case(
            "B1", case, lambda: flash_attention(q, k, v, **kw),
            lambda: attention_plain(q, k, v, **kw),
            FP32_TOL if fp32 else ATTN_TOL, on_path, rel=fp32,
            form="flash_attention_fp32" if fp32 else "",
            work=attention_work(b, h, kvh, sq, sk, d, **mask_kw,
                                elem=q.element_size(),
                                peak="fp32_3xtf32" if fp32 else "bf16"),
            library_fn=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=h != kvh),
            # a row with no live key: the reference's mean of V, SDPA's
            # own convention
            library_compare=bool((lim > 0).all()),
            library_note="scaled_dot_product_attention, boolean mask"))

    # SigLIP So400m tower: 16 heads of 72 over 256 patches, no mask
    b1("siglip_g4_h16_s256_d72", *(_bhsd(gen, GROUP, 256, 16, 72, dev)
                                   for _ in range(3)), on_path=True)
    # Gemma prefill: MQA 8:1, D=256, ragged kv_len
    b1("gemma_prefill_g4_s316_kvlen", _bhsd(gen, GROUP, PROMPT, 8, 256, dev),
       _bhsd(gen, GROUP, PROMPT, 1, 256, dev),
       _bhsd(gen, GROUP, PROMPT, 1, 256, dev), on_path=True,
       kv_len=torch.tensor([PROMPT, 290, PROMPT, 0], **i32))
    b1("causal_offset_sq40_sk64", _bhsd(gen, 2, 40, 4, 128, dev),
       _bhsd(gen, 2, 64, 2, 128, dev), _bhsd(gen, 2, 64, 2, 128, dev),
       causal=True)
    b1("prefix_kvlen_s64", _bhsd(gen, 2, 64, 4, 256, dev),
       _bhsd(gen, 2, 64, 1, 256, dev), _bhsd(gen, 2, 64, 1, 256, dev),
       causal=True, prefix_len=torch.tensor([20, 5], **i32),
       kv_len=torch.tensor([60, 64], **i32))
    # the towers and decoders of later slices: CLIP-L/336 (16 x 64 over
    # 577 tokens; LLaVA's tower, on its path), EVA ViT-g (16 x 88 over
    # 257; BLIP-2's tower, on its path), a Vicuna-7B prefill (32 x 128, MHA) of 100 new tokens after 256
    # cached ones
    b1("clip_l336_g4_h16_s577_d64", *(_bhsd(gen, GROUP, 577, 16, 64, dev)
                                      for _ in range(3)), on_path=True)
    b1("eva_g4_h16_s257_d88", *(_bhsd(gen, GROUP, 257, 16, 88, dev)
                                for _ in range(3)), on_path=True)
    b1("causal_mha_sq100_sk356_d128", _bhsd(gen, 2, 100, 32, 128, dev),
       _bhsd(gen, 2, 356, 32, 128, dev), _bhsd(gen, 2, 356, 32, 128, dev),
       causal=True, kv_len=torch.tensor([356, 300], **i32))
    # contiguous [B, H, S, D] operands with G = 4, a causal query longer
    # than the keys (rows before the first key see none), and a head dim
    # TMA cannot stride (the wrapper pads it)
    def bhsd(b, h, s, d):
        return torch.randn(b, h, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
    b1("gqa_g4_contiguous_d64", bhsd(2, 8, 70, 64), bhsd(2, 2, 70, 64),
       bhsd(2, 2, 70, 64), kv_len=torch.tensor([70, 33], **i32))
    b1("causal_sq80_sk48_dead_rows", bhsd(2, 4, 80, 128), bhsd(2, 4, 48, 128),
       bhsd(2, 4, 48, 128), causal=True)
    b1("d42_padded", bhsd(2, 2, 33, 42), bhsd(2, 2, 33, 42),
       bhsd(2, 2, 33, 42), kv_len=torch.tensor([0, 20], **i32))

    # decode attention over the 32-slot cache, timed cold (the slice reads
    # each layer's cache from device memory) and warm (from the L2 cache)
    q = torch.randn(SLOTS, 1, 8, 256, generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    kc = torch.randn(SLOTS, CACHE, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    vc = torch.randn(SLOTS, CACHE, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    acol = torch.randint(0, NEW, (SLOTS,), generator=gen, device=dev).int()
    gcnt = torch.randint(1, NEW + 1, (SLOTS,), generator=gen, device=dev).int()
    gcnt[3] = 0                                       # a slot not admitted
    kv_len = torch.randint(0, CACHE + 1, (SLOTS,), generator=gen,
                           device=dev).int()
    kv_len[5] = 0                                     # fully masked row
    valid = torch.rand(SLOTS, CACHE, generator=gen, device=dev) < 0.5
    valid[7] = False                                  # fully masked row
    pcol = torch.tensor(PROMPT, **i32)
    # the int8 cache: the same rows quantized per (slot, row, kv head)
    kq, ks = quantize_activations(kc)
    vq, vs = quantize_activations(vc)

    def b2(case, q, kk, vv, kw, on_path, scales, cold=False):
        fp32 = q.dtype == torch.float32
        form = "decode_attention_int8" if scales else \
            "decode_attention_fp32" if fp32 else "decode_attention"
        b, h, _, d = q.shape
        live = live_rows(b, kk.shape[1], dev, **kw)
        kw = dict(kw, **scales)
        name = case + ("_int8" if scales else "") + ("_cold" if cold else "")
        lib = dict(library_note="no PyTorch call attends over an int8 cache "
                                "with per-row scales")
        if not scales:
            # the cache [B, S, KV, D] as SDPA's [B, KV, S, D] view
            mask = live[:, None, None, :]
            lib = dict(
                library_fn=lambda: F.scaled_dot_product_attention(
                    q, kk.transpose(1, 2), vv.transpose(1, 2),
                    attn_mask=mask, enable_gqa=h != kk.shape[2]),
                # a slot with no live row: the plain version's 0, SDPA's
                # own convention
                library_compare=bool(live.any(dim=1).all()),
                library_note="scaled_dot_product_attention, boolean mask")
        out.append(Case(
            "B2", name,
            lambda: decode_attention(q, kk, vv, **kw),
            lambda: decode_attention_plain(q, kk, vv, **kw),
            FP32_TOL if fp32 else ATTN_TOL, on_path, form=form, cold=cold,
            rel=fp32,
            work=decode_work(h, kk.shape[2], d, _ints(live.sum(dim=1)),
                             kk.element_size(), bool(scales),
                             q.element_size(),
                             "fp32_3xtf32" if fp32 else "bf16"),
            **lib))

    for kk, vv, scales in ((kc, vc, {}),
                           (kq, vq, dict(k_scale=ks, v_scale=vs))):
        for cold in (True, False):
            b2("window_32slots", q, kk, vv,
               dict(kv_window=(pcol, NEW, acol, gcnt)), True, scales, cold)
        b2("kv_len_32slots", q, kk, vv, dict(kv_len=kv_len), False, scales)
        b2("kv_valid_32slots", q, kk, vv, dict(kv_valid=valid), False,
           scales)

    # shapes and masks the serving path does not reach: MHA (G = 1,
    # D = 128), GQA (G = 4, D = 64), one row, a ragged last tile, a long
    # cache cut into many splits with whole splits and whole rows masked
    def cache(b, s, kvh, d):
        kk = torch.randn(b, s, kvh, d, generator=gen, device=dev).to(
            torch.bfloat16)
        vv = torch.randn(b, s, kvh, d, generator=gen, device=dev).to(
            torch.bfloat16)
        kq, ks = quantize_activations(kk)
        vq, vs = quantize_activations(vv)
        return ((kk, vv, {}), (kq, vq, dict(k_scale=ks, v_scale=vs)))

    def query(b, h, d):
        return torch.randn(b, 1, h, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)

    for case, (b, h, kvh, s, d), kw in (
            ("mha_g1_d128_s100", (4, 8, 8, 100, 128),
             dict(kv_len=torch.tensor([100, 37, 0, 64], **i32))),
            ("gqa_g4_d64_s100", (4, 8, 2, 100, 64),
             dict(kv_len=torch.tensor([1, 99, 100, 65], **i32))),
            ("s1", (3, 8, 1, 1, 256), dict(kv_len=torch.tensor([1, 0, 1],
                                                             **i32))),
            ("s2048_kv_len", (4, 8, 1, 2048, 256),
             dict(kv_len=torch.tensor([2048, 300, 0, 1500], **i32))),
            ("g32_d72_s130", (2, 32, 1, 130, 72), {})):
        qq = query(b, h, d)
        for kk, vv, scales in cache(b, s, kvh, d):
            b2(case, qq, kk, vv, kw, False, scales)
    # kv_valid over 2048 rows: slot 0 has rows only in the first and last
    # 64, so the splits between hold no live row; slot 1 has none
    qq = query(4, 8, 256)
    live = torch.rand(4, 2048, generator=gen, device=dev) < 0.3
    live[0, 64:-64] = False
    live[1] = False
    for kk, vv, scales in cache(4, 2048, 1, 256):
        b2("s2048_dead_splits", qq, kk, vv, dict(kv_valid=live), False,
           scales)

    # the fp32 forms (quantization "fp32") at the fp32 slice's shapes: the
    # tower and Gemma prefill of an admission of 4, the decode window over
    # 32 slots; and the masks the slice does not reach. SDPA in fp32 (no
    # TF32: chip_smoke.py turns it off) is their yardstick.
    def f32(b, s, h, d):
        return torch.randn(b, s, h, d, generator=gen, device=dev).transpose(
            1, 2)
    b1("fp32_siglip_g4_h16_s256_d72", *(f32(GROUP, 256, 16, 72)
                                        for _ in range(3)), on_path=True)
    b1("fp32_gemma_prefill_g4_s316_kvlen", f32(GROUP, PROMPT, 8, 256),
       f32(GROUP, PROMPT, 1, 256), f32(GROUP, PROMPT, 1, 256), on_path=True,
       kv_len=torch.tensor([PROMPT, 290, PROMPT, 0], **i32))
    b1("fp32_prefix_kvlen_gqa_s64", f32(2, 64, 4, 128), f32(2, 64, 2, 128),
       f32(2, 64, 2, 128), causal=True,
       prefix_len=torch.tensor([20, 5], **i32),
       kv_len=torch.tensor([60, 64], **i32))
    b1("fp32_causal_sq80_sk48_dead_rows", f32(2, 80, 4, 64), f32(2, 48, 4, 64),
       f32(2, 48, 4, 64), causal=True)
    # the towers of later slices in fp32 (probing's mode): CLIP-L/336 and
    # EVA ViT-g
    b1("fp32_clip_l336_g4_h16_s577_d64", *(f32(GROUP, 577, 16, 64)
                                           for _ in range(3)))
    b1("fp32_eva_g4_h16_s257_d88", *(f32(GROUP, 257, 16, 88)
                                     for _ in range(3)))
    q32, kc32, vc32 = q.float(), kc.float(), vc.float()
    for cold in (True, False):
        b2("fp32_window_32slots", q32, kc32, vc32,
           dict(kv_window=(pcol, NEW, acol, gcnt)), True, {}, cold)
    b2("fp32_kv_len_32slots", q32, kc32, vc32, dict(kv_len=kv_len), False, {})
    b2("fp32_kv_valid_32slots", q32, kc32, vc32, dict(kv_valid=valid), False,
       {})

    # the per-step KV row write, in place on clones of the cache
    k_new = torch.randn(SLOTS, 1, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    v_new = torch.randn(SLOTS, 1, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    wcol = torch.full((SLOTS,), PROMPT + 7, **i32)
    per_slot = torch.randint(0, CACHE, (SLOTS,), generator=gen,
                             device=dev).int()

    def b3(case, writer, start, on_path):
        # kernel and plain each write into their own copy of the cache
        def kernel():
            ck, cv = kc.clone(), vc.clone()
            writer(ck, cv, k_new, v_new, start)
            return torch.cat([ck, cv])

        def plain():
            ck, cv = kc.clone(), vc.clone()
            kv_masked_write(ck, k_new, start)
            kv_masked_write(cv, v_new, start)
            return torch.cat([ck, cv])
        # the library: one indexed copy of each slot's row (K, then V)
        rows = torch.arange(SLOTS, device=dev)
        cols = start.long().expand(SLOTS)

        def library(ck, cv):
            ck.index_put_((rows, cols), k_new[:, 0])
            cv.index_put_((rows, cols), v_new[:, 0])
            return ck, cv
        ck, cv = kc.clone(), vc.clone()
        lk, lv = kc.clone(), vc.clone()
        out.append(Case(
            "B3", case, kernel, plain, 0.0, on_path,
            time_kernel=lambda: writer(ck, cv, k_new, v_new, start),
            time_plain=lambda: (kv_masked_write(ck, k_new, start),
                                kv_masked_write(cv, v_new, start)),
            work=(0.0, 2.0 * 2 * k_new.numel() * k_new.element_size(),
                  "bf16"),
            library_fn=lambda: library(lk, lv),
            library_out=lambda _: torch.cat(
                library(kc.clone(), vc.clone())),
            library_note="index_put_ of the rows, once for K and once "
                         "for V"))

    # the decode step writes inside B2's launch now (the fused cases below)
    b3("uniform_32slots", kv_uniform_write, wcol, False)
    b3("scatter_32slots", kv_scatter_write, per_slot, False)

    # int8 form: quantize and write values and scales, bitwise
    def b3_int8(case, k_rows, v_rows, cache, start, uniform, on_path):
        def write(fn, caches):
            fn(caches[0], caches[1], k_rows, v_rows, start, uniform)
            return torch.cat([t.float().flatten() for c in caches for t in c])

        def fresh():
            return tuple(tuple(t.clone() for t in c) for c in cache)
        mine = fresh()
        # bf16 rows read; int8 rows and fp32 scales written
        n_rows = k_rows.numel() // k_rows.shape[-1]
        out.append(Case(
            "B3", case, lambda: write(kv_quantized_write, fresh()),
            lambda: write(kv_quantized_write_plain, fresh()), 0.0, on_path,
            time_kernel=lambda: kv_quantized_write(
                mine[0], mine[1], k_rows, v_rows, start, uniform),
            time_plain=lambda: kv_quantized_write_plain(
                mine[0], mine[1], k_rows, v_rows, start, uniform),
            form="kv_write_int8",
            work=(0.0, 2.0 * (3 * k_rows.numel() + 4 * n_rows), "bf16"),
            library_note="no PyTorch call quantizes rows and writes values "
                         "and scales"))

    cache8 = ((kq, ks), (vq, vs))
    b3_int8("int8_uniform_32slots", k_new, v_new, cache8, wcol, True, False)
    b3_int8("int8_scatter_32slots", k_new, v_new, cache8, per_slot, False,
            False)
    # admission: the prompt's rows of a group of 4 at column 0
    k_pre = torch.randn(GROUP, PROMPT, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    v_pre = torch.randn(GROUP, PROMPT, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    group8 = tuple((torch.zeros(GROUP, PROMPT, 1, 256, dtype=torch.int8,
                                device=dev),
                    torch.zeros(GROUP, PROMPT, 1, 1, device=dev))
                   for _ in range(2))
    b3_int8("int8_prefill_g4_s316", k_pre, v_pre, group8,
            torch.zeros(1, **i32), True, True)

    # B3 inside B2's launch: the decode step's row write, on clones of the
    # window cache, bf16, int8 (bf16 rows quantized in the launch) and fp32
    def b3_fused(case, q, caches, k_rows, v_rows, start, uniform, kw,
                 on_path, cold=False):
        int8 = len(caches) == 4
        fp32 = q.dtype == torch.float32
        b, h, _, d = q.shape
        s_total, kvh = caches[0].shape[1], caches[0].shape[2]

        def fresh():
            return [t.clone() for t in caches]

        def scales(c):
            return dict(k_scale=c[2], v_scale=c[3]) if int8 else {}

        def attend(c, fused):
            rows = dict(k_new=k_rows, v_new=v_rows, write_start=start,
                        uniform=uniform) if fused else {}
            return decode_attention(q, c[0], c[1], **kw, **scales(c),
                                    **rows)

        def b3(c):              # B3's own kernel, or its plain version
            if int8:
                kv_quantized_write((c[0], c[2]), (c[1], c[3]), k_rows,
                                   v_rows, start, uniform)
            else:
                (kv_uniform_write if uniform else kv_scatter_write)(
                    c[0], c[1], k_rows, v_rows, start)

        def b3_plain(c):
            if int8:
                kv_quantized_write_plain((c[0], c[2]), (c[1], c[3]), k_rows,
                                         v_rows, start, uniform)
            else:
                kv_write_plain(c[0], c[1], k_rows, v_rows, start, uniform)

        def flat(o, c):         # the output, then every cache tensor
            return torch.cat([o.float().flatten()]
                             + [t.float().flatten() for t in c])

        def fused():
            c = fresh()
            return flat(attend(c, True), c)

        def unfused():
            c = fresh()
            b3(c)
            return flat(attend(c, False), c)

        def plain():
            c = fresh()
            b3_plain(c)
            return flat(decode_attention_plain(q, c[0], c[1], **kw,
                                               **scales(c)), c)
        mine, alone, theirs = fresh(), fresh(), fresh()
        cols = (start[:1].expand(b) if uniform else start).long()
        written = int(((cols >= 0) & (cols < s_total)).sum())
        live = live_rows(b, s_total, dev, **kw)
        ops, nbytes, peak = decode_work(
            h, kvh, d, _ints(live.sum(dim=1)), caches[0].element_size(),
            int8, q.element_size(), "fp32_3xtf32" if fp32 else "bf16")
        # the new rows read and written once: K and V, values (and scales)
        row_bytes = kvh * ((2 + 1) * d + 4 if int8
                           else 2 * d * k_rows.element_size())
        lib = dict(library_note="no PyTorch call quantizes rows and attends "
                                "over an int8 cache with per-row scales")
        if not int8 and written == b:
            # index_put_ of the rows (K, then V), then SDPA over the cache
            slot = torch.arange(b, device=dev)
            mask = live[:, None, None, :]

            def library():
                theirs[0].index_put_((slot, cols), k_rows[:, 0])
                theirs[1].index_put_((slot, cols), v_rows[:, 0])
                return F.scaled_dot_product_attention(
                    q, theirs[0].transpose(1, 2), theirs[1].transpose(1, 2),
                    attn_mask=mask, enable_gqa=h != kvh)
            lib = dict(library_fn=library, library_compare=False,
                       library_note="index_put_ of the rows (K, V), then "
                                    "scaled_dot_product_attention")
        elif not int8:
            lib = dict(library_note="index_put_ takes no column outside "
                                    "the cache")
        out.append(Case(
            "B3", case + ("_cold" if cold else ""), fused, plain,
            FP32_TOL if fp32 else ATTN_TOL, on_path, rel=fp32, cold=cold,
            form="kv_write_int8_fused" if int8 else "kv_write_fused",
            time_kernel=lambda: attend(mine, True),
            time_plain=lambda: (b3_plain(mine),
                                decode_attention_plain(q, mine[0], mine[1],
                                                       **kw, **scales(mine))),
            work=(ops, nbytes + 2.0 * written * row_bytes, peak),
            exact_fn=unfused, baseline_fn=lambda: attend(alone, False),
            **lib))

    # pos on the window's write column (in the last of six 64-row splits;
    # of eleven 32-row splits in fp32), per slot across tile and split
    # edges and outside the cache, and one uniform column outside it
    edges = torch.tensor([0, 31, 32, 63, 64, 127, 128, 255, 319, 320, 347,
                          -1, CACHE, PROMPT, PROMPT + 7, 200], **i32)
    fstart = torch.cat([edges, per_slot[len(edges):]])
    fkv_len = (fstart + 1).clamp(0, CACHE).int()
    k_new32, v_new32 = k_new.float(), v_new.float()
    q32 = q.float()
    forms = (("", q, (kc, vc), k_new, v_new),
             ("int8_", q, (kq, vq, ks, vs), k_new, v_new),
             ("fp32_", q32, (kc.float(), vc.float()), k_new32, v_new32))
    for tag, qq, caches, kr, vr in forms:
        # cold, as in place (a decode step streams the weights between
        # two layers' attention), and warm, as B2's own cases
        for cold in (True, False):
            b3_fused(f"{tag}fused_window_32slots", qq, caches, kr, vr,
                     wcol[:1], True, dict(kv_window=(pcol, NEW, acol, gcnt)),
                     True, cold)
        b3_fused(f"{tag}fused_scatter_kv_len_32slots", qq, caches, kr, vr,
                 fstart, False, dict(kv_len=fkv_len), False)
        b3_fused(f"{tag}fused_uniform_outside", qq, caches, kr, vr,
                 torch.full((1,), CACHE, **i32), True,
                 dict(kv_window=(pcol, NEW, acol, gcnt)), False)
        if tag != "fp32_":
            # the wave and beam engines' step: every row at one live
            # column under kv_len (8 images x 4 beams)
            b3_fused(f"{tag}fused_uniform_kv_len_32slots", qq, caches, kr,
                     vr, torch.full((1,), PROMPT + 7, **i32), True,
                     dict(kv_len=torch.full((SLOTS,), PROMPT + 8, **i32)),
                     True)

    u8 = torch.randint(0, 256, (GROUP, 224, 224, 3), generator=gen,
                       device=dev).to(torch.uint8)
    recipe = RECIPES["paligemma"]
    b4_note = ("no single PyTorch call: the cast, the scale and shift and "
               "the layout change are separate operators")
    # the admissions write the patch embedding's layout (SigLIP: 14 px
    # patches); NHWC stays for callers without a patch size
    for dtype, tag, form, elem in ((torch.bfloat16, "", "normalize", 2),
                                   (torch.float32, "fp32_", "normalize_fp32",
                                    4)):
        def b4(patch, dtype=dtype):
            return lambda: normalize_images(u8, recipe=recipe,
                                            compute_dtype=dtype,
                                            patch_size=patch)
        out.append(Case(
            "B4", f"{tag}u8_g4_224", b4(None),
            functools.partial(normalize_plain, u8, recipe, dtype),
            NORM_TOL if elem == 2 else 0.0, False, form=form,
            work=(0.0, (1.0 + elem) * u8.numel(), "bf16"),
            library_note=b4_note))
        out.append(Case(
            "B4", f"{tag}patch14_u8_g4_224", b4(14),
            functools.partial(normalize_plain, u8, recipe, dtype, 14), 0.0,
            True, form=form, work=(0.0, (1.0 + elem) * u8.numel(), "bf16"),
            baseline_fn=lambda dtype=dtype: unfold_patches(normalize_images(
                u8, recipe=recipe, compute_dtype=dtype), 14),
            library_note=b4_note))

    # B5: the weight-only int8 products of the 8bit decode step (m = 32
    # slots) and of a one-image admission (m = 316)
    def weights(k, n):
        qw = torch.randint(-127, 128, (n, k), generator=gen, device=dev).to(
            torch.int8)
        sw = torch.rand(n, generator=gen, device=dev) * (2 / k ** 0.5 / 64)
        return qw, sw

    def b5(m, k, n, qw, sw, on_path, out_dtype=torch.bfloat16):
        # fp32 out: a row-parallel rank's partial product
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        sw16 = sw.to(torch.bfloat16)
        fn, why = _library(lambda: functools.partial(
            torch._weight_int8pack_mm, x, qw, sw16))
        f32 = out_dtype == torch.float32
        out.append(Case(
            "B5", f"m{m}_k{k}_n{n}{'_fp32' if f32 else ''}",
            lambda: int8_matmul(x, qw, sw, out_dtype),
            lambda: int8_matmul_plain(x, qw, sw, out_dtype), GEMM_REL_TOL,
            on_path, rel=True, cold=True,
            work=gemm_work(m, k, n, 2 * m * k, n * k, 4 * n, 4 if f32 else 2,
                           "bf16"),
            library_fn=fn,
            library_note=why or "torch._weight_int8pack_mm, scales in bf16"))

    gemma_w = {kn: weights(*kn) for kn in GEMMA_KN}
    # the 8bit decode step (m = 32 slots) first, gate/up its main case; a
    # one-image admission (m = 316); one row; the int8 tower of one image
    for m, on_path in ((SLOTS, True), (PROMPT, True), (1, False)):
        for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
            b5(m, k, n, *gemma_w[(k, n)], on_path)
    for k, n in SIGLIP_KN:
        b5(256, k, n, *weights(k, n), False)

    # B6: the llm.int8 prefill product of a Gemma admission (m = 4 x 316,
    # fp32 out for the outlier sum) and the quantized SigLIP tower's MLP at
    # m = 2 x 256 (ragged N = 4304 and ragged K = 64 x 67 + 16), bf16 out
    def b6(m, k, n, qw, sw, out_dtype, on_path):
        qx = torch.randint(-127, 128, (m, k), generator=gen, device=dev).to(
            torch.int8)
        sx = torch.rand(m, 1, generator=gen, device=dev) * (4 / 127)
        exact = out_dtype == torch.float32
        tag = "fp32" if exact else "bf16"
        # torch._int_mm on the card takes more than 16 rows; below that the
        # plain version runs on CPU copies (the same IEEE epilogue) untimed
        card = m > 16
        lib = dict(library_note="torch._int_mm on the card takes more "
                                "than 16 rows")
        if card:
            # the int32 product alone, timed; the epilogue applied outside
            # the timed span for the comparison
            lib = dict(
                library_fn=lambda: torch._int_mm(qx, qw.t()),
                library_out=lambda acc: (acc.float() * sx * sw).to(
                    out_dtype),
                library_note="torch._int_mm: the int32 product without "
                             "the scale epilogue")
        out.append(Case(
            "B6", f"m{m}_k{k}_n{n}_{tag}",
            lambda: int8xint8_matmul(qx, sx, qw, sw, out_dtype),
            lambda: int8xint8_matmul_plain(
                *(t if card else t.cpu() for t in (qx, sx, qw, sw)),
                out_dtype).to(dev),
            0.0 if exact else GEMM_REL_TOL / 2, on_path, rel=not exact,
            cold=True, plain_timed=card,
            work=gemm_work(m, k, n, m * k, n * k, 4 * (m + n),
                           4 if exact else 2, "int8"), **lib))

    for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
        b6(GROUP * PROMPT, k, n, *gemma_w[(k, n)], torch.float32, True)
    for k, n in SIGLIP_KN:
        b6(2 * 256, k, n, *weights(k, n), torch.bfloat16, False)
    # one and four rows, K less than one 128-byte step, ragged M, N and K
    # (4304 = 33 x 128 + 80)
    b6(1, 2048, 2048, *gemma_w[(2048, 2048)], torch.float32, False)
    b6(4, 64, 32, *weights(64, 32), torch.float32, False)
    b6(4, 4304, 4304, *weights(4304, 4304), torch.bfloat16, False)
    b6(300, 4304, 1152, *weights(4304, 1152), torch.float32, False)

    # B7: packed int4 bytes (every nibble, -8 included) and fp32 group
    # scales that give lecun-sized weights
    def weights4(k, n, gs):
        q4 = torch.randint(-128, 128, (n, k // 2), generator=gen,
                           device=dev).to(torch.int8)
        s4 = (0.5 + torch.rand(n, k // gs, generator=gen, device=dev)) / (
            4 * k ** 0.5)
        return q4, s4, gs

    def b7(m, k, n, w4, on_path, out_dtype=torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        q4, s4, gs = w4
        def library():
            packed, sz = _int4pack(q4, s4)
            return functools.partial(torch._weight_int4pack_mm, x, packed, gs,
                                     sz)
        fn, why = _library(library)
        f32 = out_dtype == torch.float32
        out.append(Case(
            "B7", f"m{m}_k{k}_n{n}_gs{gs}{'_fp32' if f32 else ''}",
            lambda: int4_matmul(x, *w4, out_dtype=out_dtype),
            lambda: int4_matmul_plain(x, *w4, out_dtype=out_dtype),
            GEMM_REL_TOL, on_path, rel=True, cold=True,
            form="int4_matmul_prefill" if int4_prefill_form(m, n, k)
            else "",
            work=gemm_work(m, k, n, 2 * m * k, n * k // 2, 4 * n * (k // gs),
                           4 if f32 else 2, "bf16"),
            library_fn=fn,
            library_note=why or "torch._weight_int4pack_mm on weights "
                                "repacked by _convert_weight_to_int4pack, "
                                "scales in bf16"))

    gemma_w4 = {kn: weights4(*kn, 128) for kn in GEMMA_KN}
    # the 4bit decode step (m = 32 slots) first, gate/up its main case; a
    # one-image admission (m = 316); one row
    for m, on_path in ((SLOTS, True), (PROMPT, False), (1, False)):
        for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
            b7(m, k, n, gemma_w4[(k, n)], on_path)
    # the int4 tower of one image (m = 256): fc1 at group 128, fc2 at group
    # 16 with 2152-byte packed rows and a ragged K tail (4304 = 64 * 67 + 16)
    b7(256, 1152, 4304, weights4(1152, 4304, 128), False)
    fc2_w4 = weights4(4304, 1152, 16)
    b7(256, 4304, 1152, fc2_w4, False)
    # fc2 on the decode form at the 4bit reference's 2-image prefill (512
    # rows) and an admission of 4 (1,024): below dense_int4's gate
    b7(2 * 256, 4304, 1152, fc2_w4, True)
    b7(GROUP * 256, 4304, 1152, fc2_w4, True)
    b7(9, 128, 100, weights4(128, 100, 32), False)   # JAX's padding test
    # an admission of 4 (m = 1264): B7's prefill form
    for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
        b7(GROUP * PROMPT, k, n, gemma_w4[(k, n)], True)

    # ---- LLaVA-1.5-7B's serving shapes (the bf16 and 8bit slices) ----
    # B1: Vicuna's causal prefill of an admission of 4 (MHA, G = 1: one
    # head a block), the K/V views of the [B, S, KV, D] projections, one
    # row's prompt shorter than the rest
    lp = LLAVA_PROMPT
    b1("vicuna_prefill_g4_h32_s641_d128_kvlen",
       *(_bhsd(gen, GROUP, lp, 32, 128, dev) for _ in range(3)), on_path=True,
       causal=True, kv_len=torch.tensor([lp, lp, lp, 600], **i32))
    # its fp32 form, as the fp32 depth-cut reference runs it (2 images)
    b1("fp32_vicuna_prefill_g2_h32_s641_d128_kvlen",
       *(f32(2, lp, 32, 128) for _ in range(3)), causal=True,
       kv_len=torch.tensor([lp, 600], **i32))

    # B2 and B3 fused: the rotating window over the MHA cache (32 KV heads
    # of 128), every slot's new row written into its own head of K and V
    def llava_window(slots):
        ac = torch.randint(0, NEW, (slots,), generator=gen, device=dev).int()
        gc = torch.randint(1, NEW + 1, (slots,), generator=gen,
                           device=dev).int()
        gc[1] = 0                                     # a slot not admitted
        return (torch.tensor(lp, **i32), NEW, ac, gc)

    def rows(slots, dtype=torch.bfloat16):
        return tuple(torch.randn(slots, 1, 32, 128, generator=gen,
                                 device=dev).to(dtype) for _ in range(2))

    lwin = llava_window(LLAVA_SLOTS)
    lq = query(LLAVA_SLOTS, 32, 128)
    (lk, lv, _), _ = cache(LLAVA_SLOTS, LLAVA_CACHE, 32, 128)
    for cold in (True, False):
        b2("llava_window_32slots", lq, lk, lv, dict(kv_window=lwin), True,
           {}, cold)
    lkr, lvr = rows(LLAVA_SLOTS)
    lcol = torch.full((1,), lp + 7, **i32)
    for cold in (True, False):
        b3_fused("llava_fused_window_32slots", lq, (lk, lv), lkr, lvr, lcol,
                 True, dict(kv_window=lwin), True, cold)
    lstart = torch.randint(0, LLAVA_CACHE, (LLAVA_SLOTS,), generator=gen,
                           device=dev).int()
    lstart[:4] = torch.tensor([0, 63, 64, LLAVA_CACHE - 1], **i32)
    b3_fused("llava_fused_scatter_kv_len_32slots", lq, (lk, lv), lkr, lvr,
             lstart, False, dict(kv_len=(lstart + 1).int()), False)
    # the beam engine's step: 8 images x 4 beams at one live column
    b3_fused("llava_fused_uniform_kv_len_32slots", lq, (lk, lv), lkr, lvr,
             lcol, True, dict(kv_len=torch.full((LLAVA_SLOTS,), lp + 8,
                                                **i32)), True)
    # 8bit: 16 slots over the int8 cache
    win8 = llava_window(LLAVA_SLOTS_8BIT)
    q8 = query(LLAVA_SLOTS_8BIT, 32, 128)
    _, (kq8, vq8, sc8) = cache(LLAVA_SLOTS_8BIT, LLAVA_CACHE, 32, 128)
    for cold in (True, False):
        b2("llava_window_16slots", q8, kq8, vq8, dict(kv_window=win8), True,
           sc8, cold)
    kr8, vr8 = rows(LLAVA_SLOTS_8BIT)
    caches8 = (kq8, vq8, sc8["k_scale"], sc8["v_scale"])
    for cold in (True, False):
        b3_fused("llava_int8_fused_window_16slots", q8, caches8, kr8, vr8,
                 lcol, True, dict(kv_window=win8), True, cold)
    st8 = lstart[:LLAVA_SLOTS_8BIT].contiguous()
    b3_fused("llava_int8_fused_scatter_kv_len_16slots", q8, caches8, kr8,
             vr8, st8, False, dict(kv_len=(st8 + 1).int()), False)
    # fp32 (the fp32 depth-cut reference's forms at G = 1, D = 128): 4
    # slots
    win32 = llava_window(4)
    q32 = query(4, 32, 128).float()
    (k32, v32, _), _ = cache(4, LLAVA_CACHE, 32, 128)
    k32, v32 = k32.float(), v32.float()
    b2("fp32_llava_window_4slots", q32, k32, v32, dict(kv_window=win32),
       False, {})
    kr32, vr32 = rows(4, torch.float32)
    b3_fused("llava_fp32_fused_window_4slots", q32, (k32, v32), kr32, vr32,
             lcol, True, dict(kv_window=win32), False)
    # the fp32 slice at full depth: an admission of 4 through Vicuna's
    # causal prefill, and the decode window of its 16 slots over 641 + 8
    # rows (8 new tokens)
    b1("fp32_vicuna_prefill_g4_h32_s641_d128_kvlen",
       *(f32(GROUP, lp, 32, 128) for _ in range(3)), on_path=True,
       causal=True, kv_len=torch.full((GROUP,), lp, **i32))
    new32 = LLAVA_FP32_NEW
    ac32 = torch.randint(0, new32, (LLAVA_SLOTS_FP32,), generator=gen,
                         device=dev).int()
    gc32 = torch.randint(1, new32 + 1, (LLAVA_SLOTS_FP32,), generator=gen,
                         device=dev).int()
    (k16, v16, _), _ = cache(LLAVA_SLOTS_FP32, lp + new32, 32, 128)
    b2("fp32_llava_window_16slots", query(LLAVA_SLOTS_FP32, 32, 128).float(),
       k16.float(), v16.float(),
       dict(kv_window=(torch.tensor(lp, **i32), new32, ac32, gc32)), True,
       {}, True)
    b3_fused("llava_fp32_fused_scatter_kv_len_4slots", q32, (k32, v32),
             kr32, vr32, lstart[:4].contiguous(),
             False, dict(kv_len=(lstart[:4] + 1).int()), False)
    # standalone B3: the 8bit admission's prompt rows of 4 images, int8
    k_pre = torch.randn(GROUP, lp, 32, 128, generator=gen, device=dev).to(
        torch.bfloat16)
    v_pre = torch.randn(GROUP, lp, 32, 128, generator=gen, device=dev).to(
        torch.bfloat16)
    group8 = tuple((torch.zeros(GROUP, lp, 32, 128, dtype=torch.int8,
                                device=dev),
                    torch.zeros(GROUP, lp, 32, 1, device=dev))
                   for _ in range(2))
    b3_int8("llava_int8_prefill_g4_s641_kv32", k_pre, v_pre, group8,
            torch.zeros(1, **i32), True, True)

    # B4: an admission of 4 CLIP images (336 px) into the patch layout
    u336 = torch.randint(0, 256, (GROUP, 336, 336, 3), generator=gen,
                         device=dev).to(torch.uint8)
    clip = RECIPES["llava"]
    for dtype, tag, form, elem, on_path in (
            (torch.bfloat16, "", "normalize", 2, True),
            (torch.float32, "fp32_", "normalize_fp32", 4, False)):
        out.append(Case(
            "B4", f"{tag}patch14_u8_g4_336",
            functools.partial(normalize_images, u336, recipe=clip,
                              compute_dtype=dtype, patch_size=14),
            functools.partial(normalize_plain, u336, clip, dtype, 14), 0.0,
            on_path, form=form,
            work=(0.0, (1.0 + elem) * u336.numel(), "bf16"),
            baseline_fn=lambda dtype=dtype: unfold_patches(normalize_images(
                u336, recipe=clip, compute_dtype=dtype), 14),
            library_note=b4_note))

    # B5 at the 8bit decode step's 16 slots and B6 at an admission's
    # 4 x 641 rows (``dynamic_noout``: bf16 out), Vicuna's three products
    vicuna_w = {kn: weights(*kn) for kn in VICUNA_KN}
    for k, n in VICUNA_KN:
        b5(LLAVA_SLOTS_8BIT, k, n, *vicuna_w[(k, n)], True)
    for k, n in VICUNA_KN:
        b6(GROUP * lp, k, n, *vicuna_w[(k, n)], torch.bfloat16, True)

    # ---- BLIP-2 OPT-6.7B's serving shapes (the bf16 and 8bit slices) ----
    # B1: the EVA tower of an admission of 4 (eva_g4_h16_s257_d88 above);
    # the Q-Former's self-attention (32 queries, G = 1: one head a block,
    # 96 dead rows) and cross-attention (32 queries over the 257 image
    # tokens: a one-key last tile), as views of the [B, S, 12, 64]
    # projections; OPT's causal prefill (MHA) with one row shorter
    bp = BLIP2_PROMPT
    b1("qformer_self_g4_h12_s32_d64",
       *(_bhsd(gen, GROUP, 32, 12, 64, dev) for _ in range(3)), on_path=True)
    b1("qformer_cross_g4_h12_sq32_sk257_d64", _bhsd(gen, GROUP, 32, 12, 64,
                                                    dev),
       *(_bhsd(gen, GROUP, 257, 12, 64, dev) for _ in range(2)),
       on_path=True)
    b1("opt_prefill_g4_h32_s92_d128_kvlen",
       *(_bhsd(gen, GROUP, bp, 32, 128, dev) for _ in range(3)),
       on_path=True, causal=True, kv_len=torch.tensor([bp, bp, bp, 80],
                                                      **i32))
    # the 8bit slice's admissions of 8: the tower's attention
    b1("eva_g8_h16_s257_d88", *(_bhsd(gen, BLIP2_GROUP_8BIT, 257, 16, 88,
                                      dev) for _ in range(3)), on_path=True)
    # the fp32 forms, as the fp32 depth-cut reference runs them (2 images):
    # D = 88 (fp32_eva above), 64 at the Q-Former, 128 at OPT
    b1("fp32_qformer_self_g2_h12_s32_d64", *(f32(2, 32, 12, 64)
                                             for _ in range(3)))
    b1("fp32_qformer_cross_g2_h12_sq32_sk257_d64", f32(2, 32, 12, 64),
       f32(2, 257, 12, 64), f32(2, 257, 12, 64))
    b1("fp32_opt_prefill_g2_h32_s92_d128_kvlen",
       *(f32(2, bp, 32, 128) for _ in range(3)), causal=True,
       kv_len=torch.tensor([bp, 80], **i32))

    # B2 and B3 fused over OPT's MHA cache of 92 + 32 rows: bf16 at 32
    # slots, int8 at 64, fp32 at 4 (the fp32 reference's G = 1, D = 128)
    def opt_window(slots):
        ac = torch.randint(0, NEW, (slots,), generator=gen, device=dev).int()
        gc = torch.randint(1, NEW + 1, (slots,), generator=gen,
                           device=dev).int()
        gc[1] = 0                                     # a slot not admitted
        return (torch.tensor(bp, **i32), NEW, ac, gc)

    ocol = torch.full((1,), bp + 7, **i32)
    for slots, int8, on_path in ((BLIP2_SLOTS, False, True),
                                 (BLIP2_SLOTS_8BIT, True, True),
                                 (4, False, False)):
        fp32 = not on_path
        win = opt_window(slots)
        qq = query(slots, 32, 128)
        (kk, vv, _), (kq8, vq8, sc8) = cache(slots, BLIP2_CACHE, 32, 128)
        kr, vr = rows(slots)
        tag = "int8_" if int8 else "fp32_" if fp32 else ""
        if fp32:
            qq, kk, vv, kr, vr = (t.float() for t in (qq, kk, vv, kr, vr))
        caches, scales = ((kq8, vq8, sc8["k_scale"], sc8["v_scale"]), sc8) \
            if int8 else ((kk, vv), {})
        for cold in (True, False) if on_path else (False,):
            b2(f"{'fp32_' if fp32 else ''}blip2_window_{slots}slots", qq,
               caches[0], caches[1], dict(kv_window=win), on_path, scales,
               cold)
            b3_fused(f"blip2_{tag}fused_window_{slots}slots", qq, caches, kr,
                     vr, ocol, True, dict(kv_window=win), on_path, cold)
    # standalone B3: the 8bit admission's prompt rows of 8 images, int8
    k_pre, v_pre = (torch.randn(BLIP2_GROUP_8BIT, bp, 32, 128, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
    group8 = tuple((torch.zeros(BLIP2_GROUP_8BIT, bp, 32, 128,
                                dtype=torch.int8, device=dev),
                    torch.zeros(BLIP2_GROUP_8BIT, bp, 32, 1, device=dev))
                   for _ in range(2))
    b3_int8("blip2_int8_prefill_g8_s92_kv32", k_pre, v_pre, group8,
            torch.zeros(1, **i32), True, True)

    # B4: an admission of 8 BLIP-2 images (224 px warped, CLIP's mean and
    # std) into EVA's patch layout, bf16 (both slices' compute dtype)
    u8g8 = torch.randint(0, 256, (BLIP2_GROUP_8BIT, 224, 224, 3),
                         generator=gen, device=dev).to(torch.uint8)
    blip = RECIPES["blip2"]
    out.append(Case(
        "B4", "blip2_patch14_u8_g8_224",
        functools.partial(normalize_images, u8g8, recipe=blip,
                          compute_dtype=torch.bfloat16, patch_size=14),
        functools.partial(normalize_plain, u8g8, blip, torch.bfloat16, 14),
        0.0, True, form="normalize", work=(0.0, 3.0 * u8g8.numel(), "bf16"),
        baseline_fn=lambda: unfold_patches(normalize_images(
            u8g8, recipe=blip, compute_dtype=torch.bfloat16), 14),
        library_note=b4_note))

    # B5 at the 8bit decode step's 64 slots (OPT's three products; down at
    # K = 16384), and at a one-image admission of the int8 tower (m = 257,
    # the 8bit depth-cut reference's 1-image rows); B6 at an admission's
    # 8 x 92 OPT rows and 8 x 257 EVA rows (``dynamic_noout``: bf16 out)
    opt_w = {kn: weights(*kn) for kn in OPT_KN}
    eva_w = {kn: weights(*kn) for kn in EVA_KN}
    for k, n in OPT_KN:
        b5(BLIP2_SLOTS_8BIT, k, n, *opt_w[(k, n)], True)
    for k, n in EVA_KN:
        b5(257, k, n, *eva_w[(k, n)], False)
    for k, n in OPT_KN:
        b6(BLIP2_GROUP_8BIT * bp, k, n, *opt_w[(k, n)], torch.bfloat16, True)
    for k, n in EVA_KN:
        b6(BLIP2_GROUP_8BIT * 257, k, n, *eva_w[(k, n)], torch.bfloat16,
           True)

    # ---- the 4bit slices of LLaVA and BLIP-2: B7 at group 128 ----
    # the decode step at 32 slots: Vicuna's and OPT's three products (their
    # 4096 -> 4096 once; K = 11008 is 43 chunks of 256 k); BLIP-2's
    # admissions of 4 x 92 rows; EVA's int4 tower (``quantize_vision``) at a
    # one-image prefill, m = 257 (the reference's), and at an admission of
    # 4, m = 1028 (B7's prefill form, K = 1408 = 22 stages of 64: fc1, the
    # largest; its other two products run the same form)
    dec_w4 = {kn: weights4(*kn, 128) for kn in dict.fromkeys(VICUNA_KN +
                                                               OPT_KN)}
    for kn, w4 in dec_w4.items():
        b7(SLOTS, *kn, w4, True)
    for kn in OPT_KN:
        b7(GROUP * bp, *kn, dec_w4[kn], True)
    eva_w4 = {kn: weights4(*kn, 128) for kn in EVA_KN}
    for kn, w4 in eva_w4.items():
        b7(257, *kn, w4, False)
    b7(GROUP * 257, *EVA_KN[1], eva_w4[EVA_KN[1]], True)
    # LLaVA's 4bit admissions of 4 x 641 rows: B7's prefill form
    for kn in VICUNA_KN:
        b7(GROUP * lp, *kn, dec_w4[kn], True)

    # ---- the sweep: configs/compare_models.yaml's MiviaPar prompt ----
    # 8 slots, admissions of 4, up to 16 new tokens, a bf16 tower and cache
    # in every row: each decoder's prefill of 4 prompts, the decode window
    # of 8 slots over prompt + 16 rows (with B3's write), B5 (8bit) and B7
    # (4bit) at the decode step's 8 rows, B6 at the 8bit admission's 4 x
    # prompt rows (the default int8 prefill: fp32 out)
    def sweep_window(slots, prompt, new):
        ac = torch.randint(0, new, (slots,), generator=gen, device=dev).int()
        gc = torch.randint(1, new + 1, (slots,), generator=gen,
                           device=dev).int()
        return (torch.tensor(prompt, **i32), new, ac, gc)

    for model, (h, kvh, d, causal, kns, w8, w4) in {
            "paligemma": (8, 1, 256, False, GEMMA_KN, gemma_w, gemma_w4),
            "llava": (32, 32, 128, True, VICUNA_KN, vicuna_w, dec_w4),
            "blip2": (32, 32, 128, True, OPT_KN, opt_w, dec_w4)}.items():
        sp = SWEEP_PROMPTS[model]
        dec = {"paligemma": "gemma", "llava": "vicuna", "blip2": "opt"}[model]
        b1(f"{dec}_prefill_g{SWEEP_GROUP}_h{h}_s{sp}_d{d}_kvlen",
           _bhsd(gen, SWEEP_GROUP, sp, h, d, dev),
           *(_bhsd(gen, SWEEP_GROUP, sp, kvh, d, dev) for _ in range(2)),
           on_path=True, causal=causal,
           kv_len=torch.full((SWEEP_GROUP,), sp, **i32))
        win = sweep_window(SWEEP_SLOTS, sp, SWEEP_NEW)
        qq = query(SWEEP_SLOTS, h, d)
        (kk, vv, _), _ = cache(SWEEP_SLOTS, sp + SWEEP_NEW, kvh, d)
        b2(f"{dec}_window_{SWEEP_SLOTS}slots_s{sp + SWEEP_NEW}", qq, kk, vv,
           dict(kv_window=win), True, {}, True)
        kr, vr = (torch.randn(SWEEP_SLOTS, 1, kvh, d, generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        b3_fused(f"{dec}_fused_window_{SWEEP_SLOTS}slots_s{sp + SWEEP_NEW}",
                 qq, (kk, vv), kr, vr, torch.full((1,), sp + 7, **i32), True,
                 dict(kv_window=win), True, True)
        for k, n in kns:
            b6(SWEEP_GROUP * sp, k, n, *w8[(k, n)], torch.float32, True)
    for kn, w in {**gemma_w, **vicuna_w, **opt_w}.items():
        b5(SWEEP_SLOTS, *kn, *w, True)
    for kn, w4 in {**gemma_w4, **dec_w4}.items():
        b7(SWEEP_SLOTS, *kn, w4, True)

    # ---- the wave and beam engines' prefills: one batch of images ----
    # (every prompt of one length, so kv_len is the prompt's in every row)
    def b4_patch(case, u8, rec):
        out.append(Case(
            "B4", case,
            functools.partial(normalize_images, u8, recipe=rec,
                              compute_dtype=torch.bfloat16, patch_size=14),
            functools.partial(normalize_plain, u8, rec, torch.bfloat16, 14),
            0.0, True, form="normalize", work=(0.0, 3.0 * u8.numel(), "bf16"),
            baseline_fn=lambda: unfold_patches(normalize_images(
                u8, recipe=rec, compute_dtype=torch.bfloat16), 14),
            library_note=b4_note))

    # PaliGemma-3B: the wave's 32 images (bf16) and the 8bit beams' 8
    for g in (WAVE_IMAGES, BEAM_IMAGES):
        b1(f"siglip_g{g}_h16_s256_d72", *(_bhsd(gen, g, 256, 16, 72, dev)
                                          for _ in range(3)), on_path=True)
        b1(f"gemma_prefill_g{g}_s316_kvlen", _bhsd(gen, g, PROMPT, 8, 256,
                                                   dev),
           *(_bhsd(gen, g, PROMPT, 1, 256, dev) for _ in range(2)),
           on_path=True, kv_len=torch.full((g,), PROMPT, **i32))
        b4_patch(f"patch14_u8_g{g}_224", torch.randint(
            0, 256, (g, 224, 224, 3), generator=gen, device=dev).to(
                torch.uint8), recipe)
    # the 8bit beams' int8 prefill: B6 on Gemma's products at 8 x 316 rows
    # (fp32 out, as the admission's) and the prompt rows into the int8 cache
    for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
        b6(BEAM_IMAGES * PROMPT, k, n, *gemma_w[(k, n)], torch.float32,
           True)
    k_pre, v_pre = (torch.randn(BEAM_IMAGES, PROMPT, 1, 256, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
    group8 = tuple((torch.zeros(BEAM_IMAGES, PROMPT, 1, 256,
                                dtype=torch.int8, device=dev),
                    torch.zeros(BEAM_IMAGES, PROMPT, 1, 1, device=dev))
                   for _ in range(2))
    b3_int8(f"int8_prefill_g{BEAM_IMAGES}_s316", k_pre, v_pre, group8,
            torch.zeros(1, **i32), True, True)
    # LLaVA-1.5-7B bf16: the beams' 8 images through CLIP-L/336 and
    # Vicuna's causal prefill
    b1(f"clip_l336_g{BEAM_IMAGES}_h16_s577_d64",
       *(_bhsd(gen, BEAM_IMAGES, 577, 16, 64, dev) for _ in range(3)),
       on_path=True)
    b1(f"vicuna_prefill_g{BEAM_IMAGES}_h32_s641_d128_kvlen",
       *(_bhsd(gen, BEAM_IMAGES, lp, 32, 128, dev) for _ in range(3)),
       on_path=True, causal=True,
       kv_len=torch.full((BEAM_IMAGES,), lp, **i32))
    b4_patch(f"patch14_u8_g{BEAM_IMAGES}_336", torch.randint(
        0, 256, (BEAM_IMAGES, 336, 336, 3), generator=gen, device=dev).to(
            torch.uint8), clip)

    # ---- the mesh phases: PaliGemma-3B at one rank's shard shapes ----
    # model=2: B1 at the tower's 8 heads and the prefill's 4 query heads
    # over the KV head, bf16 and (the fp32 depth-cut reference) fp32
    b1("tp_siglip_g4_h8_s256_d72", *(_bhsd(gen, GROUP, 256, 8, 72, dev)
                                     for _ in range(3)), on_path=True)
    b1("tp_gemma_prefill_g4_q4_s316_kvlen",
       _bhsd(gen, GROUP, PROMPT, 4, 256, dev),
       *(_bhsd(gen, GROUP, PROMPT, 1, 256, dev) for _ in range(2)),
       on_path=True, kv_len=torch.full((GROUP,), PROMPT, **i32))
    b1("fp32_tp_siglip_g4_h8_s256_d72", *(f32(GROUP, 256, 8, 72)
                                          for _ in range(3)), on_path=True)
    b1("fp32_tp_gemma_prefill_g4_q4_s316_kvlen", f32(GROUP, PROMPT, 4, 256),
       *(f32(GROUP, PROMPT, 1, 256) for _ in range(2)), on_path=True,
       kv_len=torch.full((GROUP,), PROMPT, **i32))

    # B2 with B3's write inside it over the rotating window: 4 query
    # heads over the KV head at 32 slots (model=2, bf16 and int8), 8 heads
    # at 16 slots (data=2, bf16)
    def mesh_window(slots):
        ac = torch.randint(0, MESH_NEW, (slots,), generator=gen,
                           device=dev).int()
        gc = torch.randint(1, MESH_NEW + 1, (slots,), generator=gen,
                           device=dev).int()
        gc[1] = 0                                     # a slot not admitted
        return (torch.tensor(PROMPT, **i32), MESH_NEW, ac, gc)

    mcol = torch.full((1,), PROMPT + 5, **i32)
    for tag, slots, heads, int8 in (("tp", MESH_SLOTS, 4, False),
                                    ("tp", MESH_SLOTS, 4, True),
                                    ("dp", MESH_SLOTS // 2, 8, False)):
        win = mesh_window(slots)
        qq = query(slots, heads, 256)
        (kk, vv, _), (kq8, vq8, sc8) = cache(slots, MESH_CACHE, 1, 256)
        kr, vr = (torch.randn(slots, 1, 1, 256, generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        caches, scales = ((kq8, vq8, sc8["k_scale"], sc8["v_scale"]), sc8) \
            if int8 else ((kk, vv), {})
        name = f"{tag}_{'int8_' if int8 else ''}window_{slots}slots_h{heads}"
        b2(name.replace("_int8", ""), qq, caches[0], caches[1],
           dict(kv_window=win), True, scales, True)
        b3_fused(name.replace("window", "fused_window"), qq, caches, kr, vr,
                 mcol, True, dict(kv_window=win), True, True)
    # the depth-cut references' decode steps: 4 rows at their own
    # positions (kv_len), 4 query heads over the KV head, each row's write
    # at its column: bf16, int8 (the 8bit reference) and fp32
    ref_len = PROMPT + MESH_REF_STEPS
    rstart = torch.full((GROUP,), PROMPT + 1, **i32)
    for dtype, int8 in ((torch.bfloat16, False), (torch.bfloat16, True),
                        (torch.float32, False)):
        qq = query(GROUP, 4, 256).to(dtype)
        (kk, vv, _), (kq8, vq8, sc8) = cache(GROUP, ref_len, 1, 256)
        kr, vr = (torch.randn(GROUP, 1, 1, 256, generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        caches = (kq8, vq8, sc8["k_scale"], sc8["v_scale"]) if int8 else \
            (kk.to(dtype), vv.to(dtype))
        tag = "int8_" if int8 else "fp32_" if dtype == torch.float32 else ""
        b3_fused(f"tp_ref_{tag}fused_scatter_kv_len_4rows_h4", qq, caches,
                 kr, vr, rstart, False,
                 dict(kv_len=(rstart + 1).int()), True)

    # B5 (decode, m = 32 slots), B6 (the admission's llm.int8 product,
    # m = 4 x 316, fp32 out) and B7 (4bit decode) at model=2's shard
    # shapes (k/v's whole products are the single-device cases above),
    # B5 and B7 with fp32 out at the row-parallel o and down (a rank's
    # partial, summed before its one rounding); no card phase serves 4bit
    # under a mesh (the CPU parity tests hold it), so B7's are not on a
    # path
    tp_w = {kn: weights(*kn) for kn in GEMMA_TP_KN if kn not in GEMMA_KN}
    for k, n in tp_w:
        f32 = torch.float32 if (k, n) in GEMMA_TP_ROW else torch.bfloat16
        b5(MESH_SLOTS, k, n, *tp_w[(k, n)], True, f32)
        b6(GROUP * PROMPT, k, n, *tp_w[(k, n)], torch.float32, True)
        b7(MESH_SLOTS, k, n, weights4(k, n, 128), False, f32)

    # ---- probing and the quantized tower under a mesh ----
    # B1's fp32 form at CLIP-L/336's steps of 16: 8 heads a rank
    # (model=2) and all 16 (data=2 at twice the rows, or one GPU)
    def clip32(h):
        return torch.randn(PMESH_BATCH, 577, h, 64, generator=gen,
                           device=dev).transpose(1, 2)
    b1("fp32_tp_clip_l336_g16_h8_s577_d64", *(clip32(8) for _ in range(3)),
       on_path=True)
    b1("fp32_clip_l336_g16_h16_s577_d64", *(clip32(16) for _ in range(3)),
       on_path=True)
    # SigLIP's int8 / int4 MLP split unevenly over model=2: fc1's 2144 or
    # 2160 output columns (bf16 out) and fc2's 2144 or 2160 inputs (a
    # rank's fp32 partial), B6 at a batch of 8 images' rows, B5 and B7 at
    # one image's
    for part in SIGLIP_TP_MLP:
        w_in, w_out = weights(1152, part), weights(part, 1152)
        b6(8 * 256, 1152, part, *w_in, torch.bfloat16, True)
        b6(8 * 256, part, 1152, *w_out, torch.float32, True)
        b5(256, 1152, part, *w_in, True)
        b5(256, part, 1152, *w_out, True, torch.float32)
        b7(256, 1152, part, weights4(1152, part, 128), True)
        b7(256, part, 1152, weights4(part, 1152, 16), True, torch.float32)
    return out


def _int4pack(q4: torch.Tensor, s4: torch.Tensor):
    """The port's int4 weights (q [N, K/2], element 2i in the low nibble,
    signed; fp32 scales [N, K/gs]) in ``torch._weight_int4pack_mm``'s
    form: unsigned nibbles (signed + 8, element 2i high) packed by
    ``torch._convert_weight_to_int4pack``, and bf16 (scale, zero 0) pairs
    [K/gs, N, 2], for which (u - 8) * scale is the same weight."""
    a = q4.to(torch.int32)
    lo, hi = ((a << 28) >> 28) + 8, (a >> 4) + 8
    u8 = ((lo << 4) | hi).to(torch.uint8)
    k = q4.shape[1] * 2
    inner = 8 if k % 256 == 0 else 4 if k % 128 == 0 else 2
    packed = torch._convert_weight_to_int4pack(u8, inner)
    sz = torch.stack((s4.to(torch.bfloat16), torch.zeros_like(
        s4, dtype=torch.bfloat16)), dim=-1).transpose(0, 1).contiguous()
    return packed, sz


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff = (a.float() - b.float()).abs()
    return float("inf") if not torch.isfinite(diff).all() else \
        float(diff.max())


# ~30 ms of GPU clock cycles: long enough for the host to queue 20 calls
# of at most ~1 ms of enqueue each behind it; the most :func:`_ms` sleeps
_SLEEP_CYCLES = 60_000_000
# the least it sleeps (~1 ms), the clock it assumes (a slower clock sleeps
# longer), and its margin over the host's measured enqueue time
_SLEEP_MIN_CYCLES = 2_000_000
_SLEEP_HZ = 2.0e9
_SLEEP_MARGIN = 4.0


def sleep_cycles(enqueue_s: float) -> int:
    """Cycles of the sleep kernel that keep the card waiting while the
    host queues ``enqueue_s`` seconds of calls, with a margin of
    ``_SLEEP_MARGIN``, between ``_SLEEP_MIN_CYCLES`` and
    ``_SLEEP_CYCLES``."""
    want = int(_SLEEP_MARGIN * enqueue_s * _SLEEP_HZ)
    return min(_SLEEP_CYCLES, max(_SLEEP_MIN_CYCLES, want))


def _ms(fn, iters: int, flush: Optional[torch.Tensor] = None) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls. The calls are queued
    behind a sleep kernel, so the card runs them back to back and the
    events time the device, not the host's enqueue (which bounds the small
    kernels' wrappers); the sleep is sized from the host time of the
    warm-up call (:func:`sleep_cycles`). With ``flush``, a buffer larger
    than the L2 cache is overwritten before each call, outside the timed
    span."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if flush is not None:
        flush.zero_()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(sleep_cycles(iters * enqueue_s))
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _profiled(run) -> Dict[str, float]:
    """Device µs of each kernel (by name, its own time) that ``run()``
    launches, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")}


def _device_ms(fn, iters: int, flush: Optional[torch.Tensor] = None,
               flush_kernels: frozenset = frozenset()) -> Optional[float]:
    """Mean device ms of ``fn``'s kernels a call, from the profiler: the sum
    of their own times, with no event floor (a few µs a call in
    :func:`_ms`) and no gap between launches. The flush's kernels
    (``flush_kernels``, by name) are left out. A session now and then
    records no kernel at all, so it is run up to three times; None if none
    saw a kernel."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
    for _ in range(3):
        us = sum(t for k, t in _profiled(calls).items()
                 if k not in flush_kernels)
        if us > 0:
            return us / iters / 1e3
    return None


def _paired_device_ms(fn, base, iters: int, flush, flush_kernels,
                      rounds: int = 5) -> Tuple[Optional[float],
                                                Optional[float]]:
    """:func:`_device_ms` of ``fn`` and of ``base`` in alternating rounds,
    the median of each: the difference of two short kernels, steady
    against a session that misses some kernels."""
    a, b = [], []
    for _ in range(rounds):
        a.append(_device_ms(fn, iters, flush, flush_kernels))
        b.append(_device_ms(base, iters, flush, flush_kernels))

    def median(xs):
        xs = sorted(x for x in xs if x is not None)
        return xs[len(xs) // 2] if xs else None
    return median(a), median(b)


def run(device="cuda", iters: int = 20,
        spent: Optional[Dict[str, float]] = None,
        kernels: Optional[Sequence[str]] = None) -> List[Dict]:
    """Compare and time every case; returns one record per case. Timing
    alternates plain, kernel, library, library, kernel, plain and averages
    each version. The library call is compared with the plain version once
    (``library_ok``; a disagreement is reported, not fatal: it is the
    yardstick, not the port). Kernel and library call are then profiled
    once more (``device_ms``, ``library_device_ms``: :func:`_device_ms`).
    The launch counters are reset at the end: launches made here do not
    count toward the serving path's. ``spent``, when given, receives the
    seconds spent building the cases' inputs, comparing, timing with
    events and profiling. ``kernels`` (e.g. ``("B6", "B7")``) keeps only
    those kernels' cases."""
    records = []
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush_kernels = frozenset(_profiled(flush.zero_))
    spent = {} if spent is None else spent
    spent.update(dict.fromkeys(("cases", "compare", "events", "profiler"),
                               0.0))
    t0 = time.perf_counter()
    built = [c for c in cases(device)
             if kernels is None or c.kernel in kernels]
    spent["cases"] = time.perf_counter() - t0
    for c in built:
        t0 = time.perf_counter()
        got = c.kernel_fn()
        want = c.plain_fn()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        tol = c.tol * (float(want.float().abs().max()) if c.rel else 1.0)
        exact_err = None
        if c.exact_fn is not None:
            exact_err = _max_err(c.kernel_fn(), c.exact_fn())
        lib_err = None
        if c.library_fn is not None and c.library_compare:
            res = c.library_fn()
            lib_err = _max_err(c.library_out(res) if c.library_out else res,
                               want)
        tk = c.time_kernel or c.kernel_fn
        tp = c.time_plain or c.plain_fn
        fl = flush if c.cold else None
        nan = float("nan")
        t1 = time.perf_counter()
        spent["compare"] += t1 - t0
        p1 = _ms(tp, iters, fl) if c.plain_timed else nan
        k1 = _ms(tk, iters, fl)
        lib_ms = None
        if c.library_fn is not None:
            lib_ms = (_ms(c.library_fn, iters, fl)
                      + _ms(c.library_fn, iters, fl)) / 2
        k2 = _ms(tk, iters, fl)
        p2 = _ms(tp, iters, fl) if c.plain_timed else nan
        t2 = time.perf_counter()
        spent["events"] += t2 - t1
        base_dev_ms = None
        if c.baseline_fn is None:
            dev_ms = _device_ms(tk, iters, fl, flush_kernels)
        else:
            dev_ms, base_dev_ms = _paired_device_ms(
                tk, c.baseline_fn, iters, fl, flush_kernels)
        lib_dev_ms = None if c.library_fn is None else _device_ms(
            c.library_fn, iters, fl, flush_kernels)
        spent["profiler"] += time.perf_counter() - t2
        form = c.form or KERNELS[c.kernel]["name"]
        ops, nbytes, peak = c.work
        b_ms, b_by = bound_ms(ops, nbytes, peak)
        records.append(dict(kernel=c.kernel, form=form, case=c.case,
                            on_path=c.on_path, max_abs_err=err, tol=c.tol,
                            rel=c.rel, ok=err <= tol and exact_err in (None,
                                                                      0.0),
                            exact_err=exact_err,
                            baseline_device_ms=base_dev_ms,
                            ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                            ops=ops, bytes=nbytes, peak=peak, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            device_ms=dev_ms, library_device_ms=lib_dev_ms,
                            library_err=lib_err,
                            library_ok=None if lib_err is None
                            else lib_err <= tol,
                            library_note=c.library_note))
    del flush
    _lib.reset_counts()
    return records


# the end-to-end probing step's attention: CLIP-L/336 (16 heads of 64 over
# 577 tokens) at the trainer's batch of 32 images
DIFF_SHAPE = (32, 16, 577, 64)
# the backward kernel's other cases (name, B, H, KV, Sq, Sk, D, causal):
# the probing mesh's data=2 ranks (16 images a rank, all 16 heads), the
# towers of the other models' probing (SigLIP, EVA), a causal MHA prefill
# of Vicuna's heads, and grouped heads (G = 2)
DIFF_BWD_CASES = (
    ("clip_l336_g16_h16_s577_d64", 16, 16, 16, 577, 577, 64, False),
    ("siglip_g32_h16_s256_d72", 32, 16, 16, 256, 256, 72, False),
    ("eva_g32_h16_s257_d88", 32, 16, 16, 257, 257, 88, False),
    ("causal_mha_g4_h32_s512_d128", 4, 32, 32, 512, 512, 128, True),
    ("gqa2_g16_h16_kv8_s577_d64", 16, 16, 8, 577, 577, 64, False),
)


def diff_work(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
              elem: int, peak: str, causal: bool = False
              ) -> Dict[str, Tuple[float, float, str]]:
    """B1-diff: the forward 4 d operations per (row, key) over the keys
    each row's result depends on (:func:`attention_work`), q, k, v read and
    o written; the backward 10 d (five products, the scores' recompute
    counted), q, k, v and the output's gradient read, dq, dk, dv
    written."""
    fwd = attention_work(b, h, kvh, sq, sk, d, causal, elem=elem, peak=peak)
    tq, tkv = float(elem * d * b * h * sq), float(elem * d * b * kvh * sk)
    bwd = (2.5 * fwd[0], 3 * tq + 4 * tkv, peak)
    return {"fwd": fwd, "bwd": bwd,
            "both": (fwd[0] + bwd[0], fwd[1] + bwd[1], peak)}


# a row's lse above this has a live key (a dead row's is -1e30)
NEG_LSE = -1e29


def _bwd_record(q, k, v, g, causal: bool, case: str, on_path: bool,
                iters: int) -> Dict:
    """The fp32 backward kernel (``flash_attention_diff_fp32_bwd``) on
    ``q, k, v`` (requiring a gradient) and the output gradient ``g``:
    dq, dk, dv within ``FP32_TOL`` x max against the recompute (autograd
    through :func:`attention_plain`) and against the kernel's formulation
    in float64 (``testing/attention_grad.py``, ``render_err``); a second
    backward bitwise the same (``exact_err``); the forward's lse against
    the plain one (``lse_err``; a row with no live key exactly -1e30).
    Times: the backward (``retain_graph`` over one forward), the
    recompute's forward and backward (``plain_ms``), SDPA's backward alone
    (``library_ms``) and its forward and backward (``library_both_ms``)."""
    from ..ops.attention import _flash_forward
    from .attention_grad import attention_backward, attention_lse
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qkv = (q, k, v)
    base = _lib.launches["flash_attention_diff_fp32_bwd"]
    out = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, qkv, g, retain_graph=True)
    again = torch.autograd.grad(out, qkv, g, retain_graph=True)
    launched = _lib.launches["flash_attention_diff_fp32_bwd"] - base
    exact_err = max(_max_err(a, c) for a, c in zip(got, again))

    def plain():
        return torch.autograd.grad(
            attention_plain(q, k, v, causal=causal), qkv, g)
    want = plain()
    scale = max(float(w.abs().max()) for w in want)
    err = max(_max_err(a, w) for a, w in zip(got, want))
    with torch.no_grad():
        qd, kd, vd = (t.detach() for t in qkv)
        o, lse = _flash_forward(qd, kd, vd, causal=causal, with_lse=True)
        ref = attention_lse(qd, kd, vd, causal=causal)
        live = ref > NEG_LSE
        lse_err = _max_err(lse[live], ref[live]) if bool(live.any()) \
            else 0.0
        dead_ok = bool((lse[~live] == -1e30).all())
        lse_tol = FP32_TOL * max(float(ref[live].abs().max()), 1.0) \
            if bool(live.any()) else 0.0
        render_err = max(_max_err(a, w) for a, w in zip(
            got, attention_backward(qd, kd, vd, o, lse, g, causal=causal)))
        del o, lse, ref
    gqa = h != kvh
    lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             enable_gqa=gqa)

    def library():
        torch.autograd.grad(lib_out, qkv, g, retain_graph=True)

    def library_both():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa), qkv, g)
    # SDPA puts a causal diagonal at the first key: only Sq = Sk agrees
    lib_err = max(_max_err(a, w) for a, w in zip(library_both(), want)) \
        if not causal or sq == sk else None
    del want
    torch.cuda.synchronize()

    def bwd():
        torch.autograd.grad(out, qkv, g, retain_graph=True)
    t = {}
    for name, fn in (("plain", plain), ("bwd", bwd), ("library", library),
                     ("library_both", library_both)):
        t[name] = _ms(fn, iters)
    for name, fn in (("library_both", library_both), ("library", library),
                     ("bwd", bwd), ("plain", plain)):
        t[name] = (t[name] + _ms(fn, iters)) / 2
    dev_ms = {name: _device_ms(fn, iters) for name, fn in
              (("bwd", bwd), ("library", library))}
    work = diff_work(b, h, kvh, sq, sk, d, 4, "fp32_3xtf32", causal)["bwd"]
    bound, bound_by = bound_ms(*work)
    ok = (err <= FP32_TOL * scale and render_err <= FP32_TOL * scale
          and exact_err == 0.0 and lse_err <= lse_tol and dead_ok
          and launched == 2)
    return dict(
        kernel="B1-diff", form="flash_attention_diff_fp32_bwd",
        case=case + "_bwd_fp32" + ("_causal" if causal else ""),
        on_path=on_path, max_abs_err=err, tol=FP32_TOL, rel=True, ok=ok,
        exact_err=exact_err, render_err=render_err, lse_err=lse_err,
        launches_checked=launched, baseline_device_ms=None, ms=t["bwd"],
        plain_ms=t["plain"], ops=work[0], bytes=work[1], peak=work[2],
        bound_ms=bound, bound_by=bound_by, library_ms=t["library"],
        device_ms=dev_ms["bwd"], library_device_ms=dev_ms["library"],
        library_err=lib_err, library_ok=lib_err is None
        or lib_err <= FP32_TOL * scale,
        library_note="scaled_dot_product_attention backward (its forward "
        "saved)", library_both_ms=t["library_both"])



def run_diff(device="cuda", iters: int = 10,
             shape: Tuple[int, int, int, int] = DIFF_SHAPE) -> List[Dict]:
    """B1's differentiable form against autograd through
    :func:`attention_plain` on the card, in fp32 (the probing path's form)
    and bf16, at ``shape`` [B, H, S, D] ([B, S, H, D] memory, as the tower
    passes it). The forward must equal the no-gradient call bitwise
    (``exact_err``: the fp32 form's forward also writes lse, which must
    leave o as it is); dq, dk, dv within ``FP32_TOL`` x max (fp32) or
    ``ATTN_TOL`` (bf16). Times: the forward, the backward (``retain_graph``
    over one forward) and both, with events and profiled; the plain
    version's and SDPA's forward + backward (SDPA timed only, never called
    by the port). Records carry :func:`run`'s keys (``ms`` and the bound
    for forward + backward) and ``fwd_*`` / ``bwd_*`` ones; the fp32 pass
    adds the backward kernel's own record (:func:`_bwd_record`, the
    ``flash_attention_diff_fp32_bwd`` form)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, h, sq, d = shape
    records = []
    for dtype, form in ((torch.float32, "flash_attention_diff_fp32"),
                        (torch.bfloat16, "flash_attention_diff")):
        fp32 = dtype == torch.float32
        q, k, v = (torch.randn(b, sq, h, d, generator=gen, device=dev)
                   .to(dtype).transpose(1, 2).requires_grad_()
                   for _ in range(3))
        g = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
        qkv = (q, k, v)

        def fwd():
            return flash_attention(q, k, v)

        def both(attend=flash_attention):
            return torch.autograd.grad(attend(q, k, v), qkv, g)

        out = fwd()
        exact_err = _max_err(out.detach(), flash_attention(
            q.detach(), k.detach(), v.detach()))
        got, want = both(), both(attention_plain)
        err = max(_max_err(a, w) for a, w in zip(got, want))
        scale = max(float(w.float().abs().max()) for w in want) if fp32 \
            else 1.0
        tol = FP32_TOL if fp32 else ATTN_TOL

        def library():
            return torch.autograd.grad(
                F.scaled_dot_product_attention(q, k, v), qkv, g)
        lib_err = max(_max_err(a, w) for a, w in zip(library(), want))
        del got, want
        torch.cuda.synchronize()

        def bwd():
            torch.autograd.grad(out, qkv, g, retain_graph=True)
        t = {}
        for name, fn in (("plain", lambda: both(attention_plain)),
                         ("fwd", fwd), ("bwd", bwd), ("both", both),
                         ("library", library)):
            t[name] = _ms(fn, iters)
        for name, fn in (("library", library), ("both", both),
                         ("bwd", bwd), ("fwd", fwd),
                         ("plain", lambda: both(attention_plain))):
            t[name] = (t[name] + _ms(fn, iters)) / 2
        dev_ms = {name: _device_ms(fn, iters) for name, fn in
                  (("fwd", fwd), ("bwd", bwd), ("both", both),
                   ("library", library))}
        work = diff_work(b, h, h, sq, sq, d, q.element_size(),
                         "fp32_3xtf32" if fp32 else "bf16")
        bounds = {k_: bound_ms(*w) for k_, w in work.items()}
        records.append(dict(
            kernel="B1-diff", form=form,
            case=f"clip_l336_g{b}_h{h}_s{sq}_d{d}_fwd_bwd"
            + ("_fp32" if fp32 else ""),
            on_path=fp32, max_abs_err=err, tol=tol, rel=fp32,
            ok=err <= tol * scale and exact_err == 0.0, exact_err=exact_err,
            baseline_device_ms=None, ms=t["both"], plain_ms=t["plain"],
            ops=work["both"][0], bytes=work["both"][1],
            peak=work["both"][2], bound_ms=bounds["both"][0],
            bound_by=bounds["both"][1], library_ms=t["library"],
            device_ms=dev_ms["both"], library_device_ms=dev_ms["library"],
            library_err=lib_err, library_ok=lib_err <= tol * scale,
            library_note="scaled_dot_product_attention forward + backward",
            fwd_ms=t["fwd"], bwd_ms=t["bwd"], fwd_device_ms=dev_ms["fwd"],
            bwd_device_ms=dev_ms["bwd"], fwd_bound_ms=bounds["fwd"][0],
            fwd_bound_by=bounds["fwd"][1], bwd_bound_ms=bounds["bwd"][0],
            bwd_bound_by=bounds["bwd"][1]))
        del out
        if fp32:
            records.append(_bwd_record(
                q, k, v, g, False, f"clip_l336_g{b}_h{h}_s{sq}_d{d}",
                shape == DIFF_SHAPE, iters))
        del q, k, v, g
        torch.cuda.empty_cache()
    _lib.reset_counts()
    return records


def run_diff_bwd(device="cuda", iters: int = 10,
                 cases=DIFF_BWD_CASES) -> List[Dict]:
    """The fp32 backward kernel's records (:func:`_bwd_record`) at
    ``cases`` (name, B, H, KV, Sq, Sk, D, causal), q/k/v as transposes of
    [B, S, H, D]."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    records = []
    for name, b, h, kvh, sq, sk, d, causal in cases:
        def bhsd(s, n):
            return torch.randn(b, s, n, d, generator=gen, device=dev
                               ).transpose(1, 2).requires_grad_()
        q, k, v = bhsd(sq, h), bhsd(sk, kvh), bhsd(sk, kvh)
        g = torch.randn(b, h, sq, d, generator=gen, device=dev)
        records.append(_bwd_record(q, k, v, g, causal, name, False, iters))
        del q, k, v, g
        torch.cuda.empty_cache()
    _lib.reset_counts()
    return records
