"""Each CUDA kernel against its plain PyTorch version, on the card, at the
shapes the PaliGemma-3B serving path gives it (32 slots, 224 px images,
prompt length 316, 32 new tokens, admission groups of 4), plus small cases
for the mask modes the path does not reach.

Used by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``. Attention
outputs are bf16 and both versions accumulate in fp32 from the same bf16
inputs, but round at other places: the plain version rounds the normalised
probabilities to bf16 before the P.V product (as the JAX reference does),
B1 rounds the unnormalised ones (its tensor-core operands), B2 keeps them in
fp32. So they agree within ``ATTN_TOL``, a few bf16 ulps at 1. The KV
write must be bitwise; normalisation within one bf16 ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..ops import _lib
from ..ops.attention import attention_plain, flash_attention
from ..ops.decode_attention import decode_attention, decode_attention_plain
from ..ops.kvcache import kv_masked_write, kv_scatter_write, kv_uniform_write
from ..ops.preprocess import RECIPES, normalize_images, normalize_plain

ATTN_TOL = 2e-2
NORM_TOL = 2.0 ** -7

KERNELS = {
    "B1": dict(name="flash_attention", source="vlm_tpu_torch/csrc/flash_attention.cu",
               replaces="vlm_tpu/ops/attention.py:112"),
    "B2": dict(name="decode_attention", source="vlm_tpu_torch/csrc/decode_attention.cu",
               replaces="vlm_tpu/ops/decode_attention.py:72"),
    "B3": dict(name="kv_write", source="vlm_tpu_torch/csrc/kv_write.cu",
               replaces="vlm_tpu/ops/kvcache.py:34"),
    "B4": dict(name="normalize", source="vlm_tpu_torch/csrc/normalize.cu",
               replaces="vlm_tpu/ops/preprocess.py:119"),
}

# the serving path's shapes (PaliGemma-3B)
SLOTS, PROMPT, NEW, GROUP = 32, 316, 32, 4
CACHE = PROMPT + NEW


@dataclasses.dataclass
class Case:
    kernel: str                 # B1..B4
    case: str
    kernel_fn: Callable[[], torch.Tensor]
    plain_fn: Callable[[], torch.Tensor]
    tol: float
    on_path: bool               # the serving path's own shape
    # what to time, where it differs from the compared call
    time_kernel: Optional[Callable[[], object]] = None
    time_plain: Optional[Callable[[], object]] = None


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
        out.append(Case("B1", case, lambda: flash_attention(q, k, v, **kw),
                        lambda: attention_plain(q, k, v, **kw), ATTN_TOL,
                        on_path))

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

    # decode attention over the 32-slot cache
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
    for case, kw, on_path in (
            ("window_32slots", dict(kv_window=(pcol, NEW, acol, gcnt)), True),
            ("kv_len_32slots", dict(kv_len=kv_len), False),
            ("kv_valid_32slots", dict(kv_valid=valid), False)):
        out.append(Case("B2", case,
                        lambda kw=kw: decode_attention(q, kc, vc, **kw),
                        lambda kw=kw: decode_attention_plain(q, kc, vc, **kw),
                        ATTN_TOL, on_path))

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
        ck, cv = kc.clone(), vc.clone()
        out.append(Case(
            "B3", case, kernel, plain, 0.0, on_path,
            time_kernel=lambda: writer(ck, cv, k_new, v_new, start),
            time_plain=lambda: (kv_masked_write(ck, k_new, start),
                                kv_masked_write(cv, v_new, start))))

    b3("uniform_32slots", kv_uniform_write, wcol, True)
    b3("scatter_32slots", kv_scatter_write, per_slot, False)

    u8 = torch.randint(0, 256, (GROUP, 224, 224, 3), generator=gen,
                       device=dev).to(torch.uint8)
    recipe = RECIPES["paligemma"]
    out.append(Case("B4", "u8_g4_224",
                    lambda: normalize_images(u8, recipe=recipe),
                    lambda: normalize_plain(u8, recipe), NORM_TOL, True))
    return out


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff = (a.float() - b.float()).abs()
    return float("inf") if not torch.isfinite(diff).all() else \
        float(diff.max())


def _ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(device="cuda", iters: int = 20) -> List[Dict]:
    """Compare and time every case; returns one record per case. Timing
    alternates plain, kernel, kernel, plain and averages each version.
    The launch counters are reset at the end: launches made here do not
    count toward the serving path's."""
    records = []
    for c in cases(device):
        got = c.kernel_fn()
        want = c.plain_fn()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        tk = c.time_kernel or c.kernel_fn
        tp = c.time_plain or c.plain_fn
        p1 = _ms(tp, iters)
        k1 = _ms(tk, iters)
        k2 = _ms(tk, iters)
        p2 = _ms(tp, iters)
        records.append(dict(kernel=c.kernel, case=c.case, on_path=c.on_path,
                            max_abs_err=err, tol=c.tol, ok=err <= c.tol,
                            ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2))
    _lib.reset_counts()
    return records
