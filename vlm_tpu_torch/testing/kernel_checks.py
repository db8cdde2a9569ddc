"""Each CUDA kernel against its plain PyTorch version, on the card, at the
shapes the PaliGemma-3B serving paths give it (32 slots, 224 px images,
prompt length 316, 32 new tokens, admission groups of 4; bf16, 8bit with
the int8 KV cache, and 4bit), plus cases for the mask modes and shapes the
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
(values and scales); normalisation within one bf16 ulp.

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..ops import _lib
from ..ops.attention import attention_plain, flash_attention
from ..ops.decode_attention import decode_attention, decode_attention_plain
from ..ops.kvcache import (kv_masked_write, kv_quantized_write,
                           kv_quantized_write_plain, kv_scatter_write,
                           kv_uniform_write)
from ..ops.preprocess import RECIPES, normalize_images, normalize_plain
from ..ops.quant import (int4_matmul, int4_matmul_plain, int8_matmul,
                         int8_matmul_plain, int8xint8_matmul,
                         int8xint8_matmul_plain, quantize_activations)

ATTN_TOL = 2e-2
NORM_TOL = 2.0 ** -7
GEMM_REL_TOL = 2.0 ** -7

# "forms": the launch counter of each form of the kernel (_lib.KERNELS)
KERNELS = {
    "B1": dict(name="flash_attention", source="vlm_tpu_torch/csrc/flash_attention.cu",
               replaces="vlm_tpu/ops/attention.py:112",
               forms=("flash_attention",)),
    "B2": dict(name="decode_attention", source="vlm_tpu_torch/csrc/decode_attention.cu",
               replaces="vlm_tpu/ops/decode_attention.py:72",
               forms=("decode_attention", "decode_attention_int8")),
    "B3": dict(name="kv_write", source="vlm_tpu_torch/csrc/kv_write.cu",
               replaces="vlm_tpu/ops/kvcache.py:34",
               forms=("kv_write", "kv_write_int8")),
    "B4": dict(name="normalize", source="vlm_tpu_torch/csrc/normalize.cu",
               replaces="vlm_tpu/ops/preprocess.py:119",
               forms=("normalize",)),
    "B5": dict(name="int8_matmul", source="vlm_tpu_torch/csrc/int8_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:252",
               forms=("int8_matmul",)),
    "B6": dict(name="int8xint8_matmul",
               source="vlm_tpu_torch/csrc/int8xint8_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:110",
               forms=("int8xint8_matmul",)),
    "B7": dict(name="int4_matmul", source="vlm_tpu_torch/csrc/int4_matmul.cu",
               replaces="vlm_tpu/ops/quant.py:300",
               forms=("int4_matmul",)),
}
# Gemma-2B block products (K, N): q/o, k/v, gate/up, down; SigLIP fc1/fc2
GEMMA_KN = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
SIGLIP_KN = ((1152, 4304), (4304, 1152))

# the serving path's shapes (PaliGemma-3B)
SLOTS, PROMPT, NEW, GROUP = 32, 316, 32, 4
CACHE = PROMPT + NEW


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
        form = "decode_attention_int8" if scales else "decode_attention"
        kw = dict(kw, **scales)
        name = case + ("_int8" if scales else "") + ("_cold" if cold else "")
        out.append(Case(
            "B2", name,
            lambda: decode_attention(q, kk, vv, **kw),
            lambda: decode_attention_plain(q, kk, vv, **kw),
            ATTN_TOL, on_path, form=form, cold=cold))

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

    # int8 form: quantize and write values and scales, bitwise
    def b3_int8(case, k_rows, v_rows, cache, start, uniform, on_path):
        def write(fn, caches):
            fn(caches[0], caches[1], k_rows, v_rows, start, uniform)
            return torch.cat([t.float().flatten() for c in caches for t in c])

        def fresh():
            return tuple(tuple(t.clone() for t in c) for c in cache)
        mine = fresh()
        out.append(Case(
            "B3", case, lambda: write(kv_quantized_write, fresh()),
            lambda: write(kv_quantized_write_plain, fresh()), 0.0, on_path,
            time_kernel=lambda: kv_quantized_write(
                mine[0], mine[1], k_rows, v_rows, start, uniform),
            time_plain=lambda: kv_quantized_write_plain(
                mine[0], mine[1], k_rows, v_rows, start, uniform),
            form="kv_write_int8"))

    cache8 = ((kq, ks), (vq, vs))
    b3_int8("int8_uniform_32slots", k_new, v_new, cache8, wcol, True, True)
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

    u8 = torch.randint(0, 256, (GROUP, 224, 224, 3), generator=gen,
                       device=dev).to(torch.uint8)
    recipe = RECIPES["paligemma"]
    out.append(Case("B4", "u8_g4_224",
                    lambda: normalize_images(u8, recipe=recipe),
                    lambda: normalize_plain(u8, recipe), NORM_TOL, True))

    # B5: the weight-only int8 products of the 8bit decode step (m = 32
    # slots) and of a one-image admission (m = 316)
    def weights(k, n):
        qw = torch.randint(-127, 128, (n, k), generator=gen, device=dev).to(
            torch.int8)
        sw = torch.rand(n, generator=gen, device=dev) * (2 / k ** 0.5 / 64)
        return qw, sw

    gemma_w = {kn: weights(*kn) for kn in GEMMA_KN}
    for m in (SLOTS, PROMPT):
        # gate/up first: the main case of the JSON line
        for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            qw, sw = gemma_w[(k, n)]
            out.append(Case(
                "B5", f"m{m}_k{k}_n{n}",
                lambda x=x, qw=qw, sw=sw: int8_matmul(x, qw, sw),
                lambda x=x, qw=qw, sw=sw: int8_matmul_plain(x, qw, sw),
                GEMM_REL_TOL, True, rel=True, cold=True))

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
        out.append(Case(
            "B6", f"m{m}_k{k}_n{n}_{tag}",
            lambda: int8xint8_matmul(qx, sx, qw, sw, out_dtype),
            lambda: int8xint8_matmul_plain(
                *(t if card else t.cpu() for t in (qx, sx, qw, sw)),
                out_dtype).to(dev),
            0.0 if exact else GEMM_REL_TOL / 2, on_path, rel=not exact,
            cold=True, plain_timed=card))

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

    def b7(m, k, n, w4, on_path):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        out.append(Case(
            "B7", f"m{m}_k{k}_n{n}_gs{w4[2]}",
            lambda: int4_matmul(x, *w4), lambda: int4_matmul_plain(x, *w4),
            GEMM_REL_TOL, on_path, rel=True, cold=True))

    gemma_w4 = {kn: weights4(*kn, 128) for kn in GEMMA_KN}
    # the 4bit decode step (m = 32 slots) first, gate/up its main case; a
    # one-image admission (m = 316); one row
    for m, on_path in ((SLOTS, True), (PROMPT, False), (1, False)):
        for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
            b7(m, k, n, gemma_w4[(k, n)], on_path)
    # the int4 tower of one image (m = 256): fc1 at group 128, fc2 at group
    # 16 with 2152-byte packed rows and a ragged K tail (4304 = 64 * 67 + 16)
    b7(256, 1152, 4304, weights4(1152, 4304, 128), False)
    b7(256, 4304, 1152, weights4(4304, 1152, 16), False)
    b7(9, 128, 100, weights4(128, 100, 32), False)   # JAX's padding test
    # an admission of 4 (m = 1264) runs the dequantized product; B7 here
    # is timed against it for a later dispatch decision
    for k, n in sorted(GEMMA_KN, key=lambda kn: -kn[1]):
        b7(GROUP * PROMPT, k, n, gemma_w4[(k, n)], False)
    return out


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff = (a.float() - b.float()).abs()
    return float("inf") if not torch.isfinite(diff).all() else \
        float(diff.max())


# ~0.1 s of GPU clock cycles: long enough for the host to queue every
# timed call behind it
_SLEEP_CYCLES = 200_000_000


def _ms(fn, iters: int, flush: Optional[torch.Tensor] = None) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls. The calls are queued
    behind a sleep kernel, so the card runs them back to back and the
    events time the device, not the host's enqueue (which bounds the small
    kernels' wrappers). With ``flush``, a buffer larger than the L2 cache
    is overwritten before each call, outside the timed span."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(_SLEEP_CYCLES)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def run(device="cuda", iters: int = 20) -> List[Dict]:
    """Compare and time every case; returns one record per case. Timing
    alternates plain, kernel, kernel, plain and averages each version.
    The launch counters are reset at the end: launches made here do not
    count toward the serving path's."""
    records = []
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    for c in cases(device):
        got = c.kernel_fn()
        want = c.plain_fn()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        bound = c.tol * (float(want.float().abs().max()) if c.rel else 1.0)
        tk = c.time_kernel or c.kernel_fn
        tp = c.time_plain or c.plain_fn
        fl = flush if c.cold else None
        nan = float("nan")
        p1 = _ms(tp, iters, fl) if c.plain_timed else nan
        k1 = _ms(tk, iters, fl)
        k2 = _ms(tk, iters, fl)
        p2 = _ms(tp, iters, fl) if c.plain_timed else nan
        form = c.form or KERNELS[c.kernel]["name"]
        records.append(dict(kernel=c.kernel, form=form, case=c.case,
                            on_path=c.on_path, max_abs_err=err, tol=c.tol,
                            rel=c.rel, ok=err <= bound,
                            ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2))
    del flush
    _lib.reset_counts()
    return records
