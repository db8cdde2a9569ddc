"""The work and bound arithmetic of ``vlm_tpu_torch.testing.kernel_checks``
on the CPU: operations and bytes computed from shapes, and the least time
the card could take, at the serving shapes of PaliGemma-3B."""

import pytest

from vlm_tpu_torch.testing import kernel_checks as kc

# (name, work, operations, bytes, bound ms, bound kind)
CASES = [
    # SigLIP: 4 images x 16 heads x 256 x 256 keys x 72; q, k, v, o bf16
    ("b1_siglip", kc.attention_work(4, 16, 16, 256, 256, 72),
     1_207_959_552, 9_437_184, 2.817e-3, "bytes"),
    # Gemma prefill, MQA 8:1, kv_len [316, 290, 316, 0]: the dead row's
    # mean of V counts all 316 keys
    ("b1_gemma_kvlen", kc.attention_work(4, 8, 1, 316, 316, 256,
                                         kv_len=[316, 290, 316, 0]),
     4 * 256 * 8 * 316 * (316 + 290 + 316 + 316), 11_649_024, 3.477e-3,
     "bytes"),
    # B1's fp32 form at SigLIP and at the Gemma prefill: fp32 operands,
    # three TF32 products a product, so bound by operations at 494.7 / 3
    # TFLOP/s (7.3 and 19.4 us)
    ("b1_fp32_siglip", kc.attention_work(4, 16, 16, 256, 256, 72, elem=4,
                                         peak="fp32_3xtf32"),
     1_207_959_552, 18_874_368, 7.325e-3, "operations"),
    ("b1_fp32_gemma_kvlen", kc.attention_work(
        4, 8, 1, 316, 316, 256, kv_len=[316, 290, 316, 0], elem=4,
        peak="fp32_3xtf32"),
     4 * 256 * 8 * 316 * (316 + 290 + 316 + 316), 23_298_048, 1.9435e-2,
     "operations"),
    # causal, Sq = 2 < Sk = 4: rows see 3 and 4 keys
    ("b1_causal", kc.attention_work(1, 1, 1, 2, 4, 8, causal=True),
     4 * 8 * (3 + 4), 2 * 8 * (2 * 2 + 2 * 4), None, "bytes"),
    # B6 gate/up at an admission of 4: 2 m k n int8 operations
    ("b6_gate_up", kc.gemm_work(1264, 2048, 16384, 1264 * 2048,
                                16384 * 2048, 4 * (1264 + 16384), 4, "int8"),
     2 * 1264 * 2048 * 16384,
     1264 * 2048 + 16384 * 2048 + 4 * (1264 + 16384) + 4 * 1264 * 16384,
     4.286e-2, "operations"),
    # B2 bf16 over 2 slots with 3 and 0 live rows, 8 heads, 1 KV head
    ("b2_decode", kc.decode_work(8, 1, 256, [3, 0], 2, False),
     4 * 256 * 8 * 3, 2 * 2 * 2 * 8 * 256 + 2 * 3 * 256 * 2, None, "bytes"),
]


@pytest.mark.parametrize("name,work,ops,nbytes,ms,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_work_and_bound(name, work, ops, nbytes, ms, kind):
    assert work[0] == ops and work[1] == nbytes
    got_ms, got_kind = kc.bound_ms(*work)
    assert got_kind == kind
    if ms is not None:
        assert got_ms == pytest.approx(ms, rel=1e-3)
    rate = kc.HBM_BYTES_PER_S if kind == "bytes" else \
        kc.PEAK_OPS_PER_S[work[2]]
    assert got_ms == pytest.approx(
        (nbytes if kind == "bytes" else ops) / rate * 1e3)


@pytest.mark.parametrize("enqueue_s,cycles", [
    (0.0, kc._SLEEP_MIN_CYCLES),           # a floor of ~1 ms
    (20 * 10e-6, kc._SLEEP_MIN_CYCLES),    # 20 calls of 10 us: under it
    (20 * 100e-6, 16_000_000),             # 2 ms of enqueue: 4 x 2 ms
    (20 * 2e-3, kc._SLEEP_CYCLES),         # 40 ms: capped at ~30 ms
])
def test_sleep_covers_the_enqueue_with_its_margin(enqueue_s, cycles):
    assert kc.sleep_cycles(enqueue_s) == cycles
