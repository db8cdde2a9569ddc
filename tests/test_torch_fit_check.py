"""The port's weights-fit check (``vlm_tpu_torch/models/vlm.py``:
``param_bytes``, ``check_hbm_fit``, ``device_memory_limit``) against
vlm_tpu's (``vlm_tpu/models/vlm.py``), on the CPU.

- ``param_bytes`` is the summed bytes of a built module's parameters and
  buffers, for every family and mode at the "test" size; at full size
  (on ``meta``, nothing allocated) it is vlm_tpu's, but for one leaf the
  port stores by design and vlm_tpu computes on the fly: the decoder's
  RoPE tables ``decoder.rope_cos`` / ``decoder.rope_sin`` (fp32,
  ``max_position`` x head_dim / 2 each; BLIP-2's OPT has learned
  positions and no table).
- With the device limit and the byte count patched to the same values on
  both sides, the check refuses exactly where vlm_tpu's does, with the
  same sizes in its message; ``VLM_TPU_SKIP_FIT_CHECK=1`` skips it; the
  CPU has no limit; a refused build has allocated nothing.
"""

import jax.numpy as jnp
import pytest
import torch

from vlm_tpu.models import vlm as jvlm
from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS
from vlm_tpu_torch.models import base_model
from vlm_tpu_torch.models import vlm as tvlm
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.factory import create_model

FULL = {"paligemma": "3b", "llava": "7b", "blip2": "6.7b"}
# (mode, quantize_vision): the compute dtype and the integer bits
MODES = [("fp32", False), ("bf16", False), ("8bit", False), ("8bit", True),
         ("4bit", False), ("4bit", True)]
BITS = {"8bit": 8, "4bit": 4}


def _quant(mode, qv):
    bits = BITS.get(mode, 0)
    return dict(dtype=torch.float32 if mode == "fp32" else torch.bfloat16,
                quant_bits=bits, vision_quant_bits=bits if qv else 0)


def _jax_bytes(family, size, mode, qv):
    cfg = JAX_CONFIGS[family](size)
    q = _quant(mode, qv)
    dt = jnp.float32 if mode == "fp32" else jnp.bfloat16
    mod = jvlm.VLMModule(cfg, dtype=dt, param_dtype=dt,
                         quant_bits=q["quant_bits"],
                         vision_quant_bits=q["vision_quant_bits"])
    return jvlm.param_bytes(mod, cfg)


def _rope_bytes(cfg):
    dec = cfg.decoder
    if dec.pos != "rope":
        return 0
    return 2 * dec.max_position * (dec.head_dim // 2) * 4


@pytest.mark.parametrize("family", ["paligemma", "llava", "blip2"])
@pytest.mark.parametrize("mode,qv", MODES,
                         ids=[f"{m}{'_qv' if v else ''}" for m, v in MODES])
def test_param_bytes_is_the_built_state_and_vlm_tpus(family, mode, qv):
    """"test" size: the bytes of the module built on the CPU, every
    parameter and buffer at its dtype (int8 tables, packed int4 bytes and
    fp32 scales included); vlm_tpu's count plus the RoPE tables."""
    cfg = VLM_CONFIGS[family]("test")
    q = _quant(mode, qv)
    built = tvlm.VLMModule(cfg, device="cpu", **q)
    # the module's tensors: its parameters, and its buffers (the RoPE
    # tables are not in the state dict)
    state = [*built.parameters(), *built.buffers()]
    got = tvlm.param_bytes(cfg, **q)
    assert got == sum(t.numel() * t.element_size() for t in state)
    assert {t.dtype for t in state} <= {q["dtype"], torch.float32,
                                        torch.int8}
    assert got - _jax_bytes(family, "test", mode, qv) == _rope_bytes(cfg)


FULL_MODES = [("bf16", False), ("8bit", True), ("4bit", True)]


@pytest.mark.parametrize("family", ["paligemma", "llava", "blip2"])
@pytest.mark.parametrize("mode,qv", FULL_MODES,
                         ids=[f"{m}{'_qv' if v else ''}"
                              for m, v in FULL_MODES])
def test_param_bytes_at_full_size_is_vlm_tpus(family, mode, qv):
    """Full size on ``meta``: vlm_tpu's count, and the RoPE tables
    (PaliGemma 8,388,608 bytes: 2 x 8192 x 128 x 4; LLaVA 2,097,152:
    2 x 4096 x 64 x 4; BLIP-2 none)."""
    size = FULL[family]
    cfg = VLM_CONFIGS[family](size)
    diff = tvlm.param_bytes(cfg, **_quant(mode, qv)) - \
        _jax_bytes(family, size, mode, qv)
    assert diff == _rope_bytes(cfg) == {"paligemma": 8388608,
                                        "llava": 2097152,
                                        "blip2": 0}[family]


GiB = 2 ** 30
# (weights' bytes, the device's limit): at, over and under the limit, and
# LLaVA-7B's fp32 weights against a few limits
DECISIONS = [(10 * GiB, 10 * GiB), (10 * GiB + 1, 10 * GiB),
             (10 * GiB - 1, 10 * GiB), (30 * GiB, 80 * GiB),
             (81 * GiB, 80 * GiB), (28253708288, 14 * GiB),
             (28253708288, 26 * GiB), (28253708288, 27 * GiB)]


@pytest.mark.parametrize("ways", [1, 2])
@pytest.mark.parametrize("total,limit", DECISIONS)
def test_check_refuses_exactly_where_vlm_tpu_does(monkeypatch, total, limit,
                                                  ways):
    """vlm_tpu with a model axis of 1 and of 2 (a rank's bytes: here the
    total over the ways, as vlm_tpu divides it)."""
    cfg = VLM_CONFIGS["llava"]("test")
    monkeypatch.setattr(jvlm, "_device_hbm_limit", lambda: limit)
    monkeypatch.setattr(jvlm, "param_bytes", lambda m, c: total)
    monkeypatch.setattr(tvlm, "device_memory_limit", lambda d: limit)
    monkeypatch.setattr(tvlm, "param_bytes",
                        lambda c, model_ways=1, **kw: total // model_ways)
    jerr = terr = None
    try:
        jvlm.check_hbm_fit(None, JAX_CONFIGS["llava"]("test"),
                           model_ways=ways)
    except ValueError as e:
        jerr = str(e)
    try:
        tvlm.check_hbm_fit(cfg, "cuda", model_ways=ways)
    except ValueError as e:
        terr = str(e)
    assert (jerr is None) == (terr is None)
    if terr is not None:
        # the same sizes, and the same advice: quantize, or shard
        sizes = [f"{total / GiB:.1f} GiB", f"{limit / GiB:.1f} GiB"]
        assert all(s in jerr and s in terr for s in sizes)
        advice = jerr[jerr.index("`mesh: {"):].split("`")[1]
        assert "quantization: 8bit" in terr and f"`{advice}`" in terr


def test_skip_env_and_the_cpu_have_no_check(monkeypatch):
    cfg = VLM_CONFIGS["paligemma"]("test")
    assert tvlm.device_memory_limit("cpu") is None
    tvlm.check_hbm_fit(cfg, "cpu")                    # no limit: no check
    monkeypatch.setattr(tvlm, "device_memory_limit", lambda d: 1)
    with pytest.raises(ValueError, match="exceed the device's memory"):
        tvlm.check_hbm_fit(cfg, "cpu")
    monkeypatch.setenv("VLM_TPU_SKIP_FIT_CHECK", "1")
    tvlm.check_hbm_fit(cfg, "cpu")


def test_refused_build_allocates_nothing(monkeypatch):
    """``create_model`` checks before it builds: with a limit under the
    weights, it raises the fit error and never constructs the module
    (its constructor, patched to fail, is not reached)."""
    built = []

    def never(*a, **kw):
        built.append(kw.get("device"))
        raise AssertionError("the module was built")
    monkeypatch.setattr(tvlm, "device_memory_limit", lambda d: 1024)
    monkeypatch.setattr(base_model, "VLMModule", never)
    with pytest.raises(ValueError, match="Model weights"):
        create_model("blip2", size="test", device="cpu", quantization="4bit")
    assert built == []
    monkeypatch.delenv("VLM_TPU_SKIP_FIT_CHECK", raising=False)
    monkeypatch.setattr(tvlm, "device_memory_limit",
                        lambda d: tvlm.param_bytes(
                            VLM_CONFIGS["blip2"]("test"),
                            dtype=torch.bfloat16, quant_bits=4))
    with pytest.raises(AssertionError, match="the module was built"):
        create_model("blip2", size="test", device="cpu", quantization="4bit")
    assert built == [torch.device("cpu")]
