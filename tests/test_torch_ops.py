"""Port ops against vlm_tpu on the CPU: each kernel's plain PyTorch version
(what the port's wrappers run for CPU tensors) against the JAX reference
and the Pallas kernel it replaces, run in interpret mode as the JAX
package's own tests run it.

Inputs are fp32 from numpy seeds; tolerance atol = rtol = 1e-5 unless a
test states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vlm_tpu.ops.attention import _flash_attention, _xla_attention
from vlm_tpu.ops.decode_attention import flash_decode_attention
from vlm_tpu.ops.kvcache import kv_scatter_write as j_scatter
from vlm_tpu.ops.kvcache import kv_uniform_write as j_uniform
from vlm_tpu.ops.preprocess import RECIPES as J_RECIPES
from vlm_tpu.ops.preprocess import _normalize_jnp, _normalize_pallas
from vlm_tpu.ops.preprocess import host_resize as j_host_resize
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.attention import attention_plain, flash_attention
from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                decode_attention_plain)
from vlm_tpu_torch.ops.kvcache import kv_scatter_write, kv_uniform_write
from vlm_tpu_torch.ops.preprocess import (RECIPES, host_resize,
                                          normalize_images, normalize_plain)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


# ------------------------------- B1 -------------------------------

# (name, causal, sq, sk, kv_len, prefix_len): every mask mode of
# _flash_kernel, including a fully masked row (kv_len 0 -> mean of V)
B1_MODES = [
    ("none", False, 24, 24, None, None),
    ("kv_len", False, 24, 24, [17, 0], None),
    ("causal", True, 24, 24, None, None),
    ("causal_offset", True, 9, 24, None, None),
    ("prefix", True, 24, 24, None, [10, 3]),
    ("prefix_kv_len", True, 24, 24, [20, 24], [10, 3]),
]


@pytest.mark.parametrize("d,h,kvh", [(72, 4, 4), (256, 4, 1)],
                         ids=["d72_mha", "d256_mqa"])
@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_plain_matches_xla_and_flash(mode, d, h, kvh):
    _, causal, sq, sk, kv_len, prefix_len = mode
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, kvh, sk, d)).astype(np.float32)
    v = rng.normal(size=(2, kvh, sk, d)).astype(np.float32)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    pfx = None if prefix_len is None else np.asarray(prefix_len, np.int32)
    jarg = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    targ = lambda a: None if a is None else _t(a)  # noqa: E731

    port = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=targ(kvl), prefix_len=targ(pfx))
    xla = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, scale=d ** -0.5, kv_len=jarg(kvl),
                         prefix_len=jarg(pfx))
    flash = _flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jarg(kvl), jarg(pfx), causal=causal, heads=h)
    _close(port, xla)
    _close(port, flash)


def test_b1_plain_bshd_and_kv_valid():
    """The cache layout and an arbitrary key mask, against _xla_attention."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, 3, 32)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 32)).astype(np.float32)
    valid = rng.random((2, 20)) < 0.6
    port = attention_plain(_t(q), _t(k), _t(v), kv_valid=_t(valid),
                           kv_layout="bshd")
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, scale=32 ** -0.5,
                         kv_valid=jnp.asarray(valid), kv_layout="bshd")
    _close(port, ref)


def test_b1_wrapper_takes_plain_only_on_cpu():
    _lib.reset_counts()
    x = torch.zeros(1, 2, 4, 8)
    flash_attention(x, x, x)
    assert _lib.plain_calls["flash_attention_fp32"] == 1   # fp32 inputs
    assert _lib.launches["flash_attention_fp32"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))


# ------------------------------- B2 -------------------------------

B, S, W, PCOL = 4, 40, 8, 30


def _decode_inputs(d, h=8, kvh=1, seed=2):
    """bf16-representable fp32 inputs: vlm_tpu's decode kernel casts q
    (scaled by d**-0.5, a power of two here) and the cache to bf16, so only
    its bf16 rounding of the probabilities differs from fp32 math."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()
    return (bf16((B, h, 1, d)), bf16((B, S, kvh, d)), bf16((B, S, kvh, d)))


def _window():
    acol = np.asarray([0, 3, 7, 5], np.int32)
    gcnt = np.asarray([1, 8, 0, 4], np.int32)
    return acol, gcnt


def _window_valid(acol, gcnt):
    """The batcher's valid_key construction (vlm_tpu batcher.py:338-352)."""
    cols = np.arange(S)[None, :]
    j = np.mod(cols - PCOL - acol[:, None], W)
    key = np.where(cols < PCOL, -1, np.where(cols < PCOL + W, j, W))
    return key < gcnt[:, None]


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid"])
def test_b2_plain_matches_xla_and_decode_kernel(mode, d):
    q, k, v = _decode_inputs(d)
    acol, gcnt = _window()
    kv_len = np.asarray([S, 17, 0, 33], np.int32)
    valid = np.random.default_rng(3).random((B, S)) < 0.5
    valid[2] = False                                   # fully masked row
    targs, jargs = {}, {}
    if mode == "window":
        valid = _window_valid(acol, gcnt)
        targs["kv_window"] = (PCOL, W, _t(acol), _t(gcnt))
        jargs["kv_window"] = (PCOL, W, jnp.asarray(acol), jnp.asarray(gcnt))
    elif mode == "kv_len":
        valid = np.arange(S)[None, :] < kv_len[:, None]
        targs["kv_len"] = _t(kv_len)
        jargs["kv_len"] = jnp.asarray(kv_len)
    else:
        targs["kv_valid"] = _t(valid)
        jargs["kv_valid"] = jnp.asarray(valid)
    port = decode_attention(_t(q), _t(k), _t(v), **targs).numpy()
    live = valid.any(axis=1)

    # fp32 reference on every row with a live key
    xla = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=d ** -0.5, kv_valid=jnp.asarray(valid), kv_layout="bshd"))
    _close(port[live], xla[live])
    # the zero-row contract: a fully masked row returns exactly 0
    assert (port[~live] == 0).all()
    # the TPU kernel itself: it rounds its probabilities to bf16 before the
    # P.V product (decode_attention.py:179), so it agrees to bf16
    # resolution: atol 2e-2 on outputs of magnitude < 2
    kern = np.asarray(flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jargs))
    _close(port, kern, atol=2e-2, rtol=0)
    assert (kern[~live] == 0).all()


def test_b2_window_floor_mod_and_kv_len_compose():
    """A negative (r - pcol - acol) must wrap like jnp.mod, and kv_len
    still masks inside the window."""
    q, k, v = _decode_inputs(64, seed=4)
    acol = np.asarray([7, 7, 7, 7], np.int32)
    gcnt = np.asarray([2, 2, 2, 2], np.int32)
    kv_len = np.asarray([S, S, PCOL + 1, 5], np.int32)
    port = decode_attention_plain(_t(q), _t(k), _t(v), kv_len=_t(kv_len),
                                  kv_window=(PCOL, W, _t(acol), _t(gcnt)))
    valid = _window_valid(acol, gcnt) & (np.arange(S)[None] < kv_len[:, None])
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, scale=64 ** -0.5,
                         kv_valid=jnp.asarray(valid), kv_layout="bshd")
    _close(port, ref)


# ------------------------------- B3 -------------------------------

@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "scatter"])
def test_b3_plain_matches_pallas_bitwise(uniform):
    rng = np.random.default_rng(5)
    ck = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    kn = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    start = np.asarray([7, 0, 11], np.int32)
    jfn, tfn = (j_uniform, kv_uniform_write) if uniform else \
        (j_scatter, kv_scatter_write)
    jk, jv = jfn(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                 jnp.asarray(vn), jnp.asarray(start))
    tk, tv = _t(ck.copy()), _t(cv.copy())
    out = tfn(tk, tv, _t(kn), _t(vn), _t(start))
    assert out[0] is tk and out[1] is tv           # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_b3_rejects_multirow():
    c = torch.zeros(2, 8, 1, 4)
    with pytest.raises(ValueError, match="one row"):
        kv_uniform_write(c, c, torch.zeros(2, 2, 1, 4),
                         torch.zeros(2, 2, 1, 4), torch.zeros(2, dtype=torch.int32))


# ------------------------------- B4 -------------------------------

@pytest.mark.parametrize("name", ["paligemma", "llava"])
def test_b4_plain_matches_pallas_and_jnp(name):
    recipe, jrecipe = RECIPES[name], J_RECIPES[name]
    u8 = np.random.default_rng(6).integers(0, 256, (2, 28, 28, 3),
                                           dtype=np.uint8)
    port = normalize_images(_t(u8), recipe=recipe,
                            compute_dtype=torch.float32).numpy()
    mean = jnp.asarray(jrecipe.mean, jnp.float32)
    std = jnp.asarray(jrecipe.std, jnp.float32)
    pallas = _normalize_pallas(jnp.asarray(u8), 1.0 / (255.0 * std),
                               -mean / std, jnp.float32)
    _close(port, pallas)
    _close(port, _normalize_jnp(jnp.asarray(u8), mean, std, jnp.float32))
    bf16 = normalize_plain(_t(u8), recipe, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    _close(bf16.float().numpy(), port, atol=8e-3, rtol=0)   # one bf16 ulp


@pytest.mark.parametrize("name", ["paligemma", "llava"])
def test_host_resize_bit_exact(name):
    img = Image.fromarray(np.random.default_rng(7).integers(
        0, 256, (50, 70, 3), dtype=np.uint8))
    np.testing.assert_array_equal(host_resize(img, RECIPES[name]),
                                  j_host_resize(img, J_RECIPES[name]))
    assert RECIPES[name] == type(RECIPES[name])(
        **{f: getattr(J_RECIPES[name], f) for f in
           ("image_size", "mean", "std", "mode", "resample")})
