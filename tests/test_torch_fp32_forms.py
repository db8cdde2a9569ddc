"""The fp32 forms of B1, B2 and B4 (the card's kernels for models that run
with quantization "fp32") on the CPU: their plain versions against the JAX
ops on fp32 inputs made with numpy from a seed, and a numpy emulation of
each CUDA kernel's order of work against the plain version.

Tolerance: 1e-5 of the largest output (``REL``), the fp32 sums being taken
in another order (XLA's einsum, the kernels' tiles and warps), and XLA's
normalisation maybe fusing its multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_tpu.ops.attention import _xla_attention
from vlm_tpu.ops.preprocess import RECIPES as J_RECIPES
from vlm_tpu.ops.preprocess import _normalize_jnp, _normalize_pallas
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.attention import attention_plain, flash_attention
from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                decode_attention_plain,
                                                live_rows)
from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images

torch.set_num_threads(2)
REL = 1e-5
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# (name, causal, sq, sk, kv_len, prefix_len), the masks B1's fp32 form
# takes, a keyless row (kv_len 0) among them
B1_MODES = [
    ("none", False, 40, 40, None, None),
    ("kv_len", False, 40, 40, [33, 0], None),
    ("causal_offset", True, 9, 40, None, None),
    ("causal_dead_rows", True, 40, 24, None, None),
    ("prefix_kv_len", True, 40, 40, [36, 40], [12, 3]),
]
# SigLIP's head dim, Gemma's MQA, and GQA
B1_SHAPES = [(72, 4, 4), (256, 4, 1), (64, 8, 2)]


def _b1_inputs(seed, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, h, sq, d)).astype(np.float32),
            rng.normal(size=(2, kvh, sk, d)).astype(np.float32),
            rng.normal(size=(2, kvh, sk, d)).astype(np.float32))


def _opt(a, fn):
    return None if a is None else fn(np.asarray(a, np.int32))


@pytest.mark.parametrize("shape", B1_SHAPES, ids=["d72", "d256_mqa",
                                                  "d64_gqa"])
@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_plain_matches_xla(mode, shape):
    _, causal, sq, sk, kv_len, prefix = mode
    d, h, kvh = shape
    q, k, v = _b1_inputs(0, h, kvh, sq, sk, d)
    _lib.reset_counts()
    port = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=_opt(kv_len, _t),
                           prefix_len=_opt(prefix, _t))
    assert port.dtype == torch.float32
    assert _lib.plain_calls["flash_attention_fp32"] == 1
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, scale=d ** -0.5,
                         kv_len=_opt(kv_len, jnp.asarray),
                         prefix_len=_opt(prefix, jnp.asarray))
    _close(port, ref)


def _emulate_b1_fp32(q, k, v, causal, kv_len, prefix):
    """``csrc/flash_attention_fp32.cu`` in numpy: 32-key tiles, each row's
    running max and sum updated once a tile; a masked key scores the finite
    -1e30 and stays in the sum, a key past Sk does not exist."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    out = np.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            kk, vv = k[bi, hi // g], v[bi, hi // g]
            m = np.full(sq, -np.inf, np.float32)
            l = np.zeros(sq, np.float32)
            acc = np.zeros((sq, d), np.float32)
            kvl = sk if kv_len is None else min(kv_len[bi], sk)
            pfx = 0 if prefix is None else prefix[bi]
            qi = np.arange(sq)[:, None]
            for k0 in range(0, sk, 32):
                kj = np.arange(k0, k0 + 32)[None, :]
                exists = kj < sk
                kt = np.zeros((32, d), np.float32)
                vt = np.zeros((32, d), np.float32)
                kt[:min(32, sk - k0)] = kk[k0:k0 + 32]
                vt[:min(32, sk - k0)] = vv[k0:k0 + 32]
                s = (q[bi, hi] @ kt.T) * np.float32(d ** -0.5)
                allowed = kj < kvl
                if causal:
                    allowed = allowed & ((kj <= qi + (sk - sq)) | (kj < pfx))
                s = np.where(allowed, s, np.float32(NEG_INF))
                s = np.where(exists, s, -np.inf)
                mn = np.maximum(m, s.max(axis=1))
                c = np.exp(m - mn)
                p = np.where(exists, np.exp(s - mn[:, None]), 0.0)
                l = l * c + p.sum(axis=1)
                acc = acc * c[:, None] + p @ vt
                m = mn
            out[bi, hi] = acc / l[:, None]
    return out


@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_kernel_order_matches_plain(mode):
    _, causal, sq, sk, kv_len, prefix = mode
    q, k, v = _b1_inputs(1, 8, 2, sq, sk, 64)
    got = _emulate_b1_fp32(q, k, v, causal, kv_len, prefix)
    want = attention_plain(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=_opt(kv_len, _t),
                           prefix_len=_opt(prefix, _t)).numpy()
    _close(got, want)


# ------------------------------- B2 -------------------------------

B, S, W, PCOL = 4, 40, 8, 30


def _b2_inputs(d, h, kvh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, h, 1, d)).astype(np.float32),
            rng.normal(size=(B, S, kvh, d)).astype(np.float32),
            rng.normal(size=(B, S, kvh, d)).astype(np.float32))


def _b2_masks(mode):
    acol = np.asarray([0, 3, 7, 5], np.int32)
    gcnt = np.asarray([1, 8, 0, 4], np.int32)      # slot 2: no live row
    if mode == "window":
        return dict(kv_window=(PCOL, W, _t(acol), _t(gcnt)))
    if mode == "kv_len":
        return dict(kv_len=_t(np.asarray([S, 17, 0, 33], np.int32)))
    valid = np.random.default_rng(3).random((B, S)) < 0.5
    valid[2] = False
    return dict(kv_valid=_t(valid))


@pytest.mark.parametrize("shape", [(256, 8, 1), (64, 8, 2)],
                         ids=["d256_mqa", "d64_gqa"])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid"])
def test_b2_fp32_plain_matches_xla(mode, shape):
    d, h, kvh = shape
    q, k, v = _b2_inputs(d, h, kvh, 4)
    masks = _b2_masks(mode)
    _lib.reset_counts()
    port = decode_attention(_t(q), _t(k), _t(v), **masks).numpy()
    assert _lib.plain_calls["decode_attention_fp32"] == 1
    valid = live_rows(B, S, "cpu", **masks).numpy()
    live = valid.any(axis=1)
    ref = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=d ** -0.5, kv_valid=jnp.asarray(valid), kv_layout="bshd"))
    _close(port[live], ref[live])
    assert (port[~live] == 0).all()      # a slot with no live row: 0


def _emulate_b2_fp32(q, k, v, valid):
    """``decode_fp32_kernel`` in numpy: warp w walks live rows w, w + 4,
    ... with a running max and sum a row; the 4 warps merge, a warp with no
    live row weighing 0; the sum is clamped at 1e-30."""
    b, h, _, d = q.shape
    kvh = k.shape[2]
    out = np.zeros((b, h, 1, d), np.float32)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // kvh)
            ms, ls, accs = [], [], []
            for w in range(4):
                m, l, acc = -np.inf, np.float32(0), np.zeros(d, np.float32)
                for r in range(w, k.shape[1], 4):
                    if not valid[bi, r]:
                        continue
                    s = np.float32(q[bi, hi, 0] @ k[bi, r, kv]) * \
                        np.float32(d ** -0.5)
                    mn = max(m, s)
                    c, p = np.exp(m - mn), np.exp(s - mn)
                    l = l * c + p
                    acc = acc * c + p * v[bi, r, kv]
                    m = mn
                ms.append(m)
                ls.append(l)
                accs.append(acc)
            live = [x > 0 for x in ls]
            mx = max([m for m, a in zip(ms, live) if a], default=-np.inf)
            wt = [np.exp(m - mx) if a else 0.0 for m, a in zip(ms, live)]
            lsum = sum(x * y for x, y in zip(ls, wt))
            out[bi, hi, 0] = sum(x * y for x, y in zip(accs, wt)) / max(
                lsum, 1e-30)
    return out


@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid"])
def test_b2_fp32_kernel_order_matches_plain(mode):
    q, k, v = _b2_inputs(64, 8, 2, 5)
    masks = _b2_masks(mode)
    valid = live_rows(B, S, "cpu", **masks).numpy()
    got = _emulate_b2_fp32(q, k, v, valid)
    want = decode_attention_plain(_t(q), _t(k), _t(v), **masks).numpy()
    _close(got, want)


# ------------------------------- B4 -------------------------------

@pytest.mark.parametrize("name", ["paligemma", "llava", "blip2"])
def test_b4_fp32_plain_matches_jax(name):
    """Within ``REL`` of ``_normalize_pallas`` and ``_normalize_jnp`` (XLA
    on the CPU may fuse the multiply-add into one rounding; the plain
    version and the kernel round twice, and agree bitwise on the card)."""
    u8 = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    _lib.reset_counts()
    port = normalize_images(_t(u8), recipe=RECIPES[name],
                            compute_dtype=torch.float32).numpy()
    assert _lib.plain_calls["normalize_fp32"] == 1
    jr = J_RECIPES[name]
    mean = jnp.asarray(jr.mean, jnp.float32)
    std = jnp.asarray(jr.std, jnp.float32)
    pallas = np.asarray(_normalize_pallas(jnp.asarray(u8),
                                          1.0 / (255.0 * std), -mean / std,
                                          jnp.float32))
    _close(port, pallas)
    _close(port, _normalize_jnp(jnp.asarray(u8), mean, std, jnp.float32))
