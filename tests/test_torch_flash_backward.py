"""B1-diff's backward on the CPU against ``vlm_tpu``: the recompute that
:class:`FlashAttentionFn` takes for CPU tensors, and the fp32 kernel's
formulation (``vlm_tpu_torch/testing/attention_grad.py``: P = exp(S - lse),
delta = rowsum(dO o O)), each against ``jax.vjp`` of ``vlm_tpu``'s
``_flash_attention_diff`` (its Pallas forward in interpret mode), and the
formulation's log-sum-exp against ``jax.nn.logsumexp`` of the scores as
``_xla_attention`` forms them. Inputs from numpy seeds, q/k/v handed in as
transposes of ``[B, S, H, D]`` (the towers' layout); rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_tpu.ops.attention import NEG_INF as J_NEG_INF
from vlm_tpu.ops.attention import _flash_attention_diff
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.attention import (attention_plain, flash_attention,
                                         flash_attention_fp32_backward)
from vlm_tpu_torch.testing.attention_grad import (attention_backward,
                                                  attention_lse)

RTOL, ATOL = 1e-5, 1e-6
B, KV = 2, 2
# (head dim, causal, group G = H / KV, Sq, Sk): CLIP-L's, SigLIP's and EVA's
# head dims, causal and not, G = 1 and 2, and causal rows with no live key
# (Sq > Sk: their weights are uniform, their scores get no gradient)
CASES = [(64, False, 1, 40, 40), (64, True, 1, 40, 40),
         (72, False, 2, 33, 33), (72, True, 2, 33, 33),
         (88, False, 1, 24, 24), (88, True, 2, 24, 24),
         (64, True, 2, 20, 12)]
IDS = [f"d{d}-{'causal' if c else 'full'}-g{g}-q{sq}-k{sk}"
       for d, c, g, sq, sk in CASES]


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """q [B, H, Sq, D] and k/v [B, KV, Sk, D] as numpy arrays laid out
    [B, S, H, D] (transposed views of them go to the port), and dO."""
    d, causal, g, sq, sk = case
    rng = np.random.default_rng(CASES.index(case))
    h = KV * g
    q = rng.standard_normal((B, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((B, sk, KV, d), dtype=np.float32)
    v = rng.standard_normal((B, sk, KV, d), dtype=np.float32)
    do = rng.standard_normal((B, h, sq, d), dtype=np.float32)
    return q, k, v, do


def _torch(case):
    q, k, v, do = _inputs(case)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    return tq, tk, tv, torch.from_numpy(do)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """dq, dk, dv from jax.vjp of vlm_tpu's differentiable form."""
    d, causal, g, sq, sk = case
    q, k, v, do = _inputs(case)
    jq, jk, jv = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: _flash_attention_diff(
        q, k, v, causal, q.shape[1]), jq, jk, jv)
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(do)))


def _jax_lse(case):
    """logsumexp of the scaled, masked scores, formed as _xla_attention
    forms them (grouped heads against their KV head, the finite mask)."""
    d, causal, g, sq, sk = case
    q, k, _, _ = _inputs(case)
    jq, jk = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k))
    qg = jq.reshape(B, KV, g, sq, d)
    s = jnp.einsum("bngqd,bnkd->bngqk", qg, jk,
                   preferred_element_type=jnp.float32) * d ** -0.5
    if causal:
        qi = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 0)
        ki = jax.lax.broadcasted_iota(jnp.int32, (sq, sk), 1)
        s = jnp.where((ki <= qi + sk - sq)[None, None, None], s, J_NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, KV * g, sq)


def _check(got, want):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_matches_jax_logsumexp(case):
    q, k, v, _ = _torch(case)
    got = attention_lse(q, k, v, causal=case[1])
    want = _jax_lse(case)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if case[3] > case[4] and case[1]:
        dead = case[3] - case[4]
        assert (got[:, :, :dead] == J_NEG_INF).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_recompute_matches_jax_vjp(case):
    """The CPU's backward: the recompute, counted as one, no kernel."""
    q, k, v, do = _torch(case)
    for t in (q, k, v):
        t.requires_grad_()
    _lib.reset_counts()
    o = flash_attention(q, k, v, causal=case[1])
    assert len(o.grad_fn.saved_tensors) == 3      # q, k, v as before
    got = torch.autograd.grad(o, (q, k, v), do)
    assert _lib.recomputes == {"flash_attention_diff": 0,
                               "flash_attention_diff_fp32": 1}
    assert _lib.launches["flash_attention_diff_fp32_bwd"] == 0
    _check(got, _jax_grads(case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_formulation_matches_jax_vjp(case):
    """exp(S - lse) and rowsum(dO o O) from the forward's o and lse give
    vlm_tpu's gradients too."""
    q, k, v, do = _torch(case)
    o = attention_plain(q, k, v, causal=case[1])
    lse = attention_lse(q, k, v, causal=case[1])
    _check(attention_backward(q, k, v, o, lse, do, causal=case[1]),
           _jax_grads(case))


def test_backward_kernel_takes_cuda_tensors_only():
    q, k, v, do = _torch(CASES[0])
    lse = attention_lse(q, k, v)
    with pytest.raises(ValueError, match="cuda"):
        flash_attention_fp32_backward(q, k, v, q, lse, do)
