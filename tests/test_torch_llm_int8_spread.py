"""Why PaliGemma's int8 tower at 512 rows (llm.int8 in every product)
leaves the port's features up to 1e-2 of their scale from ``vlm_tpu``'s
eager run, where the fp32 tower agrees within 1e-5: the scheme's own
spread, not a difference of scheme.

- One llm.int8 product on identical inputs: the int8 part is bitwise
  ``vlm_tpu``'s, and the sum differs only where the bf16 outlier
  correction's fp32 sum rounds to the other bf16 neighbour.
- ``vlm_tpu``'s own tower, on pixels one fp32 ulp apart (x (1 + 2^-23)),
  moves as far as the port is from it: at the "test" size half of the 64
  columns are outliers (a budget of 32), and fp32 noise swaps the 32nd and
  33rd largest column maxima of block 1's q/k/v input, which moves whole
  rows' int8 codes (a column's codes jump between 0 and up to 127); before
  that, fc2's codes flip by one step where x / scale sits on a .5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_common import Case
from vlm_tpu.ops import quant as jq
from vlm_tpu_torch.ops import quant as tq

ULP = np.float32(1 + 2.0 ** -23)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_one_llm_int8_product_matches_vlm_tpu_on_identical_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    x[:, 5] *= 20                                      # an outlier column
    w = 0.1 * rng.standard_normal((64, 128)).astype(np.float32)
    jw = jq.quantize_int8(jnp.asarray(w))
    tw = tq.QuantizedWeight(torch.from_numpy(np.asarray(jw.q).T.copy()),
                            torch.from_numpy(np.asarray(jw.scale)[0].copy()), 0)
    with jax.disable_jit():
        want = np.asarray(jq.quant_matmul_outlier(
            jnp.asarray(x), jw, out_dtype=jnp.float32))
        idx = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)).max(0),
                                       32)[1])
        mask = np.ones(64, np.float32)
        mask[idx] = 0
        want_int8 = np.asarray(jq.quant_matmul_dynamic(
            jnp.asarray(x * mask), jw, out_dtype=jnp.float32))
    got = tq.quant_matmul_outlier(torch.from_numpy(x), tw,
                                  out_dtype=torch.float32).numpy()
    got_int8 = tq.quant_matmul_dynamic(torch.from_numpy(x * mask), tw,
                                       out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got_int8, want_int8)
    corr = want - want_int8                            # the bf16 correction
    diff = np.abs(got - want)
    assert float((diff > 0).mean()) <= 1e-3
    assert float(diff.max()) <= 2.0 ** -8 * float(np.abs(corr).max())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for the port's fp32 sums, as the mesh tests' ranks
    take (the thread count changes MKL's summation order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    out = {}
    for bits in (8, 0):
        case = Case("paligemma", bits=bits, n_images=32)
        px = case.pixels[:32]
        with jax.disable_jit():
            j = [np.asarray(case.jmod.apply(
                case.params, jnp.asarray(p), method="encode_images"),
                np.float32) for p in (px, px * ULP)]
        out[bits] = (case, px, j)
    return out


def test_the_int8_towers_spread_is_the_schemes_own(towers, monkeypatch):
    case, px, (jax_a, jax_b) = towers[8]
    mod = case.port()
    codes = []
    real = tq.quantize_activations

    def spy(x, row_max=None):
        q, s = real(x, row_max)
        codes.append(q.clone())
        return q, s
    monkeypatch.setattr(tq, "quantize_activations", spy)
    port = []
    for p in (px, px * ULP):
        with torch.inference_mode():
            port.append(mod.encode_images(torch.from_numpy(p)).numpy())
    # 2 runs x 2 blocks x (q, k, v, o, fc1, fc2)
    assert len(codes) == 2 * 2 * 6
    # the port from vlm_tpu, and each from itself one ulp of input apart:
    # the same order
    gap = _rel(jax_a, port[0])
    spread = min(_rel(jax_a, jax_b), _rel(port[0], port[1]))
    assert 1e-3 <= spread and gap <= 1e-2 and gap <= 2 * spread
    # the mechanism, in the port's two runs: block 0's q/k/v codes equal,
    # a few of its fc2's one step apart, block 1's q/k/v input's outlier
    # columns swapped (codes jumping by up to 127)
    steps = [int((a.int() - b.int()).abs().max())
             for a, b in zip(codes[:12], codes[12:])]
    assert steps[:3] == [0, 0, 0] and steps[5] == 1
    assert steps[6] == steps[7] == steps[8] >= 64


def test_the_fp32_tower_has_no_such_spread(towers):
    case, px, (jax_a, jax_b) = towers[0]
    with torch.inference_mode():
        port = case.port().encode_images(torch.from_numpy(px)).numpy()
    assert _rel(jax_a, jax_b) <= 1e-5 and _rel(jax_a, port) <= 1e-5
