"""The port's tensor-parallel layout against vlm_tpu's: for every
parameter of the three families at the "test" size, in fp32, 8bit and
4bit, the axis ``vlm_tpu_torch.parallel.sharding.param_specs`` splits over
``model=2`` is the one ``vlm_tpu.parallel.sharding.param_specs`` gives the
same leaf, and the ranks' slices of the full state (``shard_state_dict``)
put back together give the full tensor.

Where the layouts differ, by the port's contract:

- MQA's K/V projections (PaliGemma's one KV head): ``vlm_tpu`` splits their
  columns and lets GSPMD gather them; the port holds them whole on every
  rank;
- a row-parallel int4 layer's group scales: ``vlm_tpu`` replicates them;
  the port gives each rank the scales of its inputs, as groups of
  ``gcd(group, in / model)`` (a group that straddles two ranks gives each
  its scale): its slices put back together dequantize to the full weight.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.test_torch_blip2 import _affine_from_seed
from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu.parallel.sharding import param_specs as jax_param_specs
from vlm_tpu_torch.core.mesh import Mesh
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.vit import ViTEncoder
from vlm_tpu_torch.models.vlm import VLMModule, param_bytes
from vlm_tpu_torch.ops.quant import QuantizedWeight, dequantize
from vlm_tpu_torch.parallel.sharding import param_specs, shard_state_dict
from vlm_tpu_torch.testing.bridge import (_BLOCK, _QFORMER_PART,
                                          load_flax_params)

FAMILIES = ["paligemma", "llava", "blip2"]
BITS = [0, 8, 4]


def _port_name(tree, path):
    """The bridge's name of flax leaf ``path`` (``testing/bridge.py``)."""
    *mods, leaf = path
    node = tree
    for m in mods:
        node = node[m]
    names = []
    for m in mods:
        block, part = _BLOCK.match(m), _QFORMER_PART.match(m)
        names.append(f"blocks.{block.group(1)}" if block else
                     f"layers.{part.group(2)}.{part.group(1)}" if part
                     else m)
    leaf = {"kernel": "weight", "q_kernel": "q", "embedding": "weight"}.get(
        leaf, "scale" if leaf == "scale" and "q_kernel" in node else
        "weight" if leaf == "scale" else leaf)
    return ".".join(names + [leaf])


def _jax_axis(key, spec):
    """vlm_tpu's split of a leaf as the axis of the port's tensor: Dense
    kernels and scales transpose ([in, out] -> [out, in]), tables and
    biases keep theirs."""
    names = tuple(spec)
    if "model" not in names:
        return None
    if key in ("kernel", "q_kernel", "scale"):
        return {0: 1, 1: 0}[names.index("model")]
    return names.index("model")


_CACHE = {}


def _models(family, bits):
    if (family, bits) not in _CACHE:
        jcfg = JAX_CONFIGS[family]("test")
        _, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                             quant_bits=bits, vision_quant_bits=bits)
        tree = jax.tree.map(np.asarray, meta.unbox(params))
        if family == "blip2":
            tree = _affine_from_seed(tree)
        cfg = VLM_CONFIGS[family]("test")
        full = VLMModule(cfg, dtype=torch.float32, quant_bits=bits,
                         vision_quant_bits=bits)
        load_flax_params(full, tree)
        _CACHE[family, bits] = (params, tree, cfg, full)
    return _CACHE[family, bits]


def _rank(cfg, bits, r, ways=2):
    return VLMModule(cfg, dtype=torch.float32, quant_bits=bits,
                     vision_quant_bits=bits,
                     mesh=Mesh(1, ways, model_rank=r, groups=False))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("family", FAMILIES)
def test_split_axes_are_vlm_tpu_s(family, bits):
    params, tree, cfg, _ = _models(family, bits)
    specs = jax_param_specs(params)
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    ours = param_specs(_rank(cfg, bits, 0))
    mqa = cfg.decoder.kv_heads == 1
    seen = set()
    for path, spec in flat:
        keys = tuple(k.key for k in path)[1:]       # drop "params"
        name = _port_name(tree["params"], keys)
        seen.add(name)
        want = _jax_axis(keys[-1], spec)
        got = ours[name]
        if mqa and any(p in name for p in (".k_proj.", ".v_proj.")) and \
                name.startswith("decoder."):
            assert want is not None and got is None, name   # replicated
        elif bits == 4 and name.endswith(".scale") and want is None and \
                got == 1:
            pass                              # a row-parallel int4 scale
        else:
            assert got == want, (name, spec, got)
    assert seen == set(ours)
    assert any(d is not None for d in ours.values())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("family", FAMILIES)
def test_rank_slices_put_back_together_give_the_full_state(family, bits):
    _, _, cfg, full = _models(family, bits)
    full_sd = full.state_dict()
    ranks = [_rank(cfg, bits, r) for r in range(2)]
    parts = [shard_state_dict(full_sd, m) for m in ranks]
    specs = param_specs(ranks[0])
    mods = dict(ranks[0].named_modules())
    for name, t in full_sd.items():
        dim = specs[name]
        if dim is None:
            assert all(torch.equal(p[name], t) for p in parts), name
            continue
        mod = name.rpartition(".")[0]
        dense = mods[mod]
        if name.endswith(".scale") and getattr(dense, "quant_bits", 0) == 4 \
                and dense.split == "row":
            # the ranks' groups dequantize to the full weight
            w = torch.cat([dequantize(QuantizedWeight(
                p[f"{mod}.q"], p[name], dense.group_size)) for p in parts],
                dim=1)
            assert torch.equal(w, dequantize(QuantizedWeight(
                full_sd[f"{mod}.q"], t, full.get_submodule(mod).group_size)))
            continue
        assert torch.equal(torch.cat([p[name] for p in parts], dim=dim), t), \
            name
        # and the module built at the shard took the slice's shape
        assert all(p[name].shape[dim] * 2 == t.shape[dim] for p in parts)


@pytest.mark.parametrize("family,size", [("paligemma", "3b"),
                                         ("llava", "7b"),
                                         ("blip2", "6.7b")])
def test_full_size_shards_and_their_bytes(family, size):
    """Each family at full size builds its model=2 shard on ``meta`` in
    bf16, 8bit and 4bit (the decoder's int4 groups stay whole or split
    into whole smaller groups), and a rank's ``param_bytes`` lies between
    half the model's and the whole."""
    cfg = VLM_CONFIGS[family](size)
    for bits in (0, 8, 4):
        kw = dict(dtype=torch.bfloat16, quant_bits=bits)
        whole = param_bytes(cfg, **kw)
        rank = param_bytes(cfg, model_ways=2, **kw)
        assert whole / 2 < rank < whole * 0.6, (bits, whole, rank)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_siglip_tower_split_off_16_is_refused(bits):
    """Once refused, now built: SigLIP's MLP width 4304 over model=2 would
    leave 2152 inputs a rank, not a multiple of 16 (B5's and B6's K) and,
    for int4 (groups of 16), groups of 8. The port splits it at a multiple
    of 16 (int4: of max(16, group)): fc2 takes 2144 inputs on rank 0 and
    2160 on rank 1, fc1 the same output columns, the int4 groups whole.
    PaliGemma-3B builds on ``meta`` at full size on both ranks; the ranks'
    parts make the whole layer, and ``param_bytes`` counts rank 0's. EVA's
    and CLIP's towers still split evenly into whole groups of 16 or
    more."""
    cfg = VLM_CONFIGS["paligemma"]("3b")
    parts = []
    for rank in (0, 1):
        m = VLMModule(cfg, dtype=torch.bfloat16, device="meta",
                      quant_bits=bits, vision_quant_bits=bits,
                      mesh=Mesh(1, 2, model_rank=rank, groups=False))
        fc1, fc2 = m.vision.blocks[0].fc1, m.vision.blocks[0].fc2
        k = (2144, 2160)[rank]
        assert (fc2.split, fc2.in_dim, fc2.comm.k_lo) == \
            ("row", k, (0, 2144)[rank])
        assert (fc1.split, fc1.out_dim) == ("col", k)
        assert fc2.q.shape == (1152, k if bits == 8 else k // 2)
        assert fc1.q.shape[0] == fc1.scale.shape[0] == fc1.bias.shape[0] == k
        if bits == 4:
            assert fc2.group_size == fc2.full_group == 16
            assert fc2.scale.shape == (1152, k // 16)
        else:
            assert fc2.scale.shape == (1152,)
        parts.append(sum(t.numel() * t.element_size()
                         for t in (*m.parameters(), *m.buffers())))
    whole = param_bytes(cfg, dtype=torch.bfloat16, quant_bits=bits,
                        vision_quant_bits=bits)
    assert parts[0] == param_bytes(cfg, dtype=torch.bfloat16, model_ways=2,
                                   quant_bits=bits, vision_quant_bits=bits)
    assert whole / 2 < parts[0] < whole and parts[0] < parts[1]
    # the ranks' parts of one full fc2 put back together
    one = dataclasses.replace(cfg.vision, layers=1)
    full = ViTEncoder(one, dtype=torch.bfloat16, device="cpu",
                      quant_bits=bits).blocks[0]
    full.fc2.q.random_(-100, 100)
    full.fc2.scale.uniform_(0.5, 1.5)
    for leaf, dim in (("q", 1), ("scale", 1 if bits == 4 else None)):
        cuts = []
        for rank in (0, 1):
            m = ViTEncoder(one, dtype=torch.bfloat16, device="meta",
                           quant_bits=bits,
                           mesh=Mesh(1, 2, model_rank=rank, groups=False))
            cuts.append(m.blocks[0].fc2.shard_full(
                leaf, getattr(full.fc2, leaf)))
        t = getattr(full.fc2, leaf)
        assert torch.equal(torch.cat(cuts, dim) if dim is not None
                           else cuts[0], t), leaf
    for family, size in (("blip2", "6.7b"), ("llava", "7b")):
        m = VLMModule(VLM_CONFIGS[family](size), dtype=torch.bfloat16,
                      device="meta", quant_bits=bits, vision_quant_bits=bits,
                      mesh=Mesh(1, 2, groups=False))
        fc2 = m.vision.blocks[0].fc2
        assert fc2.split == "row" and fc2.in_dim % 16 == 0
        assert fc2.in_dim * 2 == fc2.full_in
        assert bits == 8 or fc2.in_dim % fc2.group_size == 0 and \
            fc2.group_size >= 16


def test_a_mesh_of_one_way_changes_nothing():
    """model == 1: no split, no gather: the module is the single-device
    one, tensor for tensor."""
    cfg = VLM_CONFIGS["llava"]("test")
    a = VLMModule(cfg, dtype=torch.float32, device="meta")
    b = VLMModule(cfg, dtype=torch.float32, device="meta",
                  mesh=Mesh(2, 1, groups=False))
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert not any(d is not None for d in param_specs(b).values())
    assert math.prod(Mesh(2, 1, groups=False).shape.values()) == 2
