"""Random weights drawn on the card from the run's seed.

Every tensor is a view into one flat buffer, filled by one ``normal_`` call
of a generator on the device and then scaled leaf by leaf in place: a
matrix ``[out, in]`` by ``1 / sqrt(in)``, a table or a learned position or
query block by 0.02, a bias by 0.02, a norm's scale as ``1 + 0.02 z``. The
same tensors go to the program and to the reference; neither draws its
own. Each leaf starts at a multiple of 256 bytes, as a separately
allocated tensor would."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

#: leaves drawn with a standard deviation of 0.02 whatever their shape
SMALL = ("embed.weight", "pos_embed", "cls_token", "query_tokens")


def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, shift) of a standard normal draw for leaf ``name``."""
    if name.endswith("bias"):
        return 0.02, 0.0
    if any(name.endswith(s) for s in SMALL):
        return 0.02, 0.0
    if len(shape) == 1:                 # a norm's scale
        return 0.02, 1.0
    return 1.0 / math.sqrt(shape[-1]), 0.0


def seed_of(seed: int, salt: int = 0) -> int:
    """A generator seed from the run's ``--seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + salt) % (2 ** 63)


def draw(specs: Iterable[Tuple[str, Tuple[int, ...]]], dtype, device,
         seed: int, torch) -> Dict[str, "torch.Tensor"]:
    """Views of one buffer, by leaf name, for ``specs`` (name, shape)."""
    specs = list(specs)
    align = max(1, 256 // torch.empty((), dtype=dtype).element_size())
    offsets, total = [], 0
    for _, shape in specs:
        offsets.append(total)
        n = math.prod(shape)
        total += -(-n // align) * align
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    flat.normal_(0.0, 1.0, generator=gen)
    out = {}
    with torch.no_grad():
        for (name, shape), off in zip(specs, offsets):
            view = flat[off:off + math.prod(shape)].view(shape)
            scale, shift = init_rule(name, shape)
            view.mul_(scale)
            if shift:
                view.add_(shift)
            out[name] = view
    return out


def specs_of(module) -> list:
    """(name, shape) of every floating parameter of ``module``."""
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()
            if p.is_floating_point()]
