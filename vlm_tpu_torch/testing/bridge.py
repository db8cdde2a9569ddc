"""Convert a ``vlm_tpu`` flax parameter tree into the port's state dict.

The input is the tree as numpy arrays (unboxed from flax's partitioning
metadata), e.g. ``jax.tree.map(np.asarray, flax.core.meta.unbox(params))``.
Names map one to one: ``block_<i>`` becomes ``blocks.<i>``; the Q-Former's
flat per-layer modules ``<part>_<i>`` (``self_attn``, ``cross_attn``,
``ffn_up``, ``ffn_down``, ``ffn_ln``) become ``layers.<i>.<part>``; a Dense
``kernel`` [in, out] becomes ``weight`` [out, in]; a quantized Dense's
``q_kernel`` becomes ``q``, transposed (int8 [in, out] -> [out, in], packed
int4 [in/2, out] -> [out, in/2]) and its ``scale`` [groups, out] becomes
``scale`` [out, groups], squeezed to [out] for one group (int8's [1, out];
an int4 Dense with one group gets its [out, 1] back in
:func:`load_flax_params`); the patch embedding's HWIO conv kernel
[P, P, 3, hidden] becomes the unfold-matmul weight [hidden, P*P*3]; a
norm's ``scale`` and a token or position table's ``embedding`` become
``weight``; ``bias``, the tower's ``pos_embed``, ``cls_token`` and the
Q-Former's ``query_tokens`` copy across.

Probing: a probe head's ``{"params", "batch_stats"}`` (one, or one per task
of a multi-task probe), a LoRA adapter tree (``A`` ``[in, r]`` and ``B``
``[r, out]`` keyed ``block_<i>/attn/q_proj``: the same matrices under
``blocks.<i>.attn.q_proj``) and the uncertainty weighting's log-variances.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^block_(\d+)$")
_QFORMER_PART = re.compile(
    r"^(self_attn|cross_attn|ffn_up|ffn_down|ffn_ln)_(\d+)$")


def _flatten(tree: Mapping, prefix=()):
    """(path, array, whether the leaf's module is a quantized Dense)"""
    quantized = "q_kernel" in tree
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val), quantized


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the ``{"params": {...}}`` tree of a ``VLMModule`` (or
    any of its submodules' trees)."""
    tree = params.get("params", params)
    out = {}
    for path, arr, quantized in _flatten(tree):
        *mods, leaf = path
        names = []
        for m in mods:
            block, part = _BLOCK.match(m), _QFORMER_PART.match(m)
            names.append(f"blocks.{block.group(1)}" if block else
                         f"layers.{part.group(2)}.{part.group(1)}" if part
                         else m)
        if leaf == "kernel":
            if arr.ndim == 4:                 # HWIO conv -> [out, P*P*C]
                arr = arr.reshape(-1, arr.shape[-1])
            arr = arr.T
            leaf = "weight"
        elif leaf == "q_kernel":
            arr, leaf = arr.T, "q"
        elif leaf == "scale" and quantized:   # [groups, out] -> [out, groups]
            arr = arr.T[:, 0] if arr.shape[0] == 1 else arr.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(names + [leaf])] = torch.tensor(arr)
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping) -> None:
    """Copy a flax tree into ``module`` (every parameter must be covered)."""
    state = flax_to_state_dict(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, tensor in own.items():
            src = state[name]
            if name.endswith(".scale") and tuple(tensor.shape) == (
                    *src.shape, 1):
                src = src[:, None]            # an int4 Dense with one group
            if tuple(src.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: flax {tuple(src.shape)} vs port "
                                 f"{tuple(tensor.shape)}")
            tensor.copy_(src.to(tensor.dtype))


def head_state_to_state_dict(head_state: Mapping) -> Dict[str, torch.Tensor]:
    """A ``vlm_tpu`` probe head's ``{"params", "batch_stats"}`` (numpy) as
    the port's head ``state_dict``: ``bn`` scale and bias -> ``bn.weight``,
    ``bn.bias``; ``fc*`` kernel [in, out] -> weight [out, in]; the
    BatchNorm's ``mean`` and ``var`` -> ``bn.running_mean`` and
    ``bn.running_var``."""
    out = flax_to_state_dict(head_state["params"])
    for mod, stats in head_state["batch_stats"].items():
        out[f"{mod}.running_mean"] = torch.tensor(np.asarray(stats["mean"]))
        out[f"{mod}.running_var"] = torch.tensor(np.asarray(stats["var"]))
    return out


def load_head_state(head: torch.nn.Module, head_state: Mapping) -> None:
    """Copy a ``vlm_tpu`` head state into the port's head, in place."""
    state = head_state_to_state_dict(head_state)
    own = head.state_dict()
    if set(state) != set(own):
        raise KeyError(f"head bridge mismatch: "
                       f"{sorted(set(state) ^ set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(state[name].to(t.dtype))


def load_multitask_heads(probe, head_states: Mapping) -> None:
    """A ``vlm_tpu`` multi-task probe's ``head_state`` ({task: head state},
    numpy) into the port's :class:`MultiTaskProbe`, in place."""
    if set(head_states) != set(probe.classifiers):
        raise KeyError(f"tasks {sorted(head_states)} vs "
                       f"{sorted(probe.classifiers)}")
    for t, st in head_states.items():
        load_head_state(probe.classifiers[t], st)


def lora_name(name: str) -> str:
    """``block_23/attn/q_proj`` -> ``blocks.23.attn.q_proj``."""
    parts = []
    for m in name.split("/"):
        block = _BLOCK.match(m)
        parts.append(f"blocks.{block.group(1)}" if block else m)
    return ".".join(parts)


def load_lora(lora: Mapping, jax_lora: Mapping) -> None:
    """A ``vlm_tpu`` adapter tree (numpy) into the port's adapters, in
    place (the same names, shapes and values)."""
    got = {lora_name(n): ab for n, ab in jax_lora.items()}
    if set(got) != set(lora):
        raise KeyError(f"adapters {sorted(got)} vs {sorted(lora)}")
    with torch.no_grad():
        for name, ab in got.items():
            for k in ("A", "B"):
                lora[name][k].copy_(torch.tensor(np.asarray(ab[k])))


def load_log_vars(log_vars: Mapping, jax_log_vars: Mapping) -> None:
    """``vlm_tpu``'s uncertainty log-variances into the port's, in place."""
    with torch.no_grad():
        for t, v in jax_log_vars.items():
            log_vars[t].fill_(float(np.asarray(v)))
