"""BLIP-2 OPT in plain PyTorch, in float32: EVA ViT-g, the Q-Former, the
language projection and OPT, with no kernel, cache or batching of the
program's (BLIP-2, Li et al. 2023, arXiv:2301.12597; OPT, Zhang et al.
2022, arXiv:2205.01068; the layer equations of HF ``Blip2Model``).

Weights are read from a dict by the leaf names the benchmark draws them
under; ``widths`` is a configuration file's ``widths`` block. A product
runs in the precision of the :class:`~.precision.Precision` it is given,
float32 unless a control asks for less. Nothing here imports the program.

Departures from the published model, shared with the benchmark's inputs:
a patch vector is laid out row in patch, column in patch, channel (the
layout the benchmark's patch matrix is drawn in); the prompt is token ids,
not text.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .precision import Precision

Weights = Dict[str, torch.Tensor]


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> (x / 255 - mean) / std in float32."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def patch_vectors(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p*p*C]: row, column, channel."""
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)


def layer_norm(x, W: Weights, pre: str, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), W[pre + "weight"].float(),
                        W[pre + "bias"].float(), eps)


def dense(P: Precision, x, W: Weights, pre: str):
    return P.linear(x, W[pre + "weight"], W.get(pre + "bias"))


def attention(P: Precision, q, k, v, heads: int, causal: bool = False):
    """softmax(q kᵀ / sqrt(d)) v over [B, S, H*D] inputs."""
    b, sq, hid = q.shape
    sk = k.shape[1]
    d = hid // heads
    q = q.view(b, sq, heads, d).transpose(1, 2)
    k = k.view(b, sk, heads, d).transpose(1, 2)
    v = v.view(b, sk, heads, d).transpose(1, 2)
    s = P.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    o = P.matmul(torch.softmax(s, dim=-1), v)
    return o.transpose(1, 2).reshape(b, sq, hid)


def eva(P: Precision, W: Weights, vis: dict, images_u8: torch.Tensor,
        mean, std, pre: str = "vision."):
    """EVA ViT-g over uint8 images: (every token after the final LN,
    the pooled CLS: the final LN applied to it a second time)."""
    x = patch_vectors(normalize(images_u8, mean, std), vis["patch_size"])
    x = dense(P, x, W, pre + "patch_embed.")
    b = x.shape[0]
    cls = W[pre + "cls_token"].float().expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + W[pre + "pos_embed"].float()
    eps, heads = vis["layer_norm_eps"], vis["heads"]
    for i in range(vis["layers"]):
        blk = f"{pre}blocks.{i}."
        h = layer_norm(x, W, blk + "ln1.", eps)
        a = attention(P, dense(P, h, W, blk + "attn.q_proj."),
                      dense(P, h, W, blk + "attn.k_proj."),
                      dense(P, h, W, blk + "attn.v_proj."), heads)
        x = x + dense(P, a, W, blk + "attn.out_proj.")
        h = layer_norm(x, W, blk + "ln2.", eps)
        h = F.gelu(dense(P, h, W, blk + "fc1."), approximate="none")
        x = x + dense(P, h, W, blk + "fc2.")
    last = layer_norm(x, W, pre + "post_ln.", eps)
    pooled = layer_norm(last[:, 0], W, pre + "post_ln.", eps)
    return last, pooled


def qformer(P: Precision, W: Weights, qf: dict, img: torch.Tensor,
            pre: str = "projector."):
    """The Q-Former over image tokens, then the language projection."""
    b = img.shape[0]
    eps, heads = qf["layer_norm_eps"], qf["heads"]
    x = layer_norm(W[pre + "query_tokens"].float().expand(b, -1, -1), W,
                   pre + "input_ln.", eps)

    def block(x, kv, at):
        a = attention(P, dense(P, x, W, at + "q."), dense(P, kv, W, at + "k."),
                      dense(P, kv, W, at + "v."), heads)
        return layer_norm(x + dense(P, a, W, at + "out."), W, at + "ln.", eps)

    for i in range(qf["layers"]):
        lay = f"{pre}layers.{i}."
        x = block(x, x, lay + "self_attn.")
        if i % qf["cross_attention_frequency"] == 0:
            x = block(x, img, lay + "cross_attn.")
        h = F.gelu(dense(P, x, W, lay + "ffn_up."), approximate="none")
        x = layer_norm(x + dense(P, h, W, lay + "ffn_down."), W,
                       lay + "ffn_ln.", eps)
    return dense(P, x, W, pre + "language_projection.")


def opt_hidden(P: Precision, W: Weights, dec: dict, embeds: torch.Tensor,
               pre: str = "decoder."):
    """OPT over input embeddings [B, S, H] (causal; positions 0..S-1 read
    the learned table at position + 2): the final LN's output."""
    b, s, _ = embeds.shape
    pos = torch.arange(s, device=embeds.device) + 2
    x = embeds.float() + W[pre + "pos_embed.weight"][pos].float()
    eps, heads = dec["norm_eps"], dec["heads"]
    for i in range(dec["layers"]):
        blk = f"{pre}blocks.{i}."
        h = layer_norm(x, W, blk + "input_norm.", eps)
        a = attention(P, dense(P, h, W, blk + "attn.q_proj."),
                      dense(P, h, W, blk + "attn.k_proj."),
                      dense(P, h, W, blk + "attn.v_proj."), heads,
                      causal=True)
        x = x + dense(P, a, W, blk + "attn.o_proj.")
        h = layer_norm(x, W, blk + "post_attn_norm.", eps)
        h = torch.relu(dense(P, h, W, blk + "mlp.fc1."))
        x = x + dense(P, h, W, blk + "mlp.down_proj.")
    return layer_norm(x, W, pre + "final_norm.", eps)


def served_logits(P: Precision, W: Weights, widths: dict, mean, std,
                  images_u8: torch.Tensor, prompt_ids: Sequence[int],
                  served: List[List[int]]) -> List[torch.Tensor]:
    """For each image, the reference's logits [n_i, V] at the positions
    that predict its served tokens ``served[i]`` (the first from the
    prompt's last row, each next one after the tokens before it): one
    forward over [query outputs, prompt ids, served tokens but the last],
    the rows padded at the end to one length (causal: padding changes no
    earlier row)."""
    img, _ = eva(P, W, widths["vision"], images_u8, mean, std)
    q = qformer(P, W, widths["qformer"], img)
    nq, npr = q.shape[1], len(prompt_ids)
    longest = max(len(t) for t in served)
    dev = q.device
    table = W["decoder.embed.weight"]
    rows = []
    for i, toks in enumerate(served):
        ids = list(prompt_ids) + list(toks[:-1])
        ids += [ids[-1]] * (npr + longest - 1 - len(ids))
        rows.append(torch.cat([q[i], table[torch.tensor(
            ids, device=dev)].float()]))
    h = opt_hidden(P, W, widths["decoder"], torch.stack(rows))
    out = []
    for i, toks in enumerate(served):
        at = nq + npr - 1 + torch.arange(len(toks), device=dev)
        out.append(P.linear(h[i, at], table))
    return out
