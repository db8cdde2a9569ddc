"""Token sampling and prompt ids (``vlm_tpu/generate/decode.py``).

Greedy decoding matches ``vlm_tpu`` token for token; sampled tokens come
from a ``torch.Generator`` and cannot match ``jax.random``'s stream.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """Greedy (``temperature <= 0``; argmax takes the first maximum, as
    ``jnp.argmax``), else temperature sampling with optional rank-based
    top-k and nucleus (top-p) filtering, in fp32. Returns int32 [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if (top_k and top_k > 0) or top_p < 1.0:
        # rank-based, so ties at the boundary never widen the support
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        ranks = torch.arange(logits.shape[-1], device=logits.device)
        keep = torch.ones_like(sorted_logits, dtype=torch.bool)
        if top_k and top_k > 0:
            keep &= ranks < top_k
        if top_p < 1.0:
            probs = torch.softmax(sorted_logits, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep &= (cum - probs) < top_p       # the first token always stays
        sorted_logits = torch.where(keep, sorted_logits, float("-inf"))
        logits = torch.empty_like(logits).scatter_(-1, sort_idx,
                                                   sorted_logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def build_prompt_ids(tokenizer, pre_text: str, post_text: str,
                     n_image_tokens: int, batch: int,
                     add_bos_to_pre: bool = False,
                     add_bos_to_post: bool = False, device=None):
    """Tokenize the batch-constant prompt halves. Returns (pre_ids [B,P1],
    post_ids [B,P2], prompt_len [B]) as int32 tensors."""
    pre = tokenizer.encode(pre_text, add_bos=add_bos_to_pre) if (
        pre_text or add_bos_to_pre) else []
    post = tokenizer.encode(post_text, add_bos=add_bos_to_post) if (
        post_text or add_bos_to_post) else []
    i32 = dict(dtype=torch.int32, device=device)
    pre_ids = torch.tensor([pre] * batch, **i32).reshape(batch, len(pre))
    post_ids = torch.tensor([post] * batch, **i32).reshape(batch, len(post))
    total = len(pre) + n_image_tokens + len(post)
    prompt_len = torch.full((batch,), total, **i32)
    return pre_ids, post_ids, prompt_len
