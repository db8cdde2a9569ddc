"""Beam search (``vlm_tpu/generate/beam.py``): HF ``generate(num_beams=K)``
with ``do_sample=False`` and the default knobs.

- One prefill per image; its cache rows are repeated to the image's K
  beams. Beams 1..K-1 start at ``NEG``, so the first step's candidates all
  come from beam 0.
- Each step: ``scores = beam_scores + log_softmax(logits)`` in fp32, and
  the top 2K candidates of each image over the flattened K x V grid, in
  descending order with ties to the lower index (:func:`top_candidates`).
- An EOS candidate of rank < K becomes a hypothesis scored
  ``sum_logprobs / (step + 1) ** length_penalty``: the EOS counts toward
  the length and is left out of the tokens. Lower-ranked EOS candidates
  are dropped. A pool of K hypotheses keeps the best.
- The K best non-EOS candidates become the next beams; their token
  histories and cache rows follow their source beams.
- ``early_stopping=False``: an image is done once it holds K hypotheses
  and the worst is no worse than the best candidate's score at this length.
  A done image decodes on with its beams frozen.
- At the token cap the running beams join the pool, scored over the steps
  run (HF ``finalize``), and the best hypothesis is returned.

The cache gather. A gather only permutes the beams of one image, and after
the prefill those beams hold identical rows. So they can differ only in
the columns that decode steps have written, and :func:`gather_cache`
moves just those: from the shortest prompt's end to the longest's plus the
steps run. That is bitwise the cache a gather of whole rows gives
(``vlm_tpu``'s ``_gather_cache``, which moves every row of the cache each
step).

Under a mesh whose data axis splits the images, each data rank runs the K
beams of its own images (its pixels; its rows of the prompt ids), with
its own scorer, cache and gather: nothing of one image's search depends on
another's. Each step's "still running" flag is the MAX over the data
ranks, so every rank runs the steps one device runs (a done image's beams
stay frozen) and meets its peers in any collective a step holds
(llm.int8's column maxima over every rank's rows); the flags are read in
lockstep as the wave engine's. The best tokens, lengths and scores are
all-gathered over the data axis at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.mesh import DATA_AXIS
from ..models.decoder import QuantizedKV
from .decode import Engine

NEG = -1e9


def top_candidates(flat: torch.Tensor, n: int):
    """The ``n`` largest values of each row of fp32 ``flat`` [R, N] and
    their indices, in descending order with ties to the lower index: the
    order of ``jax.lax.top_k`` (floats in their total order, -0.0 below
    0.0), which ``torch.topk`` does not promise for equal values. Each
    value and its index make one int64 key, and the keys are distinct, so
    their top ``n`` have one order only."""
    bits = flat.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    width = flat.shape[1]
    keys = ordered * (1 << 32) + (
        width - 1 - torch.arange(width, device=flat.device))
    top = torch.topk(keys, n, dim=1).indices
    return flat.gather(1, top), top


def descending(scores: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-scores)``: a stable ascending sort of the negated
    scores, so equal scores keep their order."""
    return torch.sort(-scores, dim=1, stable=True).indices


def _tensors(cache: dict):
    for layer in cache["k"] + cache["v"]:
        yield from layer if isinstance(layer, QuantizedKV) else (layer,)


def gather_cache(cache: dict, src: torch.Tensor,
                 cols: Optional[slice] = None) -> None:
    """Reorder the cache's rows in place, row ``i`` <- row ``src[i]``
    (int64 [rows]), over the columns ``cols`` (None: every column), in
    every layer's K and V (values and scales of a :class:`QuantizedKV`)."""
    for t in _tensors(cache):
        part = t if cols is None else t[:, cols]
        part.copy_(part.index_select(0, src))


@dataclasses.dataclass
class BeamResult:
    """tokens: [B, max_new] best-hypothesis ids (pad after its end);
    lengths: [B] hypothesis lengths (EOS not included); scores: [B]."""
    tokens: torch.Tensor
    lengths: torch.Tensor
    scores: torch.Tensor


@dataclasses.dataclass
class _BeamState:
    cache: dict
    prompt_len: torch.Tensor        # [B*K]
    uniform: bool
    cols: tuple                     # the shortest and the longest prompt
    beam_scores: torch.Tensor       # [B, K]
    tokens: torch.Tensor            # [B, K, max_new]
    hyp_scores: torch.Tensor        # [B, K]
    hyp_tokens: torch.Tensor        # [B, K, max_new]
    hyp_lengths: torch.Tensor       # [B, K]
    done: torch.Tensor              # [B]
    cur: Optional[torch.Tensor] = None
    step: int = 1


class BeamSearchEngine(Engine):
    """Beam search over a :class:`VLMModule`; ``generate`` runs
    :meth:`start`, :meth:`step` while :meth:`running`, and :meth:`finish`.
    Arguments as :class:`GenerationEngine`'s, ``batch_size`` counting
    images."""

    def __init__(self, module, cfg, *, batch_size: int, max_prompt_len: int,
                 num_beams: int = 4, max_new_tokens: int = 100,
                 length_penalty: float = 1.0, cache_dtype=None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None):
        super().__init__(module, cfg, batch_size=batch_size,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens,
                         cache_dtype=cache_dtype, eos_id=eos_id,
                         pad_id=pad_id)
        self.num_beams = num_beams
        self.length_penalty = length_penalty

    def push_flag(self, done: torch.Tensor) -> None:
        """Push whether an image of any data rank is still running."""
        go = ~done.all()
        if self.mesh is not None and self.mesh.data > 1:
            go = self.mesh.all_reduce(go.reshape(1).int(), DATA_AXIS,
                                      "max")[0].bool()
        self.flags.push(go)

    def _norm(self, length: int) -> float:
        """``length ** length_penalty`` in fp32, as ``vlm_tpu`` forms it."""
        return float(torch.tensor(length, dtype=torch.float32)
                     ** self.length_penalty)

    def start(self, pixels, pre_ids, post_ids, prompt_len) -> _BeamState:
        """The prefill, its rows repeated to every beam, and the first
        token chosen from the prefill's logits. Under a mesh ``pixels``
        are this data rank's images and the other arguments every
        image's."""
        r = self.rows(prompt_len.shape[0])
        pre_ids, post_ids, prompt_len = pre_ids[r], post_ids[r], prompt_len[r]
        b, k, dev = pixels.shape[0], self.num_beams, prompt_len.device
        lengths = prompt_len.cpu()              # read before the prefill
        cache = self.new_cache(b)
        last = self.module.prefill(pixels, pre_ids, post_ids, cache,
                                   prompt_len)
        cache = {kv: tuple(
            QuantizedKV(*(t.repeat_interleave(k, 0) for t in layer))
            if isinstance(layer, QuantizedKV) else
            layer.repeat_interleave(k, 0) for layer in layers)
            for kv, layers in cache.items()}
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        beam_scores = torch.full((b, k), NEG, **f32)
        beam_scores[:, 0] = 0.0
        tokens = torch.full((b, k, self.max_new_tokens), self.pad_id, **i32)
        s = _BeamState(
            cache=cache, prompt_len=prompt_len.repeat_interleave(k),
            uniform=bool((lengths == lengths[0]).all()),
            cols=(int(lengths.min()), int(lengths.max())),
            beam_scores=beam_scores, tokens=tokens,
            hyp_scores=torch.full((b, k), NEG, **f32),
            hyp_tokens=tokens.clone(),
            hyp_lengths=torch.zeros((b, k), **i32),
            done=torch.zeros((b,), dtype=torch.bool, device=dev))
        logp = torch.log_softmax(last.float(), dim=-1)
        self._advance(s, 0, logp[:, None].expand(b, k, logp.shape[-1]))
        self.flags.start()
        self.push_flag(s.done)
        return s

    def step(self, s: _BeamState) -> None:
        """One decode step of every beam, then the scorer and the gather."""
        b, k = s.done.shape[0], self.num_beams
        logits = self.module.decode_step(
            s.cur[:, None], s.prompt_len + (s.step - 1), s.cache,
            uniform_write=s.uniform)
        logp = torch.log_softmax(logits.float(), dim=-1)
        self._advance(s, s.step, logp.view(b, k, -1))
        s.step += 1
        self.push_flag(s.done)

    def _advance(self, s: _BeamState, step: int, logp: torch.Tensor):
        """Choose the beams of ``step`` (0-based in the generated suffix)
        and move the token histories and the cache after them. Decode has
        written columns ``prompt_len .. prompt_len + step - 1``."""
        b, k = logp.shape[:2]
        was_done = s.done[:, None]
        src, tok = self._select(s, step, logp)
        s.tokens = s.tokens.gather(1, src[:, :, None].expand_as(s.tokens))
        s.tokens[:, :, step] = tok
        lo, hi = s.cols
        if hi + step > lo:
            rows = (torch.arange(b, device=src.device)[:, None] * k
                    + src).reshape(-1)
            gather_cache(s.cache, rows, slice(lo, hi + step))
        # a done image's beams are fed a token in the vocabulary
        s.cur = torch.where(was_done, self.feed_id, tok).reshape(-1)

    def _select(self, s: _BeamState, step: int, logp: torch.Tensor):
        """One step of HF's beam scorer over ``logp`` [B, K, V]; updates
        the scores, the hypotheses and the done flags in ``s`` and returns
        each next beam's source beam and token ([B, K])."""
        b, k, v = logp.shape
        cand = s.beam_scores[:, :, None] + logp
        top_vals, top_idx = top_candidates(cand.reshape(b, k * v), 2 * k)
        top_beam = top_idx // v
        top_tok = (top_idx % v).to(torch.int32)
        is_eos = top_tok == self.eos_id
        rank = torch.arange(2 * k, device=logp.device)[None]
        # the EOS counts toward the length: step + 1 generated
        norm = self._norm(step + 1)
        cand_hyp = torch.where(is_eos & (rank < k) & ~s.done[:, None],
                               top_vals / norm, NEG)
        cand_tokens = s.tokens.gather(1, top_beam[:, :, None].expand(
            b, 2 * k, s.tokens.shape[2]))
        pool_scores = torch.cat([s.hyp_scores, cand_hyp], 1)
        pool_tokens = torch.cat([s.hyp_tokens, cand_tokens], 1)
        pool_lengths = torch.cat([s.hyp_lengths,
                                  torch.full_like(top_tok, step)], 1)
        order = descending(pool_scores)[:, :k]
        s.hyp_scores = pool_scores.gather(1, order)
        s.hyp_tokens = pool_tokens.gather(
            1, order[:, :, None].expand_as(s.hyp_tokens))
        s.hyp_lengths = pool_lengths.gather(1, order)

        # the K best non-EOS candidates, in rank order
        ok = ~is_eos
        slot = ok.int().cumsum(1) - 1
        key = torch.where(ok & (slot < k), slot, 2 * k)
        pick = torch.sort(key, dim=1, stable=True).indices[:, :k]
        nxt_scores = top_vals.gather(1, pick)
        nxt_beam = top_beam.gather(1, pick)
        nxt_tok = top_tok.gather(1, pick)

        # early_stopping=False: the best of all 2K candidates, EOS included
        n_hyps = (s.hyp_scores > NEG / 2).sum(1)
        best = top_vals.max(1).values / norm
        new_done = s.done | ((n_hyps >= k) & (s.hyp_scores[:, k - 1] >= best))
        was_done = s.done[:, None]
        s.beam_scores = torch.where(was_done, s.beam_scores, nxt_scores)
        src = torch.where(was_done, torch.arange(k, device=logp.device)[None],
                          nxt_beam)
        tok = torch.where(was_done, self.pad_id, nxt_tok)
        s.done = new_done
        return src, tok

    def finish(self, s: _BeamState) -> BeamResult:
        """Offer the running beams to the pool (scored over the ``step``
        tokens generated) and take each image's best hypothesis."""
        b, k = s.beam_scores.shape
        run_scores = torch.where(s.done[:, None], NEG,
                                 s.beam_scores / self._norm(max(s.step, 1)))
        pool_scores = torch.cat([s.hyp_scores, run_scores], 1)
        pool_tokens = torch.cat([s.hyp_tokens, s.tokens], 1)
        pool_lengths = torch.cat([s.hyp_lengths,
                                  torch.full_like(s.hyp_lengths, s.step)], 1)
        best = descending(pool_scores)[:, :1]
        tokens = pool_tokens.gather(1, best[:, :, None].expand(
            b, 1, pool_tokens.shape[2]))[:, 0]
        lengths = pool_lengths.gather(1, best)[:, 0]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return BeamResult(
            tokens=torch.where(pos < lengths[:, None], tokens, self.pad_id),
            lengths=lengths, scores=pool_scores.gather(1, best)[:, 0])

    @torch.inference_mode()
    def generate(self, pixels: torch.Tensor, pre_ids: torch.Tensor,
                 post_ids: torch.Tensor, prompt_len: torch.Tensor
                 ) -> BeamResult:
        """Arguments as :meth:`GenerationEngine.generate`'s; ``B`` images
        run ``B * num_beams`` rows (under a mesh, each data rank its
        images'; every rank returns every image's result)."""
        res = self.finish(self._run(lambda: self.start(
            pixels, pre_ids, post_ids, prompt_len)))
        if self.mesh is None or self.mesh.data == 1:
            return res
        return BeamResult(*(self.mesh.all_gather(t, DATA_AXIS, 0) for t in
                            (res.tokens, res.lengths, res.scores)))
