"""Token sampling, prompt ids and the wave engine
(``vlm_tpu/generate/decode.py``).

:class:`GenerationEngine` generates for one batch at a time: one prefill
over the batch of merged (text + image) prompts into a cache it allocates,
the first token from the prefill's logits, then decode steps until every
row has emitted EOS or reached its cap. ``vlm_tpu`` runs the steps in a
``lax.while_loop`` that tests "all done" on the device. Here each step
pushes that test as a step flag
(:class:`~vlm_tpu_torch.generate.readback.StepFlags`) and the host reads
the flags without waiting, enqueueing up to ``steps_ahead`` steps past the
last one read; a step after every row is done changes no token, length or
score (done rows are fed pad and keep theirs), so the steps past the end
are only device time. The host waits once, at the wave's end.

Greedy decoding matches ``vlm_tpu`` token for token; sampled tokens come
from a ``torch.Generator`` and cannot match ``jax.random``'s stream.

Under a mesh (the module's) the state of every row is whole on every rank
and each data rank runs the forwards of its own rows: its pixels are its
rows' (:meth:`Engine.rows`), and the tokens they give are all-gathered
over the data group (:func:`sample_rows`), so every rank takes the same
decisions. The flags are read in lockstep.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core.mesh import DATA_AXIS
from ..models.decoder import init_kv_cache, local_heads
from .readback import StepFlags


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


def sample_rows(logits: torch.Tensor, mesh, temperature: float = 0.0,
                generator: Optional[torch.Generator] = None, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    """:func:`sample` of a data rank's rows, returning every row's token
    (int32 [B]): greedy tokens are all-gathered over the data group;
    sampling all-gathers the logits and draws every row on every rank from
    the same generator, as one device would. Without a split of the rows,
    :func:`sample` itself."""
    if mesh is None or mesh.data == 1:
        return sample(logits, temperature, generator, top_k, top_p)
    if temperature <= 0.0:
        return mesh.all_gather(sample(logits), DATA_AXIS, 0)
    return sample(mesh.all_gather(logits, DATA_AXIS, 0), temperature,
                  generator, top_k, top_p)


def feed_token(pad_id: int, vocab_size: int) -> int:
    """The id fed for a row that is done or idle: the pad id where it lies
    in the vocabulary, else 0. Its logits are discarded and the KV rows it
    writes are never attended to by a live row, but an id past the table
    would raise here (``vlm_tpu``'s lookup fills such a row with NaN;
    LLaVA's "test" config: pad 32001, vocabulary 512)."""
    return pad_id if 0 <= pad_id < vocab_size else 0


def check_positions(cfg, max_prompt_len: int, max_new_tokens: int) -> int:
    """The cache's length, prompt + new tokens; refused past the decoder's
    positions (RoPE's table, or OPT's learned one), where a lookup would
    fault on the device."""
    if max_prompt_len + max_new_tokens > cfg.decoder.max_position:
        raise ValueError(
            f"prompt {max_prompt_len} + {max_new_tokens} new tokens "
            f"exceed the decoder's {cfg.decoder.max_position} positions")
    return max_prompt_len + max_new_tokens


def uniform_prompts(prompt_len: torch.Tensor) -> bool:
    """Whether every row's prompt has the same length (one host read, so
    the engines take it before they enqueue the prefill). Only
    then may a decode step write every row's KV at one shared column: with
    mixed lengths that column, ``prompt_len[0]``, would overwrite the
    longer prompts' rows."""
    lengths = prompt_len.cpu()
    return bool((lengths == lengths[0]).all())


@dataclasses.dataclass
class GenerationResult:
    """tokens: [B, max_new] generated ids (pad after EOS); lengths: [B]
    number of generated tokens (including the EOS token if emitted)."""
    tokens: torch.Tensor
    lengths: torch.Tensor


@dataclasses.dataclass
class _WaveState:
    cache: dict
    prompt_len: torch.Tensor
    caps: torch.Tensor
    tokens: torch.Tensor
    cur: torch.Tensor
    done: torch.Tensor
    lengths: torch.Tensor
    uniform: bool
    generator: Optional[torch.Generator]
    step: int = 1


class Engine:
    """What the wave and beam engines share: the cache's length and dtype,
    the EOS, pad and feed ids, the loop's condition and the timed loop.

    After :meth:`generate`, ``last_stats`` holds the decode steps that took
    effect (``steps``), those dispatched after every row was done
    (``guarded_steps``), the host's blocking reads, and its seconds to the
    first read of the done flags (the prefill and the first token) and
    after it (the steps, to the last one's end on the device).
    """

    #: decode steps the host may enqueue past the last flag it has read
    steps_ahead = 2

    def __init__(self, module, cfg, *, batch_size: int, max_prompt_len: int,
                 max_new_tokens: int, cache_dtype=None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None):
        self.module = module
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.cache_len = check_positions(cfg, max_prompt_len,
                                         max_new_tokens)
        self.cache_dtype = cache_dtype or module.dtype
        self.eos_id = cfg.decoder.eos_token_id if eos_id is None else eos_id
        self.pad_id = cfg.decoder.pad_token_id if pad_id is None else pad_id
        self.feed_id = feed_token(self.pad_id, cfg.decoder.vocab_size)
        self.mesh = getattr(module, "mesh", None)
        if self.mesh is not None and batch_size % self.mesh.data:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"the mesh's data axis {self.mesh.data}")
        #: the rank's KV heads (its cache's)
        self.kv_heads = local_heads(cfg.decoder, self.mesh)[1]
        self.flags = StepFlags(module.device,
                               lockstep=self.mesh is not None)
        self.last_stats: dict = {}

    def rows(self, n: int) -> slice:
        """This data rank's rows of ``n``: all of them without a mesh."""
        return self.mesh.rows(n) if self.mesh is not None else slice(0, n)

    def new_cache(self, rows: int) -> dict:
        return init_kv_cache(self.cfg.decoder, rows, self.cache_len,
                             self.cache_dtype, self.module.device,
                             kv_heads=self.kv_heads)

    def running(self, s) -> bool:
        """The loop's condition, read on the host (a blocking read), for
        a caller that steps by hand."""
        return not bool(s.done.all()) and s.step < self.max_new_tokens

    def push_flag(self, done: torch.Tensor) -> None:
        """Push the next step's flag: whether a row is still running."""
        self.flags.push(~done.all())

    def _run(self, s_fn):
        """``s_fn()`` (the prefill and the first token; it starts the
        flags and pushes the first), then :meth:`step` until a flag read
        says every row is done or the cap is reached; returns the last
        state with ``step`` at the steps that took effect + 1."""
        flags = self.flags
        waits = flags.waits
        t0 = time.perf_counter()
        s = s_fn()
        t1 = None
        while s.step < self.max_new_tokens and flags.poll() is None:
            if t1 is None and flags.read:
                t1 = time.perf_counter()
            behind = s.step - self.steps_ahead
            if behind > flags.read and flags.wait(behind) is not None:
                break
            self.step(s)
        dispatched = s.step - 1
        flags.drain()
        t2 = time.perf_counter()
        t1 = t2 if t1 is None else t1
        took = flags.effective(dispatched)
        s.step = took + 1
        self.last_stats = {"steps": took, "guarded_steps": dispatched - took,
                           "blocking_reads": flags.waits - waits,
                           "prefill_s": t1 - t0, "decode_s": t2 - t1}
        return s


class GenerationEngine(Engine):
    """Batched generation over a :class:`VLMModule`.

    Args:
        module: the assembled VLM.
        cfg: its config (cache geometry, EOS and pad ids).
        batch_size: rows generated together.
        max_prompt_len: the merged prompt's width (pre + image + post).
        max_new_tokens: generation cap.
        cache_dtype: ``"int8"`` for the quantized cache; default the
            module's compute dtype.
    """

    def __init__(self, module, cfg, *, batch_size: int, max_prompt_len: int,
                 max_new_tokens: int = 100, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, cache_dtype=None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None):
        super().__init__(module, cfg, batch_size=batch_size,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens,
                         cache_dtype=cache_dtype, eos_id=eos_id,
                         pad_id=pad_id)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p

    def _sample(self, logits, generator):
        return sample_rows(logits, self.mesh, self.temperature, generator,
                           self.top_k, self.top_p)

    def start(self, pixels, pre_ids, post_ids, prompt_len,
              generator: Optional[torch.Generator] = None,
              max_new_per_seq: Optional[torch.Tensor] = None) -> _WaveState:
        """The prefill and the first token; the state :meth:`step`
        advances. Under a mesh ``pixels`` are this data rank's rows and the
        other arguments every row's."""
        uniform = uniform_prompts(prompt_len)     # read before the prefill
        b, dev = prompt_len.shape[0], prompt_len.device
        r = self.rows(b)
        cache = self.new_cache(r.stop - r.start)
        last = self.module.prefill(pixels, pre_ids[r], post_ids[r], cache,
                                   prompt_len[r])
        caps = torch.full((b,), self.max_new_tokens, dtype=torch.int32,
                          device=dev) if max_new_per_seq is None else \
            max_new_per_seq.to(device=dev, dtype=torch.int32).clamp(
                max=self.max_new_tokens)
        tok0 = self._sample(last, generator)
        tokens = torch.full((b, self.max_new_tokens), self.pad_id,
                            dtype=torch.int32, device=dev)
        tokens[:, 0] = tok0
        done = (tok0 == self.eos_id) | (caps <= 1)
        self.flags.start()
        self.push_flag(done)
        return _WaveState(
            cache=cache, prompt_len=prompt_len, caps=caps, tokens=tokens,
            cur=tok0, done=done,
            lengths=torch.ones((b,), dtype=torch.int32, device=dev),
            uniform=uniform, generator=generator)

    def step(self, s: _WaveState) -> None:
        """One decode step for every row; rows done before it get pad."""
        r = self.rows(s.cur.shape[0])
        logits = self.module.decode_step(
            s.cur[r, None], (s.prompt_len + (s.step - 1))[r], s.cache,
            uniform_write=s.uniform)
        nxt = torch.where(s.done, self.pad_id,
                          self._sample(logits, s.generator))
        s.tokens[:, s.step] = nxt
        s.lengths += (~s.done).int()
        s.cur = torch.where(s.done, self.feed_id, nxt)
        s.done = s.done | (nxt == self.eos_id) | (s.step + 1 >= s.caps)
        s.step += 1
        self.push_flag(s.done)

    @torch.inference_mode()
    def generate(self, pixels: torch.Tensor, pre_ids: torch.Tensor,
                 post_ids: torch.Tensor, prompt_len: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 max_new_per_seq: Optional[torch.Tensor] = None
                 ) -> GenerationResult:
        """``pixels`` normalized ([B,H,W,3] or the patch layout);
        ``pre_ids``/``post_ids`` [B, P] left-aligned (padded with the pad
        id); ``prompt_len`` [B] the true merged lengths, on the module's
        device. ``max_new_per_seq`` [B] caps each row (clamped to
        ``max_new_tokens``)."""
        s = self._run(lambda: self.start(pixels, pre_ids, post_ids,
                                         prompt_len, generator,
                                         max_new_per_seq))
        return GenerationResult(tokens=s.tokens, lengths=s.lengths)


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
